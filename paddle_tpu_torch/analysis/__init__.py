"""paddle_tpu_torch.analysis — the runtime half of the JAX package's
``analysis`` (the declared lifecycle machines and their transition
recorder).  The static auditors (AST rules, the retrace, sharding and
XLA audits) are not ported yet (ROADMAP A13)."""

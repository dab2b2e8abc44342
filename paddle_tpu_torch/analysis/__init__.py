"""paddle_tpu_torch.analysis — the port of the JAX package's ``analysis``
so far: the runtime half of the lifecycle machines (the declared
machines and their transition recorder) and the fluid program verifier
(``program_check`` with its ``diagnostics``).  The AST rules, the CLI and
the retrace, sharding and XLA audits are not ported yet (ROADMAP A13c)."""

"""paddle_tpu_torch.analysis.concurrency — the declared lifecycle state
machines and the runtime transition recorder
(:mod:`~paddle_tpu_torch.analysis.concurrency.lifecycle`).  The lock
discipline checker, the static state-table rule and the schedule
explorer of the JAX package are not ported yet (ROADMAP A13)."""

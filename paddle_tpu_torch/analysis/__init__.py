"""paddle_tpu_torch.analysis — the port of the JAX package's ``analysis``:
the fluid program verifier (``program_check`` with its ``diagnostics``),
the repo-invariant linter (``lint``), the concurrency auditor
(``concurrency``: the ``guarded_by`` checker, the lifecycle state
machines checked statically and at run time, the schedule-permutation
explorer) and the CLI (``python -m paddle_tpu_torch.analysis``).  Not
ported yet: the jaxpr auditors (``retrace``, ``xla``, ``sharding``),
the last slice of the analysis package.

This ``__init__`` imports nothing: the serving fleet and the checkpoint
writer import the transition recorder from ``concurrency.lifecycle`` on
their own import paths."""

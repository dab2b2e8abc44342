"""Pin torch's CPU threads in the port's tests: imported first by every
``tests/test_torch_*.py``.

Under ``pytest -n N`` each of the N workers' torch would otherwise take
every core for its small ops while the other workers do the same; the
workers then crowd one another out (a 1.6 s drive took minutes with six
workers at the default thread count).  Each worker gets its share of
the cores, at least one.  JAX's threading is left as it is."""

import os

import torch

_WORKERS = max(1, int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
THREADS = max(1, (os.cpu_count() or 1) // _WORKERS)

torch.set_num_threads(THREADS)
try:
    torch.set_num_interop_threads(THREADS)
except RuntimeError:
    # already set, or torch has started parallel work in this process
    pass

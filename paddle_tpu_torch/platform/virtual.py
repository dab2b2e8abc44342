"""A launcher for N ranks on one host: the port's counterpart of
``paddle_tpu/platform/virtual.py``.

The JAX package tests its meshes on 8 virtual CPU devices inside one
process.  torch has no virtual devices: a mesh of N is N processes in one
``torch.distributed`` job.  :func:`start_ranks` starts them, each on
the CPU with the gloo backend and ``OMP_NUM_THREADS=1`` (N ranks that
each took every core would crowd one another out), rendezvous over a
TCP store on ``127.0.0.1``, and calls ``fn(rank, world, **kwargs)`` in
every rank; it returns while the ranks run (the caller can do its own
work meanwhile), and ``.wait()`` hands back each rank's return value
with its tensors turned into numpy arrays.  ``target`` names the
function as ``"module:function"``; the module is
imported in each rank, so it must not import JAX (a rank is a port
process).  ``paths`` are put on each rank's ``sys.path`` before the
import.  A rank that raises or exits ends the run: the others are
killed (they would wait on a collective forever) and the error carries
the failing rank's output.

``device="cuda"`` starts the ranks on the host's card instead, every
rank on card 0 and still joined by gloo: the ranks share one card, and
NCCL refuses two ranks on one device, while gloo's ``all_reduce`` and
``broadcast`` take CUDA tensors (copying them through host memory).

Run as ``python -m paddle_tpu_torch.platform.virtual <dir> <rank>``
only by :func:`start_ranks` itself.
"""

from __future__ import annotations

import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence

from paddle_tpu_torch.platform.enforce import EnforceError, enforce_that

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return int(s.getsockname()[1])


def _to_host(v):
    import numpy as np
    import torch

    if isinstance(v, torch.Tensor):
        t = v.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy().copy()
    if isinstance(v, dict):
        return {k: _to_host(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_to_host(x) for x in v)
    if isinstance(v, np.ndarray):
        return v
    return v


class RankRun:
    """A launch of ``world`` ranks in flight (:func:`start_ranks`);
    :meth:`wait` returns the ranks' results, rank 0 first."""

    def __init__(self, target: str, world: int, kwargs: Optional[Dict],
                 timeout: float, paths: Sequence[str],
                 device: str = "cpu"):
        self.target, self.world, self.timeout = target, int(world), timeout
        self._tmp = tempfile.mkdtemp(prefix="ptt_ranks_")
        self._procs: List[subprocess.Popen] = []
        self._result: Optional[List[Any]] = None
        try:
            with open(os.path.join(self._tmp, "spec.pkl"), "wb") as f:
                pickle.dump({"target": target, "world": self.world,
                             "port": free_port(), "kwargs": kwargs or {},
                             "paths": list(paths), "device": device}, f)
            env = dict(os.environ)
            env["OMP_NUM_THREADS"] = "1"
            env["MKL_NUM_THREADS"] = "1"
            env["PYTHONPATH"] = os.pathsep.join(
                [_REPO] + [p for p in env.get("PYTHONPATH", "").split(
                    os.pathsep) if p])
            for r in range(self.world):
                log = open(os.path.join(self._tmp, f"rank{r}.log"), "wb")
                self._procs.append(subprocess.Popen(
                    [sys.executable, "-m",
                     "paddle_tpu_torch.platform.virtual", self._tmp,
                     str(r)], env=env, stdout=log,
                    stderr=subprocess.STDOUT, cwd=_REPO))
                log.close()
        except BaseException:
            self._cleanup()
            raise
        self._deadline = time.monotonic() + timeout

    def wait(self) -> List[Any]:
        if self._result is not None:
            return self._result
        try:
            failed = None
            while True:
                codes = [p.poll() for p in self._procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    failed = bad[0]
                    break
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > self._deadline:
                    failed = -1
                    break
                time.sleep(0.02)
            if failed is not None:
                self._kill()
                what = (f"rank {failed} exited with code "
                        f"{self._procs[failed].returncode}" if failed >= 0
                        else f"the ranks ran past {self.timeout} s")
                # every rank's tail: the first to fail is not always the
                # first seen (its peers then fail on the closed link)
                tails = []
                for r in range(self.world):
                    with open(os.path.join(self._tmp, f"rank{r}.log"),
                              "rb") as f:
                        tails.append(f"--- rank {r} ---\n" + f.read()[
                            -3000:].decode(errors="replace"))
                raise EnforceError(f"{self.target} over {self.world} ranks:"
                                   f" {what}; the ranks' output:\n"
                                   + "\n".join(tails), context="run_ranks")
            out = []
            for r in range(self.world):
                with open(os.path.join(self._tmp, f"rank{r}.pkl"),
                          "rb") as f:
                    out.append(pickle.load(f))
            self._result = out
            return out
        finally:
            self._cleanup()

    def _kill(self) -> None:
        for p in self._procs:
            if p.poll() is None:
                p.kill()
        for p in self._procs:
            p.wait()

    def _cleanup(self) -> None:
        self._kill()
        shutil.rmtree(self._tmp, ignore_errors=True)


def start_ranks(target: str, world: int, kwargs: Optional[Dict] = None,
                timeout: float = 300.0, paths: Sequence[str] = (),
                device: str = "cpu") -> RankRun:
    """Start ``target`` in ``world`` gloo ranks and return at once (the caller may work meanwhile); ``.wait()`` collects
    the results.  ``device="cuda"`` puts every rank on card 0 (module
    doc)."""
    enforce_that(device in ("cpu", "cuda"),
                 f"device must be 'cpu' or 'cuda', got {device!r}",
                 context="run_ranks")
    return RankRun(target, world, kwargs, timeout, paths, device)


def _rank_main(tmp: str, rank: int) -> None:
    import importlib

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    with open(os.path.join(tmp, "spec.pkl"), "rb") as f:
        spec = pickle.load(f)
    for p in reversed(spec["paths"]):
        sys.path.insert(0, p)
    world = spec["world"]
    if spec.get("device") == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo",
                            init_method=f"tcp://127.0.0.1:{spec['port']}",
                            world_size=world, rank=rank)
    try:
        mod_name, fn_name = spec["target"].split(":")
        fn = getattr(importlib.import_module(mod_name), fn_name)
        result = _to_host(fn(rank=rank, world=world, **spec["kwargs"]))
        with open(os.path.join(tmp, f"rank{rank}.pkl.tmp"), "wb") as f:
            pickle.dump(result, f)
        os.replace(os.path.join(tmp, f"rank{rank}.pkl.tmp"),
                   os.path.join(tmp, f"rank{rank}.pkl"))
        # no rank leaves while another may still talk to it
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))

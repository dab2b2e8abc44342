"""Where the ResNet-50 training step's time goes on the card.

Trains the headline cell of ``tools/image_workload.py`` (ResNet-50, 224
px, batch 128, ``Momentum(0.9, 0.01)``, bf16 conv operands and maps,
random weights from seed 0, device-resident ``[B, H, W, C]`` feeds)
with ``SGD.step``: two warm-up steps, then ``STEPS`` steps unprofiled for
the host wall time, then ``STEPS`` steps under ``torch.profiler`` for the
kernels.  It prints one JSON line: wall ms a step, device busy ms a step
(the CUDA kernels' time), ``idle_share`` = 1 - busy / wall, device ms a
step in the groups convolution (cuDNN), batch norm, pooling, elementwise,
matmul and layout copies (each kernel grouped by the ``aten`` op that
launched it; ``grouped_ms_per_step`` is what the profiler tied to an op,
to be read against the busy time), kernel launches a step, the top
kernels, and the layout-changing copies a step as the dispatcher sees
them (``aten`` copies whose output orders its dimensions otherwise than
their input: count, bytes, and the shapes), which must be the conv
weights' and never an activation's.  The layout-copy group is the kernels
those copies launched, read in a second profiled pass under the
dispatcher mode, where each copy runs inside a profiler range of its own
and a kernel counts as a layout copy when its launching op lies inside
the range of a copy the mode flagged; they move there from the
elementwise group of the plain pass, which gives every other number
(the mode changes how some other ops launch).

Run from the repository root on a machine with one GPU::

    python -m paddle_tpu_torch.tools.profile_image
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from paddle_tpu_torch.tools import image_workload as iw

STEPS = 3
GROUPS = ("convolution", "batch_norm", "pooling", "matmul",
          "layout_copies", "elementwise")


def _group(op: str) -> str:
    """A kernel's group, from the ``aten`` op that launched it (cuDNN runs
    some convs as plain GEMM kernels, so its names do not tell)."""
    op = op.lower()
    for group, marks in (("batch_norm", ("batch_norm",)),
                         ("convolution", ("conv",)),
                         ("pooling", ("pool",)),
                         ("matmul", ("aten::mm", "aten::addmm",
                                     "aten::bmm"))):
        if any(m in op for m in marks):
            return group
    return "elementwise"


def _kernels(prof):
    """(name, device us, count) of the CUDA kernels only."""
    from torch.autograd import DeviceType

    return [(e.key, float(e.self_device_time_total), e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]


def profile_steps(sgd, feeds, steps: int = STEPS, mode=None):
    """``steps`` training steps under ``torch.profiler`` (and ``mode``, a
    dispatch mode, when given), synchronized at the end."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        with mode if mode is not None else contextlib.nullcontext():
            for _ in range(steps):
                sgd.step(feeds)
        torch.cuda.synchronize()
    return prof


def launches_per_step(prof, steps: int = STEPS) -> float:
    """CUDA kernel launches a step in a :func:`profile_steps` run: the
    one count of launches a step, for this tool and ``chip_smoke.py``."""
    return sum(c for _, _, c in _kernels(prof)) / steps


def _launched(prof, labels=frozenset()):
    """(kernel name, device us, launching op name, whether the op lies in
    a range named in ``labels``) of every kernel the profiler ties to the
    CPU op that launched it."""
    from torch.autograd import DeviceType

    def in_labeled(e):
        while e is not None:
            if e.name in labels:
                return True
            e = e.cpu_parent
        return False

    return [(k.name, float(k.duration), e.name, in_labeled(e))
            for e in prof.events()
            if e.device_type == DeviceType.CPU for k in e.kernels]


def _dim_order(t: torch.Tensor):
    """The dimensions of size > 1 from the outermost in memory in."""
    dims = [d for d in range(t.dim()) if t.shape[d] > 1]
    return tuple(sorted(dims, key=lambda d: -t.stride(d)))


class LayoutCopies(TorchDispatchMode):
    """Runs every ``aten`` copy inside a profiler range of its own and
    records each whose output lays its dimensions out in another order
    than its input: (op, output shape, bytes), and the names of those
    copies' ranges in ``labels``."""

    _COPIES = {"_to_copy", "copy_", "clone", "contiguous"}

    def __init__(self):
        super().__init__()
        self.copies = []
        self.labels = set()
        self._n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        op = func.overloadpacket.__name__
        if op not in self._COPIES:
            return func(*args, **(kwargs or {}))
        self._n += 1
        label = f"copy#{self._n}"
        with torch.profiler.record_function(label):
            out = func(*args, **(kwargs or {}))
        src = args[1] if op == "copy_" else args[0]
        if (isinstance(src, torch.Tensor) and src.dim() >= 2 and
                _dim_order(src) != _dim_order(out)):
            self.copies.append((op, tuple(out.shape),
                                out.numel() * out.element_size()))
            self.labels.add(label)
        return out

    def per_step(self, steps: int) -> dict:
        """Count, bytes and each distinct output shape with its count, a
        step."""
        shapes = {}
        for _, shape, _ in self.copies:
            shapes[str(shape)] = shapes.get(str(shape), 0) + 1 / steps
        return {"count": len(self.copies) / steps,
                "bytes": sum(b for *_, b in self.copies) / steps,
                "largest_bytes": max((b for *_, b in self.copies),
                                     default=0),
                "shapes": shapes}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_image: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cudnn = iw.configure_cudnn()
    dev = torch.device("cuda")
    sgd = iw.build_trainer(iw.HEADLINE, dev)
    feeds = iw.device_feeds(iw.HEADLINE, dev)
    for _ in range(2):                            # warm-up
        sgd.step(feeds)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        cost = sgd.step(feeds)
    float(cost)
    wall = 1e3 * (time.perf_counter() - t0) / STEPS
    prof = profile_steps(sgd, feeds, STEPS)
    kernels = _kernels(prof)
    busy = sum(us for _, us, _ in kernels) / 1e3 / STEPS
    groups = dict.fromkeys(GROUPS, 0.0)
    launches = dict.fromkeys(GROUPS, 0.0)
    for _, us, op, _ in _launched(prof):
        groups[_group(op)] += us / 1e3 / STEPS
        launches[_group(op)] += 1 / STEPS
    # the dispatch mode changes how some ops launch, so its pass is read
    # for the flagged copies' kernels alone, which the plain pass grouped
    # as elementwise (launched by aten copies)
    mode = LayoutCopies()
    for _, us, _, flagged in _launched(profile_steps(sgd, feeds, STEPS, mode),
                                       mode.labels):
        if flagged:
            for into, sign in (("layout_copies", 1), ("elementwise", -1)):
                groups[into] += sign * us / 1e3 / STEPS
                launches[into] += sign / STEPS
    top = sorted(kernels, key=lambda k: -k[1])[:25]
    cell = iw.MODELS[iw.HEADLINE]
    print(json.dumps({
        "model": iw.HEADLINE, "img": cell["img"], "batch": cell["batch"],
        "steps": STEPS, **cudnn, "wall_ms_per_step": wall,
        "images_per_s": cell["batch"] / (wall / 1e3),
        "device_busy_ms_per_step": busy, "idle_share": 1.0 - busy / wall,
        "grouped_ms_per_step": sum(groups.values()),
        "device_ms_per_step_by_group": groups,
        "launches_per_step_by_group": launches,
        "kernel_launches_per_step": launches_per_step(prof, STEPS),
        "layout_copies_per_step": mode.per_step(STEPS),
        "top_kernels": [{"name": n[:120], "ms_per_step": us / 1e3 / STEPS,
                         "count": c / STEPS} for n, us, c in top],
        "device": torch.cuda.get_device_name(0), "nvidia_smi": card_line()}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

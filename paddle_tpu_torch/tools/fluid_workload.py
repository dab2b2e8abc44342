"""The fluid prototype on the card: the Paddle book's recognize_digits
models, built with ``fluid.layers`` and run by ``fluid.Executor()``, and
the control-flow programs (``chip_smoke.py``'s ``fluid_mnist`` and
``fluid_control`` phases; ``python -m paddle_tpu_torch.tools.fluid_workload``
runs both and prints one JSON line each).

- :func:`fluid_mnist`: the book's MLP (784-128 relu-64 relu-10 softmax,
  Adam 1e-3) and convnet (conv 20@5x5 relu, 2x2 max pool, conv 50@5x5
  relu, 2x2 max pool, fc 10 softmax; Momentum 0.9 at 0.01), batch 64 of
  the seeded 28x28 synthetic MNIST digits (``dataset.mnist._synthetic``:
  no dataset is in the repository, and nothing is fetched), 20 steps on
  the card.  Gates: the first 3 card costs equal the port's CPU run from
  the same ``_init_value`` weights within ``COST_RTOL``; every cost
  finite and the last below the first; ``verify_program`` finds no
  error.  Printed: ms a step (host clock around ``Executor.run``, which
  returns numpy and so waits for the card; the median of the steps after
  ``WARMUP``), CUDA launches a step (``torch.profiler`` over one step),
  peak memory.
- :func:`fluid_control`: StaticRNN, cond and DynamicRNN (reverse) at
  small widths, 3 SGD steps on the card against the CPU from the same
  weights: costs, outputs and the input's gradient within ``COST_RTOL``.
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from typing import Dict, List

import numpy as np
import torch

BATCH = 64
STEPS = 20
CHECK_STEPS = 3
WARMUP = 2
PROFILED_STEP = 10
SEED = 0
# card against CPU, f32 with TF32 off: cuBLAS's and cuDNN's sums run in
# other orders than the CPU's, and Adam rescales the ~1e-7 gradient
# differences to whole steps of its lr over 3 steps
COST_RTOL = 1e-4


def mnist_program(fluid, model: str):
    """(program, loss, accuracy, feed names) of the book's ``model``
    ("mlp" or "conv")."""
    L, opt = fluid.layers, fluid.optimizer
    prog = fluid.Program()
    with fluid.program_guard(prog):
        label = L.data("label", [1], dtype="int64")
        if model == "mlp":
            img = L.data("img", [784])
            h = L.fc(img, size=128, act="relu")
            h = L.fc(h, size=64, act="relu")
        else:
            img = L.data("img", [1, 28, 28])
            h = L.conv2d(img, num_filters=20, filter_size=5, act="relu")
            h = L.pool2d(h, pool_size=2, pool_stride=2)
            h = L.conv2d(h, num_filters=50, filter_size=5, act="relu")
            h = L.pool2d(h, pool_size=2, pool_stride=2)
        pred = L.fc(h, size=10, act="softmax")
        loss = L.mean(L.cross_entropy(pred, label))
        acc = L.accuracy(pred, label)
        if model == "mlp":
            opt.AdamOptimizer(learning_rate=1e-3).minimize(loss)
        else:
            opt.MomentumOptimizer(learning_rate=0.01,
                                  momentum=0.9).minimize(loss)
    return prog, loss, acc, ["img", "label"]


def mnist_feeds(model: str, steps: int, seed: int = SEED) -> List[Dict]:
    """The first ``steps`` batches of ``STEPS`` batches of the seeded
    synthetic digits (the offline fallback of ``dataset.mnist``, called
    directly; always ``STEPS`` batches drawn, since the draw's length
    moves its stream)."""
    from paddle_tpu_torch.dataset import mnist

    images, labels = mnist._synthetic(BATCH * max(steps, STEPS), seed)
    shape = (BATCH, 784) if model == "mlp" else (BATCH, 1, 28, 28)
    return [{"img": images[i * BATCH:(i + 1) * BATCH].reshape(shape),
             "label": labels[i * BATCH:(i + 1) * BATCH, None]}
            for i in range(steps)]


def verify_errors(prog, fetch, feeds) -> List[str]:
    from paddle_tpu_torch.analysis.diagnostics import Severity
    from paddle_tpu_torch.analysis.program_check import verify_program

    return [str(d) for d in verify_program(prog, fetch_names=fetch,
                                           feed_names=feeds)
            if d.severity is Severity.ERROR]


def _profiled(exe, prog, feed, fetch, scope):
    """One ``Executor.run`` under ``torch.profiler``: (its fetches, the
    CUDA kernels it launched)."""
    from torch.autograd import DeviceType

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        got = exe.run(prog, feed=feed, fetch_list=fetch, scope=scope)
        torch.cuda.synchronize()
    return got, int(sum(e.count for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA))


def run_mnist(model: str, device, steps: int) -> Dict:
    """``steps`` steps of ``model`` on ``device`` from ``_init_value``'s
    weights: costs, accuracies, host ms of each unprofiled step, the
    launches of the profiled step (on the card) and peak memory."""
    import paddle_tpu_torch.fluid as fluid

    prog, loss, acc, feeds = mnist_program(fluid, model)
    exe, scope = fluid.Executor(device), fluid.Scope()
    cuda = exe.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    costs, accs, ms, launches = [], [], [], None
    for i, feed in enumerate(mnist_feeds(model, steps)):
        if cuda and i == PROFILED_STEP:
            (c, a), launches = _profiled(exe, prog, feed, [loss, acc],
                                         scope)
        else:
            t0 = time.perf_counter()
            c, a = exe.run(prog, feed=feed, fetch_list=[loss, acc],
                           scope=scope)
            if i >= WARMUP:
                ms.append(1e3 * (time.perf_counter() - t0))
        costs.append(float(c))
        accs.append(float(a))
    return {"model": model, "costs": costs, "accuracy": accs,
            "ms_a_step": statistics.median(ms) if ms else None,
            "ms_each": ms, "launches_a_step": launches,
            "peak_memory_mb": (torch.cuda.max_memory_allocated() / 2 ** 20
                               if cuda else None),
            "verify_errors": verify_errors(prog, [loss.name, acc.name],
                                           feeds)}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def fluid_mnist(device="cuda") -> List[Dict]:
    """Both book models on ``device`` for ``STEPS`` steps, each held to
    the port's CPU run for ``CHECK_STEPS`` steps; raises when a gate
    fails."""
    out = []
    for model in ("mlp", "conv"):
        card = run_mnist(model, device, STEPS)
        cpu = run_mnist(model, "cpu", CHECK_STEPS)
        res = dict(card, phase="fluid_mnist", batch=BATCH, steps=STEPS,
                   cpu_costs=cpu["costs"],
                   cost_rel_err_cpu=_rel(card["costs"][:CHECK_STEPS],
                                         cpu["costs"]),
                   cost_rtol=COST_RTOL)
        out.append(res)
        costs = card["costs"]
        if card["verify_errors"] or not np.all(np.isfinite(costs)) or \
                not costs[-1] < costs[0] or \
                res["cost_rel_err_cpu"] > COST_RTOL:
            raise AssertionError(f"fluid_mnist {model}: {res}")
    return out


def control_program(fluid, kind: str):
    """(program, fetch names, feed) of a small control-flow program with
    an SGD step: a StaticRNN, a cond over two fc branches, a reverse
    DynamicRNN over ragged rows."""
    L = fluid.layers
    rng = np.random.RandomState(11)
    prog = fluid.Program()
    with fluid.program_guard(prog):
        if kind == "static_rnn":
            x = L.data("x", [6, 4, 8], append_batch_size=False)
            rnn = L.StaticRNN()
            with rnn.step():
                xt = rnn.step_input(x)
                h_prev = rnn.memory(shape=(4, 16), init_value=0.0)
                h = L.fc([xt, h_prev], size=16, act="tanh", name="ctl_rnn")
                rnn.update_memory(h_prev, h)
                rnn.step_output(h)
            out = rnn()
            feed = {"x": rng.randn(6, 4, 8).astype(np.float32)}
        elif kind == "cond":
            x = L.data("x", [8])
            pred = L.data("pred", [1])
            out = L.cond(pred, lambda: L.fc(x, size=4, act="tanh"),
                         lambda: L.fc(x, size=4))
            feed = {"x": rng.randn(16, 8).astype(np.float32),
                    "pred": (rng.rand(16) > 0.5).astype(np.float32)}
        else:
            x = L.data("x", [8], lod_level=1)
            drnn = L.DynamicRNN(reverse=True)
            with drnn.step():
                xt = drnn.step_input(x)
                h = drnn.memory(shape=(4, 16))
                s = L.fc([xt, h], size=16, act="tanh", name="ctl_drnn")
                drnn.update_memory(h, s)
                drnn.step_output(s)
            out = drnn()
            lod = ((0, 5, 7, 8, 14),)
            feed = {"x": fluid.LoDArray(rng.randn(14, 8).astype(np.float32),
                                        lod)}
        x.stop_gradient = False
        loss = L.mean(L.square(out))
        fluid.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
    return prog, [loss.name, out.name, "x@GRAD"], feed


def fluid_control(device="cuda") -> List[Dict]:
    """The three control-flow programs, ``CHECK_STEPS`` steps on
    ``device`` and on the CPU from the same weights; raises when a cost,
    an output or the input's gradient parts by more than ``COST_RTOL``
    (in norm, relative)."""
    import paddle_tpu_torch.fluid as fluid

    out = []
    for kind in ("static_rnn", "cond", "dynamic_recurrent"):
        runs = {}
        for dev in (device, "cpu"):
            prog, fetch, feed = control_program(fluid, kind)
            exe, scope = fluid.Executor(dev), fluid.Scope()
            runs[str(dev)] = [exe.run(prog, feed=feed, fetch_list=fetch,
                                      scope=scope)
                              for _ in range(CHECK_STEPS)]
        card, cpu = runs[str(device)], runs["cpu"]
        errs = [float(np.linalg.norm(np.asarray(a, np.float64) - b)
                      / max(np.linalg.norm(np.asarray(b, np.float64)),
                            1e-30))
                for ra, rb in zip(card, cpu) for a, b in zip(ra, rb)]
        res = {"phase": "fluid_control", "program": kind,
               "costs": [float(r[0]) for r in card],
               "cpu_costs": [float(r[0]) for r in cpu],
               "max_rel_err_cpu": max(errs), "rtol": COST_RTOL}
        out.append(res)
        if not max(errs) <= COST_RTOL or \
                not np.all(np.isfinite(res["costs"])):
            raise AssertionError(f"fluid_control {kind}: {res}")
    return out


def main(argv=None) -> int:
    # f32 means f32 on the card, as in chip_smoke.py: no TF32 in cuBLAS or
    # cuDNN (the CPU gates compare against exact f32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for res in fluid_mnist() + fluid_control():
        print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())

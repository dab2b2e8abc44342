"""Where the NMT training step's and generated batch's time goes on the
card.

Trains ``nmt_workload``'s configuration (``models/seq2seq`` at
demo/seqToseq's width: dictionaries of 30000, word vectors and GRUs of
512, batch 50 of lengths 10-80, Adam at 5e-4) on one batch: two warm-up
steps, ``STEPS`` steps through ``SGD.train`` (the end-to-end step: the
``DataFeeder`` feeds the batch each step) and ``STEPS`` through
``SGD.step`` on feeds made once, each ending in the cost's host copy, the
feeding alone (``nmt_workload.feeds``, ``STEPS`` times), then ``STEPS``
``SGD.step`` steps under ``torch.profiler``.  Then it generates from the
trained weights (16 sources, beam 3, max_length 250) through
``Inference``, for each of ``nmt_workload.GENERATIONS`` (``<e>`` banned
until each source's target length, and until step 250): one warm-up
batch, one for the wall time, one profiled.  One JSON line each: wall ms,
device busy ms (the sum of CUDA kernel times), ``idle_share`` = 1 - busy
/ wall, device ms and launches grouped into the one-launch GRU step (B6),
matrix products and everything else, kernel launches, the top kernels,
peak memory, and the card's SM clock read just after the profile.

Run from the repository root on a machine with one GPU::

    python -m paddle_tpu_torch.tools.profile_nmt
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from paddle_tpu_torch import event
from paddle_tpu_torch.tools import nmt_workload as nw
from paddle_tpu_torch.tools.compare_flash import sm_clock
from paddle_tpu_torch.tools.profile_rnn import summary

STEPS = 3


def _wall(fn, n: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / n


def _profiled(fn, n: int):
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return prof


def profile_train(dev):
    sgd = nw.build_trainer(dev)
    batch = nw.samples(nw.SEED + 1)
    feeds = nw.feeds(sgd, batch)

    def step():
        float(sgd.step(feeds))

    def train():
        costs = []
        sgd.train(nw.repeat_reader(batch, STEPS), event_handler=lambda ev:
                  costs.append(ev.cost)
                  if isinstance(ev, event.EndIteration) else None,
                  feeding=nw.FEEDING)

    _wall(step, 2)                                   # warm-up
    torch.cuda.reset_peak_memory_stats()
    train_ms = _wall(train, 1) / STEPS
    wall = _wall(step, STEPS)
    feed_ms = _wall(lambda: nw.feeds(sgd, batch), STEPS)
    prof = _profiled(step, STEPS)
    res = {"what": "train_step", "batch": nw.BATCH,
           "source_frames": nw.source_frames(batch),
           "target_tokens": nw.target_tokens(batch), "steps": STEPS,
           "train_ms": train_ms, "feed_ms": feed_ms,
           **summary(prof, STEPS, wall),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
           "sm_clock_after_profile": sm_clock()}
    return sgd, res


def profile_generate(dev, sgd, variant: str):
    seed = nw.SEED + 4
    srcs = nw.sources(seed)
    beam, inf = nw.generator(sgd.parameters, sgd.model_state, dev, hooks={
        "candidate_adjust": nw.EosBan(nw.eos_until(variant, seed))})

    def run():
        nw.generate(inf, srcs)

    run()                                            # warm-up
    wall = _wall(run, 1)
    prof = _profiled(run, 1)
    return {"what": "generate_batch", "variant": variant,
            "sources": len(srcs), "beam": nw.BEAM,
            "max_length": nw.MAX_LENGTH, "steps_taken": beam.steps_taken,
            "source_frames": nw.source_frames(srcs),
            **summary(prof, 1, wall), "sm_clock_after_profile": sm_clock()}


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_nmt: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    sgd, res = profile_train(dev)
    for r in [res] + [profile_generate(dev, sgd, v) for v in nw.GENERATIONS]:
        r.update(device=torch.cuda.get_device_name(0), nvidia_smi=card)
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

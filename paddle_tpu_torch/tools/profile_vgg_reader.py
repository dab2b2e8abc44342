"""Where VGG-16's reader step goes on the host.

Trains ``vgg_workload``'s configuration (224 px, batch 64, bf16) through
``SGD.train`` from its reader and splits the host's part of a step: the
reader's mapping of a batch (``image.py``'s crop, mirror, mean and CHW
steps, the shuffle and the batching, timed over a pass), the
``DataFeeder``'s stacking on the host, and the pinned copy to the card,
beside the device-feed step; then the step at prefetch 0,
at prefetch 2, and at prefetch 2 with the interpreter's thread switch
interval cut from 5 ms to 0.5 ms (restored after), each over ``PASSES``
passes of ``BATCHES`` batches, ten times the shuffle buffer, timed from
the end of each pass's first batch (``vgg_workload.StepClock``).  It
prints one JSON line with each time and the card's name and power
limit.

Run from the repository root on a machine with one GPU::

    python -m paddle_tpu_torch.tools.profile_vgg_reader
"""

from __future__ import annotations

import json
import random
import subprocess
import sys
import time

import numpy as np
import torch

from paddle_tpu_torch.tools import vgg_workload as vw

BATCHES, PASSES = 20, 2


def _ms_a_step(sgd, reader, prefetch: int) -> list:
    """Host ms a step of each pass after its first batch."""
    out = []
    for _ in range(PASSES):
        clock = vw.StepClock()
        sgd.train(reader, num_passes=1, event_handler=clock,
                  prefetch=prefetch)
        out.append(clock.ms_a_step())
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_vgg_reader: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cudnn.benchmark = True
    random.seed(0)
    sgd = vw.trainer(dev)
    samples = vw.raw_images(vw.BATCH * BATCHES, 1)
    reader = vw.train_reader(samples, 2)
    feeder = sgd._make_feeder(None, torch.device("cpu"))
    # the mapping, shuffle and batching timed over the whole pass
    t0 = time.perf_counter()
    batches = list(reader())
    host = {"map_ms": [1e3 * (time.perf_counter() - t0) / BATCHES],
            "feed_ms": [], "pin_copy_ms": []}
    for batch in batches:
        t1 = time.perf_counter()
        feeds = feeder.feed(batch)
        t2 = time.perf_counter()
        on_card = {k: v.pin_memory().to(dev, non_blocking=True)
                   for k, v in feeds.items()}
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        host["feed_ms"].append(1e3 * (t2 - t1))
        host["pin_copy_ms"].append(1e3 * (t3 - t2))
    sgd.step(on_card)                                   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(BATCHES):
        sgd.step(on_card)
    torch.cuda.synchronize()
    device_ms = 1e3 * (time.perf_counter() - t0) / BATCHES
    steps = {"prefetch_0": _ms_a_step(sgd, reader, 0),
             "prefetch_2": _ms_a_step(sgd, reader, 2)}
    old = sys.getswitchinterval()
    sys.setswitchinterval(5e-4)
    try:
        steps["prefetch_2_switch_0.5ms"] = _ms_a_step(sgd, reader, 2)
    finally:
        sys.setswitchinterval(old)
    print(json.dumps({
        "what": "vgg16_reader_step", "batch": vw.BATCH, "img": vw.IMG,
        "batches": BATCHES, "passes": PASSES,
        "shuffle_buf": vw.SHUFFLE_BUF,
        "host_ms_a_batch": {k: float(np.median(v)) for k, v in host.items()},
        "device_feed_step_ms": device_ms, "ms_a_step": steps,
        "switch_interval_s": old,
        "device": torch.cuda.get_device_name(0), "nvidia_smi": card}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

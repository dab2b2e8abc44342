"""How far VGG-16's batch-2 gradients at 224 px move between runs that
round apart: the bound below which the card-against-CPU step of
``chip_smoke.py``'s ``vgg16`` phase cannot hold.

One batch of 2 of ``vgg_workload``'s mapped images, the weights drawn on
the CPU from seed 0, the dropout masks shared (``SharedMasks``), the f32
policy; the gradients of the mean cost on the CPU and on the card, each
with float32 and with float64 weights and images (the port's fc products
and cost still round their outputs to float32).  It prints one JSON line:
for each run, its cost and each parameter's gradient against the card's
float64 run, relative in norm (median, worst, the six worst), and the
card's name and power limit.

Run from the repository root on a machine with one GPU::

    python -m paddle_tpu_torch.tools.vgg_grad_spread
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

from paddle_tpu_torch.tools import vgg_workload as vw

RUNS = (("cpu", torch.float32), ("cpu", torch.float64),
        ("cuda", torch.float32), ("cuda", torch.float64))


def gradients(topo, p0, batch, masks, dev, dtype):
    """(mean cost, {name: gradient as CPU float64})."""
    p = {k: v.detach().to(dev, dtype).clone().requires_grad_(True)
         for k, v in p0.items()}
    feeds = vw.device_feeds(batch, dev)
    feeds["image"] = feeds["image"].to(dtype)
    masks.reset()
    loss = topo.forward(p, feeds)[0].mean()
    loss.backward()
    return float(loss), {k: v.grad.detach().cpu().double()
                         for k, v in p.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("vgg_grad_spread: needs a CUDA device", file=sys.stderr)
        return 2
    from paddle_tpu_torch import topology
    from paddle_tpu_torch.ops import math as pmath
    from paddle_tpu_torch.parameters import Parameters
    from paddle_tpu_torch.platform.flags import FLAGS

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    FLAGS.use_bf16 = False
    masks = vw.SharedMasks()
    pmath.dropout = masks
    topology.reset_name_scope()
    _, _, _, cost = vw.build()
    topo = topology.Topology([cost])
    params = Parameters.from_topology(topo, seed=0, device="cpu")
    p0 = {k: params[k].detach().clone() for k in topo.param_specs()}
    batch = [vw.mapper(71)(s) for s in vw.raw_images(2, 70)]
    runs = {f"{d}_{str(t)[6:]}": gradients(topo, p0, batch, masks,
                                           torch.device(d), t)
            for d, t in RUNS}
    ref = runs["cuda_float64"][1]
    out = {}
    for name, (loss, g) in runs.items():
        rel = {k: float((g[k] - ref[k]).norm() / ref[k].norm())
               for k in ref}
        worst = sorted(rel, key=rel.get)[-6:]
        out[name] = {"cost": loss, "median": float(np.median(
            list(rel.values()))), "max": rel[worst[-1]],
            "worst": {k: rel[k] for k in worst}}
    print(json.dumps({"what": "vgg16_grad_spread", "img": vw.IMG,
                      "batch": 2, "against": "cuda_float64", **out,
                      "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

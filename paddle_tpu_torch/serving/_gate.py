"""Shared pieces of the serving gates (``main(["check"])`` of
``kv_cache``, ``fleet``, ``migrate`` and ``control``, and
``obs.cli.seeded_chaos``): the gates' small model and their command
line.  Each gate replays a seeded trace at the JAX package's widths
(vocab 64, one layer, two heads of 8) on the JAX package's seed-0
weights (``gate_weights.npz``, its ``init_params(PRNGKey(0))`` draw as
numpy: the traces' coverage — which requests a kill catches mid-flight,
which migrate — depends on the tokens those weights generate), and
exits 0 (clean), 1 (findings) or 2 (a crash, or an unknown command)."""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Sequence

import numpy as np

from paddle_tpu_torch.platform.device import DeviceLike

GATE_MODEL = dict(vocab_size=64, num_layers=1, num_heads=2, head_dim=8)


WEIGHTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "gate_weights.npz")


def gate_weights(max_positions: int = 64) -> Dict[str, np.ndarray]:
    """The gates' weights at ``max_positions`` (at most 128; the position
    table's first rows)."""
    with np.load(WEIGHTS) as f:
        params = {k: f[k] for k in f.files}
    params["pos"] = params["pos"][:max_positions]
    return params


def gate_model(device: DeviceLike = None, max_positions: int = 64):
    """The gates' ``DecoderLM`` on ``device`` (default ``cuda``)."""
    from paddle_tpu_torch.convert import decoder_lm_from_numpy
    from paddle_tpu_torch.serving.engine import DecoderLM

    model = DecoderLM(**GATE_MODEL, max_positions=max_positions,
                      device=device)
    return decoder_lm_from_numpy(gate_weights(max_positions), model)


def run_gate(argv: Optional[Sequence[str]], name: str, usage: str,
             selfcheck: Callable[[Optional[str]], int]) -> int:
    """The gates' command line: ``check [--device D]`` runs
    ``selfcheck(device)``; a conservation finding
    (:class:`PageLeakError`) exits 1, a crash 2."""
    import sys

    from paddle_tpu_torch.obs.cli import _parse
    from paddle_tpu_torch.serving.faults import PageLeakError

    args, device = _parse(sys.argv[1:] if argv is None else argv,
                          "--device")
    cmd, rest = (args[0], args[1:]) if args else ("check", [])
    if cmd != "check" or rest:
        print(f"unknown command {' '.join([cmd] + rest)!r}; usage: "
              f"{usage}")
        return 2
    try:
        return selfcheck(device)
    except PageLeakError as e:
        print(str(e))
        return 1
    except Exception as e:   # crash != findings: distinct exit code
        print(f"{name} check crashed: {e!r}")
        return 2

"""Device choice for every entry point of the port.

The port runs on the card: ``device=None`` means ``cuda``.  Without a
CUDA device the call raises instead of dropping to the CPU, so a run that
was meant for the card can never quietly measure or serve on the host.
Tests and CPU users pass ``device="cpu"`` explicitly."""

from __future__ import annotations

from typing import Optional, Union

import torch

from paddle_tpu_torch.platform.enforce import enforce_that

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    enforce_that(dev.type in ("cuda", "cpu"),
                 f"unsupported device {dev}: the port runs on 'cuda' or, "
                 "when asked, 'cpu'", context="device")
    if dev.type == "cuda":
        enforce_that(torch.cuda.is_available(),
                     "CUDA is not available: the port runs on the card by "
                     "default — pass device='cpu' to run on the host",
                     context="device")
    return dev

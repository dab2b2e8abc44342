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


# ---------------------------------------------------------------------------
# init: the single-device half of paddle_tpu/platform/device.py:34-140
# ---------------------------------------------------------------------------

_state = {"initialized": False, "devices": None}
_CLUSTER_KEYS = ("coordinator_address", "num_processes", "process_id")
_MESH_FLAGS = ("mesh_shape", "mesh_axes")
_JAX_FLAGS = ("platform", "check_nan")


def init(device: DeviceLike = None, **kwargs) -> None:
    """``paddle.init(**flags)``: set flags (``platform.flags``) and find
    the devices: every card on ``cuda`` (the default; raises without
    CUDA), the host alone on ``device="cpu"``.  A device mesh and a
    multi-host job (``mesh_shape``, ``mesh_axes``,
    ``coordinator_address``, ``num_processes``, ``process_id``) come with
    the parallel slice and raise; ``platform`` and ``check_nan`` configure
    JAX and raise when set.  Safe to call more than once."""
    from paddle_tpu_torch.platform.flags import FLAGS

    for k in _CLUSTER_KEYS + _MESH_FLAGS:
        enforce_that(k not in kwargs,
                     f"init({k}=...) needs a device mesh or a multi-host "
                     "job: they come with the parallel slice (A12)",
                     context="init")
    for k in _JAX_FLAGS:
        enforce_that(not kwargs.get(k),
                     f"init({k}=...) configures JAX, which the port does "
                     "not use: the flag has no meaning here",
                     context="init")
    dev = resolve_device(device)
    FLAGS.update(**kwargs)
    if dev.type == "cuda":
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [torch.device("cpu")]
    _state["devices"] = devs
    _state["initialized"] = True


def is_initialized() -> bool:
    return _state["initialized"]


def _ensure_init() -> None:
    if not _state["initialized"]:
        init()


def device_count() -> int:
    _ensure_init()
    return len(_state["devices"])


def devices() -> list:
    _ensure_init()
    return list(_state["devices"])


def platform_name() -> str:
    """``gpu`` on the cards (JAX's name for CUDA devices), else ``cpu``."""
    _ensure_init()
    return "gpu" if _state["devices"][0].type == "cuda" else "cpu"

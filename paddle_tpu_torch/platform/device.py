"""Device choice for every entry point of the port.

The port runs on the card: ``device=None`` means ``cuda``.  Without a
CUDA device the call raises instead of dropping to the CPU, so a run that
was meant for the card can never quietly measure or serve on the host.
Tests and CPU users pass ``device="cpu"`` explicitly."""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
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
# init: paddle_tpu/platform/device.py:34-140
# ---------------------------------------------------------------------------

_state = {"initialized": False, "devices": None, "mesh": None,
          "distributed": None}
_JAX_FLAGS = ("platform", "check_nan")


def _parse_mesh_flags(mesh_shape, mesh_axes):
    shape = None
    if mesh_shape:
        shape = tuple(int(x) for x in str(mesh_shape).split(",") if x)
    axes = tuple(a.strip() for a in str(mesh_axes).split(",") if a.strip())
    return shape, axes


def init(device: DeviceLike = None, **kwargs) -> None:
    """``paddle.init(**flags)``: set flags (``platform.flags``), find the
    devices and build the default mesh (``mesh_shape``/``mesh_axes``;
    default: one ``data`` axis over every rank).

    A mesh's devices are the job's ranks, one device a rank.  A job of
    several processes joins through ``coordinator_address="host:port"``
    with ``num_processes`` and ``process_id``: ``init_process_group``
    over a TCP store there (NCCL on the cards, gloo on the CPU; rank r
    takes card ``r % cuda.device_count()``), the etcd-registration
    analog.  ``platform`` and ``check_nan`` configure JAX and raise when
    set.  Safe to call more than once: a later call rebuilds the mesh."""
    import torch.distributed as dist

    from paddle_tpu_torch.platform.flags import FLAGS

    coord = kwargs.pop("coordinator_address", None)
    nproc = kwargs.pop("num_processes", None)
    pid = kwargs.pop("process_id", None)
    enforce_that(coord is not None or (nproc is None and pid is None),
                 "num_processes/process_id need coordinator_address= — "
                 "refusing to silently run single-host", context="init")
    for k in _JAX_FLAGS:
        enforce_that(not kwargs.get(k),
                     f"init({k}=...) configures JAX, which the port does "
                     "not use: the flag has no meaning here",
                     context="init")
    dev = resolve_device(device)
    if coord is not None:
        prev = _state["distributed"]
        enforce_that(prev is None or prev == coord,
                     f"torch.distributed already joined {prev}; cannot "
                     f"join {coord}", context="init")
        if prev is None and not dist.is_initialized():
            enforce_that(nproc is not None and pid is not None,
                         "coordinator_address needs num_processes= and "
                         "process_id= (torch.distributed has no "
                         "discovery)", context="init")
            if dev.type == "cuda":
                torch.cuda.set_device(int(pid) % torch.cuda.device_count())
            dist.init_process_group(
                "nccl" if dev.type == "cuda" else "gloo",
                init_method=f"tcp://{coord}", world_size=int(nproc),
                rank=int(pid))
        _state["distributed"] = coord
    from paddle_tpu_torch.parallel.mesh import Mesh, world_size

    # the mesh is checked before any flag is set: a refused init leaves
    # the flags as they were
    ranks = world_size()
    shape, axes = _parse_mesh_flags(
        kwargs.get("mesh_shape", FLAGS.mesh_shape),
        kwargs.get("mesh_axes", FLAGS.mesh_axes))
    if shape is None:
        shape = (ranks,)
    enforce_that(len(axes) >= len(shape),
                 f"mesh_axes {axes} shorter than mesh_shape {shape}",
                 context="init")
    n_needed = int(np.prod(shape))
    enforce_that(n_needed <= ranks,
                 f"mesh_shape {shape} needs {n_needed} devices, found "
                 f"{ranks} (a mesh's devices are the job's ranks: join "
                 "more with coordinator_address=)", context="init")
    FLAGS.update(**kwargs)
    if dev.type == "cuda":
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [torch.device("cpu")]
    _state["devices"] = devs
    _state["mesh"] = Mesh(shape, axes[:len(shape)])
    _state["initialized"] = True


def is_initialized() -> bool:
    return _state["initialized"]


def _ensure_init() -> None:
    if not _state["initialized"]:
        init()


def default_mesh():
    """The process-wide mesh ``init`` built."""
    _ensure_init()
    return _state["mesh"]


def set_default_mesh(mesh) -> None:
    _state["mesh"] = mesh
    _state["initialized"] = True


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

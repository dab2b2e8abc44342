"""Parameters: the trainable tensors with tar save/load (the port of
``paddle_tpu/parameters.py``).

Values are plain tensors keyed by ``<layer>.<param>`` names, on one
device.  ``to_tar``/``from_tar`` write and read the JAX package's format
byte for byte — one ``.npy`` member per parameter plus ``manifest.json`` —
so weights cross between the two packages in either direction.
Optimizer slots live in the trainer's state, not here.
"""

from __future__ import annotations

import io
import json
import tarfile
from typing import Dict, Iterator

import numpy as np
import torch

from paddle_tpu_torch.initializer import default_bias_init, to_initializer
from paddle_tpu_torch.platform.device import DeviceLike, resolve_device
from paddle_tpu_torch.platform.enforce import EnforceError, enforce_that
from paddle_tpu_torch.topology import ParamSpec, Topology


class Parameters:
    """name -> tensor with attached specs.  Behaves like a mapping."""

    def __init__(self):
        self._values: Dict[str, torch.Tensor] = {}
        self._specs: Dict[str, ParamSpec] = {}

    # ---- construction ----------------------------------------------------

    @staticmethod
    def from_topology(topology: Topology, *, seed: int = 0,
                      dtype=torch.float32,
                      device: DeviceLike = None) -> "Parameters":
        """Initialize every parameter of ``topology`` with its spec's
        initializer (the default weight and bias rules otherwise), drawn
        on the host from one generator seeded with ``seed`` in sorted-name
        order, then moved to ``device`` (``cuda`` unless asked)."""
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(int(seed))
        params = Parameters()
        for name, spec in sorted(topology.param_specs().items()):
            is_bias = name.endswith(".b") or name.endswith("bias")
            if spec.attr.initializer is not None:
                init = to_initializer(spec.attr.initializer)
            elif is_bias:
                init = default_bias_init()
            else:
                init = to_initializer(None)
            value = init(gen, tuple(spec.shape), spec.dtype or dtype)
            params._values[name] = value.to(dev)
            params._specs[name] = spec
        return params

    # ---- mapping surface -------------------------------------------------

    def __getitem__(self, name: str) -> torch.Tensor:
        if name not in self._values:
            raise EnforceError(f"no parameter named {name!r}",
                               context="parameters")
        return self._values[name]

    def __setitem__(self, name: str, value) -> None:
        if name in self._specs:
            enforce_that(tuple(value.shape) == tuple(self._specs[name].shape),
                         f"shape mismatch for {name!r}: {tuple(value.shape)} "
                         f"vs {self._specs[name].shape}",
                         context="parameters")
        self._values[name] = value

    def __contains__(self, name: str) -> bool:
        return name in self._values

    def __iter__(self) -> Iterator[str]:
        return iter(self._values)

    def __len__(self) -> int:
        return len(self._values)

    def keys(self):
        return self._values.keys()

    def names(self):
        return list(self._values.keys())

    def items(self):
        return self._values.items()

    def get(self, name: str) -> np.ndarray:
        """A parameter as a host numpy array."""
        return self[name].detach().cpu().numpy()

    def as_dict(self) -> Dict[str, torch.Tensor]:
        """The tensors themselves (shared, not copied)."""
        return dict(self._values)

    # ---- checkpoint (the JAX package's tar format) -----------------------

    def to_tar(self, f) -> None:
        """Write a tar with one .npy member per parameter + a manifest."""
        with tarfile.open(fileobj=f, mode="w") as tar:
            manifest = {}
            for name in self._values:
                value = self.get(name)
                buf = io.BytesIO()
                np.save(buf, value, allow_pickle=False)
                data = buf.getvalue()
                member = name.replace("/", "__") + ".npy"
                info = tarfile.TarInfo(name=member)
                info.size = len(data)
                tar.addfile(info, io.BytesIO(data))
                manifest[name] = {"member": member,
                                  "shape": list(value.shape),
                                  "dtype": str(value.dtype)}
            mdata = json.dumps(manifest).encode()
            info = tarfile.TarInfo(name="manifest.json")
            info.size = len(mdata)
            tar.addfile(info, io.BytesIO(mdata))

    @staticmethod
    def from_tar(f, device: DeviceLike = None) -> "Parameters":
        arrays = {}
        with tarfile.open(fileobj=f, mode="r") as tar:
            manifest = json.loads(tar.extractfile("manifest.json").read())
            for name, meta in manifest.items():
                arrays[name] = np.load(
                    io.BytesIO(tar.extractfile(meta["member"]).read()),
                    allow_pickle=False)
        from paddle_tpu_torch.convert import parameters_from_numpy

        return parameters_from_numpy(arrays, device)

    def __repr__(self):
        total = sum(v.numel() for v in self._values.values())
        return f"Parameters({len(self._values)} tensors, {total:,} elements)"

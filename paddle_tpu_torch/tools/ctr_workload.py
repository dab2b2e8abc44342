"""The DeepFM CTR configuration (BASELINE config #4) that ``chip_smoke.py``
and ``python -m paddle_tpu_torch.tools.profile_ctr`` drive, in one place.

DeepFM at Criteo's width (Guo et al., IJCAI 2017, section 3: 39 fields,
FM factor k = 10, a 400-400-400 ReLU tower, Adam): 13 numeric fields
bucketed to 64 ids each, then the 26 categorical fields at the per-field
id counts of DLRM's Criteo Kaggle preprocessing (summing to 33,762,577),
packed one after the other into the one shared vocabulary of
``deepfm.build``: V = 33,763,409.  Batch 4096 and the numeric packing are
this configuration's choices (the paper fixes neither).  Adam at 1e-3 under
the dtype policy of the other training slices: bf16 products, f32 tables
and updates.  The tables and their Adam moments take 33.76 M x 11 f32 x 3
= 4.46 GB, a dense gradient 1.49 GB more.

The click logs are not in the repository: batches are seeded synthetic
data of their shape, made on the device in bulk.  Each field's ids are
drawn from a power law (log-uniform ranks, P(rank <= r) = log(r + 1) /
log(n)) inside that field's own range of the shared table, as click logs
are skewed; labels come from a hidden logistic model over the ids, so the
cost can fall.  Weights are drawn with numpy from a seed by the package's
default rules (Xavier-uniform weights, zero biases, the FM projection's
``Constant(0.5)``).

Usage::

    sgd = build_trainer(torch.device("cuda"))
    data = CtrData(torch.device("cuda"), batches=7)
    cost = sgd.step(data.feeds(0))
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

NUMERIC_FIELDS, NUMERIC_IDS = 13, 64
# DLRM's Criteo Kaggle preprocessing, C1..C26
CATEGORICAL_IDS = (1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3,
                   93145, 5683, 8351593, 3194, 27, 14992, 5461306, 10,
                   5652, 2173, 4, 7046547, 18, 15, 286181, 105, 142572)
FIELD_IDS = (NUMERIC_IDS,) * NUMERIC_FIELDS + CATEGORICAL_IDS
FIELDS = len(FIELD_IDS)                       # 39
VOCAB = sum(FIELD_IDS)                        # 33,763,409
FACTOR = 10
DEEP = (400, 400, 400)
BATCH = 4096
LEARNING_RATE = 1e-3
SEED = 0              # weights; the data uses SEED + 1
# the hidden model: logit = SIGNAL * sum of the fields' id weights + BIAS
SIGNAL, BIAS = 0.5, -1.0


def field_ids(vocab: int = VOCAB, fields: int = FIELDS) -> tuple:
    """Ids per field: Criteo's at the full vocabulary, else ``vocab`` cut
    into ``fields`` near-equal ranges (a cut-down table for runs the CPU
    must keep up with)."""
    if vocab == VOCAB and fields == FIELDS:
        return FIELD_IDS
    base = vocab // fields
    return (base,) * (fields - 1) + (vocab - base * (fields - 1),)


def build(vocab: int = VOCAB, fields: int = FIELDS):
    """``deepfm.build`` at this configuration's widths: (fields, label,
    prob, cost)."""
    from paddle_tpu_torch import topology
    from paddle_tpu_torch.models import deepfm

    topology.reset_name_scope()
    return deepfm.build(num_fields=fields, vocab_size=vocab,
                        factor_dim=FACTOR, deep_layers=DEEP)


def numpy_params(specs, seed: int = SEED) -> Dict[str, np.ndarray]:
    """Weights for ``specs`` (name -> ParamSpec) drawn with numpy from
    ``seed`` in sorted-name order, by the package's default rules: a
    spec's own ``Constant``, zero biases, Xavier-uniform weights."""
    from paddle_tpu_torch.initializer import Constant

    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in sorted(specs.items()):
        shape = tuple(spec.shape)
        init = spec.attr.initializer
        if isinstance(init, Constant):
            out[name] = np.full(shape, init.value, np.float32)
        elif name.endswith(".b"):
            out[name] = np.zeros(shape, np.float32)
        else:
            fan_in, fan_out = shape[0], shape[-1]
            limit = math.sqrt(6.0 / (fan_in + fan_out))
            x = rng.random(shape, dtype=np.float32)
            out[name] = x * np.float32(2 * limit) - np.float32(limit)
    return out


def build_trainer(device, vocab: int = VOCAB, fields: int = FIELDS,
                  seed: int = SEED, lr: float = LEARNING_RATE):
    """``trainer.SGD`` over DeepFM's cost with Adam at ``lr``, weights
    from :func:`numpy_params` on ``device``."""
    from paddle_tpu_torch import optimizer, topology, trainer
    from paddle_tpu_torch.convert import parameters_from_numpy

    cost = build(vocab, fields)[3]
    params = parameters_from_numpy(
        numpy_params(topology.Topology([cost]).param_specs(), seed),
        device=device)
    return trainer.SGD(cost, params, optimizer.Adam(learning_rate=lr),
                       device=device)


class CtrData:
    """``batches`` seeded batches of (ids [B, F] int32 in the shared
    table, labels [B] int32) made on ``device``: per field, power-law
    ranks inside its range; labels drawn from the hidden logistic
    model."""

    def __init__(self, device, batches: int, batch: int = BATCH,
                 vocab: int = VOCAB, fields: int = FIELDS,
                 seed: int = SEED + 1):
        gen = torch.Generator(device=device).manual_seed(seed)
        sizes = field_ids(vocab, fields)
        self.offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        n = torch.tensor(sizes, dtype=torch.float64, device=device)
        u = torch.rand((batches, batch, fields), generator=gen,
                       dtype=torch.float64, device=device)
        rank = torch.floor(torch.exp(u * torch.log(n))) - 1
        rank = torch.minimum(rank.clamp_min(0), n - 1).long()
        self.ids = (rank + torch.as_tensor(self.offsets, device=device)
                    ).to(torch.int32)
        hidden = torch.randn(vocab, generator=gen, device=device)
        logit = SIGNAL * hidden[self.ids.long()].sum(-1) + BIAS
        p = torch.sigmoid(logit)
        self.labels = (torch.rand(p.shape, generator=gen, device=device)
                       < p).to(torch.int32)
        self.fields = fields

    def feeds(self, i: int) -> Dict[str, torch.Tensor]:
        """Batch ``i`` as the trainer's feeds (device tensors)."""
        out = {f"field_{f}": self.ids[i, :, f].contiguous()
               for f in range(self.fields)}
        out["label"] = self.labels[i]
        return out

    def samples(self, i: int) -> List[tuple]:
        """Batch ``i`` as reader samples: (id_0, ..., id_{F-1}, click)."""
        rows = torch.cat([self.ids[i], self.labels[i][:, None]], 1)
        return [tuple(r) for r in rows.cpu().tolist()]


FEEDING = None        # the data layers' declaration order: fields, label


def repeat_reader(samples: List[tuple], steps: int):
    """A reader that yields the batch ``samples`` ``steps`` times."""
    return lambda: iter([samples] * steps)

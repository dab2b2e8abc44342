"""The recurrent training workload that ``chip_smoke.py`` drives, and the
RNN kernel cases it checks, in one place so the script,
``tools/profile_rnn.py`` and ``tests/test_torch_kernels_cuda.py`` run the
same shapes.

The model is bench.py's IMDB config (``worker_lstm``, bench.py:267-334):
``models/text_lstm.build`` (dict 30000, embedding 128, 2 x ``simple_lstm``
at h 512, max pooling, fc(2), ``classification_cost``), batch 64 of random
sequences of 100 tokens with random 0/1 labels, ``Momentum(0.9, lr 0.01)``
(bench.py:89-94), at the flag defaults.  The feeder buckets the longest
sequence, 100, to ``max_len`` 128, so each recurrent layer scans 128 steps
(28 of them fully masked) over a [64, 128, 4H] view of the 8192-slot
buffer.  The GRU variant is the same classifier with
``networks.simple_gru`` in place of ``simple_lstm``, at h 512 (JAX's
single-block plan; the port's B6) and h 1280 (bench.py's
``lstm_h1280_bs64`` width; JAX tiles it, the port runs B7 + B8).

Usage::

    sgd = build_trainer(torch.device("cuda"))
    sgd.train(repeat_reader(samples(SEED + 1), steps), feeding=FEEDING)
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from paddle_tpu_torch import data_type, layer, networks, optimizer, pooling
from paddle_tpu_torch import topology, trainer
from paddle_tpu_torch.models import text_lstm
from paddle_tpu_torch.ops import rnn
from paddle_tpu_torch.parameters import Parameters

MODEL = dict(dict_size=30000, embed_size=128, hidden=512, num_classes=2,
             num_layers=2)
BATCH, SEQ = 64, 100
STEPS_T = 128            # the feeder's max_len bucket of 100
SEED = 0                 # weights; batches use SEED + 1 and up
FEEDING = {"words": 0, "label": 1}
MOMENTUM, LEARNING_RATE = 0.9, 0.01


def samples(seed: int, bs: int = BATCH, seq: int = SEQ,
            dict_size: int = MODEL["dict_size"]):
    """``bs`` (token list, label) samples: ``seq`` random tokens, a random
    0/1 label (bench.py:287-288)."""
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, dict_size, size=seq).tolist(),
             int(rng.randint(2))) for _ in range(bs)]


def repeat_reader(batch, steps: int):
    """A reader that yields the same batch ``steps`` times."""
    return lambda: iter([batch] * steps)


def build_classifier(cell: str = "lstm", **cfg):
    """The classifier's cost node: ``text_lstm.build`` for ``"lstm"``, the
    same graph with ``simple_gru`` layers for ``"gru"``."""
    cfg = dict(MODEL, **cfg)
    if cell == "lstm":
        return text_lstm.build(**cfg)[-1]
    words = layer.data(name="words",
                       type=data_type.integer_value_sequence(
                           cfg["dict_size"]))
    label = layer.data(name="label",
                       type=data_type.integer_value(cfg["num_classes"]))
    net = layer.embedding(input=words, size=cfg["embed_size"])
    for i in range(cfg["num_layers"]):
        net = networks.simple_gru(input=net, size=cfg["hidden"],
                                  name=f"gru{i}")
    pooled = layer.pooling(input=net, pooling_type=pooling.MaxPooling())
    logits = layer.fc(input=pooled, size=cfg["num_classes"])
    return layer.classification_cost(input=logits, label=label)


def build_trainer(device, cell: str = "lstm", seed: int = SEED, **cfg):
    """``trainer.SGD`` over :func:`build_classifier` with weights from
    ``seed`` on ``device``, ``Momentum(0.9, 0.01)``."""
    topology.reset_name_scope()
    cost = build_classifier(cell, **cfg)
    params = Parameters.from_topology(topology.Topology([cost]), seed=seed,
                                      device=device)
    return trainer.SGD(cost, params, optimizer.Momentum(
        momentum=MOMENTUM, learning_rate=LEARNING_RATE), device=device)


# ---------------------------------------------------------------------------
# kernels: launch counts and the plain path
# ---------------------------------------------------------------------------

KERNELS = {"lstm_step": rnn.lstm_step_kernel, "gru_step": rnn.gru_step_kernel,
           "gru_zr": rnn.gru_zr_kernel, "gru_cand": rnn.gru_cand_kernel}
# the plain version of each wrapper, by the wrapper's name in ops/rnn.py
_PLAIN = {"lstm_step_kernel": rnn.lstm_step_reference,
          "gru_step_kernel": rnn.gru_step_reference,
          "gru_zr_kernel": rnn.gru_zr_reference,
          "gru_cand_kernel": rnn.gru_cand_reference}


def launches() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


@contextlib.contextmanager
def plain_rnn_path():
    """Route the fused steps through the plain versions on the card: the
    path the kernel path is held against in a training run."""
    kernels = {name: getattr(rnn, name) for name in _PLAIN}
    for name, plain in _PLAIN.items():
        setattr(rnn, name, plain)
    try:
        yield
    finally:
        for name, kern in kernels.items():
            setattr(rnn, name, kern)


# ---------------------------------------------------------------------------
# kernel cases
# ---------------------------------------------------------------------------

# name: (kernel, B, H, xp dtype, save acts); the gru_tiled cases run B7
# and then B8 on B7's plain outputs
RNN_CASES = {
    "lstm_f32_h512_acts": ("lstm_step", 64, 512, "float32", True),
    "lstm_f32_h512": ("lstm_step", 64, 512, "float32", False),
    "lstm_bf16_h512_acts": ("lstm_step", 64, 512, "bfloat16", True),
    "lstm_f32_h1280_acts": ("lstm_step", 64, 1280, "float32", True),
    "lstm_f32_h1280": ("lstm_step", 64, 1280, "float32", False),
    "gru_block_f32_h512_acts": ("gru_step", 64, 512, "float32", True),
    "gru_block_f32_h512": ("gru_step", 64, 512, "float32", False),
    "gru_tiled_f32_h1280_acts": ("gru_tiled", 64, 1280, "float32", True),
    "gru_tiled_f32_h1280": ("gru_tiled", 64, 1280, "float32", False),
    # B6 at the NMT encoder's shapes (tools/nmt_workload.py): a training
    # step (B 50, acts saved) and a generated batch of 16 sources; 50 and
    # 16 rows take a partial 32-row block
    "nmt_gru_block_f32_b50_acts": ("gru_step", 50, 512, "float32", True),
    "nmt_gru_block_f32_b16": ("gru_step", 16, 512, "float32", False),
    # B5 at the CRF taggers' and quick_start's shapes (tools/srl_workload,
    # tools/quick_start_workload): SRL's eight LSTMs of 128 at batch 10,
    # quick_start's LSTMs of 128 at batch 128, both training (acts saved)
    "lstm_f32_h128_b10_acts": ("lstm_step", 10, 128, "float32", True),
    "lstm_f32_h128_b128_acts": ("lstm_step", 128, 128, "float32", True),
}
# the main path's case of each kernel (the training calls save acts)
MAIN_CASE = {"lstm_step": "lstm_f32_h512_acts",
             "gru_step": "gru_block_f32_h512_acts",
             "gru_zr": "gru_tiled_f32_h1280_acts",
             "gru_cand": "gru_tiled_f32_h1280_acts"}


def rnn_case(name: str, device) -> dict:
    """The named case's inputs on ``device``, drawn from a seed at the
    scales of the model: xp ~ N(0, 1), h = tanh(N(0, 1)), c ~ N(0, 1),
    W_h XavierUniform, bias ~ N(0, 0.1)."""
    kind, B, H, dtype, save = RNN_CASES[name]
    gates = 4 if kind == "lstm_step" else 3
    rng = np.random.default_rng([SEED, sorted(RNN_CASES).index(name)])
    dt = getattr(torch, dtype)

    def t(a, to=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            device, to)

    bound = math.sqrt(6.0 / (H + gates * H))
    case = dict(kind=kind, B=B, H=H, save_acts=save,
                xp=t(rng.standard_normal((B, gates * H)), dt),
                h=t(np.tanh(rng.standard_normal((B, H))), dt),
                w_h=t(rng.uniform(-bound, bound, (H, gates * H))),
                bias=t(0.1 * rng.standard_normal(gates * H)))
    if kind == "lstm_step":
        case["c"] = t(rng.standard_normal((B, H)))
    return case


# f32 outputs against the plain version: 1e-5 abs + 1e-5 rel (the kernels
# sum h W_h in another order, K = H terms).  bf16 outputs (h' under a bf16
# xp): one bf16 step of the element's own magnitude, 2**-7 |want|, plus
# 1e-5: the f32 value before the rounding can sit on the other side of a
# rounding boundary.
RNN_TOL_F32 = (1e-5, 1e-5)
RNN_TOL_BF16 = (1e-5, 2.0 ** -7)


def rnn_error(got: torch.Tensor, want: torch.Tensor) -> dict:
    err = (got.float() - want.float()).abs()
    atol, rtol = RNN_TOL_BF16 if got.dtype == torch.bfloat16 \
        else RNN_TOL_F32
    limit = atol + rtol * want.float().abs()
    return {"max_abs_err": float(err.max()),
            "worst_err_over_limit": float((err / limit).max()),
            "within_tolerance": bool((err <= limit).all()) and
            bool(torch.isfinite(got.float()).all())}


def case_io(case: dict, kernel: str):
    """(bytes, flops) of one call of ``kernel`` on ``case``: each input
    read once and each output written once, and 2 flops a multiply-add of
    its recurrent product."""
    B, H, save = case["B"], case["H"], case["save_acts"]
    es = case["xp"].element_size()
    if kernel == "lstm_step":
        # xp, h, c, W_h, b in; h', c' (and acts [B, 5H]) out
        nbytes = (B * 4 * H * es + B * H * es + B * H * 4 + H * 4 * H * 4
                  + 4 * H * 4 + B * H * es + B * H * 4
                  + (B * 5 * H * 4 if save else 0))
        return nbytes, 2 * B * H * 4 * H
    if kernel == "gru_step":
        # xp, h, W_h, b in; h' (and acts [B, 3H]) out
        nbytes = (B * 3 * H * es + B * H * es + H * 3 * H * 4 + 3 * H * 4
                  + B * H * es + (B * 3 * H * 4 if save else 0))
        return nbytes, 2 * B * H * 3 * H
    if kernel == "gru_zr":
        # xp_zr, h, W_zr, b_zr in; z, r, r h out
        nbytes = (B * 2 * H * es + B * H * es + H * 2 * H * 4 + 2 * H * 4
                  + 3 * B * H * 4)
        return nbytes, 2 * B * H * 2 * H
    # gru_cand: r h, xp_c, W_c, b_c, z, h in; h' (and c) out
    nbytes = (B * H * 4 + B * H * es + H * H * 4 + H * 4 + B * H * 4
              + B * H * es + B * H * es + (B * H * 4 if save else 0))
    return nbytes, 2 * B * H * H

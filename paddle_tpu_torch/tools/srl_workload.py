"""The CRF taggers that ``chip_smoke.py`` drives, in one place.

- SRL, the PaddlePaddle book's chapter 07 (label_semantic_roles,
  ``db_lstm``) at its widths: word and predicate embeddings of 32, a mark
  embedding of 5, eight LSTMs of 128 units (the book's ``hidden_dim`` of
  512 is the mix width, 4 x 128), the conll05 dictionaries' sizes (44068
  words, 59 labels, 3162 predicates), batch 10, ``Momentum(0, 1e-3)``
  (the book's optimizer without its L2 of 8e-4 and its ``ModelAverage``).
- The CoNLL-2000 chunker, ``models/sequence_tagging`` with 23 tags
  (CoNLL-2000's 11 chunk types in B- and I- form, and O), its other
  widths the model's defaults, batch 64, Adam at 1e-3.

The corpora are not in the repository: samples are seeded synthetic ones
of the datasets' shapes.  An SRL sample has conll05's nine slots (the
word ids, five context words and the predicate each repeated over the
sentence, the 0/1 mark of the predicate's +-2 window, the labels) over 5
to 29 tokens, as ``paddle_tpu/dataset/conll05.py``'s offline samples
are; a chunker sample has 5 to 40 tokens of a 2000-word vocabulary with
tags that follow the words.  Weights are drawn with numpy
(``ctr_workload.numpy_params``).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from paddle_tpu_torch import optimizer, topology, trainer
from paddle_tpu_torch.convert import parameters_from_numpy
from paddle_tpu_torch.models import sequence_tagging, srl
from paddle_tpu_torch.ops import crf as pcrf
from paddle_tpu_torch.tools.ctr_workload import numpy_params

BOOK = dict(word_dict_len=44068, label_dict_len=59, pred_dict_len=3162,
            word_dim=32, mark_dim=5, hidden_dim=128, depth=8)
SRL_BATCH = 10
SRL_MOMENTUM, SRL_LEARNING_RATE = 0.0, 1e-3
# the small configuration held against the CPU path on the card
PARITY = dict(word_dict_len=512, label_dict_len=59, pred_dict_len=64,
              word_dim=32, mark_dim=5, hidden_dim=32, depth=3)
CHUNK = dict(vocab_size=2000, num_tags=23)
CHUNK_BATCH, CHUNK_LEARNING_RATE = 64, 1e-3
SEED = 0              # weights; the data uses SEED + 1
FEEDING = None        # the data layers' declaration order


def repeat_reader(batch, steps: int):
    """A reader that yields the same batch ``steps`` times."""
    return lambda: iter([batch] * steps)


def sample(rs, lo: int = 5, hi: int = 30, *, word_dict_len: int,
           label_dict_len: int, pred_dict_len: int, **_widths):
    """One conll05-shaped sample of ``lo`` to ``hi - 1`` tokens."""
    length = int(rs.randint(lo, hi))
    words = [int(w) for w in rs.randint(0, word_dict_len, length)]
    v = int(rs.randint(length))
    mark = [1 if abs(i - v) <= 2 else 0 for i in range(length)]
    ctx = [[int(rs.randint(word_dict_len))] * length for _ in range(5)]
    pred = [int(rs.randint(pred_dict_len))] * length
    labels = [int(x) for x in rs.randint(0, label_dict_len, length)]
    return (words, *ctx, pred, mark, labels)


def srl_batch(dims=None, batch: int = SRL_BATCH, seed: int = SEED + 1):
    rs = np.random.RandomState(seed)
    return [sample(rs, **(dims or BOOK)) for _ in range(batch)]


def chunk_batch(batch: int = CHUNK_BATCH, seed: int = SEED + 1):
    rs = np.random.RandomState(seed)
    rows = []
    for n in rs.randint(5, 41, batch):
        toks = rs.randint(0, CHUNK["vocab_size"], n)
        rows.append((toks.tolist(),
                     ((toks * 7 + 3) % CHUNK["num_tags"]).tolist()))
    return rows


def _params(cost, device):
    specs = topology.Topology([cost]).param_specs()
    return parameters_from_numpy(numpy_params(specs, SEED), device=device)


def build_srl(device, dims=None, momentum: float = SRL_MOMENTUM,
              learning_rate: float = SRL_LEARNING_RATE):
    """(SGD over the SRL cost, the decoded node) at ``dims`` (the book's
    by default)."""
    topology.reset_name_scope()
    _, cost, decoded = srl.build(**(dims or BOOK))
    sgd = trainer.SGD(cost, _params(cost, device), optimizer.Momentum(
        momentum=momentum, learning_rate=learning_rate), device=device)
    return sgd, decoded


# the chunker's tags: B-t and I-t for each of 11 chunk types, and O
CHUNK_TYPES = (CHUNK["num_tags"] - 1) // 2


def build_chunker(device, chunk_f1: bool = False):
    """(SGD over the chunker's CRF cost, the decoded node); ``chunk_f1``
    adds ``evaluator.chunk`` over the decoded tags (IOB, 11 types) as
    the extra layer ``chunk_f1``."""
    from paddle_tpu_torch import evaluator

    topology.reset_name_scope()
    _, label, cost, decoded = sequence_tagging.build(**CHUNK)
    extra = [evaluator.chunk(input=decoded, label=label,
                             num_chunk_types=CHUNK_TYPES, chunk_scheme="IOB",
                             name="chunk_f1")] if chunk_f1 else None
    sgd = trainer.SGD(cost, _params(cost, device),
                      optimizer.Adam(learning_rate=CHUNK_LEARNING_RATE),
                      extra_layers=extra, device=device)
    return sgd, decoded


def decode(decoded, parameters, batch, data_names, device, model_state=None):
    """The Viterbi paths of ``batch`` (samples in ``data_names``' order,
    the labels dropped) through ``Inference`` on ``device``: int32 numpy
    [capacity]."""
    from paddle_tpu_torch.inference import Inference

    inf = Inference(decoded, parameters, model_state=model_state,
                    device=device)
    names = [n.name for n in inf.topology.data_nodes]
    rows = [tuple(s[data_names.index(n)] for n in names) for s in batch]
    return inf.infer(rows, batch_size=len(rows)).reshape(-1)


def frames(batch) -> int:
    """The frames one scan runs: the feeder's ``max_len`` bucket."""
    longest = max(len(s[0]) for s in batch)
    cap = 16
    while cap < longest:
        cap *= 2
    return cap


# ---------------------------------------------------------------------------
# where the step's time goes
# ---------------------------------------------------------------------------

CRF_RANGE = "crf_forward"
GROUPS = ("lstm_step", "crf_forward", "embedding_backward", "matmul",
          "optimizer", "other")


def group(ops) -> str:
    """A kernel's group, from its launching op and that op's callers."""
    from paddle_tpu_torch.tools.profiling import OPTIMIZER_RANGE

    low = [op.lower() for op in ops]
    if OPTIMIZER_RANGE in low:
        return "optimizer"
    if CRF_RANGE in low:
        return "crf_forward"
    if "aten::embedding_dense_backward" in low or \
            any("embedding_backward" in op for op in low):
        return "embedding_backward"
    if any(op in ("aten::mm", "aten::addmm", "aten::bmm", "aten::matmul")
           for op in low):
        return "matmul"
    return "other"


@contextlib.contextmanager
def ranged_crf():
    """Run the CRF's forward recursion in a profiler range (its backward
    runs on autograd's thread, outside it)."""
    plain = pcrf.crf_forward

    def ranged(*a, **k):
        with torch.profiler.record_function(CRF_RANGE):
            return plain(*a, **k)

    pcrf.crf_forward = ranged
    try:
        yield
    finally:
        pcrf.crf_forward = plain


def breakdown(prof, steps: int, wall_ms: float, lstm_kernel_name: str
              ) -> dict:
    """Busy ms, idle share and device ms and launches by :data:`GROUPS`
    of a profile of ``steps`` steps.  B5's kernels are found by their
    name; the others by the op that launched them (a kernel the profiler
    ties to no op counts as "other")."""
    from torch.autograd import DeviceType

    from paddle_tpu_torch.tools.profiling import OPTIMIZER_RANGE
    from paddle_tpu_torch.tools.profile_image import _kernels

    def chain(e):
        while e is not None:
            yield e.name
            e = e.cpu_parent

    skip = (OPTIMIZER_RANGE, CRF_RANGE)
    kernels = [k for k in _kernels(prof) if k[0] not in skip]
    busy = sum(us for _, us, _ in kernels) / 1e3 / steps
    ms = dict.fromkeys(GROUPS, 0.0)
    launches = dict.fromkeys(GROUPS, 0.0)
    for n, us, c in kernels:
        if lstm_kernel_name in n:
            ms["lstm_step"] += us / 1e3 / steps
            launches["lstm_step"] += c / steps
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        for k in e.kernels:
            if lstm_kernel_name in k.name:
                continue
            g = group(list(chain(e)))
            ms[g] += float(k.duration) / 1e3 / steps
            launches[g] += 1 / steps
    total = sum(c for _, _, c in kernels) / steps
    ms["other"] += busy - sum(ms.values())
    launches["other"] += total - sum(launches.values())
    top = sorted(kernels, key=lambda k: -k[1])[:10]
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / wall_ms,
            "device_ms_by_group": ms, "launches_by_group": launches,
            "kernel_launches": total,
            "top_kernels": [{"name": n[:90], "ms": us / 1e3 / steps,
                             "count": c / steps} for n, us, c in top]}

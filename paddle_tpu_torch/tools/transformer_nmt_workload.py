"""The Transformer-base translation workload that ``chip_smoke.py`` drives,
in one place so the script, ``tools/profile_transformer_nmt.py`` and
``tests/test_torch_transformer_cuda.py`` run the same configuration.

The model is ``transformer.build_seq2seq`` at the base model's widths of
Vaswani et al. 2017, "Attention Is All You Need", Table 3 (N 6 encoder
and 6 decoder blocks, d_model 512, d_ff 2048, h 8: head dim 64), over
the repository's WMT-14 dictionaries (30000 words a side,
``dataset/wmt14.py``).  The corpus is not in the repository, so a batch
is 80 of ``nmt_workload.samples``' seeded synthetic pairs (lengths
10-80 a side, ids in [3, 30000)): ``src`` the source, ``trg`` ``<s>`` +
target, ``label`` target + ``<e>``, with their positions.  About 3,600
tokens a side, so each side packs into the feeder's 4096 bucket, near
one GPU's share of the paper's 25,000-token batches over 8 GPUs.  The
optimizer is Adam at lr 5e-4 with the paper's betas (0.9, 0.98) and
epsilon 1e-9; the paper's warm-up schedule and label smoothing wait for
the port's LR schedules and losses.  The flags are at their defaults
(the bf16 policy).

Each step runs the three flash kernels 18 times each: 6 encoder
self-attentions (non-causal, segments), 6 causal decoder
self-attentions and 6 cross-attentions (the targets' packed queries
against the sources' packed keys), all [1, 4096, 8, 64] in bf16.

Usage::

    sgd = build_trainer(torch.device("cuda"))
    cost = sgd.step(feeds(sgd, samples(SEED + 1)))
"""

from __future__ import annotations

from paddle_tpu_torch import optimizer, topology, trainer
from paddle_tpu_torch.models import transformer
from paddle_tpu_torch.parameters import Parameters
from paddle_tpu_torch.tools import nmt_workload as nw
from paddle_tpu_torch.tools.nmt_workload import repeat_reader  # noqa: F401

MODEL = dict(src_vocab=30000, trg_vocab=30000, d_model=512, n_layers=6,
             n_heads=8, max_len=256, ffn_mult=4)
BATCH = 80
LEARNING_RATE, BETA1, BETA2, EPSILON = 5e-4, 0.9, 0.98, 1e-9
SEED = 0                 # weights; batches use SEED + 1 and up
FEEDING = {"src": 0, "src_pos": 1, "trg": 2, "trg_pos": 3, "label": 4}
# the card-against-CPU parity model: f32, small enough for the host
PARITY = dict(src_vocab=512, trg_vocab=512, d_model=64, n_layers=2,
              n_heads=4, max_len=256, ffn_mult=4)
PARITY_BATCH = 16


def samples(seed: int, bs: int = BATCH,
            dict_size: int = MODEL["trg_vocab"]):
    """``bs`` (src, src_pos, trg, trg_pos, label) samples:
    ``nmt_workload.samples``' pairs with their positions."""
    out = []
    for src, trg, label in nw.samples(seed, bs=bs, dict_size=dict_size):
        out.append((src, list(range(len(src))), trg, list(range(len(trg))),
                    label))
    return out


def batch_lengths(seed: int = SEED + 1, bs: int = BATCH):
    """(source lengths, target lengths) of ``samples(seed, bs)``: the
    segments the feeder packs each side into."""
    batch = samples(seed, bs)
    return (tuple(len(s[0]) for s in batch), tuple(len(s[2]) for s in batch))


def target_tokens(batch) -> int:
    return sum(len(s[4]) for s in batch)


def source_tokens(batch) -> int:
    return sum(len(s[0]) for s in batch)


def feeds(sgd, batch):
    """``batch`` through the trainer's ``DataFeeder``."""
    return sgd._make_feeder(FEEDING).feed(batch)


def adam():
    return optimizer.Adam(learning_rate=LEARNING_RATE, beta1=BETA1,
                          beta2=BETA2, epsilon=EPSILON)


def build_trainer(device, seed: int = SEED, config=None):
    """``trainer.SGD`` over ``build_seq2seq(**config)`` (default
    :data:`MODEL`) with weights from ``seed`` (drawn on the host, the same
    on every device), Adam as in the paper, on ``device``."""
    topology.reset_name_scope()
    *_, cost = transformer.build_seq2seq(**(config or MODEL))
    params = Parameters.from_topology(topology.Topology([cost]), seed=seed,
                                      device=device)
    return trainer.SGD(cost, params, adam(), device=device)


def flash_calls_per_step(config=None) -> int:
    """Calls of each flash kernel a training step: encoder self, decoder
    self and cross-attention, one each a block."""
    return 3 * (config or MODEL)["n_layers"]


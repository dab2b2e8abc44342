"""Hierarchical recurrent groups and the beam cost that ``chip_smoke.py``
drives on the card against the CPU path.

Three document classifiers over nested sequences (documents of 1 to 4
sentences of 2 to 8 tokens, each token a dense vector of 128), each the
configuration of a hierarchical test of ``tests/test_recurrent_group.py``
at width 128: ``pool_rnn`` (each sentence averaged, an fc recurrence over
the sentence vectors), ``nested_output`` (each token plus the previous
sentence's mean: a nested sequence out, then pooled) and
``sequence_memory`` (each sentence's mean plus the max of the previous
sentence, carried as a sequence memory).  Batch 16 through the feeder's
``dense_vector_sub_sequence`` slot, Adam at 1e-3.  A document's label is
the sign of its tokens' mean; the tokens are seeded draws.

The beam cost's cases are those of ``tests/test_beam_cost_tagging.py``:
gold in the beam or falling off it, beams of mixed sizes, linked paths.
"""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch import (data_type, layer, optimizer, pooling, topology,
                              trainer)
from paddle_tpu_torch.convert import parameters_from_numpy
from paddle_tpu_torch.tools.ctr_workload import numpy_params

WIDTH, BATCH, LEARNING_RATE = 128, 16, 1e-3
MAX_INNER, MAX_INNER_LEN = 4, 8
CONFIGS = ("pool_rnn", "nested_output", "sequence_memory")
SEED = 0              # weights; the data uses SEED + 1
FEEDING = None        # the data layers' declaration order


def repeat_reader(batch, steps: int):
    """A reader that yields the same batch ``steps`` times."""
    return lambda: iter([batch] * steps)


def _classifier(feature):
    label = layer.data(name="label", type=data_type.integer_value(2))
    logits = layer.fc(input=feature, size=2, name="doc_out")
    return layer.classification_cost(input=logits, label=label)


def build(config: str, width: int = WIDTH):
    """The cost node of one of :data:`CONFIGS`."""
    x = layer.data(name="x", type=data_type.dense_vector_sub_sequence(width))
    nested = layer.SubsequenceInput(x, max_inner=MAX_INNER,
                                    max_inner_len=MAX_INNER_LEN)
    if config == "pool_rnn":
        def step(sentence):
            pooled = layer.pooling(input=sentence,
                                   pooling_type=pooling.AvgPooling())
            m = layer.memory(name="doc_h", size=width)
            return layer.fc(input=[pooled, m], size=width, act="tanh",
                            name="doc_h")

        grp = layer.recurrent_group(step=step, input=nested, name="rg_doc")
        return _classifier(layer.last_seq(grp))
    if config == "nested_output":
        def step(sentence):
            m = layer.memory(name="sent_mean", size=width)
            shifted = layer.addto(
                input=[sentence, layer.expand(m, sentence)], name="tok_out")
            mean = layer.pooling(input=sentence,
                                 pooling_type=pooling.AvgPooling(),
                                 name="sent_mean")
            return [shifted, mean]

        outs = layer.recurrent_group(step=step, input=nested,
                                     name="rg_nested_out")
        toks = layer.fc(input=outs[0], size=width, act="tanh",
                        name="tok_fc")
        return _classifier(layer.pooling(input=toks,
                                         pooling_type=pooling.MaxPooling()))
    if config == "sequence_memory":
        def step(sentence):
            prev = layer.memory(name="raw_out", size=width, is_seq=True)
            prev_max = layer.pooling(input=prev,
                                     pooling_type=pooling.MaxPooling())
            cur = layer.pooling(input=sentence,
                                pooling_type=pooling.AvgPooling())
            out = layer.addto(input=[cur, prev_max], name="vec_out")
            return [out, layer.get_output(sentence, name="raw_out")]

        outs = layer.recurrent_group(step=step, input=nested,
                                     name="rg_seq_mem")
        return _classifier(layer.last_seq(outs[0]))
    raise KeyError(config)


def documents(seed: int = SEED + 1, bs: int = BATCH, width: int = WIDTH):
    """``bs`` (document, label) samples."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(bs):
        doc = [rs.randn(rs.randint(2, MAX_INNER_LEN + 1), width).astype(
            np.float32) for _ in range(rs.randint(1, MAX_INNER + 1))]
        label = int(np.concatenate(doc).mean() > 0)
        out.append(([d.tolist() for d in doc], label))
    return out


def build_trainer(config: str, device, width: int = WIDTH):
    topology.reset_name_scope()
    cost = build(config, width)
    specs = topology.Topology([cost]).param_specs()
    params = parameters_from_numpy(numpy_params(specs, SEED), device=device)
    return trainer.SGD(cost, params,
                       optimizer.Adam(learning_rate=LEARNING_RATE),
                       device=device)


# ---------------------------------------------------------------------------
# cross_entropy_over_beam
# ---------------------------------------------------------------------------

def _mk_beams(rng, batch=4, t=3, n=12, k=4):
    beams = []
    for _ in range(t):
        scores = rng.randn(batch, n).astype(np.float32)
        selected = np.stack([rng.choice(n, size=k, replace=False)
                             for _ in range(batch)]).astype(np.int32)
        gold = rng.randint(0, n, size=batch).astype(np.int32)
        beams.append((scores, selected, gold))
    return beams


def beam_cases():
    """{name: [per expansion (scores, selected, gold[, parents])]}."""
    regimes = _mk_beams(np.random.RandomState(0))
    for t, (_, selected, gold) in enumerate(regimes):
        gold[0] = selected[0][0]
        if t == 0:
            gold[1] = [j for j in range(12) if j not in selected[1]][0]
        gold[2] = (selected[2][1] if t < 1
                   else [j for j in range(12) if j not in selected[2]][0])
    rng = np.random.RandomState(1)
    mixed = [_mk_beams(rng, t=1, n=10, k=3)[0],
             _mk_beams(rng, t=1, n=16, k=5)[0]]
    rng = np.random.RandomState(5)
    B, N0, K0, N1, K1 = 3, 8, 3, 10, 3
    s0 = rng.randn(B, N0).astype(np.float32)
    sel0 = np.stack([rng.choice(N0, K0, replace=False)
                     for _ in range(B)]).astype(np.int32)
    g0 = np.array([sel0[b][b % K0] for b in range(B)], np.int32)
    s1 = rng.randn(B, N1).astype(np.float32)
    sel1 = np.stack([rng.choice(N1, K1, replace=False)
                     for _ in range(B)]).astype(np.int32)
    par1 = np.stack([rng.randint(0, K0, K1)
                     for _ in range(B)]).astype(np.int32)
    g1 = np.array([sel1[b][0] for b in range(B)], np.int32)
    slot0 = [int(np.where(sel0[b] == g0[b])[0][0]) for b in range(B)]
    par1[0, 0] = slot0[0]
    par1[1, 0] = (slot0[1] + 1) % K0
    g1[2] = [j for j in range(N1) if j not in sel1[2]][0]
    linked = [(s0, sel0, g0), (s1, sel1, g1, par1)]
    return {"regimes": regimes, "mixed_sizes": mixed, "linked": linked}


def beam_cost_and_grads(beams, device):
    """(costs [B], the gradients of their weighted sum to each
    expansion's scores) on ``device``."""
    from paddle_tpu_torch.ops.losses import cross_entropy_over_beam

    scores = [torch.tensor(b[0], device=device, requires_grad=True)
              for b in beams]
    rest = [tuple(torch.from_numpy(x).to(device) for x in b[1:])
            for b in beams]
    cost = cross_entropy_over_beam([(s,) + r for s, r in zip(scores, rest)])
    w = torch.arange(1.0, cost.shape[0] + 1, device=device)
    grads = torch.autograd.grad((cost * w).sum(), scores)
    return cost.detach().cpu().numpy(), [g.cpu().numpy() for g in grads]

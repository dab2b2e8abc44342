"""The port's encoder-decoder transformer (``transformer.build_seq2seq``)
against the JAX package, on the CPU, at JAX's copy-task configuration
(``tests/test_transformer.py`` ``test_seq2seq_transformer_learns_copy_task``:
vocabularies of 41, d 32, 4 heads, max_len 32), with 1 and 2 layers.  The
JAX ``Parameters.from_topology(seed=0)`` weights cross through the tar
format; the flash attention runs JAX's Pallas kernels in interpret mode
and the port's plain versions.  The translation batches pair sources of
4-8 tokens with targets of 10-15, so the decoder's queries (capacity
128) attend a memory of another capacity (64), segment i against
segment i, the padding of each buffer a segment of its own.

Tolerances:
- one forward in f32: logits and per-token costs within 1e-5 relative
  (1e-5 absolute near zero): the same products summed in another order.
- 3 Adam steps in f32: costs within 1e-5 relative, every parameter within
  1e-4 in norm (Adam moves a weight with a near-zero gradient by about
  the learning rate whatever the gradient's rounding; see
  ``tests/test_torch_train.py``).
- 3 Adam steps under the bf16 policy: costs within 2e-3 relative, every
  parameter within 5e-2 in norm, the bounds ``tests/test_torch_train.py``
  states for the LM (an f32 sum in another order can cross a bf16
  rounding step).  Measured: f32 costs 2.9e-7 apart, parameters 1.2e-5;
  bf16 costs 2.3e-4, parameters 9.4e-3 (``dec0_ln2.beta``).
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import jax
import numpy as np
import pytest
import torch

from paddle_tpu import layer as jlayer
from paddle_tpu import optimizer as jopt
from paddle_tpu import topology as jtopo
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu.parameters import Parameters as JParameters

from paddle_tpu_torch import data_feeder as tfeeder
from paddle_tpu_torch import event as tevent
from paddle_tpu_torch import layer as tlayer
from paddle_tpu_torch import minibatch as tminibatch
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import topology as ttopo
from paddle_tpu_torch import trainer as ttrainer
from paddle_tpu_torch.models import transformer as ttransformer
from paddle_tpu_torch.parameters import Parameters as TParameters

from torch_transformer_util import (S2S_FEEDING, assert_norm_close, costs_of,
                                    policy, train_both)

VOCAB = 41
CFG = dict(src_vocab=VOCAB, trg_vocab=VOCAB, d_model=32, n_heads=4,
           max_len=32)


def _pairs(seed, n=8, src_len=(4, 9), trg_len=(10, 16)):
    """(src, src_pos, <bos> + gold[:-1], trg_pos, gold) samples."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        s = rng.randint(2, VOCAB, size=int(rng.randint(*src_len)))
        g = rng.randint(2, VOCAB, size=int(rng.randint(*trg_len)))
        out.append((s.tolist(), list(range(len(s))),
                    [1] + g[:-1].tolist(), list(range(len(g))), g.tolist()))
    return out


def _copy_pairs(seed, n=8):
    """The copy task: the gold target is the source."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        m = int(rng.randint(5, 10))
        s = rng.randint(2, VOCAB, size=m)
        out.append((s.tolist(), list(range(m)), [1] + s[:-1].tolist(),
                    list(range(m)), s.tolist()))
    return out


def _build(pkg, n_layers, out="cost"):
    def build():
        *_, logits, cost = pkg.build_seq2seq(n_layers=n_layers, **CFG)
        return cost if out == "cost" else (logits, cost)
    return build


@pytest.mark.parametrize("n_layers", [1, 2])
def test_forward_matches_jax_f32(n_layers):
    batch = _pairs(1)
    with policy(False):
        jtopo.reset_name_scope()
        jlogits, jcost = _build(jtransformer, n_layers, "both")()
        jt = jtopo.Topology([jlogits, jcost])
        jparams = JParameters.from_topology(jtopo.Topology([jcost]), seed=0)
        from paddle_tpu import data_feeder as jfeeder
        jfeeds = jfeeder.DataFeeder(
            [(n.name, n.input_type) for n in jt.data_nodes],
            S2S_FEEDING).feed(batch)
        (jl, jc), _ = jax.jit(lambda p, f: jt.forward(p, {}, f))(
            jparams.as_dict(), jfeeds)
        ttopo.reset_name_scope()
        tlogits, tcost = _build(ttransformer, n_layers, "both")()
        tt = ttopo.Topology([tlogits, tcost])
        tparams = {k: torch.tensor(np.asarray(v))
                   for k, v in jparams.as_dict().items()}
        tfeeds = tfeeder.DataFeeder(
            [(n.name, n.input_type) for n in tt.data_nodes], S2S_FEEDING,
            device="cpu").feed(batch)
        tl, tc = tt.forward(tparams, tfeeds)
    assert tfeeds["trg"].capacity == 128 and tfeeds["src"].capacity == 64
    valid = tfeeds["trg"].valid_mask.numpy()
    np.testing.assert_allclose(tl.data.numpy()[valid],
                               np.asarray(jl.data)[valid], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tc.data.numpy(), np.asarray(jc.data),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("use_bf16,cost_rtol,param_rtol",
                         [(False, 1e-5, 1e-4), (True, 2e-3, 5e-2)])
def test_three_adam_steps_match_jax(use_bf16, cost_rtol, param_rtol):
    batches = [_pairs(2), _pairs(3), _pairs(4)]
    with policy(use_bf16):
        jcosts, tcosts, jp, tp = train_both(
            _build(jtransformer, 2), _build(ttransformer, 2), batches,
            lambda: jopt.Adam(learning_rate=5e-3),
            lambda: topt.Adam(learning_rate=5e-3), S2S_FEEDING, seed=0)
    assert len(tcosts) == 3 and np.isfinite(tcosts).all()
    np.testing.assert_allclose(tcosts, jcosts, rtol=cost_rtol)
    assert_norm_close(tp, jp, param_rtol)


def test_parameter_names_equal_jax():
    jtopo.reset_name_scope()
    jspecs = jtopo.Topology([_build(jtransformer, 2)()]).param_specs()
    ttopo.reset_name_scope()
    tspecs = ttopo.Topology([_build(ttransformer, 2)()]).param_specs()
    assert {k: tuple(s.shape) for k, s in tspecs.items()} == \
        {k: tuple(s.shape) for k, s in jspecs.items()}
    assert "dec1_cross.wq" in tspecs and "dec1_ln3.gamma" in tspecs


def test_the_port_learns_the_copy_task_through_the_memory():
    """JAX's copy-task test on the port alone: 60 Adam steps cut the loss
    below 0.2x the first, and a corrupted source changes the logits."""
    samples = _copy_pairs(0)
    ttopo.reset_name_scope()
    logits, cost = _build(ttransformer, 1, "both")()
    params = TParameters.from_topology(ttopo.Topology([cost]), seed=0,
                                       device="cpu")
    sgd = ttrainer.SGD(cost, params, topt.Adam(learning_rate=5e-3),
                       device="cpu")
    losses = costs_of(sgd, tevent, tminibatch, [samples] * 60, S2S_FEEDING)
    assert losses[-1] < losses[0] * 0.2, (losses[0], losses[-1])
    topo = ttopo.Topology([logits])
    needed = {k: params[k] for k in topo.param_specs()}
    good = samples[0]
    bad = ((np.array(good[0]) % (VOCAB - 2) + 2).tolist(),) + good[1:]

    def run(smp):
        feeds = sgd._make_feeder(S2S_FEEDING).feed([smp])
        with torch.no_grad():
            out = topo.forward(needed, feeds)[0]
        return out.data.numpy()[: len(smp[0])]

    assert np.abs(run(good) - run(bad)).max() > 1e-3


def test_causal_cross_attention_raises_in_both():
    errors = []
    for layer_mod, dt_mod, topo_mod in (
            (jlayer, __import__("paddle_tpu.data_type").data_type, jtopo),
            (tlayer, __import__("paddle_tpu_torch.data_type").data_type,
             ttopo)):
        topo_mod.reset_name_scope()
        q = layer_mod.data(name="q", type=dt_mod.dense_vector_sequence(8))
        m = layer_mod.data(name="m", type=dt_mod.dense_vector_sequence(8))
        with pytest.raises(Exception) as err:
            layer_mod.multi_head_attention(q, key=m, num_heads=2,
                                           causal=True)
        errors.append(str(err.value))
    assert "self-attention only" in errors[1]
    assert errors[0] == errors[1]

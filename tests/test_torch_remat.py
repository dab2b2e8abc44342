"""The port's ``topology.remat_scope`` (each group one
``torch.utils.checkpoint`` segment) and ``transformer.build(remat=True,
dropout=...)`` against the JAX package and against the port without
remat, on the CPU.

Tolerances:
- remat against no remat in the port, f32, dropout 0.15, 6 Adam steps:
  costs within 1e-6 relative, JAX's own bound for the same pair
  (``tests/test_transformer.py`` ``test_remat_training_parity``).  The
  recompute runs the same ops on the same inputs with the same dropout
  generators, so in the port the two are in fact the same bits.
- the port's remat build against JAX's, dropout 0 (masks cannot be
  shared across the packages), f32, 3 Adam steps: costs within 1e-5
  relative, every parameter within 1e-4 in norm (Adam, as
  ``tests/test_torch_train.py`` states).
- ``batch_norm`` in a group: the moving statistics after 3 steps equal
  the graph's without remat (written once a step, not again by the
  recompute), and JAX's within 1e-5.
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import contextlib

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import data_type as jdt
from paddle_tpu import layer as jlayer
from paddle_tpu import optimizer as jopt
from paddle_tpu import topology as jtopo
from paddle_tpu import trainer as jtrainer
from paddle_tpu.models import transformer as jtransformer

from paddle_tpu_torch import data_type as tdt
from paddle_tpu_torch import layer as tlayer
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import topology as ttopo
from paddle_tpu_torch import trainer as ttrainer
from paddle_tpu_torch.models import transformer as ttransformer
from paddle_tpu_torch.ops import attention as tattn
from paddle_tpu_torch.parameters import Parameters as TParameters

from torch_transformer_util import (LM_FEEDING, assert_norm_close, lm_batch,
                                    policy, train_both)

LM = dict(vocab_size=89, d_model=16, n_layers=2, n_heads=2, max_len=32)


def _port_costs(remat, dropout, steps=6):
    from paddle_tpu_torch import event, minibatch
    from torch_transformer_util import costs_of

    ttopo.reset_name_scope()
    *_, cost = ttransformer.build(**LM, dropout=dropout, remat=remat)
    params = TParameters.from_topology(ttopo.Topology([cost]), seed=7,
                                       device="cpu")
    sgd = ttrainer.SGD(cost, params, topt.Adam(learning_rate=3e-3),
                       device="cpu")
    batch = lm_batch(np.random.RandomState(2), LM["vocab_size"], (10, 6, 13))
    return costs_of(sgd, event, minibatch, [batch] * steps, LM_FEEDING)


def test_remat_follows_the_graph_without_remat_with_dropout():
    with policy(False):
        plain = _port_costs(False, 0.15)
        remat = _port_costs(True, 0.15)
        no_dropout = _port_costs(False, 0.0)
    np.testing.assert_allclose(remat, plain, rtol=1e-6)
    # the masks are live: dropout moves the costs
    assert np.abs(plain - no_dropout).max() > 1e-3


def test_remat_runs_each_block_forward_twice_a_step():
    """The backward reruns each block's forward: two forward attention
    calls a block a step, the backward's once."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = tattn.flash_fwd_reference, tattn.flash_bwd_dq_reference

    def count(which, fn):
        def wrapped(*a, **k):
            calls[which] += 1
            return fn(*a, **k)
        return wrapped

    mp = pytest.MonkeyPatch()
    mp.setattr(tattn, "flash_fwd_reference", count("fwd", fwd))
    mp.setattr(tattn, "flash_bwd_dq_reference", count("bwd", bwd))
    try:
        with policy(False):
            _port_costs(True, 0.0, steps=1)
    finally:
        mp.undo()
    assert calls == {"fwd": 2 * LM["n_layers"], "bwd": LM["n_layers"]}


def test_remat_build_matches_jax_remat_build():
    batches = [lm_batch(np.random.RandomState(2), LM["vocab_size"],
                        (10, 6, 13))] * 3

    def build(pkg):
        def f():
            *_, cost = pkg.build(**LM, remat=True)
            return cost
        return f

    with policy(False):
        jcosts, tcosts, jp, tp = train_both(
            build(jtransformer), build(ttransformer), batches,
            lambda: jopt.Adam(learning_rate=3e-3),
            lambda: topt.Adam(learning_rate=3e-3), LM_FEEDING, seed=7)
    np.testing.assert_allclose(tcosts, jcosts, rtol=1e-5)
    assert_norm_close(tp, jp, 1e-4)


def _bn_graph(layer_mod, dt_mod, topo_mod, remat):
    topo_mod.reset_name_scope()
    x = layer_mod.data(name="x", type=dt_mod.dense_vector(8))
    scope = (topo_mod.remat_scope("seg") if remat
             else contextlib.nullcontext())
    with scope:
        h = layer_mod.fc(input=x, size=8, act="relu", name="seg_fc")
        h = layer_mod.batch_norm(input=h, name="seg_bn")
    y = layer_mod.fc(input=h, size=4, name="head")
    lbl = layer_mod.data(name="lbl", type=dt_mod.integer_value(4))
    return layer_mod.classification_cost(input=y, label=lbl)


def test_batch_norm_state_in_a_group_is_written_once():
    rng = np.random.RandomState(0)
    xs = rng.randn(6, 8).astype(np.float32)
    ys = rng.randint(0, 4, size=6)
    batch = [(xs[i].tolist(), int(ys[i])) for i in range(6)]
    feeding = {"x": 0, "lbl": 1}

    def run_port(remat):
        from paddle_tpu_torch import event, minibatch
        from torch_transformer_util import costs_of

        cost = _bn_graph(tlayer, tdt, ttopo, remat)
        params = TParameters.from_topology(ttopo.Topology([cost]), seed=1,
                                           device="cpu")
        init = {k: params.get(k).copy() for k in params.keys()}
        sgd = ttrainer.SGD(cost, params, topt.Sgd(learning_rate=0.1),
                           device="cpu")
        costs = costs_of(sgd, event, minibatch, [batch] * 3, feeding)
        return costs, init, {k: {s: v.numpy() for s, v in d.items()}
                               for k, d in sgd.model_state.items()}

    with policy(False):
        plain, params, state_plain = run_port(False)
        remat, _, state_remat = run_port(True)
        # JAX's remat graph from the same weights
        cost = _bn_graph(jlayer, jdt, jtopo, True)
        jparams = jpaddle.Parameters.from_topology(jtopo.Topology([cost]),
                                                   seed=1)
        for k in jparams.keys():
            jparams[k] = params[k]  # the port's initial weights
        jsgd = jtrainer.SGD(cost=cost, parameters=jparams,
                            update_equation=jopt.Sgd(learning_rate=0.1))
        from paddle_tpu import event as jevent, minibatch as jminibatch
        from torch_transformer_util import costs_of
        jcosts = costs_of(jsgd, jevent, jminibatch, [batch] * 3, feeding)
    np.testing.assert_array_equal(remat, plain)
    assert state_remat.keys() == state_plain.keys() == {"seg_bn"}
    for s in ("moving_mean", "moving_var"):
        np.testing.assert_array_equal(state_remat["seg_bn"][s],
                                      state_plain["seg_bn"][s])
        np.testing.assert_allclose(state_remat["seg_bn"][s],
                                   np.asarray(jsgd.model_state["seg_bn"][s]),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(remat, jcosts, rtol=1e-5)


def _split_group(layer_mod, dt_mod, topo_mod):
    """Group "g" = {g_a, g_b} with a node outside it between them."""
    topo_mod.reset_name_scope()
    x = layer_mod.data(name="x", type=dt_mod.dense_vector(4))
    with topo_mod.remat_scope("g"):
        a = layer_mod.fc(input=x, size=4, name="g_a")
    c = layer_mod.fc(input=a, size=4, name="c")
    with topo_mod.remat_scope("g"):
        b = layer_mod.addto(input=[a, c], name="g_b")
    return x, a, b


def test_the_two_remat_errors_match_jax():
    xs = np.ones((2, 4), np.float32)
    # a group that is not a contiguous segment
    _, _, jb = _split_group(jlayer, jdt, jtopo)
    jt = jtopo.Topology([jb])
    jp = jpaddle.Parameters.from_topology(jt, seed=0).as_dict()
    with pytest.raises(Exception) as jerr:
        jt.forward(jp, {}, {"x": xs})
    _, _, tb = _split_group(tlayer, tdt, ttopo)
    tt = ttopo.Topology([tb])
    tp = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    with pytest.raises(Exception) as terr:
        tt.forward(tp, {"x": torch.tensor(xs)})
    assert "is not available yet" in str(terr.value)
    assert str(terr.value) == str(jerr.value)
    # a group none of whose outputs is used outside it
    jx, ja, _ = _split_group(jlayer, jdt, jtopo)
    jt = jtopo.Topology([ja])
    with pytest.raises(Exception) as jerr:
        jt._run_remat_group("g", [jx, ja], {"x": xs}, jp,
                            jtopo.Context(train=False, rng=None, state={}),
                            set())
    tx, ta, _ = _split_group(tlayer, tdt, ttopo)
    tt = ttopo.Topology([ta])
    with pytest.raises(Exception) as terr:
        tt._run_remat_group("g", [tx, ta], {"x": torch.tensor(xs)}, tp,
                            ttopo.Context(train=False, state={}), set())
    assert "no outputs used outside it" in str(terr.value)
    assert str(terr.value) == str(jerr.value)

"""The port's fused LM head (``ops/losses.lm_head_xent``,
``layer.lm_head_cost``, ``transformer.build(fused_head=True)``) against
the JAX package, on the CPU.

Tolerances:
- ``lm_head_xent`` in f32 (``use_bf16`` off in both): loss, dx, dw and
  db within 1e-5 relative (1e-6 absolute near zero): the same products,
  summed in another order.
- under the bf16 policy: the loss within 1e-5 relative (bf16-rounded
  inputs, exact products, f32 sums in both); the gradients at the flash
  kernels' bf16 bound, ``2**-7 |want| + 2e-3 max|want|``
  (``train_workload.FLASH_TOL_BF16``): the backward rounds each block's
  f32 ``dlg`` to bf16, and an f32 value that differs in its last bits can
  round to the other bf16 neighbour.
- ``build(fused_head=True)`` against ``build()`` in the port, f32, 3 Adam
  steps: costs within 1e-5 relative, every parameter within 1e-4 in norm
  (the blockwise sums differ from the one-block logsumexp in rounding).
- the fused build against JAX's fused build at JAX's
  ``test_fused_head_training_parity`` configuration (vocab 97, d 16, one
  block, ``Sgd(0.1)``, 5 steps, f32): costs within 1e-5 relative, every
  parameter within 1e-4 relative (1e-6 absolute).
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import jax
import numpy as np
import pytest
import torch

from paddle_tpu import optimizer as jopt
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu.ops import losses as jlosses

from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import topology as ttopo
from paddle_tpu_torch import trainer as ttrainer
from paddle_tpu_torch.models import transformer as ttransformer
from paddle_tpu_torch.ops import losses as tlosses
from paddle_tpu_torch.parameters import Parameters as TParameters
from paddle_tpu_torch.tools import train_workload as tw

from torch_transformer_util import (LM_FEEDING, assert_norm_close, costs_of,
                                    lm_batch, policy, train_both)

V, N, D = 1000, 40, 16
# labels on the edges of the 256-column blocks, the last (padded) block's
# last real column, and the rest drawn
EDGES = [0, 255, 256, 511, 512, 767, 768, 999]


def _inputs():
    rng = np.random.RandomState(3)
    x = rng.standard_normal((N, D)).astype(np.float32)
    w = (rng.standard_normal((D, V)) * 0.3).astype(np.float32)
    b = (rng.standard_normal(V) * 0.1).astype(np.float32)
    labels = np.concatenate([EDGES, rng.randint(0, V, N - len(EDGES))])
    g = rng.standard_normal(N).astype(np.float32)
    return x, w, b, labels.astype(np.int32), g


def _jax_xent(block_v):
    def loss(x, w, b, labels, g):
        return (jlosses.lm_head_xent(x, w, b, labels, block_v) * g).sum()

    @jax.jit
    def run(x, w, b, labels, g):
        out = jlosses.lm_head_xent(x, w, b, labels, block_v)
        return (out,) + jax.grad(loss, argnums=(0, 1, 2))(x, w, b, labels, g)

    return run


def _port_xent(block_v, x, w, b, labels, g):
    ts = [torch.tensor(a, requires_grad=True) for a in (x, w, b)]
    out = tlosses.lm_head_xent(ts[0], ts[1], ts[2], torch.tensor(labels),
                               block_v)
    (out * torch.tensor(g)).sum().backward()
    return [out.detach().numpy()] + [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("block_v", [256, 0, 2000])
def test_lm_head_xent_matches_jax_f32(block_v):
    """256: four blocks, the last padded by 24 columns; 0 and 2000 (above
    V): one block."""
    args = _inputs()
    with policy(False):
        want = [np.asarray(a) for a in _jax_xent(block_v)(*args)]
        got = _port_xent(block_v, *args)
    for name, gv, wv in zip(("loss", "dx", "dw", "db"), got, want):
        assert gv.shape == wv.shape, name
        np.testing.assert_allclose(gv, wv, rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def test_lm_head_xent_matches_jax_under_the_bf16_policy():
    args = _inputs()
    with policy(True):
        want = [np.asarray(a) for a in _jax_xent(256)(*args)]
        got = _port_xent(256, *args)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    for name, gv, wv in zip(("dx", "dw", "db"), got[1:], want[1:]):
        err = tw.flash_error(torch.tensor(gv).bfloat16(), torch.tensor(wv))
        assert err["within_tolerance"], (name, err)


def test_lm_head_xent_equals_the_unfused_softmax_cross_entropy():
    x, w, b, labels, _ = _inputs()
    with policy(False):
        got = tlosses.lm_head_xent(torch.tensor(x), torch.tensor(w),
                                   torch.tensor(b), torch.tensor(labels), 256)
        want = tlosses.softmax_cross_entropy(
            torch.tensor(x) @ torch.tensor(w) + torch.tensor(b),
            torch.tensor(labels))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5)


def _lm_build(pkg, **kw):
    def build():
        *_, cost = pkg.build(vocab_size=97, d_model=16, n_layers=1,
                             n_heads=2, max_len=32, **kw)
        return cost
    return build


def _port_run(fused, batches):
    ttopo.reset_name_scope()
    cost = _lm_build(ttransformer, fused_head=fused)()
    params = TParameters.from_topology(ttopo.Topology([cost]), seed=3,
                                       device="cpu")
    sgd = ttrainer.SGD(cost, params, topt.Adam(learning_rate=1e-2),
                       device="cpu")
    from paddle_tpu_torch import event, minibatch
    costs = costs_of(sgd, event, minibatch, batches, LM_FEEDING)
    return costs, {k: sgd.parameters.get(k) for k in sgd.parameters.keys()}


def test_fused_build_follows_the_unfused_build_in_the_port():
    batches = [lm_batch(np.random.RandomState(5), 97, (9, 6))] * 3
    with policy(False):
        plain, p_plain = _port_run(False, batches)
        fused, p_fused = _port_run(True, batches)
    np.testing.assert_allclose(fused, plain, rtol=1e-5)
    assert [k for k in p_fused if k.startswith("lm_head")] == \
        ["lm_head.b", "lm_head.w0"]
    assert_norm_close(p_fused, p_plain, 1e-4)


def test_fused_build_matches_jax_fused_build():
    batches = [lm_batch(np.random.RandomState(5), 97, (9, 6))] * 5
    with policy(False):
        jcosts, tcosts, jp, tp = train_both(
            _lm_build(jtransformer, fused_head=True),
            _lm_build(ttransformer, fused_head=True), batches,
            lambda: jopt.Sgd(learning_rate=0.1),
            lambda: topt.Sgd(learning_rate=0.1), LM_FEEDING, seed=3)
    np.testing.assert_allclose(tcosts, jcosts, rtol=1e-5)
    assert set(tp) == set(jp)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_lm_head_cost_without_a_bias():
    from paddle_tpu_torch import data_type, layer

    ttopo.reset_name_scope()
    x = layer.data(name="x", type=data_type.dense_vector(8))
    y = layer.data(name="y", type=data_type.integer_value(50))
    cost = layer.lm_head_cost(x, y, vocab_size=50, bias_attr=False,
                              block_size=16)
    topo = ttopo.Topology([cost])
    assert set(topo.param_specs()) == {f"{cost.name}.w"}
    params = {f"{cost.name}.w": torch.randn(8, 50)}
    xs, ys = torch.randn(4, 8), torch.tensor([0, 15, 16, 49])
    with policy(False):
        got = topo.forward(params, {"x": xs, "y": ys})[0]
    want = tlosses.softmax_cross_entropy(xs @ params[f"{cost.name}.w"], ys)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5)


def test_mixture_of_experts_blocks_still_raise_naming_their_queue():
    """Mixture-of-experts blocks came with the parallel slice: the cost is
    the cross-entropy plus one aux cost a block, and the parameters are
    JAX's names (each block's FFN replaced by ``blk{i}_moe``)."""
    from paddle_tpu.models import transformer as jtransformer
    from paddle_tpu import topology as jtopo

    ttopo.reset_name_scope()
    *_, costs = ttransformer.build(vocab_size=97, d_model=16, n_layers=2,
                                   n_heads=2, max_len=32, moe_experts=2)
    jtopo.reset_name_scope()
    *_, jcosts = jtransformer.build(vocab_size=97, d_model=16, n_layers=2,
                                    n_heads=2, max_len=32, moe_experts=2)
    assert isinstance(costs, list) and len(costs) == 3
    assert [c.name for c in costs] == [c.name for c in jcosts]
    tspecs = ttopo.Topology(costs).param_specs()
    jspecs = jtopo.Topology(jcosts).param_specs()
    assert {k: tuple(v.shape) for k, v in tspecs.items()} == \
        {k: tuple(v.shape) for k, v in jspecs.items()}
    assert "blk1_moe.w1" in tspecs and "blk1_ffn_up.w0" not in tspecs

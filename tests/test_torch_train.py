"""The port's training slice against the JAX package, on the CPU.

Both packages build ``transformer.build(vocab 97, d 64, 2 layers, 4
heads)``; the JAX ``Parameters.from_topology(seed=0)`` weights cross into
the port through the tar format; the same numpy batches go through both
``DataFeeder``s and both ``trainer.SGD.train`` loops (the JAX flash
attention runs its Pallas kernels in interpret mode).

Tolerances (costs per step; parameters after the five steps):
- f32 (``use_bf16=False`` in both): costs within 1e-4 relative.  With
  Momentum every parameter is within 1e-4 relative (1e-6 absolute near
  zero): the two frameworks only sum in other orders.  Adam divides each
  gradient entry by its own running RMS, so an entry near zero, whose f32
  sum differs in relative terms between the frameworks, still moves its
  weight by up to lr a step: there each parameter tensor is held to 1e-4
  relative in norm, ``|W_port - W_jax| <= 1e-4 |W_jax|``.
- bf16 policy (``use_bf16=True``, the default): costs within 2e-3
  relative, each parameter tensor within 2e-2 (Momentum) or 5e-2 (Adam)
  relative in norm.  Both packages round matmul and attention inputs to
  bf16 at the same places, but an f32 sum taken in another order can land
  on the other side of a bf16 rounding step, which moves a result by up
  to 2**-8 of itself; five steps carry that into the weights, and Adam's
  per-entry normalisation turns a flipped near-zero gradient into a full
  lr step the other way.
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import contextlib
import io

import jax
import numpy as np
import pytest
import torch

from paddle_tpu import activation as jact
from paddle_tpu import data_feeder as jfeeder
from paddle_tpu import data_type as jdt
from paddle_tpu import event as jevent
from paddle_tpu import minibatch as jminibatch
from paddle_tpu import optimizer as jopt
from paddle_tpu import topology as jtopo
from paddle_tpu import trainer as jtrainer
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu.ops import losses as jlosses
from paddle_tpu.ops import math as jmath
from paddle_tpu.ops import norm as jnorm
from paddle_tpu.parameters import Parameters as JParameters
from paddle_tpu.platform.flags import FLAGS as JFLAGS

from paddle_tpu_torch import activation as tact
from paddle_tpu_torch import data_feeder as tfeeder
from paddle_tpu_torch import data_type as tdt
from paddle_tpu_torch import event as tevent
from paddle_tpu_torch import initializer as tinit
from paddle_tpu_torch import minibatch as tminibatch
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import topology as ttopo
from paddle_tpu_torch import trainer as ttrainer
from paddle_tpu_torch.models import transformer as ttransformer
from paddle_tpu_torch.ops import losses as tlosses
from paddle_tpu_torch.ops import math as tmath
from paddle_tpu_torch.ops import norm as tnorm
from paddle_tpu_torch.parameters import Parameters as TParameters
from paddle_tpu_torch.platform.flags import FLAGS as TFLAGS

VOCAB, D, LAYERS, HEADS, MAX_LEN = 97, 64, 2, 4, 64
FEEDING = {"tokens": 0, "pos": 1, "target": 2}
# per step: sequence lengths of one batch.  Every batch packs to capacity
# 64 with its longest sequence in 17..32 (the feeder's max_len bucket
# 32), so the JAX step compiles once
BATCH_LENS = [(20, 7, 16), (17, 3, 9), (5, 30, 12), (24, 16, 16), (32, 1, 9)]


@contextlib.contextmanager
def bf16_policy(on: bool):
    old = (JFLAGS.use_bf16, TFLAGS.use_bf16)
    JFLAGS.use_bf16 = TFLAGS.use_bf16 = on
    try:
        yield
    finally:
        JFLAGS.use_bf16, TFLAGS.use_bf16 = old


def _batches(seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for lens in BATCH_LENS:
        batch = []
        for n in lens:
            toks = rng.randint(0, VOCAB, size=n)
            batch.append((toks.tolist(), list(range(n)),
                          np.roll(toks, -1).tolist()))
        out.append(batch)
    return out


def _build(topo_mod, transformer_mod):
    topo_mod.reset_name_scope()
    *_, cost = transformer_mod.build(vocab_size=VOCAB, d_model=D,
                                     n_layers=LAYERS, n_heads=HEADS,
                                     max_len=MAX_LEN)
    return cost


def _jax_params_tar() -> bytes:
    cost = _build(jtopo, jtransformer)
    buf = io.BytesIO()
    JParameters.from_topology(jtopo.Topology([cost]), seed=0).to_tar(buf)
    return buf.getvalue()


def _train(sgd, event_mod, minibatch_mod, batches):
    """Train one pass over ``batches``, regrouped from a flat sample
    reader by the package's ``minibatch.batch``; the per-step costs."""
    costs = []

    def handler(ev):
        if isinstance(ev, event_mod.EndIteration):
            costs.append(ev.cost)

    size = len(batches[0])
    assert all(len(b) == size for b in batches)
    samples = [s for b in batches for s in b]
    sgd.train(minibatch_mod.batch(lambda: iter(samples), size),
              num_passes=1, event_handler=handler, feeding=FEEDING)
    return np.asarray(costs)


OPTIMIZERS = {
    "momentum": (lambda: jopt.Momentum(momentum=0.9, learning_rate=0.01),
                 lambda: topt.Momentum(momentum=0.9, learning_rate=0.01)),
    "adam": (lambda: jopt.Adam(learning_rate=1e-2),
             lambda: topt.Adam(learning_rate=1e-2)),
}


def _train_both(opt_name, use_bf16):
    make_j, make_t = OPTIMIZERS[opt_name]
    batches = _batches()
    with bf16_policy(use_bf16):
        tar = _jax_params_tar()
        jcost = _build(jtopo, jtransformer)
        jparams = JParameters.from_tar(io.BytesIO(tar))
        jsgd = jtrainer.SGD(cost=jcost, parameters=jparams,
                            update_equation=make_j())
        jcosts = _train(jsgd, jevent, jminibatch, batches)
        tcost = _build(ttopo, ttransformer)
        tparams = TParameters.from_tar(io.BytesIO(tar), device="cpu")
        tsgd = ttrainer.SGD(tcost, tparams, make_t(), device="cpu")
        tcosts = _train(tsgd, tevent, tminibatch, batches)
    final_j = {k: np.asarray(v) for k, v in jsgd.parameters.as_dict().items()}
    final_t = {k: tsgd.parameters.get(k) for k in tsgd.parameters.keys()}
    return jcosts, tcosts, final_j, final_t


def _assert_norm_close(got, want, rtol):
    for k in want:
        err = np.linalg.norm(got[k] - want[k])
        assert err <= rtol * np.linalg.norm(want[k]), (k, err)


@pytest.mark.parametrize("opt_name", ["momentum", "adam"])
def test_training_matches_jax_f32(opt_name):
    jcosts, tcosts, final_j, final_t = _train_both(opt_name, False)
    assert len(jcosts) == len(tcosts) == len(BATCH_LENS)
    np.testing.assert_allclose(tcosts, jcosts, rtol=1e-4)
    assert set(final_t) == set(final_j)
    if opt_name == "adam":
        _assert_norm_close(final_t, final_j, 1e-4)
        return
    for k in final_j:
        np.testing.assert_allclose(final_t[k], final_j[k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("opt_name,rtol", [("momentum", 2e-2),
                                           ("adam", 5e-2)])
def test_training_matches_jax_bf16_policy(opt_name, rtol):
    jcosts, tcosts, final_j, final_t = _train_both(opt_name, True)
    np.testing.assert_allclose(tcosts, jcosts, rtol=2e-3)
    _assert_norm_close(final_t, final_j, rtol)


def test_costs_fall_on_a_repeated_batch():
    """The port alone learns: the same batch five times with Momentum."""
    cost = _build(ttopo, ttransformer)
    params = TParameters.from_topology(ttopo.Topology([cost]), seed=0,
                                       device="cpu")
    sgd = ttrainer.SGD(cost, params,
                       topt.Momentum(momentum=0.9, learning_rate=0.01),
                       device="cpu")
    costs = _train(sgd, tevent, tminibatch, [_batches()[0]] * 5)
    assert np.all(np.isfinite(costs)) and costs[-1] < costs[0]


def test_tar_is_byte_compatible_both_ways():
    tar = _jax_params_tar()
    tparams = TParameters.from_tar(io.BytesIO(tar), device="cpu")
    buf = io.BytesIO()
    tparams.to_tar(buf)
    assert buf.getvalue() == tar          # port writes the JAX bytes
    back = JParameters.from_tar(io.BytesIO(buf.getvalue()))
    assert set(back.keys()) == set(tparams.keys())
    for k in back.keys():
        assert np.array_equal(np.asarray(back[k]), tparams.get(k))


def test_from_topology_matches_jax_specs_and_distributions():
    """Same names and shapes as the JAX package; weights drawn from the
    same distributions (XavierUniform bounds, constant biases and norm
    parameters), from a torch generator."""
    jcost = _build(jtopo, jtransformer)
    jspecs = jtopo.Topology([jcost]).param_specs()
    tcost = _build(ttopo, ttransformer)
    params = TParameters.from_topology(ttopo.Topology([tcost]), seed=3,
                                       device="cpu")
    assert {k: tuple(s.shape) for k, s in jspecs.items()} == \
        {k: tuple(params[k].shape) for k in params.keys()}
    w = params.get("blk0_ffn_up.w0")
    limit = np.sqrt(6.0 / (D + 4 * D))
    assert np.abs(w).max() <= limit and np.abs(w).max() > 0.9 * limit
    assert np.all(params.get("blk0_ffn_up.b") == 0.0)
    assert np.all(params.get("final_ln.gamma") == 1.0)
    again = TParameters.from_topology(ttopo.Topology([tcost]), seed=3,
                                      device="cpu")
    assert np.array_equal(again.get("lm_head.w0"), params.get("lm_head.w0"))
    x = tinit.Normal(0.5, 0.02)(torch.Generator().manual_seed(0), (4096,))
    assert abs(float(x.mean()) - 0.5) < 2e-3
    assert abs(float(x.std()) - 0.02) < 2e-3


def _grad_pair(jfn, tfn, *arrays):
    """Forward values and input gradients of sum(f(x) * cot) in both
    packages (cot fixed random)."""
    jout = np.asarray(jfn(*arrays), np.float32)
    cot = np.random.RandomState(7).standard_normal(jout.shape).astype(
        np.float32)
    jg = jax.grad(lambda *a: (jfn(*a).astype(np.float32) * cot).sum(),
                  argnums=tuple(range(len(arrays))))(*arrays)
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    tout = tfn(*ts)
    (tout.float() * torch.from_numpy(cot)).sum().backward()
    return (jout, tout.detach().float().numpy(),
            [np.asarray(g) for g in jg], [t.grad.numpy() for t in ts])


def test_ops_match_jax():
    rng = np.random.RandomState(1)
    x = rng.standard_normal((6, 32)).astype(np.float32) * 3 + 1
    gamma = rng.standard_normal(32).astype(np.float32)
    beta = rng.standard_normal(32).astype(np.float32)
    cases = [
        (lambda a, g, b: jnorm.layer_norm(a, g, b),
         lambda a, g, b: tnorm.layer_norm(a, g, b), (x, gamma, beta)),
        (jact.GeluActivation.fn, tact.GeluActivation.fn, (x,)),
        (jact.SoftmaxActivation.fn, tact.SoftmaxActivation.fn, (x,)),
    ]
    for jfn, tfn, arrays in cases:
        jo, to, jg, tg = _grad_pair(jfn, tfn, *arrays)
        np.testing.assert_allclose(to, jo, rtol=1e-5, atol=1e-5)
        for a, b in zip(tg, jg):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    labels = rng.randint(0, 32, size=6).astype(np.int32)
    jo = np.asarray(jlosses.softmax_cross_entropy(x, labels))
    to = tlosses.softmax_cross_entropy(torch.from_numpy(x),
                                       torch.from_numpy(labels)).numpy()
    np.testing.assert_allclose(to, jo, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("use_bf16", [False, True])
def test_matmul_dtype_policy_matches_jax(use_bf16):
    rng = np.random.RandomState(2)
    a = rng.standard_normal((8, 48)).astype(np.float32)
    b = rng.standard_normal((48, 16)).astype(np.float32)
    with bf16_policy(use_bf16):
        jo, to, jg, tg = _grad_pair(jmath.matmul, tmath.matmul, a, b)
        assert tmath.compute_dtype(torch.from_numpy(a)) == (
            torch.bfloat16 if use_bf16 else torch.float32)
        assert tmath.matmul(torch.from_numpy(a),
                            torch.from_numpy(b)).dtype == torch.float32
    # bf16 inputs, f32 accumulator not rounded: both sides agree to f32
    # summation order; the bf16 gradient is rounded once, like JAX's
    np.testing.assert_allclose(to, jo, rtol=1e-5, atol=1e-5)
    grad_tol = 1e-2 if use_bf16 else 1e-5
    for x, y in zip(tg, jg):
        np.testing.assert_allclose(x, y, rtol=grad_tol, atol=grad_tol)


def test_feeder_matches_jax():
    batch = _batches()[2]
    jf = jfeeder.DataFeeder([(n, jdt.integer_value_sequence(VOCAB))
                             for n in FEEDING], FEEDING)
    tf = tfeeder.DataFeeder([(n, tdt.integer_value_sequence(VOCAB))
                             for n in FEEDING], FEEDING, device="cpu")
    jfeeds, tfeeds = jf.feed(batch), tf.feed(batch)
    for name in FEEDING:
        j, t = jfeeds[name], tfeeds[name]
        assert t.capacity == j.capacity == 64
        assert t.max_len == j.max_len and t.num_seqs == j.num_seqs == 3
        for field in ("data", "segment_ids", "lengths"):
            assert np.array_equal(getattr(t, field).numpy(),
                                  np.asarray(getattr(j, field))), field
        assert np.array_equal(t.valid_mask.numpy(), np.asarray(j.valid_mask))
    # padding slots carry segment id num_seqs
    total = sum(BATCH_LENS[2])
    seg = tfeeds["tokens"].segment_ids.numpy()
    assert np.all(seg[total:] == 3) and np.all(seg[:total] < 3)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this checks the no-CUDA refusal")
    cost = _build(ttopo, ttransformer)
    with pytest.raises(Exception, match="CUDA is not available"):
        TParameters.from_topology(ttopo.Topology([cost]), seed=0)
    with pytest.raises(Exception, match="CUDA is not available"):
        tfeeder.DataFeeder([("tokens", tdt.integer_value_sequence(9))])

"""The port's beam search against the JAX package's, on the CPU.

Both packages build the decoder of ``tests/test_beam_search.py`` (a
memory booted from a static start vector, the embedded previous token
added to it, a softmax over V tokens), the JAX weights cross as numpy,
and the same start vectors go through both.  Tokens and lengths must be
equal, scores within 1e-5 (relative and absolute: the same f32 sums in
another order), with each of the four hooks, with forced ties, and where
the port's loop stops early against JAX's full ``max_length`` scan.
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import data_type as jdt
from paddle_tpu import generation as jgen
from paddle_tpu import layer as jlayer
from paddle_tpu import topology as jtopo
from paddle_tpu.attr import ParamAttr as JAttr
from paddle_tpu.parameters import Parameters as JParameters
from paddle_tpu.platform.flags import FLAGS as JFLAGS

from paddle_tpu_torch import data_type as tdt
from paddle_tpu_torch import generation as tgen
from paddle_tpu_torch import layer as tlayer
from paddle_tpu_torch import topology as ttopo
from paddle_tpu_torch.attr import ParamAttr as TAttr
from paddle_tpu_torch.convert import parameters_from_numpy
from paddle_tpu_torch.platform.flags import FLAGS as TFLAGS

E, B, K = 5, 2, 3
BOS, EOS = 0, 1
JAX_PKG = (jlayer, jdt, JAttr, jgen, jtopo)
PORT_PKG = (tlayer, tdt, TAttr, tgen, ttopo)


@pytest.fixture(autouse=True)
def f32():
    old = (JFLAGS.use_bf16, TFLAGS.use_bf16)
    JFLAGS.use_bf16 = TFLAGS.use_bf16 = False
    yield
    JFLAGS.use_bf16, TFLAGS.use_bf16 = old


def _build(pkg, V, T, **hooks):
    layer, dt, Attr, gen, topo = pkg
    topo.reset_name_scope()
    start = layer.data(name="start", type=dt.dense_vector(E))

    def step(token_emb, static_start):
        h = layer.memory(name="h", size=E, boot_layer=start)
        merged = layer.addto(input=[token_emb, h], name="h")
        return layer.fc(input=merged, size=V, act="softmax", bias_attr=False,
                        param_attr=Attr(name="out_w"), name="probs")

    return gen.beam_search(
        step=step, input=[gen.GeneratedInput(size=V, embedding_name="tok_emb",
                                             embedding_size=E),
                          layer.StaticInput(start)],
        bos_id=BOS, eos_id=EOS, beam_size=K, max_length=T, name="gen",
        **hooks)


def generate_both(jhooks=None, thooks=None, V=7, T=4, seed=42,
                  start_seed=0):
    """(JAX (tokens, lengths, scores), port's, the port's beam node)."""
    jbeam = _build(JAX_PKG, V, T, **(jhooks or {}))
    jt = jtopo.Topology([jbeam])
    jparams = JParameters.from_topology(jt, seed=seed)
    start = np.random.RandomState(start_seed).randn(B, E).astype(np.float32)
    (jout,), _ = jt.forward(jparams.as_dict(), jt.init_state(),
                            {"start": jnp.asarray(start)})
    tbeam = _build(PORT_PKG, V, T, **(thooks or {}))
    tt = ttopo.Topology([tbeam])
    tparams = parameters_from_numpy(
        {k: np.asarray(v) for k, v in jparams.as_dict().items()},
        device="cpu")
    with torch.no_grad():
        (tout,) = tt.forward(tparams.as_dict(),
                             {"start": torch.from_numpy(start)})
    return ([np.asarray(a) for a in jout], [a.numpy() for a in tout],
            tbeam)


def assert_same(jout, tout):
    jt, jl, js = jout
    tt, tl, ts = tout
    assert tt.dtype == np.int32 and tl.dtype == np.int32
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed,start_seed", [(42, 0), (7, 1), (3, 2)])
def test_beam_search_matches_jax(seed, start_seed):
    jout, tout, _ = generate_both(seed=seed, start_seed=start_seed)
    assert_same(jout, tout)
    assert tout[0].shape == (B, K, 4)
    assert (np.diff(tout[2], axis=1) <= 1e-5).all()


def test_candidate_adjust_matches_jax():
    def jadj(logp, beam):
        bonus = jnp.where(beam.lengths < 4, 2.0, 0.0)
        return logp.at[:, :, 3].set(-1e9).at[:, :, EOS].add(-bonus)

    def tadj(logp, beam):
        logp = logp.clone()
        logp[:, :, 3] = -1e9
        logp[:, :, EOS] -= torch.where(beam.lengths < 4, 2.0, 0.0)
        return logp

    jout, tout, _ = generate_both({"candidate_adjust": jadj},
                                  {"candidate_adjust": tadj}, start_seed=3)
    assert_same(jout, tout)
    assert (tout[0] != 3).all()


def test_host_candidate_adjust_gets_numpy_and_matches_jax():
    seen = []

    def hosted(logp, tokens, t):
        seen.append((type(logp), logp.shape, tokens.dtype, int(t)))
        out = np.array(logp)
        out[:, :, 2] = -1e9
        return out

    jout, tout, _ = generate_both({"host_candidate_adjust": hosted},
                                  {"host_candidate_adjust": hosted},
                                  start_seed=5)
    assert_same(jout, tout)
    assert (tout[0] != 2).all()
    assert seen[-1][:3] == (np.ndarray, (B, K, 7), np.int32)


def test_path_filter_matches_jax():
    jout, tout, _ = generate_both(
        {"path_filter": lambda beam: beam.tokens != 4},
        {"path_filter": lambda beam: beam.tokens != 4}, start_seed=7)
    assert_same(jout, tout)
    toks, lens, scores = tout
    for b in range(B):
        for k in range(K):
            if scores[b, k] > -1e8:
                assert 4 not in toks[b, k, :lens[b, k]]


def test_forced_ties_choose_the_lower_flat_index_as_jax_top_k():
    """Dropping every beam at step 1 leaves each row's scores at -1e9, so
    at step 2 all K x V totals round to the same f32 value: the winners
    are the first K flat indices, parent 0 with tokens 0, 1, 2."""
    def jdrop(beam):
        return jnp.full(beam.finished.shape, beam.t != 1)

    def tdrop(beam):
        return torch.full_like(beam.finished, beam.t != 1)

    jout, tout, _ = generate_both({"path_filter": jdrop},
                                  {"path_filter": tdrop}, T=5, start_seed=9)
    assert_same(jout, tout)
    toks, lens, scores = tout
    assert (scores < -1e8).all()
    assert set(toks[:, :, 2].ravel()) <= {0, 1, 2}


def test_stop_condition_matches_jax_and_ends_the_loop():
    def stop(beam):
        return beam.t >= 1

    jout, tout, beam = generate_both({"stop_condition": stop},
                                     {"stop_condition": stop}, T=6,
                                     start_seed=11)
    assert_same(jout, tout)
    assert (tout[1] <= 2).all()
    assert beam.steps_taken == 2


@pytest.mark.parametrize("host", [False, True])
def test_early_stop_gives_the_full_scans_outputs(host):
    """With 4 tokens, from these two starts every beam finishes by step 21
    of 24: the port's loop stops there and its outputs equal JAX's 24-step
    scan."""
    hooks = {"host_candidate_adjust": lambda lp, tk, t: lp} if host else {}
    for start_seed in (0, 2):
        jout, tout, beam = generate_both(hooks, hooks, V=4, T=24,
                                         start_seed=start_seed)
        assert_same(jout, tout)
        assert beam.steps_taken < 24
        assert (tout[1] <= beam.steps_taken).all()

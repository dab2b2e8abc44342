"""The port's sequence parallelism against the JAX package's, on the CPU.

Ring attention and Ulysses over a 'seq' axis of 2 and of 4 ranks (the
port's side in 4 gloo ranks started once for the file; JAX's on its
virtual mesh), with packed segment ids (three segments a row, cut at
different places in the two rows) and with and without causal masking:
each rank's output chunk and its q/k/v gradients (of sum(out * dout))
against JAX's ``ring_attention``/``ulysses_attention`` on the same
global arrays, f32, 1e-5 (the online-softmax merges run in f32 in both;
Ulysses' local attention is the port's flash plain version against
JAX's Pallas kernel in interpret mode).
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paddle_tpu.parallel import make_mesh as jmake_mesh
from paddle_tpu.parallel.ring import ring_attention, ulysses_attention

from torch_parallel_util import cat, launch

B, S, H, D = 2, 32, 4, 8
TOL = 1e-5


def _data():
    rng = np.random.RandomState(3)
    q, k, v, dout = (rng.randn(B, S, H, D).astype(np.float32)
                     for _ in range(4))
    seg = np.zeros((B, S), np.int32)
    seg[0, 11:] = 1
    seg[0, 20:] = 2
    seg[1, 5:] = 1
    seg[1, 27:] = 2
    return q, k, v, seg, dout


@pytest.fixture(scope="module")
def launched():
    q, k, v, seg, dout = _data()
    return launch([("ring_cases", dict(q=q, k=k, v=v, seg=seg,
                                       dout=dout))])


@pytest.fixture(scope="module")
def jax_want():
    q, k, v, seg, dout = _data()
    want = {}
    for n in (2, 4):
        mesh = jmake_mesh((n,), ("seq",), jax.devices()[:n])
        for name, fn in (("ring", ring_attention),
                         ("ulysses", ulysses_attention)):
            for causal in (False, True):
                def loss(q_, k_, v_, fn=fn, mesh=mesh, causal=causal):
                    o = fn(q_, k_, v_, mesh, axis="seq",
                           segment_ids=jnp.asarray(seg), causal=causal)
                    return jnp.sum(o * dout), o

                # jitted: eager shard_map compiles op by op
                (_, o), g = jax.jit(jax.value_and_grad(
                    loss, argnums=(0, 1, 2), has_aux=True))(
                    jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
                key = f"{name}_n{n}_c{int(causal)}"
                want[key] = np.asarray(o)
                for gname, gv in zip(("dq", "dk", "dv"), g):
                    want[f"{key}_{gname}"] = np.asarray(gv)
    return want


@pytest.fixture(scope="module")
def ranks(launched, jax_want):
    return [r["ring_cases"] for r in launched.wait()]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [False, True])
def test_sequence_parallel_attention_matches_jax(ranks, jax_want, n, name,
                                                 causal):
    key = f"{name}_n{n}_c{int(causal)}"
    np.testing.assert_allclose(cat(ranks, key, n, axis=1), jax_want[key],
                               atol=TOL, rtol=TOL)
    for g in ("dq", "dk", "dv"):
        np.testing.assert_allclose(cat(ranks, f"{key}_{g}", n, axis=1),
                                   jax_want[f"{key}_{g}"], atol=TOL,
                                   rtol=TOL, err_msg=g)

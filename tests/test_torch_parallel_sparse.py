"""The row-sharded half of ``parallel/sparse.py`` against the JAX
package's, on ``tests/test_compare_sparse.py``'s cases (the port's side
in 4 gloo ranks started once for the file: a (2, 2) 'data' x 'model'
mesh and a 4-rank 'model' axis; JAX on the same meshes of its virtual
devices):

- ``shard_table`` + ``sharded_lookup`` with whole ids, and with ids split
  over 'data' (each rank passing its own slice, against JAX's
  ``batch_axis``): every rank's rows equal JAX's (and the dense
  ``table[ids]``);
- ``alltoall_lookup``: each rank's rows of its own queries;
- ``sharded_row_update``: each rank's shard equals its rows of JAX's
  updated table (duplicate ids summed);
- 10 steps of embedding regression through the sharded lookup and row
  update equal JAX's sharded run and its dense ``jax.grad`` run;
- ``SparseEmbeddingUpdater(mesh=)``: a marked table's shard takes the
  rows of its ids once each (duplicates not double-counted), an unmarked
  parameter the dense step, as JAX's meshed updater.
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paddle_tpu.parallel import make_mesh as jmake_mesh
from paddle_tpu.parallel import sparse as jsp

from torch_parallel_util import launch

TOL = 1e-6
TRAIN_TOL = 1e-5


def _cases():
    rng = np.random.RandomState(0)
    lookup = dict(table=rng.randn(32, 6).astype(np.float32),
                  ids=rng.randint(0, 32, (16,)).astype(np.int32))
    batch = dict(table=rng.randn(16, 4).astype(np.float32),
                 ids=rng.randint(0, 16, (8,)).astype(np.int32))
    a2a = dict(table=rng.randn(16, 4).astype(np.float32),
               ids=rng.randint(0, 16, (8,)).astype(np.int32))
    update = dict(table=rng.randn(32, 4).astype(np.float32),
                  ids=np.array([0, 5, 17, 31, 5], np.int32),
                  rows=rng.randn(5, 4).astype(np.float32))
    train = dict(table=rng.randn(16, 4).astype(np.float32), lr=0.05,
                 steps=[(rng.randint(0, 16, (8,)).astype(np.int32),
                         rng.randn(8, 4).astype(np.float32))
                        for _ in range(10)])
    g = np.zeros((12, 3), np.float32)
    g[[2, 5]] = 1.0
    updater = dict(p=rng.randn(12, 3).astype(np.float32), g=g,
                   ids=np.array([2, 5, 2], np.int32))
    return dict(lookup=lookup, batch=batch, a2a=a2a, update=update,
                train=train, updater=updater)


CASES = _cases()


@pytest.fixture(scope="module")
def launched():
    return launch([("sparse_cases", CASES)])


def _m22():
    return jmake_mesh((2, 2), ("data", "model"), jax.devices()[:4])


@pytest.fixture(scope="module")
def jax_runs(launched):
    c, m22 = CASES, _m22()
    m4 = jmake_mesh((4,), ("model",), jax.devices()[:4])
    out = {}
    a = c["lookup"]
    out["lookup"] = np.asarray(jsp.sharded_lookup(
        m22, jsp.shard_table(m22, jnp.asarray(a["table"])),
        jnp.asarray(a["ids"]), axis="model"))
    a = c["batch"]
    out["batch"] = np.asarray(jsp.sharded_lookup(
        m22, jsp.shard_table(m22, jnp.asarray(a["table"])),
        jnp.asarray(a["ids"]), axis="model", batch_axis="data"))
    a = c["a2a"]
    out["a2a"] = np.asarray(jsp.alltoall_lookup(
        m4, jsp.shard_table(m4, jnp.asarray(a["table"])),
        jnp.asarray(a["ids"]), axis="model"))
    a = c["update"]
    out["update"] = np.asarray(jsp.sharded_row_update(
        m22, jsp.shard_table(m22, jnp.asarray(a["table"])),
        jsp.SelectedRows(jnp.asarray(a["ids"]), jnp.asarray(a["rows"]),
                         32), 0.5, axis="model"))
    a = c["train"]

    @jax.jit           # one compile for the 10 steps (eager shard_maps
    def step(sharded, dense, ids, tgt):       # compile once a call)
        rows = jsp.sharded_lookup(m22, sharded, ids, axis="model")
        d_rows = jax.grad(lambda r: jnp.mean(jnp.square(r - tgt)))(rows)
        sharded = jsp.sharded_row_update(
            m22, sharded, jsp.SelectedRows(ids, d_rows, 16), a["lr"],
            axis="model")
        g = jax.grad(lambda t: jnp.mean(jnp.square(
            jnp.take(t, ids, axis=0) - tgt)))(dense)
        return sharded, dense - a["lr"] * g

    sharded = jsp.shard_table(m22, jnp.asarray(a["table"]))
    dense = jnp.asarray(a["table"])
    for ids, tgt in a["steps"]:
        sharded, dense = step(sharded, dense, jnp.asarray(ids),
                              jnp.asarray(tgt))
    out["train"], out["train_dense"] = np.asarray(sharded), np.asarray(dense)
    a = c["updater"]
    upd = jsp.SparseEmbeddingUpdater(mesh=m22, sparse_params=("emb",))
    p = jsp.shard_table(m22, jnp.asarray(a["p"]))
    out["updater"] = np.asarray(upd.apply(
        {"emb": p}, {"emb": jnp.asarray(a["g"])}, lr=0.1,
        ids={"emb": jnp.asarray(a["ids"])})["emb"])
    out["updater_dense"] = np.asarray(upd.apply(
        {"w": jnp.asarray(a["p"])}, {"w": jnp.asarray(a["g"])},
        lr=0.1)["w"])
    return out


@pytest.fixture(scope="module")
def ranks(launched, jax_runs):
    return [r["sparse_cases"] for r in launched.wait()]


def _rows(full, r, n=2):
    """Rank r's rows of a table split over a 'model' axis of n (the
    (2, 2) mesh's model coordinate is r % 2)."""
    per = full.shape[0] // n
    i = r % n
    return full[i * per:(i + 1) * per]


def test_sharded_lookup_matches_jax_and_dense(ranks, jax_runs):
    want = CASES["lookup"]["table"][CASES["lookup"]["ids"]]
    np.testing.assert_allclose(jax_runs["lookup"], want, atol=TOL)
    for res in ranks:
        np.testing.assert_allclose(res["lookup"], jax_runs["lookup"],
                                   atol=TOL)


def test_sharded_lookup_with_ids_split_over_data(ranks, jax_runs):
    for r, res in enumerate(ranks):
        d = r // 2
        np.testing.assert_allclose(res["batch"],
                                   jax_runs["batch"][4 * d:4 * d + 4],
                                   atol=TOL)


def test_alltoall_lookup_each_rank_its_queries(ranks, jax_runs):
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["a2a"],
                                   jax_runs["a2a"][2 * r:2 * r + 2],
                                   atol=TOL)


def test_sharded_row_update_each_rank_its_rows(ranks, jax_runs):
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["update"],
                                   _rows(jax_runs["update"], r), atol=1e-5)


def test_sharded_training_parity(ranks, jax_runs):
    np.testing.assert_allclose(jax_runs["train"], jax_runs["train_dense"],
                               atol=TRAIN_TOL, rtol=TRAIN_TOL)
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["train"], _rows(jax_runs["train"], r),
                                   atol=TRAIN_TOL, rtol=TRAIN_TOL)


def test_meshed_updater_matches_jax(ranks, jax_runs):
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["updater"],
                                   _rows(jax_runs["updater"], r), atol=TOL)
        np.testing.assert_allclose(res["updater_dense"],
                                   jax_runs["updater_dense"], atol=TOL)

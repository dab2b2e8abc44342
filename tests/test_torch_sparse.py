"""The port's sparse-row gradients and updates
(``paddle_tpu_torch/parallel/sparse.py``) against the JAX package's
``parallel/sparse.py``, on the CPU: the single-device cases of
``tests/test_compare_sparse.py`` (SelectedRows gradient and SGD row
update, row-sparse Adagrad, the sparse embedding updater), with duplicate
ids and the pad slots of the fixed-size combine, and the sharded half on
a mesh axis of one.

The port updates tables in place, so each port call takes a copy.
Tolerance: 1e-6 absolute (f32); untouched rows bit-identical.
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.parallel import sparse as jsp

from paddle_tpu_torch.parallel import sparse as tsp
from paddle_tpu_torch.platform.enforce import EnforceError

ATOL = 1e-6


def _t(x):
    return torch.from_numpy(np.array(x))


def test_selected_rows_grad_and_sgd_update_match_jax():
    rs = np.random.RandomState(0)
    table = rs.randn(10, 3).astype(np.float32)
    ids = np.array([1, 3, 1, 7, 1], np.int32)          # id 1 three times
    target = rs.randn(5, 3).astype(np.float32)

    jloss, jgrad = jsp.embedding_grad(
        jnp.asarray(table), jnp.asarray(ids),
        lambda r: jnp.sum(jnp.square(r - target)))
    tloss, tgrad = tsp.embedding_grad(
        _t(table), _t(ids), lambda r: torch.sum((r - _t(target)) ** 2))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(tgrad.rows.numpy(), np.asarray(jgrad.rows),
                               atol=ATOL)
    np.testing.assert_allclose(tgrad.to_dense().numpy(),
                               np.asarray(jgrad.to_dense()), atol=ATOL)

    want = np.asarray(jsp.sgd_update_rows(jnp.asarray(table), jgrad, 0.1))
    got = tsp.sgd_update_rows(_t(table), tgrad, 0.1).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    untouched = np.setdiff1d(np.arange(10), ids)
    np.testing.assert_array_equal(got[untouched], table[untouched])


@pytest.mark.parametrize("ids", [[2, 6], [2, 6, 2, 2, 0], [5, 5, 5]],
                         ids=["distinct", "duplicates_and_row_0",
                              "one_id_thrice"])
def test_adagrad_rows_match_jax(ids):
    """Duplicates are combined before the accumulator sees them; the
    fixed-size combine's pad slots (-1, clipped to row 0) change
    nothing."""
    rs = np.random.RandomState(1)
    vocab, dim = 8, 3
    table = rs.randn(vocab, dim).astype(np.float32)
    accum = np.abs(rs.randn(vocab, dim)).astype(np.float32)
    ids = np.array(ids, np.int32)
    rows = rs.randn(len(ids), dim).astype(np.float32)
    jt, ja = jsp.adagrad_update_rows(
        jnp.asarray(table), jnp.asarray(accum),
        jsp.SelectedRows(jnp.asarray(ids), jnp.asarray(rows), vocab), lr=0.1)
    tt, ta = tsp.adagrad_update_rows(
        _t(table), _t(accum),
        tsp.SelectedRows(_t(ids), _t(rows), vocab), lr=0.1)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=ATOL)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=ATOL)
    untouched = np.setdiff1d(np.arange(vocab), ids)
    np.testing.assert_array_equal(tt.numpy()[untouched], table[untouched])
    np.testing.assert_array_equal(ta.numpy()[untouched], accum[untouched])


def test_combine_pads_its_unused_slots():
    uniq, combined = tsp._combine(_t(np.array([4, 1, 4, 4], np.int64)),
                                  _t(np.arange(8, dtype=np.float32)
                                     .reshape(4, 2)))
    np.testing.assert_array_equal(uniq.numpy(), [1, 4, -1, -1])
    # id 4's rows summed in slot order: rows 0, 2, 3
    np.testing.assert_array_equal(combined.numpy(),
                                  [[2, 3], [0 + 4 + 6, 1 + 5 + 7], [0, 0],
                                   [0, 0]])


def test_sparse_embedding_updater_matches_jax():
    rs = np.random.RandomState(2)
    vocab, dim = 12, 3
    p = rs.randn(vocab, dim).astype(np.float32)
    g = rs.randn(vocab, dim).astype(np.float32)
    ids = np.array([2, 5, 2, 11], np.int32)            # 2 repeated
    upd_j = jsp.SparseEmbeddingUpdater(sparse_params=("emb",))
    upd_t = tsp.SparseEmbeddingUpdater(sparse_params=("emb",))
    want = np.asarray(upd_j.apply({"emb": jnp.asarray(p)},
                                  {"emb": jnp.asarray(g)}, lr=0.1,
                                  ids={"emb": jnp.asarray(ids)})["emb"])
    got = upd_t.apply({"emb": _t(p)}, {"emb": _t(g)}, lr=0.1,
                      ids={"emb": _t(ids)})["emb"].numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    untouched = np.setdiff1d(np.arange(vocab), ids)
    np.testing.assert_array_equal(got[untouched], p[untouched])
    # a marked param without ids, and an unmarked one: the dense step
    for params, kw in (({"emb": p}, {}), ({"w": p}, {"ids": {"w": ids}})):
        name = next(iter(params))
        want = np.asarray(upd_j.apply(
            {name: jnp.asarray(p)}, {name: jnp.asarray(g)}, lr=0.1,
            **{k: {n: jnp.asarray(v) for n, v in d.items()}
               for k, d in kw.items()})[name])
        got = upd_t.apply({name: _t(p)}, {name: _t(g)}, lr=0.1,
                          **{k: {n: _t(v) for n, v in d.items()}
                             for k, d in kw.items()})[name].numpy()
        np.testing.assert_allclose(got, want, atol=ATOL)


def test_sparse_training_matches_dense_training():
    """The test_CompareSparse analog on one device: 10 steps of an
    embedding regression with SelectedRows gradients and row updates
    equal 10 dense steps (the JAX package's dense run)."""
    rs = np.random.RandomState(3)
    vocab, dim, bs, lr = 16, 4, 8, 0.05
    table0 = rs.randn(vocab, dim).astype(np.float32)
    steps = [(rs.randint(0, vocab, (bs,)).astype(np.int32),
              rs.randn(bs, dim).astype(np.float32)) for _ in range(10)]
    dense = jnp.asarray(table0)
    table = _t(table0)
    for ids, tgt in steps:
        g = jax.grad(lambda t: jnp.mean(jnp.square(
            jnp.take(t, jnp.asarray(ids), axis=0) - tgt)))(dense)
        dense = dense - lr * g
        _, grad = tsp.embedding_grad(
            table, _t(ids), lambda r: torch.mean((r - _t(tgt)) ** 2))
        tsp.sgd_update_rows(table, grad, lr)
    np.testing.assert_allclose(table.numpy(), np.asarray(dense), atol=1e-5,
                               rtol=1e-5)


def test_a_mesh_raises_until_the_sharded_half_is_ported():
    """The sharded half is ported: on a 'model' axis of one (no process
    group) the meshed updater, ``sharded_lookup``, ``alltoall_lookup``
    and ``sharded_row_update`` equal JAX's on a one-device mesh (the
    multi-rank cases are ``tests/test_torch_parallel_sparse.py``); an
    axis the mesh lacks raises."""
    from paddle_tpu.parallel import make_mesh as jmake_mesh
    from paddle_tpu_torch.parallel import make_mesh

    rs = np.random.RandomState(5)
    p = rs.randn(12, 3).astype(np.float32)
    g = np.zeros((12, 3), np.float32)
    g[[2, 5]] = 1.0
    ids = np.array([2, 5, 2], np.int32)
    jm, tm = jmake_mesh((1,), ("model",), jax.devices()[:1]), \
        make_mesh((1,), ("model",))
    want = jsp.SparseEmbeddingUpdater(mesh=jm, sparse_params=("emb",)).apply(
        {"emb": jsp.shard_table(jm, jnp.asarray(p))},
        {"emb": jnp.asarray(g)}, lr=0.1, ids={"emb": jnp.asarray(ids)})
    got = tsp.SparseEmbeddingUpdater(mesh=tm, sparse_params=("emb",)).apply(
        {"emb": tsp.shard_table(tm, _t(p))}, {"emb": _t(g)}, lr=0.1,
        ids={"emb": _t(ids)})
    np.testing.assert_allclose(got["emb"].numpy(), np.asarray(want["emb"]),
                               atol=ATOL)
    table = jsp.shard_table(jm, jnp.asarray(p))
    np.testing.assert_allclose(
        tsp.sharded_lookup(tm, _t(p), _t(ids)).numpy(),
        np.asarray(jsp.sharded_lookup(jm, table, jnp.asarray(ids))),
        atol=ATOL)
    np.testing.assert_allclose(
        tsp.alltoall_lookup(tm, _t(p), _t(ids)).numpy(),
        np.asarray(jsp.alltoall_lookup(jm, table, jnp.asarray(ids))),
        atol=ATOL)
    rows = rs.randn(3, 3).astype(np.float32)
    np.testing.assert_allclose(
        tsp.sharded_row_update(tm, _t(p), tsp.SelectedRows(
            _t(ids), _t(rows), 12), 0.5).numpy(),
        np.asarray(jsp.sharded_row_update(jm, table, jsp.SelectedRows(
            jnp.asarray(ids), jnp.asarray(rows), 12), 0.5)), atol=ATOL)
    with pytest.raises(EnforceError, match="no axis 'model'"):
        tsp.SparseEmbeddingUpdater(mesh=make_mesh((1,), ("data",)),
                                   sparse_params=("emb",))

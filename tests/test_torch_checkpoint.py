"""The port's checkpoints (``paddle_tpu_torch/checkpoint.py`` and the
trainer's save/resume) against the JAX package's, on the CPU.

- the counterparts of ``tests/test_checkpoint_export.py``'s three
  checkpoint tests (round trip with optimizer state, ``start_pass``
  resume, corruption detected), and of ``tests/test_resilience.py``'s
  three loader tests (fallback over corrupt dirs, an explicit corrupt
  load, verified-aware pruning);
- the commit protocol under a kill at each ``COMMIT_PHASES`` phase;
- the optimizer-state conversions against the JAX package's trees (every
  rule, SparseMomentum's scalars, ModelAverage's average);
- across packages, both ways: a JAX ``SGD`` trains 3 steps and saves,
  the port loads that dir and trains 3 more, against the JAX package
  continuing (Momentum and Adam, the same numpy weights); a port
  checkpoint passes the JAX package's ``verify_pass_dir``, its
  ``load_checkpoint`` returns the same arrays, and the JAX package
  continuing from it matches the port continuing; batch norm's model
  state crosses both ways.

Tolerances: within one package a resumed run is bit-identical to a
straight one (``assert_array_equal``).  Across packages, f32 parameters
and slots within 1e-5 relative + 1e-6 absolute after 3 steps (the level
``tests/test_torch_optimizers.py`` holds the rules at; Adam's bias
correction is f64 in one package's schedule arithmetic and f32 in the
other's), and what crosses a file unchanged is equal.  Both packages run
the f32 policy (``use_bf16`` off).
"""

import os

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import checkpoint as jckpt
from paddle_tpu.platform.flags import FLAGS as JFLAGS

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import checkpoint as ckpt
from paddle_tpu_torch import convert
from paddle_tpu_torch.platform.enforce import EnforceError
from paddle_tpu_torch.platform.flags import FLAGS as TFLAGS

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def f32():
    old = (JFLAGS.use_bf16, TFLAGS.use_bf16)
    JFLAGS.use_bf16 = TFLAGS.use_bf16 = False
    try:
        yield
    finally:
        JFLAGS.use_bf16, TFLAGS.use_bf16 = old


def build_model(pkg, classes=3, norm=False):
    pkg.topology.reset_name_scope()
    layer = pkg.layer
    x = layer.data(name="x", type=pkg.data_type.dense_vector(8))
    y = layer.data(name="y", type=pkg.data_type.integer_value(classes))
    h = layer.fc(x, size=16, act="linear" if norm else "relu")
    if norm:
        h = layer.batch_norm(h, act="relu")
    logits = layer.fc(h, size=classes)
    return layer.classification_cost(input=logits, label=y)


def make_data(seed=0, n=96):
    rng = np.random.RandomState(seed)
    data = []
    for _ in range(n):
        yv = rng.randint(0, 3)
        xv = rng.randn(8).astype(np.float32) * 0.1
        xv[yv * 2] += 1.0
        data.append((xv, yv))
    return data


def reader(data, batch=32):
    return tpaddle.batch(lambda: iter(data), batch)


def port_sgd(opt=None, seed=0, weights=None, norm=False):
    cost = build_model(tpaddle, norm=norm)
    params = convert.parameters_from_numpy(weights, "cpu") \
        if weights is not None else tpaddle.Parameters.from_topology(
            tpaddle.topology.Topology([cost]), seed=seed, device="cpu")
    return tpaddle.trainer.SGD(
        cost=cost, parameters=params, device="cpu",
        update_equation=opt or tpaddle.optimizer.Momentum(
            momentum=0.9, learning_rate=0.05))


def jax_sgd(opt, seed=0, norm=False):
    cost = build_model(jpaddle, norm=norm)
    params = jpaddle.Parameters.from_topology(
        jpaddle.topology.Topology([cost]), seed=seed)
    return jpaddle.trainer.SGD(cost=cost, parameters=params,
                               update_equation=opt)


def params_np(sgd):
    return {k: np.asarray(sgd.parameters.get(k)) for k in
            sgd.parameters.names()}


def slots_np(state):
    return {f"{s}/{k}": np.asarray(v) for s, d in state["slots"].items()
            for k, v in d.items()}


# ---------------------------------------------------------------------------
# the port's checkpoints (test_checkpoint_export.py's three)
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip_with_optimizer_state(tmp_path):
    sgd = port_sgd()
    sgd.train(reader(make_data()), num_passes=2, save_dir=str(tmp_path))
    assert ckpt.latest_pass(str(tmp_path)) == 1
    p2, opt2, mst2, meta = ckpt.load_checkpoint(str(tmp_path), device="cpu")
    assert meta["pass_id"] == 1
    for k in sgd.parameters.names():
        np.testing.assert_array_equal(p2.get(k), sgd.parameters.get(k))
    # the slots (Momentum's velocity) round-trip as numpy, non-trivially
    assert int(opt2["step"]) == sgd.opt_state["step"] == 6
    assert opt2["step"].dtype == np.int32
    for name, v in slots_np(opt2).items():
        s, k = name.split("/", 1)
        assert isinstance(v, np.ndarray)
        np.testing.assert_array_equal(
            v, sgd.opt_state["slots"][s][k].numpy())
    assert any(np.abs(a).sum() > 0 for a in slots_np(opt2).values())


def test_resume_continues_identically(tmp_path):
    """4 passes straight vs 2 + checkpoint + a fresh trainer (other
    weights) resumed for 2 (``start_pass``): the same bits."""
    data = make_data(1)
    straight = port_sgd(seed=3)
    straight.train(reader(data), num_passes=4, save_dir=str(tmp_path / "a"))
    first = port_sgd(seed=3)
    first.train(reader(data), num_passes=2, save_dir=str(tmp_path / "b"))
    resumed = port_sgd(seed=99)
    resumed.train(reader(data), num_passes=4, save_dir=str(tmp_path / "b"),
                  start_pass=2)
    for k, v in params_np(straight).items():
        np.testing.assert_array_equal(params_np(resumed)[k], v, err_msg=k)
    assert resumed.opt_state["step"] == straight.opt_state["step"] == 12


def test_checkpoint_corruption_detected(tmp_path):
    sgd = port_sgd()
    ckpt.save_checkpoint(str(tmp_path), 0, sgd.parameters)
    with open(os.path.join(str(tmp_path), "pass-00000", "params.tar"),
              "r+b") as f:
        f.seek(100)
        f.write(b"XXXX")
    with pytest.raises(EnforceError, match="CKPT-CORRUPT"):
        ckpt.load_checkpoint(str(tmp_path), 0, device="cpu")


# ---------------------------------------------------------------------------
# commit protocol, fallback, pruning
# ---------------------------------------------------------------------------


def _save_n(root, n, seed=5):
    sgd = port_sgd(seed=seed)
    for i in range(n):
        ckpt.save_checkpoint(str(root), i, sgd.parameters,
                             opt_state=sgd.opt_state,
                             model_state=sgd.model_state,
                             extra_meta={"tag": i})
    return sgd


@pytest.mark.parametrize("phase", ckpt.COMMIT_PHASES)
def test_commit_protocol_under_each_kill(tmp_path, phase):
    """A kill before the meta commit leaves a meta-less dir every reader
    skips silently (the previous checkpoint stays latest); a kill after
    it ("done") leaves a committed, verified checkpoint."""
    sgd = _save_n(tmp_path, 1)

    class Boom(RuntimeError):
        pass

    def hook(at):
        if at == phase:
            raise Boom()

    with pytest.raises(Boom):
        ckpt.save_checkpoint(str(tmp_path), 1, sgd.parameters,
                             opt_state=sgd.opt_state, commit_hook=hook,
                             extra_meta={"tag": 1})
    d1 = ckpt.pass_dir(str(tmp_path), 1)
    assert [f for f in os.listdir(d1) if f.endswith(".tmp")] == []
    if phase == "done":
        assert ckpt.latest_pass(str(tmp_path)) == 1
        assert ckpt.verify_pass_dir(str(tmp_path), 1) is None
        assert ckpt.load_checkpoint(str(tmp_path), device="cpu")[3][
            "tag"] == 1
        return
    assert os.path.exists(os.path.join(d1, "params.tar")) == \
        (phase in ("state", "meta"))
    assert os.path.exists(os.path.join(d1, "state.pkl")) == \
        (phase == "meta")
    assert ckpt.latest_pass(str(tmp_path)) == 0
    assert ckpt.verify_pass_dir(str(tmp_path), 1) == "missing meta.json"
    assert ckpt.load_checkpoint(str(tmp_path), device="cpu")[3]["tag"] == 0


def test_load_latest_falls_back_over_corrupt_dirs(tmp_path, capsys):
    _save_n(tmp_path, 3)
    # newest: torn blob (the kill-mid-prune / partial-copy case)
    os.remove(ckpt.pass_dir(str(tmp_path), 2) + "/state.pkl")
    # middle: flipped bytes (md5 mismatch)
    with open(ckpt.pass_dir(str(tmp_path), 1) + "/params.tar", "r+b") as f:
        f.seek(40)
        f.write(b"XXXX")
    _, _, _, meta = ckpt.load_checkpoint(str(tmp_path), device="cpu")
    assert meta["tag"] == 0, "must fall back to the oldest intact dir"
    out = capsys.readouterr().out
    assert out.count("CKPT-CORRUPT") == 2
    assert "missing state.pkl" in out and "md5 mismatch" in out


def test_explicit_corrupt_load_raises_with_tag(tmp_path):
    _save_n(tmp_path, 1)
    with open(ckpt.pass_dir(str(tmp_path), 0) + "/state.pkl", "r+b") as f:
        f.write(b"ZZ")
    with pytest.raises(EnforceError, match="CKPT-CORRUPT"):
        ckpt.load_checkpoint(str(tmp_path), 0, device="cpu")


def test_prune_never_reaps_newest_verified(tmp_path):
    """Two corrupt young dirs must not count toward keep: the only good
    artifact survives pruning."""
    _save_n(tmp_path, 3)
    for pid in (1, 2):
        with open(ckpt.pass_dir(str(tmp_path), pid) + "/params.tar",
                  "r+b") as f:
            f.seek(10)
            f.write(b"CORRUPT!")
    ckpt.prune_checkpoints(str(tmp_path), keep=2)
    assert ckpt.verify_pass_dir(str(tmp_path), 0) is None, \
        "the only verified checkpoint was reaped"
    # and with enough verified dirs, old ones (corrupt or not) go
    _save_n(tmp_path, 5)
    ckpt.prune_checkpoints(str(tmp_path), keep=2)
    assert sorted(os.listdir(str(tmp_path))) == ["pass-00003", "pass-00004"]


def test_refusals_name_their_limit(tmp_path):
    sgd = port_sgd()
    bf16 = {"w": torch.zeros(2, dtype=torch.bfloat16)}
    with pytest.raises(EnforceError, match="bfloat16"):
        ckpt.snapshot_checkpoint(bf16)
    with pytest.raises(EnforceError, match="bfloat16"):
        ckpt.snapshot_checkpoint(sgd.parameters, model_state={"bn": bf16})
    with pytest.raises(EnforceError, match="A12"):
        ckpt.save_checkpoint(str(tmp_path), 0, sgd.parameters,
                             shard_plan=object())
    assert not os.path.exists(ckpt.pass_dir(str(tmp_path), 0))


def test_snapshot_is_a_finished_copy():
    """The snapshot never aliases a live tensor: an in-place update after
    it (the next step) leaves it as it was."""
    sgd = port_sgd()
    host = ckpt.snapshot_checkpoint(sgd.parameters, opt_state=sgd.opt_state)
    before = {k: v.copy() for k, v in host.params.items()}
    with torch.no_grad():
        for v in sgd.parameters.as_dict().values():
            v.add_(1.0)
    for k, v in before.items():
        np.testing.assert_array_equal(host.params[k], v)
    # params + Momentum slots + the int32 step counter
    assert host.nbytes() == 2 * sum(v.nbytes for v in before.values()) + 4


# ---------------------------------------------------------------------------
# optimizer state as the JAX package's tree
# ---------------------------------------------------------------------------


RULES = {
    "momentum": lambda p: p.optimizer.Momentum(momentum=0.9,
                                               learning_rate=0.05),
    "adam": lambda p: p.optimizer.Adam(learning_rate=1e-2),
    "sparse_momentum": lambda p: p.optimizer.SparseMomentum(
        momentum=0.9, learning_rate=0.05),
    "adam_average": lambda p: p.optimizer.Adam(
        learning_rate=1e-2, model_average=p.optimizer.ModelAverage(0.5)),
}


def _tree_paths(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tree_paths(v, path + (k,)))
        return out
    return {path: np.asarray(tree)}


@pytest.mark.parametrize("rule", sorted(RULES))
def test_opt_state_trees_match_jax(rule):
    """The port's state as numpy has the JAX package's keys, shapes and
    dtypes (``"step"`` int32[]), and converts back unchanged."""
    weights = params_np(port_sgd())
    t = port_sgd(RULES[rule](tpaddle), weights=weights)
    t.train(reader(make_data()), num_passes=1)
    j = jax_sgd(RULES[rule](jpaddle))
    jt, tt = (_tree_paths(jckpt._to_numpy_tree(j.opt_state)),
              _tree_paths(convert.opt_state_to_numpy(t.opt_state)))
    assert sorted(jt) == sorted(tt)
    for k in jt:
        assert (jt[k].shape, jt[k].dtype) == (tt[k].shape, tt[k].dtype), k
    back = convert.opt_state_from_numpy(
        convert.opt_state_to_numpy(t.opt_state), "cpu")
    assert back["step"] == t.opt_state["step"] == 3
    assert isinstance(back["step"], int)
    for k, v in _tree_paths(convert.opt_state_to_numpy(back)).items():
        np.testing.assert_array_equal(v, tt[k])


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------


def _continue_both(data, jsgd, tsgd):
    later = tpaddle.batch(lambda: iter(data[48:]), 16)   # 3 steps
    jsgd.train(later, num_passes=1)
    tsgd.train(later, num_passes=1)
    for k, v in params_np(jsgd).items():
        np.testing.assert_allclose(params_np(tsgd)[k], v, rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    js, ts = slots_np(jsgd.opt_state), slots_np(tsgd.opt_state)
    assert sorted(js) == sorted(ts)
    for k, v in js.items():
        np.testing.assert_allclose(ts[k], v, rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    assert int(jsgd.opt_state["step"]) == tsgd.opt_state["step"] == 6


@pytest.mark.parametrize("rule", ["momentum", "adam"])
def test_jax_checkpoint_resumes_in_the_port(tmp_path, rule):
    data = make_data(2)
    jsgd = jax_sgd(RULES[rule](jpaddle))
    jsgd.train(tpaddle.batch(lambda: iter(data[:48]), 16), num_passes=1)
    jsgd.save_checkpoint(str(tmp_path), 0)
    tsgd = port_sgd(RULES[rule](tpaddle), seed=7)    # other weights
    tsgd.load_checkpoint(str(tmp_path))
    assert tsgd.opt_state["step"] == 3
    _continue_both(data, jsgd, tsgd)


@pytest.mark.parametrize("rule", ["momentum", "adam"])
def test_port_checkpoint_verifies_and_loads_in_jax(tmp_path, rule):
    data = make_data(3)
    jsgd = jax_sgd(RULES[rule](jpaddle), seed=4)
    tsgd = port_sgd(RULES[rule](tpaddle), weights=params_np(jsgd))
    tsgd.train(tpaddle.batch(lambda: iter(data[:48]), 16), num_passes=1)
    tsgd.save_checkpoint(str(tmp_path), 0)
    assert jckpt.verify_pass_dir(str(tmp_path), 0) is None
    p, opt, mst, meta = jckpt.load_checkpoint(str(tmp_path))
    assert meta["pass_id"] == 0
    for k, v in params_np(tsgd).items():
        np.testing.assert_array_equal(np.asarray(p[k]), v)
    ts = slots_np(tsgd.opt_state)
    for k, v in slots_np(opt).items():
        np.testing.assert_array_equal(v, ts[k])
    assert int(opt["step"]) == 3
    jsgd.apply_checkpoint((p, opt, mst, meta))
    _continue_both(data, jsgd, tsgd)


def test_model_state_crosses_both_ways(tmp_path):
    """Batch norm's moving statistics: a port checkpoint's model state
    loads in the JAX package unchanged, and a JAX checkpoint's in the
    port."""
    data = make_data(4)
    jsgd = jax_sgd(RULES["momentum"](jpaddle), norm=True)
    tsgd = port_sgd(weights=params_np(jsgd), norm=True)
    for sgd in (jsgd, tsgd):
        sgd.train(tpaddle.batch(lambda: iter(data[:32]), 16), num_passes=1)
    tsgd.save_checkpoint(str(tmp_path / "port"), 0)
    jsgd.save_checkpoint(str(tmp_path / "jax"), 0)
    _, _, jmst, _ = jckpt.load_checkpoint(str(tmp_path / "port"))
    assert jmst and sorted(jmst) == sorted(tsgd.model_state)
    for layer, slots in tsgd.model_state.items():
        for k, v in slots.items():
            np.testing.assert_array_equal(np.asarray(jmst[layer][k]),
                                          v.numpy())
    other = port_sgd(weights=params_np(jsgd), norm=True)
    other.load_checkpoint(str(tmp_path / "jax"))
    for layer, slots in jsgd.model_state.items():
        for k, v in slots.items():
            np.testing.assert_array_equal(
                other.model_state[layer][k].numpy(), np.asarray(v))

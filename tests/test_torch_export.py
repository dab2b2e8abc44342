"""``paddle_tpu_torch.export`` against ``paddle_tpu.export`` on the CPU.

- ``merge_model``: the graphs of the JAX package's merge tests (the MLP of
  ``test_native.py`` and the classifier of ``test_checkpoint_export.py``)
  with JAX's weights through numpy, merged with a symbolic batch by both;
  the port's ``infer`` equals JAX's ``MergedModel`` at batches 4 and 9
  (and 1) to 1e-5; ``create_shared`` shares the one loaded program and
  gives the same result from two threads; a merge or a load meant for
  ``cuda`` raises without a card.
- ``export_aot_program``: the MLP, the conv + batch norm + pool + fc
  graph, the embedding model, LeNet at 28 px, a padded average pool and
  an addto + concat graph; the port's ``.ptnm`` and the JAX package's,
  each run through the port's build of ``native/src/aot_runtime.cpp`` by a
  C client with no Python in its process, equal JAX's f32 forward to
  1e-5; each activation the runtime can express, after an fc, likewise
  (the port's program); a sequence graph and an op the translator does
  not know raise ``EnforceError`` at export.
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import json
import threading
import zipfile

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import export as jexport
from paddle_tpu.platform.flags import FLAGS as JFLAGS

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import convert, native
from paddle_tpu_torch import export as texport
from paddle_tpu_torch.platform.enforce import EnforceError
from paddle_tpu_torch.tools import export_workload as ew

# merged against JAX's merged model: both run the same f32 products on
# bf16-rounded operands (the default policy), summed in other orders
MERGE_ATOL = 1e-5
# the .ptnm on the C runtime against JAX's f32 forward (the JAX package's
# own bound for its programs)
AOT_ATOL = 1e-5


def mlp(P):
    P.topology.reset_name_scope()
    x = P.layer.data(name="x", type=P.data_type.dense_vector(8))
    return P.layer.fc(P.layer.fc(x, size=16, act="relu"), size=3,
                      act="softmax")


def classifier(P):
    """``test_checkpoint_export.build_model``'s logits."""
    P.topology.reset_name_scope()
    x = P.layer.data(name="x", type=P.data_type.dense_vector(8))
    y = P.layer.data(name="y", type=P.data_type.integer_value(3))
    h = P.layer.fc(x, size=16, act="relu")
    logits = P.layer.fc(h, size=3)
    P.layer.classification_cost(input=logits, label=y)
    return logits


def cnn(P):
    P.topology.reset_name_scope()
    x = P.layer.data(name="img", type=P.data_type.dense_vector(2 * 6 * 6),
                     height=6, width=6)
    c = P.layer.img_conv(x, filter_size=3, num_filters=4, num_channels=2,
                         padding=1, act="relu")
    bn = P.layer.batch_norm(c, act="relu")
    p = P.layer.img_pool(bn, pool_size=2)
    return P.layer.fc(p, size=3, act="softmax")


def embedding(P):
    P.topology.reset_name_scope()
    ids = P.layer.data(name="ids", type=P.data_type.integer_value(50))
    emb = P.layer.embedding(ids, size=8)
    return P.layer.fc(emb, size=3, act="softmax")


def lenet(P):
    P.topology.reset_name_scope()
    models = __import__(f"{P.__name__}.models.lenet",
                        fromlist=["build"])
    return models.build(img_size=28)[2]


def both(build, seed):
    """(JAX output layer, JAX topology, JAX weights, port output layer,
    port weights on the CPU): the same graph in both packages, JAX's
    weights carried to the port as numpy."""
    jout = build(jpaddle)
    jtopo = jpaddle.topology.Topology([jout])
    jparams = jpaddle.Parameters.from_topology(jtopo, seed=seed)
    arrays = {k: np.asarray(v) for k, v in jparams.as_dict().items()}
    tout = build(tpaddle)
    return jout, jtopo, jparams, tout, convert.parameters_from_numpy(
        arrays, device="cpu")


def jax_forward(topo, params, feeds, f32=False):
    old = JFLAGS.use_bf16
    if f32:
        JFLAGS.use_bf16 = False
    try:
        out, _ = topo.forward(params.as_dict(), topo.init_state(), feeds,
                              train=False)
    finally:
        JFLAGS.use_bf16 = old
    return np.asarray(out[0])


# ---------------------------------------------------------------------------
# merge_model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("build", [mlp, classifier],
                         ids=["mlp", "checkpoint_classifier"])
def test_merge_model_matches_jax(build, tmp_path):
    jout, _, jparams, tout, tparams = both(build, seed=0)
    jpath, tpath = str(tmp_path / "j.ptm"), str(tmp_path / "t.ptm")
    jexport.merge_model(jout, jparams, jpath)
    texport.merge_model(tout, tparams, tpath, device="cpu")
    jm = jexport.load_merged_model(jpath)
    tm = texport.load_merged_model(tpath)
    assert tm.input_names == jm.input_names == ["x"]
    assert tm.output_names == jm.output_names
    with zipfile.ZipFile(tpath) as z:
        manifest = json.loads(z.read("manifest.json"))
    assert manifest["inputs"] == jm.manifest["inputs"]
    assert manifest["symbolic_batch"] is True
    assert manifest["device"] == "cpu"
    rng = np.random.RandomState(3)
    for b in (4, 9, 1):
        xb = rng.randn(b, 8).astype(np.float32)
        (want,) = jm.infer({"x": xb})
        (got,) = tm.infer({"x": xb})
        assert got.shape == want.shape == (b, 3)
        np.testing.assert_allclose(got, want, atol=MERGE_ATOL, rtol=0)


def test_merged_model_create_shared(tmp_path):
    """The clone shares the loaded program (one weight copy), infers
    identically, and two threads agree with the single-thread result."""
    tpaddle.topology.reset_name_scope()
    x = tpaddle.layer.data(name="x", type=tpaddle.data_type.dense_vector(6))
    out = tpaddle.layer.fc(x, size=4, act="softmax")
    params = tpaddle.Parameters.from_topology(
        tpaddle.topology.Topology([out]), seed=1, device="cpu")
    path = str(tmp_path / "m.ptmodel")
    texport.merge_model(out, params, path, batch_size=3, device="cpu")

    m = texport.load_merged_model(path)
    assert m.manifest["symbolic_batch"] is False
    clone = m.create_shared()
    assert clone._module is m._module   # one program, one weight copy
    fx = np.random.RandomState(0).randn(3, 6).astype(np.float32)
    want = m.infer({"x": fx})[0]
    np.testing.assert_array_equal(clone.infer({"x": fx})[0], want)
    results = {}

    def run(tag, inst):
        for _ in range(10):
            results[tag] = inst.infer({"x": fx})[0]

    ts = [threading.Thread(target=run, args=("a", m)),
          threading.Thread(target=run, args=("b", clone))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    np.testing.assert_array_equal(results["a"], want)
    np.testing.assert_array_equal(results["b"], want)


def test_merge_and_load_meant_for_cuda_raise_without_a_card(tmp_path,
                                                            monkeypatch):
    out = mlp(tpaddle)
    params = tpaddle.Parameters.from_topology(
        tpaddle.topology.Topology([out]), seed=0, device="cpu")
    path = str(tmp_path / "m.ptm")
    texport.merge_model(out, params, path, device="cpu")
    # a manifest that names the card, as a merge on the card writes it
    cuda = str(tmp_path / "cuda.ptm")
    with zipfile.ZipFile(path) as src, zipfile.ZipFile(cuda, "w") as dst:
        for item in src.namelist():
            data = src.read(item)
            if item == "manifest.json":
                data = json.dumps(dict(json.loads(data), device="cuda"))
            dst.writestr(item, data)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(EnforceError, match="CUDA is not available"):
        texport.merge_model(out, params, str(tmp_path / "x.ptm"))
    with pytest.raises(EnforceError, match="CUDA is not available"):
        texport.load_merged_model(cuda)
    with pytest.raises(EnforceError, match="CUDA is not available"):
        texport.export_aot_program(out, params, str(tmp_path / "x.ptnm"),
                                   batch_size=2)


# ---------------------------------------------------------------------------
# export_aot_program
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def aot_client(tmp_path_factory):
    lib = native.build_aot()
    return ew.build_client("aot", lib, str(tmp_path_factory.mktemp("aot")))


def _feed(build, batch, dim):
    if build is embedding:
        return np.array([3, 11, 49, 0][:batch], np.float32).reshape(batch, 1)
    return ((np.arange(batch * dim) * 37 % 100 - 50) / 100.0).astype(
        np.float32).reshape(batch, dim)


def avg_pool(P):
    """A padded average pool: its divisor counts the cells inside."""
    P.topology.reset_name_scope()
    x = P.layer.data(name="img", type=P.data_type.dense_vector(2 * 7 * 7),
                     height=7, width=7)
    p = P.layer.img_pool(x, pool_size=3, stride=2, padding=1,
                         pool_type=P.pooling.AvgPooling(), num_channels=2)
    return P.layer.fc(p, size=3)


def concat_addto(P):
    P.topology.reset_name_scope()
    x = P.layer.data(name="x", type=P.data_type.dense_vector(8))
    a = P.layer.fc(x, size=4)
    b = P.layer.fc(x, size=4, act="tanh")
    s = P.layer.addto([a, b], act="relu")
    return P.layer.fc(P.layer.concat([s, b]), size=3, act="softmax")


AOT_GRAPHS = {"mlp": (mlp, "x", 2, 8, 0), "cnn": (cnn, "img", 3, 72, 1),
              "embedding": (embedding, "ids", 4, 1, 2),
              "lenet": (lenet, "pixel", 4, 784, 0),
              "avg_pool": (avg_pool, "img", 2, 98, 3),
              "concat_addto": (concat_addto, "x", 3, 8, 4)}


@pytest.mark.parametrize("graph", sorted(AOT_GRAPHS))
def test_aot_program_matches_jax(graph, aot_client, tmp_path):
    build, name, batch, dim, seed = AOT_GRAPHS[graph]
    jout, jtopo, jparams, tout, tparams = both(build, seed)
    xb = _feed(build, batch, dim)
    feed = xb.reshape(batch).astype(np.int32) if build is embedding else xb
    want = jax_forward(jtopo, jparams, {name: feed}, f32=True)
    jpath, tpath = str(tmp_path / "j.ptnm"), str(tmp_path / "t.ptnm")
    jexport.export_aot_program(jout, jparams, jpath, batch_size=batch)
    texport.export_aot_program(tout, tparams, tpath, batch_size=batch,
                               device="cpu")
    for path in (tpath, jpath):
        run = ew.run_client(aot_client, path, xb, name, reps=1, env={})
        np.testing.assert_allclose(run["out"],
                                   want.reshape(run["out"].shape),
                                   atol=AOT_ATOL, rtol=0)


ACTIVATIONS = ("sigmoid", "tanh", "stanh", "relu", "brelu", "abs",
               "square", "exponential", "reciprocal", "sqrt", "log", "gelu")


@pytest.mark.parametrize("act", ACTIVATIONS)
def test_aot_activations_match_jax(act, aot_client, tmp_path):
    """Each activation the runtime's ops can express, after an fc: the
    port's ``.ptnm`` equals JAX's f32 forward (NaN where both take the
    square root or log of a negative)."""
    def build(P):
        P.topology.reset_name_scope()
        x = P.layer.data(name="x", type=P.data_type.dense_vector(8))
        return P.layer.fc(x, size=6, act=act)

    _, jtopo, jparams, tout, tparams = both(build, seed=5)
    xb = _feed(build, 3, 8)
    want = jax_forward(jtopo, jparams, {"x": xb}, f32=True)
    path = str(tmp_path / "t.ptnm")
    texport.export_aot_program(tout, tparams, path, batch_size=3,
                               device="cpu")
    run = ew.run_client(aot_client, path, xb, "x", reps=1, env={})
    np.testing.assert_allclose(run["out"], want, atol=AOT_ATOL,
                               rtol=AOT_ATOL)


def test_aot_rejects_sequence_graphs(tmp_path):
    """A sequence feed fails at export, as in the JAX package."""
    tpaddle.topology.reset_name_scope()
    s = tpaddle.layer.data(
        name="s", type=tpaddle.data_type.dense_vector_sequence(4))
    out = tpaddle.layer.pooling(s)
    params = tpaddle.Parameters.from_topology(
        tpaddle.topology.Topology([out]), seed=0, device="cpu")
    with pytest.raises(EnforceError, match="dense-input"):
        texport.export_aot_program(out, params, str(tmp_path / "x.ptnm"),
                                   batch_size=2, device="cpu")


def test_aot_rejects_an_op_it_does_not_know(tmp_path):
    """An op outside the runtime's set raises at export, naming the op and
    the merged-model path."""
    tpaddle.topology.reset_name_scope()
    x = tpaddle.layer.data(name="x", type=tpaddle.data_type.dense_vector(4))
    out = tpaddle.layer.fc(x, size=3, act="softrelu")
    params = tpaddle.Parameters.from_topology(
        tpaddle.topology.Topology([out]), seed=0, device="cpu")
    with pytest.raises(EnforceError, match="unsupported op .*merge_model"):
        texport.export_aot_program(out, params, str(tmp_path / "x.ptnm"),
                                   batch_size=2, device="cpu")

"""``paddle_tpu_torch.cli``, ``utils`` and ``__main__`` against the JAX
package's, on the CPU, with the JAX package's own test config written
once for each package.

- ``dump_config`` JSON and the dot diagram are equal;
- ``gradient_check`` gives the same verdicts (pass on the same weights;
  fail in both when the analytic gradient is doubled);
- ``compare_topologies`` holds ``fc`` against ``mixed`` of a
  ``full_matrix_projection`` and catches a different function;
- ``param_to_text`` writes the same text, ``text_to_param`` round trips;
- ``extract_embedding`` and ``torch2paddle`` (one shared state dict)
  give the same values;
- the exit codes of ``main([...])``, and ``python -m paddle_tpu_torch
  version``.
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import io
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import jax
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import cli as jcli
from paddle_tpu import utils as jutils

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import cli as tcli
from paddle_tpu_torch import utils as tutils
from paddle_tpu_torch.platform.enforce import EnforceError

REPO = pathlib.Path(__file__).resolve().parents[1]

CONFIG = """
import numpy as np
import {pkg} as paddle
from {pkg} import layer, optimizer

x = layer.data(name="x", type=paddle.data_type.dense_vector(8))
y = layer.data(name="y", type=paddle.data_type.integer_value(3))
hidden = layer.fc(x, size=16, act="relu", name="hidden")
logits = layer.fc(hidden, size=3, name="logits")
cost = layer.classification_cost(input=logits, label=y)
outputs = logits
optimizer = optimizer.Sgd(learning_rate=0.1)
batch_size = 16

_rng = np.random.RandomState(0)
_data = []
for _ in range(64):
    _y = int(_rng.randint(0, 3))
    _x = (_rng.randn(8) * 0.2).astype(np.float32)
    _x[_y * 2] += 1.0
    _data.append((_x, _y))


def reader():
    return iter(_data)
"""


@pytest.fixture
def configs(tmp_path):
    out = {}
    for name, pkg in (("jax", "paddle_tpu"), ("port", "paddle_tpu_torch")):
        p = tmp_path / f"conf_{name}.py"
        p.write_text(CONFIG.format(pkg=pkg))
        out[name] = str(p)
    return out


@pytest.mark.parametrize("fmt", ["json", "dot"])
def test_dump_config_equals_jax(configs, capsys, fmt):
    assert jcli.main(["dump_config", "--config", configs["jax"],
                      "--format", fmt]) == 0
    want = capsys.readouterr().out
    assert tcli.main(["dump_config", "--config", configs["port"],
                      "--format", fmt]) == 0
    got = capsys.readouterr().out
    assert got == want
    if fmt == "json":
        cfg = json.loads(got)
        assert {p["name"] for p in cfg["parameters"]} >= {"hidden.w0",
                                                          "logits.b"}


def _net(pkg):
    pkg.topology.reset_name_scope()
    layer = pkg.layer
    x = layer.data(name="x", type=pkg.data_type.dense_vector(6))
    y = layer.data(name="y", type=pkg.data_type.integer_value(3))
    h = layer.fc(input=x, size=8, act="tanh")
    cost = layer.classification_cost(input=layer.fc(input=h, size=3),
                                     label=y)
    return cost


def _jax_tar(cost) -> bytes:
    buf = io.BytesIO()
    jpaddle.Parameters.from_topology(jpaddle.topology.Topology([cost]),
                                     seed=0).to_tar(buf)
    return buf.getvalue()


def test_gradient_check_verdicts_equal_jax(monkeypatch):
    rng = np.random.RandomState(0)
    xs = rng.randn(4, 6).astype(np.float32)
    ys = rng.randint(0, 3, size=(4, 1))
    jcost = _net(jpaddle)
    tar = _jax_tar(jcost)
    jparams = jpaddle.Parameters.from_tar(io.BytesIO(tar))
    jfeeds = {"x": jax.numpy.asarray(xs), "y": jax.numpy.asarray(ys)}
    tcost = _net(tpaddle)
    tparams = tpaddle.Parameters.from_tar(io.BytesIO(tar), device="cpu")
    tfeeds = {"x": torch.from_numpy(xs), "y": torch.from_numpy(ys)}
    jrep = jutils.gradient_check(jcost, jparams, jfeeds)
    trep = tutils.gradient_check(tcost, tparams, tfeeds)
    assert trep.keys() == jrep.keys()
    assert all(v <= 2e-2 for v in trep.values())
    # a doubled ANALYTIC gradient fails in both packages
    real_jgrad, real_tgrad = jax.grad, torch.autograd.grad

    def bad_jgrad(f, *a, **kw):
        g = real_jgrad(f, *a, **kw)
        return lambda p: jax.tree.map(lambda x: 2.0 * x, g(p))

    def bad_tgrad(*a, **kw):
        return tuple(None if g is None else 2.0 * g
                     for g in real_tgrad(*a, **kw))

    monkeypatch.setattr(jax, "grad", bad_jgrad)
    monkeypatch.setattr(torch.autograd, "grad", bad_tgrad)
    with pytest.raises(Exception, match="gradient check failed"):
        jutils.gradient_check(jcost, jparams, jfeeds)
    with pytest.raises(EnforceError, match="gradient check failed"):
        tutils.gradient_check(tcost, tparams, tfeeds)


def test_compare_topologies_fc_against_mixed_projection():
    layer, attr = tpaddle.layer, tpaddle.attr
    tpaddle.topology.reset_name_scope()
    x = layer.data(name="x", type=tpaddle.data_type.dense_vector(5))
    a = layer.fc(input=x, size=4, bias_attr=False,
                 param_attr=attr.ParamAttr(name="w"))
    b = layer.mixed(size=4, input=[layer.full_matrix_projection(
        input=x, size=4, param_attr=attr.ParamAttr(name="w"))])
    feeds = {"x": torch.from_numpy(
        np.random.RandomState(1).randn(3, 5).astype(np.float32))}
    out_a, out_b, ga, gb = tutils.compare_topologies(
        a, b, feeds, check_inputs=("x",), device="cpu")
    np.testing.assert_allclose(out_a, out_b, rtol=1e-6)
    assert set(ga) == {"w"}
    c = layer.fc(input=x, size=4, bias_attr=False, act="tanh",
                 param_attr=attr.ParamAttr(name="w"))
    with pytest.raises(AssertionError, match="outputs differ"):
        tutils.compare_topologies(a, c, feeds, device="cpu")


def test_param_text_identical_and_round_trips(tmp_path):
    table = np.random.RandomState(2).randn(7, 5).astype(np.float32)
    jpath, tpath = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    jutils.param_to_text(table, jpath)
    tutils.param_to_text(torch.from_numpy(table), tpath)
    assert open(tpath).read() == open(jpath).read()
    back = tutils.text_to_param(tpath, dim=5)
    np.testing.assert_allclose(back, table, atol=1e-6)
    np.testing.assert_array_equal(back, jutils.text_to_param(jpath, dim=5))
    lines = open(tpath).read().splitlines()
    open(tpath, "w").write("\n".join([lines[0]] + lines[2:]) + "\n")
    with pytest.raises(ValueError):
        tutils.text_to_param(tpath, dim=5)


def _emb_net(pkg):
    pkg.topology.reset_name_scope()
    layer = pkg.layer
    words = layer.data(name="w",
                       type=pkg.data_type.integer_value_sequence(50))
    emb = layer.embedding(input=words, size=8, name="emb")
    lin = layer.fc(input=layer.pooling(
        input=emb, pooling_type=pkg.pooling.AvgPooling()), size=6,
        name="lin")
    return pkg.topology.Topology([lin])


def test_extract_embedding_and_torch2paddle_equal_jax():
    jtopo = _emb_net(jpaddle)
    buf = io.BytesIO()
    jpaddle.Parameters.from_topology(jtopo, seed=0).to_tar(buf)
    jparams = jpaddle.Parameters.from_tar(io.BytesIO(buf.getvalue()))
    _emb_net(tpaddle)
    tparams = tpaddle.Parameters.from_tar(io.BytesIO(buf.getvalue()),
                                          device="cpu")
    np.testing.assert_array_equal(
        tutils.extract_embedding(tparams, "emb.w", [3, 1, 4]),
        jutils.extract_embedding(jparams, "emb.w", [3, 1, 4]))
    torch.manual_seed(0)
    lin = torch.nn.Linear(8, 6)
    state = lin.state_dict()
    names = {"weight": "lin.w0", "bias": "lin.b"}
    assert sorted(tutils.torch2paddle(state, tparams, name_map=names)) == \
        sorted(jutils.torch2paddle(state, jparams, name_map=names)) == \
        ["lin.b", "lin.w0"]
    for k in ("lin.w0", "lin.b", "emb.w"):
        np.testing.assert_array_equal(tparams.get(k), np.asarray(jparams[k]))
    np.testing.assert_array_equal(tparams.get("lin.w0"),
                                  lin.weight.detach().numpy().T)


def test_main_exit_codes(configs, tmp_path, capsys):
    conf = configs["port"]
    tar = str(tmp_path / "model.tar")
    assert tcli.main(["train", "--config", conf, "--device", "cpu",
                      "--num_passes", "10", "--model_tar", tar]) == 0
    capsys.readouterr()
    assert tcli.main(["train", "--config", conf, "--device", "cpu",
                      "--job", "test", "--init_model_tar", tar]) == 0
    out = capsys.readouterr().out
    # the trained model beats an untrained ~log(3)
    assert float(out.split("Test cost=")[1].split()[0]) < 0.9
    bad = tmp_path / "bad.tar"
    bad.write_bytes(b"not a tar at all")
    assert tcli.main(["train", "--config", conf, "--device", "cpu",
                      "--job", "test", "--init_model_tar", str(bad)]) == 2
    assert "cannot load model tar" in capsys.readouterr().err
    assert tcli.main(["train", "--config", conf, "--device", "cpu",
                      "--job", "test"]) == 2
    noreader = tmp_path / "noreader.py"
    noreader.write_text(CONFIG.format(pkg="paddle_tpu_torch")
                        .replace("def reader():", "def _unused():"))
    assert tcli.main(["train", "--config", str(noreader),
                      "--device", "cpu"]) == 2
    assert "reader" in capsys.readouterr().err
    assert tcli.main(["version"]) == 0
    assert "paddle_tpu_torch 0.1.0 (torch" in capsys.readouterr().out
    # --save_dir: a checkpoint a pass, evaluated by --job=test
    ck = str(tmp_path / "ck")
    assert tcli.main(["train", "--config", conf, "--device", "cpu",
                      "--num_passes", "2", "--save_dir", ck]) == 0
    assert sorted(os.listdir(ck)) == ["pass-00000", "pass-00001"]
    capsys.readouterr()
    assert tcli.main(["train", "--config", conf, "--device", "cpu",
                      "--job", "test", "--save_dir", ck]) == 0
    assert "Test cost=" in capsys.readouterr().out
    assert tcli.main(["train", "--config", conf, "--device", "cpu",
                      "--job", "test", "--save_dir",
                      str(tmp_path / "empty")]) == 2
    assert "cannot load checkpoint" in capsys.readouterr().err
    with pytest.raises(EnforceError, match="A13"):
        tcli.main(["merge_model", "--config", conf, "--output", "x"])


def test_python_dash_m_version():
    out = subprocess.run([sys.executable, "-m", "paddle_tpu_torch",
                          "version"], cwd=REPO, capture_output=True,
                         text=True, timeout=120,
                         env={"PATH": "/usr/bin:/bin",
                              "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("paddle_tpu_torch 0.1.0 (torch ")

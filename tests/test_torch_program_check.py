"""The port's program verifier against the JAX package's, on the CPU: the
``program_check`` cases of ``tests/test_analysis.py`` (real training
programs verify clean; each seeded bad program raises its class: def
before use, undefined var, dangling fetch and unknown feed, dead var,
duplicate writer, gradient fan-in allowed, shape mismatches of matmul,
elementwise, conv channels and reshape, the unknown batch broadcast,
dtype mismatches) give the same ``(code, severity)`` diagnostics, with
the same messages, in both packages; the Executor's strict gate and
feed/fetch validation raise in JAX's words, warn mode logs no per-run
dead var, a strict good program trains as JAX's does; every port zoo
builder verifies with zero errors, and the topology checks catch
duplicate names and bad parameter shapes.
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import logging

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.analysis import program_check as jcheck
from paddle_tpu.platform.flags import FLAGS as JFLAGS

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.analysis import program_check as tcheck
from paddle_tpu_torch.analysis.diagnostics import Severity
from paddle_tpu_torch.platform.flags import FLAGS as TFLAGS

SIDES = {"jax": (jfluid, jcheck), "torch": (tfluid, tcheck)}


def _fit_a_line(fluid):
    L = fluid.layers
    prog = fluid.Program()
    with fluid.program_guard(prog):
        x, y = L.data("x", [13]), L.data("y", [1])
        pred = L.fc(x, size=1, bias_attr=True)
        loss = L.mean(L.square_error_cost(pred, y))
        fluid.optimizer.SGDOptimizer(learning_rate=0.05).minimize(loss)
    return prog, dict(fetch_names=[loss.name], feed_names=["x", "y"])


def _mlp_with_metrics(fluid):
    L = fluid.layers
    prog = fluid.Program()
    with fluid.program_guard(prog):
        img = L.data("img", [64])
        label = L.data("label", [1], dtype="int64")
        logits = L.fc(L.fc(img, size=32, act="relu"), size=4)
        loss = L.mean(L.softmax_with_cross_entropy(logits, label))
        acc = L.accuracy(logits, label)
        fluid.optimizer.AdamOptimizer(learning_rate=1e-3).minimize(loss)
    return prog, dict(fetch_names=[loss.name, acc.name],
                      feed_names=["img", "label"])


def _convnet(fluid):
    L = fluid.layers
    prog = fluid.Program()
    with fluid.program_guard(prog):
        img = L.data("img", [1, 12, 12])
        label = L.data("label", [1], dtype="int64")
        c = L.batch_norm(L.conv2d(img, num_filters=4, filter_size=3,
                                  act="relu"))
        logits = L.fc(L.pool2d(c, pool_size=2, pool_type="max"), size=4)
        loss = L.mean(L.softmax_with_cross_entropy(logits, label))
        fluid.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
    return prog, dict(fetch_names=[loss.name], feed_names=["img", "label"])


def _static_rnn(fluid):
    L = fluid.layers
    prog = fluid.Program()
    with fluid.program_guard(prog):
        x = L.data("x", [6, 4, 8], append_batch_size=False)
        rnn = L.StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)
            h_prev = rnn.memory(shape=(4, 16), init_value=0.0)
            h = L.fc([x_t, h_prev], size=16, act="tanh", bias_attr=False)
            rnn.update_memory(h_prev, h)
            rnn.step_output(h)
        loss = L.mean(rnn())
        fluid.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
    return prog, dict(fetch_names=[loss.name], feed_names=["x"])


def _def_before_use(fluid):
    prog = fluid.Program()
    b = prog.global_block()
    for n in "abc":
        b.create_var(n, shape=(4,))
    b.append_op("relu", inputs={"X": "b"}, outputs={"Out": "c"})
    b.append_op("tanh", inputs={"X": "a"}, outputs={"Out": "b"})
    return prog, dict(feed_names=["a"])


def _undefined_var(fluid):
    prog = fluid.Program()
    b = prog.global_block()
    b.create_var("out", shape=(4,))
    b.append_op("relu", inputs={"X": "never_declared"},
                outputs={"Out": "out"})
    return prog, {}


def _dangling_fetch_unknown_feed(fluid):
    prog, _ = _fit_a_line(fluid)
    return prog, dict(fetch_names=["no_such_var"],
                      feed_names=["x", "y", "typo"])


def _dead_var(fluid):
    L = fluid.layers
    prog = fluid.Program()
    with fluid.program_guard(prog):
        x = L.data("x", [8])
        used = L.relu(x)
        L.tanh(x)                     # never fetched, never read
        out = L.mean(used)
    return prog, dict(fetch_names=[out.name], feed_names=["x"])


def _duplicate_writer(fluid):
    prog = fluid.Program()
    b = prog.global_block()
    b.create_var("x", shape=(4,))
    b.create_var("o", shape=(4,))
    b.append_op("relu", inputs={"X": "x"}, outputs={"Out": "o"})
    b.append_op("tanh", inputs={"X": "x"}, outputs={"Out": "o"})
    return prog, dict(feed_names=["x"])


def _fan_in(fluid):
    L = fluid.layers
    prog = fluid.Program()
    with fluid.program_guard(prog):
        h = L.fc(L.data("x", [8]), size=8, act="relu")
        loss = L.mean(L.fc(h, size=4) + L.fc(h, size=4))
        fluid.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
    return prog, dict(fetch_names=[loss.name], feed_names=["x"])


def _matmul_mismatch(fluid):
    prog = fluid.Program()
    b = prog.global_block()
    b.create_var("a", shape=(-1, 4))
    b.create_parameter("w", shape=(7, 3))
    b.create_var("o", shape=(-1, 3))
    b.append_op("mul", inputs={"X": "a", "Y": "w"}, outputs={"Out": "o"})
    return prog, dict(feed_names=["a"])


def _elementwise_mismatch(fluid):
    prog = fluid.Program()
    b = prog.global_block()
    b.create_var("p", shape=(8, 4))
    b.create_var("q", shape=(8, 5))
    b.create_var("r", shape=(8, 4))
    b.append_op("elementwise_add", inputs={"X": "p", "Y": "q"},
                outputs={"Out": "r"})
    return prog, dict(feed_names=["p", "q"])


def _conv_channels(fluid):
    prog = fluid.Program()
    b = prog.global_block()
    b.create_var("img", shape=(-1, 3, 8, 8))
    b.create_parameter("w", shape=(4, 5, 3, 3))     # expects 5 channels
    b.create_var("o", shape=())
    b.append_op("conv2d", inputs={"Input": "img", "Filter": "w"},
                outputs={"Output": "o"}, attrs={"strides": 1,
                                                "paddings": 0})
    return prog, dict(feed_names=["img"])


def _reshape_count(fluid):
    prog = fluid.Program()
    b = prog.global_block()
    b.create_var("x", shape=(6, 4))
    b.create_var("y", shape=())
    b.append_op("reshape", inputs={"X": "x"}, outputs={"Out": "y"},
                attrs={"shape": [5, 5]})           # 24 -> 25 elements
    return prog, dict(feed_names=["x"])


def _unknown_batch_broadcast(fluid):
    prog = fluid.Program()
    b = prog.global_block()
    b.create_var("x", shape=(-1, 8))
    b.create_var("one", shape=(1, 8))
    b.create_var("s", shape=(-1, 8))
    b.create_var("r", shape=(4, 8))
    b.append_op("elementwise_add", inputs={"X": "x", "Y": "one"},
                outputs={"Out": "s"})
    b.append_op("reshape", inputs={"X": "s"}, outputs={"Out": "r"},
                attrs={"shape": [4, 8]})
    return prog, dict(feed_names=["x", "one"])


def _dtype_float_int(fluid):
    prog = fluid.Program()
    b = prog.global_block()
    b.create_var("f", shape=(4,), dtype="float32")
    b.create_var("i", shape=(4,), dtype="int64")
    b.create_var("o", shape=(4,))
    b.append_op("elementwise_add", inputs={"X": "f", "Y": "i"},
                outputs={"Out": "o"})
    return prog, dict(feed_names=["f", "i"])


def _dtype_float_label(fluid):
    L = fluid.layers
    prog = fluid.Program()
    with fluid.program_guard(prog):
        logits = L.data("logits", [4])
        label = L.data("label", [1], dtype="float32")
        L.softmax_with_cross_entropy(logits, label)
    return prog, dict(feed_names=["logits", "label"])


CASES = {
    "fit_a_line": (_fit_a_line, set()),
    "mlp_with_metrics": (_mlp_with_metrics, set()),
    "convnet": (_convnet, set()),
    "static_rnn": (_static_rnn, set()),
    "def_before_use": (_def_before_use, {"def-before-use"}),
    "undefined_var": (_undefined_var, {"undefined-var"}),
    "dangling_fetch_unknown_feed": (_dangling_fetch_unknown_feed,
                                    {"dangling-fetch", "unknown-feed"}),
    "dead_var": (_dead_var, {"dead-var"}),
    "duplicate_writer": (_duplicate_writer, {"duplicate-writer"}),
    "gradient_fan_in": (_fan_in, set()),
    "matmul_mismatch": (_matmul_mismatch, {"shape-mismatch"}),
    "elementwise_mismatch": (_elementwise_mismatch, {"shape-mismatch"}),
    "conv_channels": (_conv_channels, {"shape-mismatch"}),
    "reshape_count": (_reshape_count, {"shape-mismatch"}),
    "unknown_batch_broadcast": (_unknown_batch_broadcast, set()),
    "dtype_float_int": (_dtype_float_int, {"dtype-mismatch"}),
    "dtype_float_label": (_dtype_float_label, {"dtype-mismatch"}),
}


def _diags(side, build):
    fluid, check = SIDES[side]
    prog, kw = build(fluid)
    return [(d.code, str(d.severity), d.message, d.block_idx, d.op_idx,
             d.vars) for d in check.verify_program(prog, **kw)]


@pytest.mark.parametrize("name", list(CASES))
def test_verifier_diagnostics_match_jax(name):
    build, want_codes = CASES[name]
    got, want = _diags("torch", build), _diags("jax", build)
    assert got == want
    assert {c for c, *_ in got if c != "dead-var"} == want_codes - \
        {"dead-var"}
    if "dead-var" in want_codes:
        assert any(c == "dead-var" and s == "WARNING" for c, s, *_ in got)


def _strict(fn):
    old = (JFLAGS.fluid_verify, TFLAGS.fluid_verify)
    JFLAGS.fluid_verify = TFLAGS.fluid_verify = "strict"
    try:
        return fn()
    finally:
        JFLAGS.fluid_verify, TFLAGS.fluid_verify = old


def _exe(fluid):
    return jfluid.Executor() if fluid is jfluid else tfluid.Executor("cpu")


def test_strict_gate_and_feed_fetch_errors_in_jax_words():
    msgs = {}
    for side, (fluid, _) in SIDES.items():
        prog, _ = _matmul_mismatch(fluid)
        out = []
        with pytest.raises(Exception) as e:
            _strict(lambda: _exe(fluid).run(
                prog, feed={"a": np.zeros((2, 4), np.float32)},
                fetch_list=["o"], scope=fluid.Scope()))
        out.append(str(e.value))
        prog, kw = _fit_a_line(fluid)
        feed = {"x": np.zeros((4, 13), np.float32),
                "y": np.zeros((4, 1), np.float32),
                "typo": np.zeros((4, 1), np.float32)}
        with pytest.raises(Exception) as e:
            _exe(fluid).run(prog, feed=feed, fetch_list=["nope"],
                            scope=fluid.Scope())
        out.append(str(e.value))
        msgs[side] = out
    assert msgs["torch"] == msgs["jax"]
    assert "shape-mismatch" in msgs["torch"][0]
    assert "feed 'typo'" in msgs["torch"][1] and \
        "fetch 'nope'" in msgs["torch"][1]


def test_strict_good_program_trains_as_jax():
    def train(fluid):
        prog, kw = _fit_a_line(fluid)
        rng = np.random.RandomState(0)
        true_w = rng.randn(13, 1).astype(np.float32)
        exe, scope = _exe(fluid), fluid.Scope()
        losses = []
        for _ in range(10):
            xb = rng.randn(16, 13).astype(np.float32)
            (l,) = exe.run(prog, feed={"x": xb, "y": xb @ true_w},
                           fetch_list=kw["fetch_names"], scope=scope)
            losses.append(float(l))
        return losses

    t, j = _strict(lambda: train(tfluid)), _strict(lambda: train(jfluid))
    np.testing.assert_allclose(t, j, rtol=1e-5)
    assert t[-1] < t[0]


def test_warn_mode_logs_no_per_run_dead_var(caplog):
    prog, _ = _mlp_with_metrics(tfluid)
    loss_name = [op for op in prog.global_block().ops
                 if op.type == "mean"][0].output("Out")[0]
    feed = {"img": np.zeros((4, 64), np.float32),
            "label": np.zeros((4, 1), np.int64)}
    with caplog.at_level(logging.WARNING, logger="paddle_tpu_torch"):
        tfluid.Executor("cpu").run(prog, feed=feed, fetch_list=[loss_name],
                                   scope=tfluid.Scope())
    assert "dead-var" not in caplog.text


def _zoo_builders():
    import importlib

    out = []
    for name in ("lenet", "smallnet", "alexnet", "googlenet", "resnet",
                 "text_lstm", "deepfm", "gan", "vae", "sequence_tagging",
                 "srl", "quick_start", "traffic_prediction", "transformer",
                 "seq2seq"):
        mod = importlib.import_module(f"paddle_tpu_torch.models.{name}")
        for fn_name in ("build", "build_train", "build_seq2seq"):
            fn = getattr(mod, fn_name, None)
            if fn is not None:
                out.append(pytest.param(fn, id=f"{name}.{fn_name}"))
    return out


@pytest.mark.parametrize("build", _zoo_builders())
def test_zoo_verifies_with_zero_errors(build):
    from paddle_tpu_torch.topology import LayerOutput

    result = build()
    nodes = [r for r in (result if isinstance(result, tuple) else (result,))
             if isinstance(r, LayerOutput)]
    assert nodes, "build returned no LayerOutputs"
    diags = tcheck.verify_topology(nodes)
    assert [d for d in diags if d.severity is Severity.ERROR] == [], \
        [str(d) for d in diags]


def test_topology_checks_catch_duplicate_names_and_bad_params():
    from paddle_tpu_torch.attr import ParamAttr
    from paddle_tpu_torch.topology import LayerOutput, ParamSpec

    a = LayerOutput("dup", "fc", [], fn=lambda ctx, p, ins: ins[0])
    bad = LayerOutput("dup", "fc", [a], fn=lambda ctx, p, ins: ins[0])
    assert any(d.severity is Severity.ERROR
               for d in tcheck.verify_topology(bad))
    p = LayerOutput("p", "fc", [], fn=lambda ctx, p, ins: 0,
                    params={"w": ParamSpec(shape=(-1, 4),
                                           attr=ParamAttr())})
    assert "shape-mismatch" in {d.code for d in tcheck.verify_topology(p)
                                if d.severity is Severity.ERROR}

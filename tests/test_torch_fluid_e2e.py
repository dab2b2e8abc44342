"""The port's fluid programs against the JAX package's, on the CPU: every
program of ``tests/test_fluid_e2e.py`` and ``tests/test_fluid_control_io.py``
(fit_a_line with SGD, the MLP with Adam and its accuracy, the conv net
with Momentum, StaticRNN, cond forward and training, DynamicRNN forward,
reverse and training) built with each package's ``fluid.layers`` from the
same code, both starting from ``_init_value``'s numpy weights: each
step's fetched values and, after 5 steps, every scope value (weights,
optimizer slots, Adam's beta powers) equal JAX's.  Then the IR surface
(``to_string``, ``prune``) and the IO-only rule, in JAX's words.

Tolerances: costs and scopes at rtol 1e-5 / atol 1e-6 (f32 in both,
summed in other orders).
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid

RTOL, ATOL = 1e-5, 1e-6
STEPS = 5


def _fit_a_line(fluid, rng):
    L, opt = fluid.layers, fluid.optimizer
    x, y = L.data("x", [13]), L.data("y", [1])
    pred = L.fc(x, size=1, bias_attr=True)
    loss = L.mean(L.square_error_cost(pred, y))
    opt.SGDOptimizer(learning_rate=0.05).minimize(loss)
    w = rng.randn(13, 1).astype(np.float32)
    feeds = []
    for _ in range(STEPS):
        xb = rng.randn(32, 13).astype(np.float32)
        feeds.append({"x": xb, "y": xb @ w})
    return [loss], feeds


def _mlp(fluid, rng):
    L, opt = fluid.layers, fluid.optimizer
    img, label = L.data("img", [64]), L.data("label", [1], dtype="int64")
    h = L.fc(img, size=32, act="relu")
    logits = L.fc(h, size=4)
    loss = L.mean(L.softmax_with_cross_entropy(logits, label))
    acc = L.accuracy(logits, label)
    opt.AdamOptimizer(learning_rate=0.01).minimize(loss)
    feeds = []
    for _ in range(STEPS):
        y = rng.randint(0, 4, (64, 1)).astype(np.int64)
        x = rng.randn(64, 64).astype(np.float32) * 0.3
        for i in range(64):
            x[i, y[i, 0] * 16:(y[i, 0] + 1) * 16] += 1.5
        feeds.append({"img": x, "label": y})
    return [loss, acc], feeds


def _conv(fluid, rng):
    L, opt = fluid.layers, fluid.optimizer
    img, label = L.data("img", [1, 8, 8]), L.data("label", [1],
                                                  dtype="int64")
    c = L.conv2d(img, num_filters=4, filter_size=3, padding=1, act="relu")
    p = L.pool2d(c, pool_size=2)
    logits = L.fc(p, size=2)
    loss = L.mean(L.softmax_with_cross_entropy(logits, label))
    opt.MomentumOptimizer(learning_rate=0.05, momentum=0.9).minimize(loss)
    feeds = []
    for _ in range(STEPS):
        y = rng.randint(0, 2, (32, 1)).astype(np.int64)
        x = rng.randn(32, 1, 8, 8).astype(np.float32) * 0.2
        x[y[:, 0] == 1, :, 2:6, 2:6] += 1.0
        feeds.append({"img": x, "label": y})
    return [loss], feeds


def _static_rnn(fluid, rng):
    L, opt = fluid.layers, fluid.optimizer
    T, B, D, H = 5, 4, 3, 6
    x = L.data("x", [T, B, D], append_batch_size=False)
    target = L.data("target", [B, H], append_batch_size=False)
    rnn = L.StaticRNN()
    with rnn.step():
        xt = rnn.step_input(x)
        h_prev = rnn.memory(shape=(B, H), init_value=0.0)
        h = L.fc([xt, h_prev], size=H, act="tanh", bias_attr=True,
                 name="rnn_fc")
        rnn.update_memory(h_prev, h)
        rnn.step_output(h)
    outs = rnn()
    last = L.reshape(L.crop(outs, offsets=[T - 1, 0, 0], shape=[1, B, H]),
                     [B, H])
    loss = L.mean(L.square_error_cost(last, target))
    opt.SGDOptimizer(learning_rate=0.1).minimize(loss)
    feed = {"x": rng.randn(T, B, D).astype(np.float32),
            "target": rng.rand(B, H).astype(np.float32) * 0.5}
    return [loss], [feed] * STEPS


def _cond_forward(fluid, rng):
    L = fluid.layers
    x, pred = L.data("x", [3]), L.data("pred", [1])
    out = L.cond(pred, lambda: L.scale(x, scale=2.0),
                 lambda: L.scale(x, scale=0.5))
    feed = {"x": np.arange(12, dtype=np.float32).reshape(4, 3),
            "pred": np.array([1.0, 0.0, 1.0, 0.0], np.float32)}
    return [out], [feed]


def _cond_train(fluid, rng):
    L, opt = fluid.layers, fluid.optimizer
    x, pred, y = L.data("x", [4]), L.data("pred", [1]), L.data("y", [1])
    out = L.cond(pred, lambda: L.fc(x, size=1, bias_attr=True),
                 lambda: L.fc(x, size=1, bias_attr=True))
    loss = L.mean(L.square_error_cost(out, y))
    opt.SGDOptimizer(learning_rate=0.1).minimize(loss)
    w_t = rng.randn(4, 1).astype(np.float32)
    feeds = []
    for _ in range(STEPS):
        xb = rng.randn(16, 4).astype(np.float32)
        pb = (rng.rand(16) > 0.5).astype(np.float32)
        feeds.append({"x": xb, "pred": pb,
                      "y": np.where(pb[:, None] > 0, xb @ w_t, -xb @ w_t)})
    return [loss], feeds


def _ragged(fluid, rng, lens, dim):
    offs = np.concatenate([[0], np.cumsum(lens)])
    data = rng.randn(int(offs[-1]), dim).astype(np.float32)
    return fluid.LoDArray(data, (tuple(int(o) for o in offs),))


def _drnn_sum(fluid, rng, reverse):
    L = fluid.layers
    lens, dim = ([3, 1, 4, 2], 5) if not reverse else ([2, 3], 3)
    x = L.data("x", [dim], lod_level=1)
    drnn = L.DynamicRNN(reverse=reverse)
    with drnn.step():
        x_t = drnn.step_input(x)
        h = drnn.memory(shape=(len(lens), dim))
        s = L.elementwise_add(x_t, h)
        drnn.update_memory(h, s)
        drnn.step_output(s)
    out = drnn()
    return [out], [{"x": _ragged(fluid, rng, lens, dim)}]


def _drnn_train(fluid, rng):
    L, opt = fluid.layers, fluid.optimizer
    dim, lens = 4, [3, 2, 4, 1]
    x = L.data("x", [dim], lod_level=1)
    tgt = L.data("tgt", [dim], lod_level=1)
    drnn = L.DynamicRNN()
    with drnn.step():
        x_t = drnn.step_input(x)
        h = drnn.memory(shape=(4, dim))
        s = L.elementwise_add(L.fc(x_t, size=dim), h)
        drnn.update_memory(h, s)
        drnn.step_output(s)
    out = drnn()
    loss = L.mean(L.square_error_cost(out, tgt))
    opt.AdamOptimizer(learning_rate=0.02).minimize(loss)
    feeds = []
    for _ in range(STEPS):
        x_lod = _ragged(fluid, rng, lens, dim)
        offs = np.asarray(x_lod.lod[0])
        t = np.concatenate([np.cumsum(0.5 * x_lod.data[offs[i]:offs[i + 1]],
                                      axis=0) for i in range(len(lens))])
        feeds.append({"x": x_lod, "tgt": fluid.LoDArray(t, x_lod.lod)})
    return [loss], feeds


PROGRAMS = {
    "fit_a_line": _fit_a_line, "mlp": _mlp, "conv": _conv,
    "static_rnn": _static_rnn, "cond_forward": _cond_forward,
    "cond_train": _cond_train,
    "drnn_forward": lambda f, r: _drnn_sum(f, r, False),
    "drnn_reverse": lambda f, r: _drnn_sum(f, r, True),
    "drnn_train": _drnn_train,
}


def _drive(fluid, exe, name):
    prog = fluid.Program()
    with fluid.program_guard(prog):
        fetch, feeds = PROGRAMS[name](fluid, np.random.RandomState(7))
    scope = fluid.Scope()
    got = [exe.run(prog, feed=f, fetch_list=fetch, scope=scope)
           for f in feeds]
    vals = {}
    for n, v in scope.values.items():
        vals[n] = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
            else np.asarray(v)
    return got, vals


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_program_steps_and_scope_match_jax(name):
    jgot, jscope = _drive(jfluid, jfluid.Executor(), name)
    tgot, tscope = _drive(tfluid, tfluid.Executor("cpu"), name)
    assert len(tgot) == len(jgot)
    for step, (t, j) in enumerate(zip(tgot, jgot)):
        for a, b in zip(t, j):
            a, b = np.asarray(a), np.asarray(b)
            assert a.shape == b.shape and a.dtype == b.dtype, (step, a, b)
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name} step {step}")
    assert sorted(tscope) == sorted(jscope)
    for n, v in jscope.items():
        assert tscope[n].dtype == v.dtype, n
        np.testing.assert_allclose(tscope[n], v, rtol=RTOL, atol=ATOL,
                                   err_msg=n)


def test_scope_crosses_the_packages():
    """A JAX scope after 2 Momentum steps, carried into the port by
    ``convert.scope_from_numpy``, trains on as JAX's does; the port's
    scope read back by ``scope_to_numpy`` continues in JAX the same."""
    from paddle_tpu_torch.convert import scope_from_numpy, scope_to_numpy

    def build(fluid):
        prog = fluid.Program()
        with fluid.program_guard(prog):
            fetch, feeds = _conv(fluid, np.random.RandomState(7))
        return prog, fetch, feeds

    jprog, jfetch, feeds = build(jfluid)
    tprog, tfetch, _ = build(tfluid)
    jexe, texe = jfluid.Executor(), tfluid.Executor("cpu")
    jscope = jfluid.Scope()
    for f in feeds[:2]:
        jexe.run(jprog, feed=f, fetch_list=jfetch, scope=jscope)
    tscope = scope_from_numpy({n: np.asarray(v)
                               for n, v in jscope.values.items()}, "cpu")
    for f in feeds[2:4]:
        (j,) = jexe.run(jprog, feed=f, fetch_list=jfetch, scope=jscope)
        (t,) = texe.run(tprog, feed=f, fetch_list=tfetch, scope=tscope)
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)
    back = jfluid.Scope()
    back.values.update(scope_to_numpy(tscope))
    (j,) = jexe.run(jprog, feed=feeds[4], fetch_list=jfetch, scope=jscope)
    (b,) = jexe.run(jprog, feed=feeds[4], fetch_list=jfetch, scope=back)
    np.testing.assert_allclose(b, j, rtol=RTOL, atol=ATOL)


def _printed_and_pruned(fluid):
    prog = fluid.Program()
    with fluid.program_guard(prog):
        x = fluid.layers.data("x", [4])
        h = fluid.layers.fc(x, size=3, act="relu")
        loss = fluid.layers.mean(h)
        fluid.optimizer.SGDOptimizer(0.1).minimize(loss)
    inf = fluid.framework.prune(prog, [h])
    return prog.to_string(), inf, h


def test_program_text_and_prune_match_jax():
    jtext, jinf, jh = _printed_and_pruned(jfluid)
    ttext, tinf, th = _printed_and_pruned(tfluid)
    assert ttext == jtext
    assert tinf.to_string() == jinf.to_string()
    assert tinf.fingerprint() == jinf.fingerprint()
    kinds = [op.type for op in tinf.global_block().ops]
    assert "sgd" not in kinds and not any(k.endswith("_grad") for k in kinds)
    feed = {"x": np.ones((2, 4), np.float32)}
    (t,) = tfluid.Executor("cpu").run(tinf, feed=feed, fetch_list=[th],
                                      scope=tfluid.Scope())
    (j,) = jfluid.Executor().run(jinf, feed=feed, fetch_list=[jh],
                                 scope=jfluid.Scope())
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)


def test_io_programs_must_be_pure_in_jax_words(tmp_path):
    msgs = []
    for fluid, exe in ((jfluid, jfluid.Executor()),
                       (tfluid, tfluid.Executor("cpu"))):
        prog = fluid.Program()
        with fluid.program_guard(prog):
            x = fluid.layers.data("x", [2])
            v = prog.global_block().create_var(name="w", shape=(2,),
                                               persistable=True)
            fluid.layers.scale(x, scale=2.0)
            prog.global_block().append_op(
                "save", inputs={"X": [v]}, outputs={},
                attrs={"path": str(tmp_path)})
        with pytest.raises(Exception) as e:
            exe.run(prog, feed={"x": np.ones((1, 2), np.float32)},
                    fetch_list=[], scope=fluid.Scope())
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "IO-only" in msgs[0]


def test_executor_runs_on_cuda_by_default():
    """``Executor()`` is the card's; without CUDA it raises, and
    ``place="cpu"`` is the host."""
    if torch.cuda.is_available():
        assert tfluid.Executor().device.type == "cuda"
    else:
        with pytest.raises(Exception, match="CUDA is not available"):
            tfluid.Executor()
    assert tfluid.Executor("cpu").device.type == "cpu"

"""The port's fluid op library against the JAX package's, on the CPU.

- the registry: the same 103 op names, families and flags;
- every op, forward and ``_grad``: all the single-op cases run as ONE
  program in each package (the JAX package compiles it once), each case
  on its own seeded numpy inputs, with a loss term ``mean(out * w)`` of a
  seeded cotangent ``w`` on its differentiable output; every output and
  every input's gradient is held to JAX's.  The control-flow ops
  (``recurrent``, ``cond``, ``dynamic_recurrent``) run their own
  programs, forward and gradients; ``save``/``restore`` cross the two
  packages' ``.npy`` layout;
- the random ops: JAX's draws handed to the port's draw functions
  (``ops.draw_uniform``/``draw_normal``) give JAX's outputs and dropout
  masks; the port's own draws are checked by their statistics;
- grad ops never recompute a forward: a dropout's gradient goes through
  the mask its forward drew.

Tolerances: f32 forwards and gradients at rtol 1e-5 / atol 1e-6 unless
the case states a wider bound with its reason.
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import jax
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import ops as jops

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import ops as tops

RTOL, ATOL = 1e-5, 1e-6
SEED = 3


def _r(seed, *shape, lo=None, hi=None, scale=1.0):
    rng = np.random.RandomState(seed)
    if lo is not None:
        return rng.uniform(lo, hi, size=shape).astype(np.float32)
    return np.asarray(rng.randn(*shape) * scale, np.float32)


def _ints(seed, hi, *shape):
    return np.random.RandomState(seed).randint(0, hi, shape).astype(np.int64)


def _lod(data, lod):
    return ("lod", data, lod)


ACT_ATTRS = {"brelu": {"t_min": -0.5, "t_max": 0.8},
             "soft_relu": {"threshold": 1.5}, "pow": {"factor": 3.0},
             "leaky_relu": {"alpha": 0.1}, "relu6": {"threshold": 1.0},
             "hard_shrink": {"threshold": 0.4},
             "soft_shrink": {"lambda": 0.3}, "elu": {"alpha": 0.7}}
POSITIVE = ("sqrt", "log", "reciprocal")


def _cases():
    c = []

    def add(op, ins, attrs=None, outs=("Out",), diff="Out", key=None,
            tol=None):
        c.append(dict(key=key or op, op=op, ins=ins, attrs=attrs or {},
                      outs={s: 1 for s in outs} if isinstance(outs, tuple)
                      else outs, diff=diff, tol=tol))

    x, y = _r(1, 4, 5), _r(2, 4, 5)
    for op in ("elementwise_add", "elementwise_sub", "elementwise_mul",
               "elementwise_max", "elementwise_min"):
        add(op, {"X": x, "Y": y})
    add("elementwise_div", {"X": x, "Y": _r(3, 4, 5, lo=0.5, hi=2.0)})
    add("elementwise_pow", {"X": _r(4, 4, 5, lo=0.5, hi=2.0),
                            "Y": _r(5, 4, 5, lo=-1.0, hi=2.0)})
    add("elementwise_add", {"X": _r(6, 2, 3, 4), "Y": _r(7, 3)},
        {"axis": 1}, key="elementwise_add_axis")
    for i, op in enumerate(jops._ACTS):
        a = _r(10 + i, 3, 4, lo=0.2, hi=3.0) if op in POSITIVE \
            else _r(10 + i, 3, 4, scale=1.5)
        add(op, {"X": a}, ACT_ATTRS.get(op))
    add("scale", {"X": x}, {"scale": 1.5, "bias": -0.25})
    add("clip", {"X": x}, {"min": -0.5, "max": 0.7})
    add("cast", {"X": x}, {"out_dtype": "int64"}, diff=None)
    add("mul", {"X": _r(40, 3, 2, 4), "Y": _r(41, 8, 5)},
        {"x_num_col_dims": 1})
    add("matmul", {"X": _r(42, 2, 4, 3), "Y": _r(43, 2, 5, 4)},
        {"transpose_X": True, "transpose_Y": True})
    add("conv2d", {"Input": _r(44, 2, 3, 7, 7), "Filter": _r(45, 4, 3, 3, 3),
                   "Bias": _r(46, 4)},
        {"strides": 2, "paddings": 1, "dilations": 1}, outs=("Output",),
        diff="Output")
    add("conv2d_transpose", {"Input": _r(47, 2, 3, 4, 4),
                             "Filter": _r(48, 3, 2, 2, 2)},
        {"strides": 2, "paddings": 1}, outs=("Output",), diff="Output")
    add("conv3d", {"Input": _r(49, 1, 2, 4, 5, 5),
                   "Filter": _r(50, 3, 2, 2, 3, 3)},
        {"strides": [1, 2, 1], "paddings": [0, 1, 1]}, outs=("Output",),
        diff="Output")
    add("pool2d", {"X": _r(51, 2, 3, 6, 6)},
        {"ksize": 3, "strides": 2, "paddings": 1, "pooling_type": "max"},
        key="pool2d_max")
    add("pool2d", {"X": _r(52, 2, 3, 6, 6)},
        {"ksize": 3, "strides": 2, "paddings": 1, "pooling_type": "avg"},
        key="pool2d_avg")
    add("pool2d", {"X": _r(53, 2, 3, 5, 4)},
        {"pooling_type": "avg", "global_pooling": True}, key="pool2d_global")
    add("pool2d_with_index", {"X": _r(54, 2, 2, 6, 6)},
        {"ksize": 2, "strides": 2}, outs=("Out", "Mask"))
    add("batch_norm", {"X": _r(55, 4, 3, 3, 3), "Scale": _r(56, 3),
                       "Bias": _r(57, 3), "Mean": _r(58, 3),
                       "Variance": _r(59, 3, lo=0.5, hi=1.5)},
        {"momentum": 0.8}, outs=("Y", "MeanOut", "VarianceOut", "SavedMean",
                                 "SavedVariance"), diff="Y")
    add("lrn", {"X": _r(60, 2, 6, 3, 3)}, {"n": 3})
    add("layer_norm", {"X": _r(61, 4, 6), "Scale": _r(62, 6),
                       "Bias": _r(63, 6)}, outs=("Y",), diff="Y")
    add("softmax", {"X": _r(64, 4, 6)})
    probs = np.random.RandomState(65).dirichlet(np.ones(6), 4) \
        .astype(np.float32)
    add("cross_entropy", {"X": probs, "Label": _ints(66, 6, 4, 1)},
        outs=("Y",), diff="Y")
    add("cross_entropy", {"X": probs, "Label": np.random.RandomState(67)
                          .dirichlet(np.ones(6), 4).astype(np.float32)},
        {"soft_label": True}, outs=("Y",), diff="Y", key="cross_entropy_soft")
    add("softmax_with_cross_entropy", {"Logits": _r(68, 4, 6),
                                       "Label": _ints(69, 6, 4, 1)},
        outs=("Softmax", "Loss"), diff="Loss")
    add("sigmoid_cross_entropy_with_logits",
        {"X": _r(70, 4, 3), "Labels": _r(71, 4, 3, lo=0.0, hi=1.0)})
    add("squared_l2_distance", {"X": _r(72, 4, 3), "Y": _r(73, 4, 3)},
        outs=("sub_result", "Out"))
    add("squared_l2_norm", {"X": _r(74, 4, 3)})
    add("rank_loss", {"Label": _r(75, 4, 1, lo=0.0, hi=1.0),
                      "Left": _r(76, 4, 1), "Right": _r(77, 4, 1)})
    add("margin_rank_loss", {"Label": np.sign(_r(78, 4, 1)),
                             "X1": _r(79, 4, 1), "X2": _r(80, 4, 1)},
        {"margin": 0.3}, outs=("Out", "Activated"))
    add("smooth_l1_loss", {"X": _r(81, 4, 3), "Y": _r(82, 4, 3),
                           "InsideWeight": _r(83, 4, 3, lo=0.5, hi=1.5),
                           "OutsideWeight": _r(84, 4, 3, lo=0.5, hi=1.5)},
        {"sigma": 1.5}, outs=("Diff", "Out"))
    add("huber_loss", {"X": _r(85, 4, 1), "Y": _r(86, 4, 1)},
        {"delta": 0.5}, outs=("Residual", "Out"))
    add("lookup_table", {"W": _r(87, 10, 4), "Ids": np.array(
        [[1], [3], [1], [9]], np.int64)})
    add("gather", {"X": _r(88, 6, 3), "Index": np.array([4, 0, 4, 2],
                                                        np.int64)})
    add("scatter", {"Ref": _r(89, 6, 3), "Index": np.array([1, 4],
                                                           np.int64),
                    "Updates": _r(90, 2, 3)})
    add("reshape", {"X": x}, {"shape": [5, -1]})
    add("transpose", {"X": _r(91, 2, 3, 4)}, {"axis": [2, 0, 1]})
    add("concat", {"X": [x, _r(92, 2, 5)]}, {"axis": 0})
    add("split", {"X": _r(93, 4, 6)}, {"sections": [2, 4], "axis": 1},
        outs={"Out": 2})
    add("split", {"X": _r(94, 4, 6)}, {"num": 3, "axis": 1},
        outs={"Out": 3}, key="split_num")
    add("pad", {"X": x}, {"paddings": [1, 0, 0, 2], "pad_value": 0.5})
    add("crop", {"X": _r(95, 4, 6)}, {"offsets": [1, 2], "shape": [2, 3]})
    add("squeeze", {"X": _r(96, 3, 1, 4, 1)}, {"axes": [1, 3]})
    add("unsqueeze", {"X": _r(97, 3, 4)}, {"axes": [0, 2]})
    for i, op in enumerate(("reduce_sum", "reduce_mean", "reduce_max",
                            "reduce_min")):
        add(op, {"X": _r(98 + i, 3, 4)}, {"dim": 1, "keep_dim": True,
                                           "reduce_all": False})
        add(op, {"X": _r(102 + i, 3, 4)}, {"dim": None, "reduce_all": True},
            key=f"{op}_all")
    add("mean", {"X": x})
    add("sum", {"X": [x, y, _r(106, 4, 5)]})
    add("minus", {"X": x, "Y": y})
    add("top_k", {"X": _r(107, 4, 6)}, {"k": 2}, outs=("Out", "Indices"),
        diff=None)
    add("accuracy", {"Out": np.array([[1, 0], [2, 3], [0, 1]], np.int32),
                     "Label": np.array([[0], [1], [1]], np.int64)},
        outs=("Accuracy", "Correct", "Total"), diff=None)
    add("argmax", {"X": _r(108, 4, 6)}, {"axis": 0}, diff=None)
    add("uniform_random", {}, {"shape": [3, 4], "min": -2.0, "max": 1.0},
        diff=None)
    add("gaussian_random", {}, {"shape": [3, 4], "mean": 0.5, "std": 2.0},
        diff=None)
    add("fill_constant", {}, {"shape": [2, 3], "value": 1.5}, diff=None)
    add("fill_constant", {}, {"shape": [2], "value": 7, "dtype": "int64"},
        diff=None, key="fill_constant_int")
    add("fill_zeros_like", {"X": x}, diff=None)
    add("increment", {"X": x}, {"step": 2.5}, diff=None)
    add("dropout", {"X": _r(109, 4, 5)}, {"dropout_prob": 0.3},
        outs=("Out", "Mask"))
    add("lstm_unit", {"X": _r(110, 3, 16), "C_prev": _r(111, 3, 4)},
        {"forget_bias": 0.5}, outs=("C", "H"), diff="H")
    add("gru_unit", {"Input": _r(112, 3, 12), "HiddenPrev": _r(113, 3, 4),
                     "Weight": _r(114, 4, 12), "Bias": _r(115, 12)},
        outs=("Gate", "ResetHiddenPrev", "Hidden"), diff="Hidden")
    seq = _r(116, 7, 3)
    lod = ((0, 2, 2, 7),)          # a zero-length sequence in the middle
    for pt in ("SUM", "AVERAGE", "SQRT", "MAX", "LAST", "FIRST"):
        add("sequence_pool", {"X": _lod(seq, lod)}, {"pooltype": pt},
            key=f"sequence_pool_{pt.lower()}")
    add("sequence_softmax", {"X": _lod(_r(117, 6, 1), ((0, 2, 6),))})
    add("sequence_concat", {"X": [_lod(_r(118, 5, 2), ((0, 2, 5),)),
                                  _lod(_r(119, 3, 2), ((0, 1, 3),))]},
        {"axis": 0})
    add("sequence_concat", {"X": [_lod(_r(120, 5, 2), ((0, 2, 5),)),
                                  _lod(_r(121, 5, 3), ((0, 2, 5),))]},
        {"axis": 1}, key="sequence_concat_axis1")
    add("sequence_expand", {"X": _r(122, 3, 2),
                            "Y": _lod(_r(123, 6, 1), ((0, 1, 3, 6),))})
    p, g = _r(124, 5), _r(125, 5)
    lr = np.array([0.1], np.float32)
    pos = _r(126, 5, lo=0.1, hi=1.0)
    add("sgd", {"Param": p, "Grad": g, "LearningRate": lr},
        outs=("ParamOut",), diff=None)
    add("momentum", {"Param": p, "Grad": g, "Velocity": _r(127, 5),
                     "LearningRate": lr}, {"mu": 0.9, "use_nesterov": True},
        outs=("ParamOut", "VelocityOut"), diff=None)
    add("adagrad", {"Param": p, "Grad": g, "Moment": pos,
                    "LearningRate": lr}, outs=("ParamOut", "MomentOut"),
        diff=None)
    add("adadelta", {"Param": p, "Grad": g, "AvgSquaredGrad": pos,
                     "AvgSquaredUpdate": _r(128, 5, lo=0.1, hi=1.0),
                     "LearningRate": lr},
        outs=("ParamOut", "AvgSquaredGradOut", "AvgSquaredUpdateOut"),
        diff=None)
    add("rmsprop", {"Param": p, "Grad": g, "MeanSquare": pos,
                    "Moment": _r(129, 5), "LearningRate": lr},
        {"momentum": 0.5}, outs=("ParamOut", "MomentOut", "MeanSquareOut"),
        diff=None)
    add("decayed_adagrad", {"Param": p, "Grad": g, "Moment": pos,
                            "LearningRate": lr},
        outs=("ParamOut", "MomentOut"), diff=None)
    b1p = np.array([0.9 ** 3], np.float32)
    b2p = np.array([0.999 ** 3], np.float32)
    add("adam", {"Param": p, "Grad": g, "Moment1": _r(130, 5),
                 "Moment2": pos, "Beta1Pow": b1p, "Beta2Pow": b2p,
                 "LearningRate": lr},
        outs=("ParamOut", "Moment1Out", "Moment2Out"), diff=None)
    add("adamax", {"Param": p, "Grad": g, "Moment": _r(131, 5),
                   "InfNorm": pos, "Beta1Pow": b1p, "LearningRate": lr},
        outs=("ParamOut", "MomentOut", "InfNormOut"), diff=None)
    add("proximal_gd", {"Param": p, "Grad": g, "LearningRate": lr},
        {"l1": 0.05, "l2": 0.1}, outs=("ParamOut",), diff=None)
    add("beta_pow_update", {"Beta1Pow": b1p, "Beta2Pow": b2p},
        {"beta1": 0.9, "beta2": 0.999},
        outs=("Beta1PowOut", "Beta2PowOut"), diff=None)
    return c


CASES = _cases()
# each own program: sub-blocks, and the host-side IO ops
OWN_PROGRAM = ("recurrent", "cond", "dynamic_recurrent", "save", "restore")


def _feed_value(fluid, a):
    if isinstance(a, tuple) and a[0] == "lod":
        return fluid.LoDArray(a[1], a[2])
    return a


def _build(fluid, cases, shapes):
    """One program holding every case; with ``shapes`` (each case's
    differentiated output's shape) a loss term a case and the backward."""
    L = fluid.layers
    prog = fluid.Program()
    feed, names, terms = {}, [], []
    with fluid.program_guard(prog):
        blk = prog.global_block()
        for k, c in enumerate(cases):
            in_vars, in_names = {}, {}
            for slot, arrs in c["ins"].items():
                vs = []
                for i, a in enumerate(arrs if isinstance(arrs, list)
                                      else [arrs]):
                    name = f"c{k}_{slot}_{i}"
                    is_lod = isinstance(a, tuple)
                    data = a[1] if is_lod else a
                    v = L.data(name, data.shape, dtype=str(data.dtype),
                               lod_level=len(a[2]) if is_lod else 0,
                               append_batch_size=False)
                    v.stop_gradient = False
                    feed[name] = _feed_value(fluid, a)
                    vs.append(v)
                in_vars[slot] = vs
                in_names[slot] = [v.name for v in vs]
            outs = {s: [blk.create_var(name=f"c{k}_{s}_{j}")
                        for j in range(n)] for s, n in c["outs"].items()}
            blk.append_op(c["op"], inputs=in_vars, outputs=outs,
                          attrs=dict(c["attrs"]))
            names.append((in_names, {s: [v.name for v in vs]
                                     for s, vs in outs.items()}))
            if shapes is not None and c["diff"]:
                w = L.data(f"c{k}_cot", shapes[k], append_batch_size=False)
                feed[w.name] = _r(1000 + k, *shapes[k])
                terms.append(L.mean(L.elementwise_mul(outs[c["diff"]][0],
                                                      w)))
        if terms:
            fluid.append_backward(L.sums(terms), parameter_list=[])
    return prog, feed, names


def _jax_draws(monkeypatch):
    """The port's draw functions return JAX's draws for the same seed and
    salt (``jax.random.fold_in(PRNGKey(seed), salt)``)."""
    def key(ctx, salt):
        return jax.random.fold_in(jax.random.PRNGKey(ctx.seed), salt)

    def uniform(ctx, salt, shape, low=0.0, high=1.0):
        return torch.as_tensor(np.array(jax.random.uniform(
            key(ctx, salt), tuple(shape), minval=low, maxval=high)))

    def normal(ctx, salt, shape):
        return torch.as_tensor(np.array(jax.random.normal(
            key(ctx, salt), tuple(shape))))

    monkeypatch.setattr(tops, "draw_uniform", uniform)
    monkeypatch.setattr(tops, "draw_normal", normal)


def _run(fluid, exe, prog, feed, names, grads):
    fetch = [n for _, outs in names for ns in outs.values() for n in ns]
    got = exe.run(prog, feed=feed, fetch_list=fetch + grads,
                  scope=fluid.Scope(), seed=SEED)
    return dict(zip(fetch + grads, got))


@pytest.fixture(scope="module")
def batched():
    """Every single-op case in one program, run by both packages."""
    mp = pytest.MonkeyPatch()
    _jax_draws(mp)
    try:
        prog, feed, names = _build(tfluid, CASES, None)
        fwd = _run(tfluid, tfluid.Executor("cpu"), prog, feed, names, [])
        shapes = [np.shape(fwd[outs[c["diff"]][0]]) if c["diff"] else None
                  for c, (_, outs) in zip(CASES, names)]
        jprog, jfeed, names = _build(jfluid, CASES, shapes)
        grads = sorted({n for op in jprog.global_block().ops
                        if op.type.endswith("_grad")
                        for n in op.output("InGrad")})
        want = _run(jfluid, jfluid.Executor(), jprog, jfeed, names, grads)
        tprog, tfeed, _ = _build(tfluid, CASES, shapes)
        got = _run(tfluid, tfluid.Executor("cpu"), tprog, tfeed, names,
                   grads)
    finally:
        mp.undo()
    return names, want, got


def test_registry_matches_jax():
    """The same 103 names, each with the same family and flags."""
    assert tfluid.registered_ops() == jfluid.registered_ops()
    assert len(tfluid.registered_ops()) == 103
    for name in jfluid.registered_ops():
        j, t = jops.get(name), tops.get(name)
        assert (t.family, t.stateful_outputs, t.no_grad, t.uses_rng) == \
            (j.family, j.stateful_outputs, j.no_grad, j.uses_rng), name


def _check(a, b, tol, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert a.dtype.kind == b.dtype.kind, (what, a.dtype, b.dtype)
    if a.dtype.kind == "f":
        rtol, atol = tol or (RTOL, ATOL)
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=what)
    else:
        np.testing.assert_array_equal(a, b, err_msg=what)


def _own_program_case(op):
    """(build(fluid) -> (prog, feed, fetch names)) of an op that needs
    sub-blocks: a small forward with a loss whose gradients reach the
    op's inputs and parameters through every step."""
    def build(fluid):
        L = fluid.layers
        prog = fluid.Program()
        with fluid.program_guard(prog):
            if op == "recurrent":
                x = L.data("x", [4, 2, 3], append_batch_size=False)
                x.stop_gradient = False
                rnn = L.StaticRNN()
                with rnn.step():
                    xt = rnn.step_input(x)
                    h_prev = rnn.memory(shape=(2, 5), init_value=0.1)
                    h = L.fc([xt, h_prev], size=5, act="tanh", name="srnn")
                    rnn.update_memory(h_prev, h)
                    rnn.step_output(h)
                out = rnn()
                feed, shape = {"x": _r(200, 4, 2, 3)}, (4, 2, 5)
            elif op == "cond":
                x = L.data("x", [3])
                x.stop_gradient = False
                pred = L.data("pred", [1])
                out = L.cond(pred, lambda: L.fc(x, size=2, act="tanh"),
                             lambda: L.scale(L.fc(x, size=2), scale=-0.5))
                feed = {"x": _r(201, 5, 3),
                        "pred": np.array([1, 0, 0, 1, 1], np.float32)}
                shape = (5, 2)
            else:
                x = L.data("x", [3], lod_level=1)
                x.stop_gradient = False
                drnn = L.DynamicRNN(reverse=True)
                with drnn.step():
                    xt = drnn.step_input(x)
                    h = drnn.memory(shape=(3, 4))
                    s = L.fc([xt, h], size=4, act="tanh", name="drnn")
                    drnn.update_memory(h, s)
                    drnn.step_output(s)
                out = drnn()
                feed = {"x": fluid.LoDArray(_r(202, 7, 3),
                                            ((0, 3, 4, 7),))}
                shape = (7, 4)
            w = L.data("w", shape, append_batch_size=False)
            feed["w"] = _r(203, *shape)
            loss = L.mean(L.elementwise_mul(out, w))
            pg = fluid.append_backward(loss)
        return prog, feed, [loss.name, out.name, "x@GRAD"] + \
            sorted(g.name for _, g in pg)

    return build


@pytest.mark.parametrize("case", CASES + [dict(key=k) for k in OWN_PROGRAM],
                         ids=lambda c: c["key"])
def test_op_forward_and_grad_match_jax(case, batched, tmp_path):
    if case["key"] in ("recurrent", "cond", "dynamic_recurrent"):
        build = _own_program_case(case["key"])
        got = {}
        for name, fluid, exe in (("jax", jfluid, jfluid.Executor()),
                                 ("torch", tfluid,
                                  tfluid.Executor("cpu"))):
            prog, feed, fetch = build(fluid)
            got[name] = exe.run(prog, feed=feed, fetch_list=fetch,
                                scope=fluid.Scope(), seed=SEED)
        for n, a, b in zip(fetch, got["torch"], got["jax"]):
            _check(a, b, None, n)
        return
    if case["key"] in ("save", "restore"):
        _check_io_across_packages(case["key"], tmp_path)
        return
    names, want, got = batched
    k = CASES.index(case)
    in_names, out_names = names[k]
    for slot, ns in out_names.items():
        for n in ns:
            _check(got[n], want[n], case["tol"], f"{case['key']} {slot}")
    for slot, ns in in_names.items():
        for n in ns:
            g = n + "@GRAD"
            if g in want:
                _check(got[g], want[g], case["tol"], f"{case['key']} d{slot}")
    if case["diff"]:
        assert any(n + "@GRAD" in want for ns in in_names.values()
                   for n in ns), case["key"]


def _io_program(fluid, tmp_path):
    L = fluid.layers
    prog = fluid.Program()
    with fluid.program_guard(prog):
        x = L.data("x", [4])
        h = L.fc(x, size=3, act="relu", name="io_fc")
        loss = L.mean(h)
        fluid.optimizer.MomentumOptimizer(0.1, 0.9).minimize(loss)
    return prog, loss


def _check_io_across_packages(which, tmp_path):
    """A directory one package saves, the other restores: the values
    equal the saver's bit for bit (``save`` case: JAX saves, the port
    restores; ``restore`` case: the port saves, JAX restores)."""
    feed = {"x": _r(210, 6, 4)}
    src, dst = (jfluid, tfluid) if which == "save" else (tfluid, jfluid)
    exes = {jfluid: jfluid.Executor(), tfluid: tfluid.Executor("cpu")}
    prog, loss = _io_program(src, tmp_path)
    scope = src.Scope()
    for _ in range(2):
        exes[src].run(prog, feed=feed, fetch_list=[loss], scope=scope)
    src.io.save_persistables(exes[src], str(tmp_path), main_program=prog,
                             scope=scope)
    dprog, _ = _io_program(dst, tmp_path)
    dscope = dst.Scope()
    dst.io.load_persistables(exes[dst], str(tmp_path), main_program=dprog,
                             scope=dscope)
    assert sorted(dscope.values) == sorted(scope.values)
    for n, v in scope.values.items():
        a = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
            else np.asarray(v)
        b = dscope.values[n]
        b = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) \
            else np.asarray(b)
        np.testing.assert_array_equal(a, b, err_msg=n)


def test_port_draws_have_their_distribution():
    """Unpatched, the port's generators: uniform within [min, max) with
    its mean, normal with its mean and std; a run's seed repeats its
    draws, another seed does not."""
    L = tfluid.layers
    prog = tfluid.Program()
    with tfluid.program_guard(prog):
        blk = prog.global_block()
        u, g = blk.create_var(), blk.create_var()
        blk.append_op("uniform_random", outputs={"Out": u},
                      attrs={"shape": [20000], "min": -2.0, "max": 1.0})
        blk.append_op("gaussian_random", outputs={"Out": g},
                      attrs={"shape": [20000], "mean": 0.5, "std": 2.0})
    del L
    exe = tfluid.Executor("cpu")
    uv, gv = exe.run(prog, fetch_list=[u, g], scope=tfluid.Scope(), seed=42)
    assert -2.0 <= uv.min() and uv.max() < 1.0
    assert abs(uv.mean() + 0.5) < 0.03 and abs(uv.std() - 3 / 12 ** 0.5) \
        < 0.03
    assert abs(gv.mean() - 0.5) < 0.06 and abs(gv.std() - 2.0) < 0.06
    again = exe.run(prog, fetch_list=[u], scope=tfluid.Scope(), seed=42)[0]
    other = exe.run(prog, fetch_list=[u], scope=tfluid.Scope(), seed=43)[0]
    np.testing.assert_array_equal(again, uv)
    assert not np.array_equal(other, uv)


def test_dropout_gradient_goes_through_the_drawn_mask():
    """Grad ops never recompute a forward: the gradient of
    sum(dropout(x) * w) is mask * w / (1 - p) for the mask the forward
    drew, whatever the generator would draw next."""
    L = tfluid.layers
    prog = tfluid.Program()
    with tfluid.program_guard(prog):
        x = L.data("x", [6])
        x.stop_gradient = False
        w = L.data("w", [6])
        d = L.dropout(x, dropout_prob=0.5)
        loss = L.reduce_sum(L.elementwise_mul(d, w))
        tfluid.append_backward(loss, parameter_list=[])
    mask = [op for op in prog.global_block().ops
            if op.type == "dropout"][0].output("Mask")[0]
    calls = []
    real = tops.draw_uniform

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    feed = {"x": _r(220, 8, 6), "w": _r(221, 8, 6)}
    tops.draw_uniform = counted
    try:
        m, gx = tfluid.Executor("cpu").run(
            prog, feed=feed, fetch_list=[mask, "x@GRAD"],
            scope=tfluid.Scope(), seed=5)
    finally:
        tops.draw_uniform = real
    assert len(calls) == 1                 # one draw: the forward's
    assert 0 < m.sum() < m.size
    np.testing.assert_allclose(gx, m * feed["w"] / 0.5, rtol=RTOL,
                               atol=ATOL)

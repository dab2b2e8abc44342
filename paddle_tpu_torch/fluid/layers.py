"""Fluid-analog python layer builders: append ops/vars to the Program (the
port of ``paddle_tpu/fluid/layers.py``, pure Python, copied).

Reference analog: python/paddle/v2/framework/layers.py (fc/embedding/conv2d/
pool2d/cross_entropy/StaticRNN; auto-generated op wrappers `_create_op_func_`
layers.py:98) and layer_helper.py.

These only BUILD the Program; the Executor runs it.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from paddle_tpu_torch.fluid.framework import (Parameter, Program, Variable,
                                        default_main_program)
from paddle_tpu_torch.platform.enforce import EnforceError, enforce_that


def _block():
    return default_main_program().current_block()


def _tmp(shape=(), dtype="float32", lod_level=0):
    return _block().create_var(shape=shape, dtype=dtype, lod_level=lod_level)


def _to_var(x, like: Variable) -> Variable:
    """Literal scalars become fill_constant vars (expression sugar)."""
    if isinstance(x, Variable):
        return x
    out = _tmp(shape=(1,), dtype=like.dtype)
    _block().append_op("fill_constant", outputs={"Out": out},
                       attrs={"shape": [1], "value": float(x),
                              "dtype": like.dtype})
    return out


# ---------------------------------------------------------------------------
# data / parameters
# ---------------------------------------------------------------------------


def data(name: str, shape: Sequence[int], dtype="float32",
         lod_level: int = 0, append_batch_size: bool = True) -> Variable:
    """Feed placeholder (v2/framework/layers.py data)."""
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    b = default_main_program().global_block()
    v = b.create_var(name=name, shape=shape, dtype=dtype,
                     lod_level=lod_level)
    v.stop_gradient = True
    return v


def create_parameter(shape, dtype="float32", name=None, initializer=None,
                     trainable=True) -> Parameter:
    return default_main_program().global_block().create_parameter(
        name=name, shape=shape, dtype=dtype, initializer=initializer,
        trainable=trainable)



def _conv_out(hw, k, stride, pad, dil=1):
    return (hw + 2 * pad - dil * (k - 1) - 1) // stride + 1


def _pair2(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (int(v), int(v))

# ---------------------------------------------------------------------------
# core layers
# ---------------------------------------------------------------------------


def fc(input, size: int, act: Optional[str] = None, bias_attr=True,
       num_flatten_dims: int = 1, param_initializer=None,
       name: Optional[str] = None) -> Variable:
    inputs = input if isinstance(input, (list, tuple)) else [input]
    prog = default_main_program()
    name = name or prog.unique_name("fc")
    mul_outs = []
    for i, inp in enumerate(inputs):
        in_dim = int(np.prod(inp.shape[num_flatten_dims:]))
        w = create_parameter((in_dim, size), dtype=inp.dtype,
                             name=f"{name}.w_{i}",
                             initializer=param_initializer)
        out = _tmp(shape=tuple(inp.shape[:num_flatten_dims]) + (size,),
                   lod_level=inp.lod_level)
        _block().append_op("mul", inputs={"X": inp, "Y": w},
                           outputs={"Out": out},
                           attrs={"x_num_col_dims": num_flatten_dims,
                                  "y_num_col_dims": 1})
        mul_outs.append(out)
    pre = mul_outs[0]
    if len(mul_outs) > 1:
        s = _tmp(shape=pre.shape)
        _block().append_op("sum", inputs={"X": mul_outs},
                           outputs={"Out": s})
        pre = s
    if bias_attr:
        b = create_parameter((size,), dtype=pre.dtype, name=f"{name}.b",
                             initializer={"type": "constant", "value": 0.0})
        out = _tmp(shape=pre.shape, lod_level=pre.lod_level)
        _block().append_op("elementwise_add", inputs={"X": pre, "Y": b},
                           outputs={"Out": out}, attrs={"axis": -1})
        pre = out
    return _apply_act(pre, act)


def embedding(input, size, dtype="float32", param_name=None,
              name=None) -> Variable:
    vocab, dim = size
    w = create_parameter((vocab, dim), dtype=dtype,
                         name=param_name
                         or default_main_program().unique_name("emb.w"),
                         initializer={"type": "uniform", "low": -0.1,
                                      "high": 0.1})
    out = _tmp(shape=(-1, dim), dtype=dtype, lod_level=input.lod_level)
    _block().append_op("lookup_table", inputs={"W": w, "Ids": input},
                       outputs={"Out": out})
    return out


def conv2d(input, num_filters: int, filter_size, stride=1, padding=0,
           dilation=1, groups: int = 1, act: Optional[str] = None,
           bias_attr=True, name: Optional[str] = None) -> Variable:
    prog = default_main_program()
    name = name or prog.unique_name("conv2d")
    k = filter_size if isinstance(filter_size, (list, tuple)) \
        else (filter_size, filter_size)
    in_ch = int(input.shape[1])
    w = create_parameter((num_filters, in_ch // groups, k[0], k[1]),
                         dtype=input.dtype, name=f"{name}.w")
    ins = {"Input": input, "Filter": w}
    if bias_attr:
        ins["Bias"] = create_parameter(
            (num_filters,), dtype=input.dtype, name=f"{name}.b",
            initializer={"type": "constant", "value": 0.0})
    st, pd = _pair2(stride), _pair2(padding)
    dl = _pair2(dilation)
    h, w_ = int(input.shape[2]), int(input.shape[3])
    out = _tmp(shape=(input.shape[0], num_filters,
                      _conv_out(h, k[0], st[0], pd[0], dl[0]),
                      _conv_out(w_, k[1], st[1], pd[1], dl[1])))
    _block().append_op("conv2d", inputs=ins, outputs={"Output": out},
                       attrs={"strides": stride, "paddings": padding,
                              "dilations": dilation, "groups": groups})
    return _apply_act(out, act)


def conv2d_transpose(input, num_filters: int, filter_size, stride=1,
                     padding=0, name=None) -> Variable:
    prog = default_main_program()
    name = name or prog.unique_name("conv2d_transpose")
    k = filter_size if isinstance(filter_size, (list, tuple)) \
        else (filter_size, filter_size)
    in_ch = int(input.shape[1])
    w = create_parameter((in_ch, num_filters, k[0], k[1]),
                         dtype=input.dtype, name=f"{name}.w")
    st, pd = _pair2(stride), _pair2(padding)
    h, w_ = int(input.shape[2]), int(input.shape[3])
    out = _tmp(shape=(input.shape[0], num_filters,
                      (h - 1) * st[0] - 2 * pd[0] + k[0],
                      (w_ - 1) * st[1] - 2 * pd[1] + k[1]))
    _block().append_op("conv2d_transpose",
                       inputs={"Input": input, "Filter": w},
                       outputs={"Output": out},
                       attrs={"strides": stride, "paddings": padding})
    return out


def pool2d(input, pool_size=2, pool_type="max", pool_stride=None,
           pool_padding=0, global_pooling=False) -> Variable:
    if global_pooling:
        shape = (input.shape[0], input.shape[1], 1, 1)
    else:
        k, st = _pair2(pool_size), _pair2(pool_stride or pool_size)
        pd = _pair2(pool_padding)
        shape = (input.shape[0], input.shape[1],
                 _conv_out(int(input.shape[2]), k[0], st[0], pd[0]),
                 _conv_out(int(input.shape[3]), k[1], st[1], pd[1]))
    out = _tmp(shape=shape)
    _block().append_op("pool2d", inputs={"X": input}, outputs={"Out": out},
                       attrs={"ksize": pool_size,
                              "strides": pool_stride or pool_size,
                              "paddings": pool_padding,
                              "pooling_type": pool_type,
                              "global_pooling": global_pooling})
    return out


def batch_norm(input, act: Optional[str] = None, momentum=0.9, epsilon=1e-5,
               data_layout="NCHW", name=None) -> Variable:
    prog = default_main_program()
    name = name or prog.unique_name("batch_norm")
    c = int(input.shape[1 if data_layout == "NCHW" else -1])
    g = prog.global_block()
    scale = create_parameter((c,), input.dtype, f"{name}.scale",
                             initializer={"type": "constant", "value": 1.0})
    bias = create_parameter((c,), input.dtype, f"{name}.bias",
                            initializer={"type": "constant", "value": 0.0})
    mean = g.create_var(name=f"{name}.mean", shape=(c,), dtype=input.dtype,
                        persistable=True)
    mean.initializer = {"type": "constant", "value": 0.0}
    var = g.create_var(name=f"{name}.variance", shape=(c,),
                       dtype=input.dtype, persistable=True)
    var.initializer = {"type": "constant", "value": 1.0}
    y = _tmp(shape=input.shape)
    saved_m, saved_v = _tmp(shape=(c,)), _tmp(shape=(c,))
    _block().append_op(
        "batch_norm",
        inputs={"X": input, "Scale": scale, "Bias": bias, "Mean": mean,
                "Variance": var},
        outputs={"Y": y, "MeanOut": mean, "VarianceOut": var,
                 "SavedMean": saved_m, "SavedVariance": saved_v},
        attrs={"momentum": momentum, "epsilon": epsilon,
               "data_layout": data_layout})
    return _apply_act(y, act)


def dropout(x, dropout_prob=0.5, is_test=False) -> Variable:
    out = _tmp(shape=x.shape, lod_level=x.lod_level)
    mask = _tmp(shape=x.shape)
    _block().append_op("dropout", inputs={"X": x},
                       outputs={"Out": out, "Mask": mask},
                       attrs={"dropout_prob": dropout_prob,
                              "is_test": is_test})
    return out


# ---------------------------------------------------------------------------
# losses / metrics
# ---------------------------------------------------------------------------


def cross_entropy(input, label, soft_label=False) -> Variable:
    out = _tmp(shape=(input.shape[0], 1), lod_level=input.lod_level)
    _block().append_op("cross_entropy", inputs={"X": input, "Label": label},
                       outputs={"Y": out},
                       attrs={"soft_label": soft_label})
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False):
    softmax = _tmp(shape=logits.shape)
    loss = _tmp(shape=(logits.shape[0], 1))
    _block().append_op("softmax_with_cross_entropy",
                       inputs={"Logits": logits, "Label": label},
                       outputs={"Softmax": softmax, "Loss": loss},
                       attrs={"soft_label": soft_label})
    return loss


def square_error_cost(input, label) -> Variable:
    sub = _tmp(shape=input.shape)
    out = _tmp(shape=(input.shape[0], 1))
    _block().append_op("squared_l2_distance",
                       inputs={"X": input, "Y": label},
                       outputs={"sub_result": sub, "Out": out})
    return out


def accuracy(input, label, k: int = 1) -> Variable:
    topk_out, topk_idx = _tmp(), _tmp(dtype="int64")
    _block().append_op("top_k", inputs={"X": input},
                       outputs={"Out": topk_out, "Indices": topk_idx},
                       attrs={"k": k})
    acc = _tmp()
    correct = _tmp(dtype="int64")
    total = _tmp(dtype="int64")
    _block().append_op("accuracy",
                       inputs={"Out": topk_idx, "Label": label},
                       outputs={"Accuracy": acc, "Correct": correct,
                                "Total": total})
    acc.stop_gradient = True
    return acc


def mean(x) -> Variable:
    out = _tmp(shape=())
    _block().append_op("mean", inputs={"X": x}, outputs={"Out": out})
    return out


def sums(inputs) -> Variable:
    inputs = list(inputs)
    out = _tmp(shape=inputs[0].shape)
    _block().append_op("sum", inputs={"X": list(inputs)},
                       outputs={"Out": out})
    return out


# ---------------------------------------------------------------------------
# auto-generated unary / misc wrappers (`_create_op_func_` analog)
# ---------------------------------------------------------------------------


def _make_unary(op_type):
    def f(x, **attrs):
        out = _tmp(shape=getattr(x, "shape", ()),
                   lod_level=getattr(x, "lod_level", 0))
        _block().append_op(op_type, inputs={"X": x}, outputs={"Out": out},
                           attrs=attrs)
        return out
    f.__name__ = op_type
    return f


for _op in ["sigmoid", "logsigmoid", "exp", "relu", "tanh", "sqrt", "abs",
            "reciprocal", "log", "square", "softsign", "brelu", "soft_relu",
            "pow", "stanh", "leaky_relu", "relu6", "softplus", "elu", "sign",
            "floor", "ceil", "round", "softmax"]:
    globals()[_op] = _make_unary(_op)


def _elementwise(op_type, x, y, axis=-1):
    y = _to_var(y, x) if not isinstance(y, Variable) else y
    x = _to_var(x, y) if not isinstance(x, Variable) else x
    shape = x.shape if len(x.shape) >= len(y.shape) else y.shape
    out = _tmp(shape=shape, lod_level=max(x.lod_level, y.lod_level))
    _block().append_op(op_type, inputs={"X": x, "Y": y},
                       outputs={"Out": out}, attrs={"axis": axis})
    return out


def elementwise_add(x, y, axis=-1):
    return _elementwise("elementwise_add", x, y, axis)


def elementwise_sub(x, y, axis=-1):
    return _elementwise("elementwise_sub", x, y, axis)


def elementwise_mul(x, y, axis=-1):
    return _elementwise("elementwise_mul", x, y, axis)


def elementwise_div(x, y, axis=-1):
    return _elementwise("elementwise_div", x, y, axis)


def scale(x, scale=1.0, bias=0.0) -> Variable:
    out = _tmp(shape=x.shape, lod_level=x.lod_level)
    _block().append_op("scale", inputs={"X": x}, outputs={"Out": out},
                       attrs={"scale": scale, "bias": bias})
    return out


def cast(x, dtype) -> Variable:
    out = _tmp(shape=x.shape, dtype=dtype, lod_level=x.lod_level)
    _block().append_op("cast", inputs={"X": x}, outputs={"Out": out},
                       attrs={"out_dtype": dtype})
    return out


def clip(x, min, max) -> Variable:
    out = _tmp(shape=x.shape, lod_level=x.lod_level)
    _block().append_op("clip", inputs={"X": x}, outputs={"Out": out},
                       attrs={"min": min, "max": max})
    return out


def concat(inputs, axis=0) -> Variable:
    out = _tmp()
    _block().append_op("concat", inputs={"X": list(inputs)},
                       outputs={"Out": out}, attrs={"axis": axis})
    return out


def reshape(x, shape) -> Variable:
    out = _tmp(shape=tuple(shape))
    _block().append_op("reshape", inputs={"X": x}, outputs={"Out": out},
                       attrs={"shape": list(shape)})
    return out


def transpose(x, perm) -> Variable:
    out = _tmp(shape=tuple(x.shape[p] for p in perm) if x.shape else ())
    _block().append_op("transpose", inputs={"X": x}, outputs={"Out": out},
                       attrs={"axis": list(perm)})
    return out


def crop(x, offsets, shape) -> Variable:
    out = _tmp(shape=tuple(shape))
    _block().append_op("crop", inputs={"X": x}, outputs={"Out": out},
                       attrs={"offsets": list(offsets),
                              "shape": list(shape)})
    return out


def pad(x, paddings, pad_value=0.0) -> Variable:
    out = _tmp()
    _block().append_op("pad", inputs={"X": x}, outputs={"Out": out},
                       attrs={"paddings": list(paddings),
                              "pad_value": pad_value})
    return out


def split(x, num_or_sections, axis=0) -> List[Variable]:
    if isinstance(num_or_sections, int):
        n = num_or_sections
        attrs = {"num": n, "axis": axis}
    else:
        n = len(num_or_sections)
        attrs = {"sections": list(num_or_sections), "axis": axis}
    outs = [_tmp() for _ in range(n)]
    _block().append_op("split", inputs={"X": x}, outputs={"Out": outs},
                       attrs=attrs)
    return outs


def topk(x, k=1):
    vals, idx = _tmp(), _tmp(dtype="int64")
    _block().append_op("top_k", inputs={"X": x},
                       outputs={"Out": vals, "Indices": idx},
                       attrs={"k": k})
    return vals, idx


def reduce_sum(x, dim=None, keep_dim=False) -> Variable:
    out = _tmp()
    _block().append_op("reduce_sum", inputs={"X": x}, outputs={"Out": out},
                       attrs={"dim": dim, "keep_dim": keep_dim,
                              "reduce_all": dim is None})
    return out


def reduce_mean(x, dim=None, keep_dim=False) -> Variable:
    out = _tmp()
    _block().append_op("reduce_mean", inputs={"X": x}, outputs={"Out": out},
                       attrs={"dim": dim, "keep_dim": keep_dim,
                              "reduce_all": dim is None})
    return out


def sequence_pool(input, pool_type="average") -> Variable:
    out = _tmp(shape=input.shape)
    _block().append_op("sequence_pool", inputs={"X": input},
                       outputs={"Out": out},
                       attrs={"pooltype": pool_type.upper()})
    return out


def sequence_softmax(input) -> Variable:
    out = _tmp(lod_level=input.lod_level)
    _block().append_op("sequence_softmax", inputs={"X": input},
                       outputs={"Out": out})
    return out


def sequence_expand(x, y) -> Variable:
    out = _tmp(lod_level=max(1, y.lod_level))
    _block().append_op("sequence_expand", inputs={"X": x, "Y": y},
                       outputs={"Out": out})
    return out


def _apply_act(x: Variable, act: Optional[str]) -> Variable:
    if act is None:
        return x
    enforce_that(act in ("sigmoid", "relu", "tanh", "softmax", "sqrt",
                         "abs", "log", "exp", "square", "brelu",
                         "soft_relu", "stanh", "leaky_relu", "softsign"),
                 f"unknown activation {act!r}", context="fluid")
    return globals()[act](x)


# ---------------------------------------------------------------------------
# StaticRNN (layers.py:333 analog): builds a sub-block run once a step
# ---------------------------------------------------------------------------


class StaticRNN:
    """Time-major static RNN.

    Usage::

        rnn = StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)          # x: [T, B, D]
            h_prev = rnn.memory(shape=(B, H), init_value=0.)
            h = some_layers(x_t, h_prev)
            rnn.update_memory(h_prev, h)
            rnn.step_output(h)
        outs = rnn()                          # [T, B, H]
    """

    def __init__(self):
        self.program = default_main_program()
        self.sub_block = None
        self._seq_inputs: List[Variable] = []       # outer [T, ...] vars
        self._step_inputs: List[Variable] = []      # sub-block per-step vars
        self._init_states: List[Variable] = []
        self._state_in: List[Variable] = []
        self._state_out: List[Optional[Variable]] = []
        self._step_outputs: List[Variable] = []
        self._built = False

    class _Guard:
        def __init__(self, rnn):
            self.rnn = rnn

        def __enter__(self):
            self.rnn.sub_block = self.rnn.program.create_block()
            return self.rnn

        def __exit__(self, *exc):
            self.rnn.program.rollback()
            return False

    def step(self):
        return self._Guard(self)

    def step_input(self, x: Variable) -> Variable:
        self._seq_inputs.append(x)
        v = self.sub_block.create_var(
            name=self.program.unique_name("rnn_step_in"),
            shape=x.shape[1:], dtype=x.dtype)
        self._step_inputs.append(v)
        return v

    def memory(self, init: Optional[Variable] = None, shape=None,
               init_value: float = 0.0, dtype="float32") -> Variable:
        if init is None:
            enforce_that(shape is not None, "memory needs init or shape",
                         context="StaticRNN")
            g = self.program.global_block()
            init = g.create_var(
                name=self.program.unique_name("rnn_init"),
                shape=shape, dtype=dtype, persistable=True)
            init.initializer = {"type": "constant", "value": init_value}
        self._init_states.append(init)
        v = self.sub_block.create_var(
            name=self.program.unique_name("rnn_mem"),
            shape=init.shape, dtype=init.dtype)
        self._state_in.append(v)
        self._state_out.append(None)
        return v

    def update_memory(self, mem: Variable, new: Variable) -> None:
        i = self._state_in.index(mem)
        self._state_out[i] = new

    def step_output(self, o: Variable) -> None:
        self._step_outputs.append(o)

    def __call__(self):
        enforce_that(not self._built, "StaticRNN already finalized",
                     context="StaticRNN")
        enforce_that(all(s is not None for s in self._state_out),
                     "every memory needs update_memory", context="StaticRNN")
        self._built = True
        # every parent-block var the step graph reads (parameters, biases)
        # is routed through the op's Parameters slot so autodiff sees it
        local = set(self.sub_block.vars)
        used, seen = [], set()
        for op in self.sub_block.ops:
            for n in op.input_names():
                if n not in local and n not in seen:
                    seen.add(n)
                    used.append(self.program.global_block().var(n))
        outs = [self.program.global_block().create_var(
            name=self.program.unique_name("rnn_out"), dtype=o.dtype)
            for o in self._step_outputs]
        finals = [self.program.global_block().create_var(
            name=self.program.unique_name("rnn_final"), dtype=s.dtype)
            for s in self._state_out]
        self.program.global_block().append_op(
            "recurrent",
            inputs={"Inputs": self._seq_inputs,
                    "InitStates": self._init_states,
                    "Parameters": used},
            outputs={"Outputs": outs, "FinalStates": finals},
            attrs={"sub_block": self.sub_block.idx,
                   "step_inputs": [v.name for v in self._step_inputs],
                   "step_states_in": [v.name for v in self._state_in],
                   "step_states_out": [v.name for v in self._state_out],
                   "step_outputs": [v.name for v in self._step_outputs],
                   "param_names": [v.name for v in used]})
        return outs[0] if len(outs) == 1 else outs


def _collect_outer_vars(program, sub_blocks):
    """Parent-block vars read by sub-block ops, routed through the op's
    input slots so program-level autodiff reaches them (StaticRNN-style)."""
    used, seen = [], set()
    for sub in sub_blocks:
        local = set(sub.vars)
        for op in sub.ops:
            for n in op.input_names():
                if n not in local and n not in seen:
                    seen.add(n)
                    used.append(program.global_block().var(n))
    return used


def cond(pred: Variable, true_fn, false_fn):
    """Dynamic if-else (cond_op.h analog): ``pred`` is a per-row [N] mask;
    row i of the output comes from ``true_fn``'s graph where pred[i] else
    ``false_fn``'s. Both branch graphs are built as sub-blocks; both
    run on the full batch and a masked merge selects rows (static shapes —
    see the cond op docstring in ops.py). Each fn takes no args, reads
    enclosing vars, and returns one Variable (or a list, matched 1:1)."""
    prog = default_main_program()
    tb = prog.create_block()
    t_out = true_fn()
    prog.rollback()
    fb = prog.create_block()
    f_out = false_fn()
    prog.rollback()
    t_outs = t_out if isinstance(t_out, (list, tuple)) else [t_out]
    f_outs = f_out if isinstance(f_out, (list, tuple)) else [f_out]
    enforce_that(len(t_outs) == len(f_outs),
                 "cond branches must return the same number of outputs",
                 context="cond")
    used = _collect_outer_vars(prog, [tb, fb])
    outs = [prog.global_block().create_var(
        name=prog.unique_name("cond_out"), shape=o.shape, dtype=o.dtype)
        for o in t_outs]
    prog.global_block().append_op(
        "cond",
        inputs={"Cond": pred, "Xs": used},
        outputs={"Out": outs},
        attrs={"true_block": tb.idx, "false_block": fb.idx,
               "true_outputs": [v.name for v in t_outs],
               "false_outputs": [v.name for v in f_outs],
               "x_names": [v.name for v in used]})
    return outs[0] if len(outs) == 1 else outs


class DynamicRNN:
    """Variable-length RNN over a LoD input (dynamic_recurrent_op analog).

    Same shape as StaticRNN but ``step_input`` takes a lod_level-1 var
    (ragged rows); the op packs it to padded time-major once, scans with
    mask-gated memories, and returns a LoD output in the input's order::

        drnn = DynamicRNN()
        with drnn.step():
            x_t = drnn.step_input(x)              # x: LoD rows [R, D]
            h_prev = drnn.memory(shape=(B, H))
            h = some_layers(x_t, h_prev)
            drnn.update_memory(h_prev, h)
            drnn.step_output(h)
        out = drnn()                              # LoD rows [R, H]
    """

    def __init__(self, reverse: bool = False):
        self.program = default_main_program()
        self.sub_block = None
        self.reverse = reverse
        self._seq_input: Optional[Variable] = None
        self._step_in: Optional[Variable] = None
        self._init_states: List[Variable] = []
        self._state_in: List[Variable] = []
        self._state_out: List[Optional[Variable]] = []
        self._step_outputs: List[Variable] = []
        self._built = False

    class _Guard:
        def __init__(self, rnn):
            self.rnn = rnn

        def __enter__(self):
            self.rnn.sub_block = self.rnn.program.create_block()
            return self.rnn

        def __exit__(self, *exc):
            self.rnn.program.rollback()
            return False

    def step(self):
        return self._Guard(self)

    def step_input(self, x: Variable) -> Variable:
        enforce_that(self._seq_input is None,
                     "DynamicRNN supports one sequence input",
                     context="DynamicRNN")
        enforce_that(x.lod_level >= 1, "DynamicRNN input must be LoD",
                     context="DynamicRNN")
        self._seq_input = x
        v = self.sub_block.create_var(
            name=self.program.unique_name("drnn_step_in"),
            shape=x.shape, dtype=x.dtype)
        self._step_in = v
        return v

    def memory(self, init: Optional[Variable] = None, shape=None,
               init_value: float = 0.0, dtype="float32") -> Variable:
        if init is None:
            enforce_that(shape is not None, "memory needs init or shape",
                         context="DynamicRNN")
            g = self.program.global_block()
            init = g.create_var(
                name=self.program.unique_name("drnn_init"),
                shape=shape, dtype=dtype, persistable=True)
            init.initializer = {"type": "constant", "value": init_value}
        self._init_states.append(init)
        v = self.sub_block.create_var(
            name=self.program.unique_name("drnn_mem"),
            shape=init.shape, dtype=init.dtype)
        self._state_in.append(v)
        self._state_out.append(None)
        return v

    def update_memory(self, mem: Variable, new: Variable) -> None:
        i = self._state_in.index(mem)
        self._state_out[i] = new

    def step_output(self, o: Variable) -> None:
        self._step_outputs.append(o)

    def __call__(self):
        enforce_that(not self._built, "DynamicRNN already finalized",
                     context="DynamicRNN")
        enforce_that(self._seq_input is not None, "no step_input",
                     context="DynamicRNN")
        enforce_that(all(s is not None for s in self._state_out),
                     "every memory needs update_memory", context="DynamicRNN")
        self._built = True
        used = _collect_outer_vars(self.program, [self.sub_block])
        outs = [self.program.global_block().create_var(
            name=self.program.unique_name("drnn_out"), dtype=o.dtype,
            shape=(-1,) + tuple(o.shape[1:]), lod_level=1)
            for o in self._step_outputs]
        finals = [self.program.global_block().create_var(
            name=self.program.unique_name("drnn_final"), dtype=s.dtype)
            for s in self._state_out]
        self.program.global_block().append_op(
            "dynamic_recurrent",
            inputs={"Inputs": self._seq_input,
                    "InitStates": self._init_states,
                    "Parameters": used},
            outputs={"Outputs": outs, "FinalStates": finals},
            attrs={"sub_block": self.sub_block.idx,
                   "step_inputs": [self._step_in.name],
                   "step_states_in": [v.name for v in self._state_in],
                   "step_states_out": [v.name for v in self._state_out],
                   "step_outputs": [v.name for v in self._step_outputs],
                   "param_names": [v.name for v in used],
                   "reverse": self.reverse})
        return outs[0] if len(outs) == 1 else outs

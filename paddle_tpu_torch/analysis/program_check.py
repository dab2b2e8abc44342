"""Static program verifier: abstract interpretation over fluid Programs
(the port of ``paddle_tpu/analysis/program_check.py``, pure Python,
copied: the same rules, codes and severities).

Reference analog: the Gen-2 Fluid design validates a ``ProgramDesc``
before execution (InferShape / InferVarType passes over each OpDesc);
without it a shape mismatch or def-before-use bug only surfaces as a
runtime failure deep inside an op.  This pass walks ``Program`` /
``Block`` / ``Operator`` with a per-op-type shape+dtype inference
registry and reports structured :class:`Diagnostic`\\ s:

- ``undefined-var``   — an op reads a name no block in scope declares;
- ``def-before-use``  — an op reads a name whose only writers come later
  in the same block (a misordered graph);
- ``dangling-fetch``  — a fetch target nothing produces or stores;
- ``unknown-feed``    — a feed name no block declares (a typo that
  today would be *silently ignored*);
- ``dead-var``        — an op none of whose outputs reach a fetch,
  a persistable store, or a stateful slot (only checked when the fetch
  list is known — severity WARNING, the prune() candidate set);
- ``duplicate-writer``— two ops write one name (gradient fan-in
  ``@GRAD`` accumulation, declared stateful outputs, and in-place
  updates through an op's own input are the three sanctioned aliases);
- ``shape-mismatch`` / ``dtype-mismatch`` — per-op inference rules
  prove the op cannot execute (matmul inner dims, conv channels,
  non-broadcastable elementwise, integer labels expected, ...).

Shapes are abstract: ``None`` marks an unknown dim (``-1`` batch dims
normalize to it) and a var may be wholly unknown — declared shapes of
intermediate temporaries are builder hints, often empty, so inference
trusts only leaf declarations (feeds, parameters, persistables) and
per-op rules.  Ops without a registered rule produce unknown outputs;
the verifier NEVER guesses, so a clean report means "provably
well-formed where the registry has a rule", not "no rule fired".

Entry points: :func:`verify_program` (used inline by ``Executor.run``
behind ``FLAGS.fluid_verify``) and :func:`verify_topology` for the
layer-DSL graphs in ``paddle_tpu_torch.models``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from paddle_tpu_torch.analysis.diagnostics import Diagnostic, Severity

# abstract shape: tuple of int-or-None, or None for "wholly unknown"
AbsShape = Optional[Tuple[Optional[int], ...]]


class VarState:
    """Abstract value: best-known shape and dtype ('' = unknown)."""

    __slots__ = ("shape", "dtype")

    def __init__(self, shape: AbsShape = None, dtype: str = ""):
        self.shape = shape
        self.dtype = dtype

    def __repr__(self):
        s = "?" if self.shape is None else \
            "[" + ",".join("?" if d is None else str(d)
                           for d in self.shape) + "]"
        return f"{s}:{self.dtype or '?'}"


def _declared_state(var) -> VarState:
    """Leaf state from a declared Variable: -1 / 0 dims become unknown;
    an empty declared shape on a non-scalar builder temp is treated as
    wholly unknown (builders use ``_tmp()`` without shapes)."""
    shape = tuple(None if s <= 0 else int(s) for s in var.shape)
    return VarState(shape if shape else None, var.dtype)


def _known(shape: AbsShape) -> bool:
    return shape is not None and all(d is not None for d in shape)


def _is_float(dtype: str) -> bool:
    return dtype.startswith(("float", "bfloat"))


def _is_int(dtype: str) -> bool:
    return dtype.startswith(("int", "uint", "bool"))


# ---------------------------------------------------------------------------
# per-op-type shape+dtype inference registry
# ---------------------------------------------------------------------------
# rule(ins: {slot: [VarState]}, attrs, emit) -> {slot: [VarState]}
# ``emit(severity, code, message, *vars)`` reports a conflict; the rule
# still returns its best-effort outputs so inference continues.

_RULES: Dict[str, Callable] = {}


def rule(*op_types):
    def deco(fn):
        for t in op_types:
            _RULES[t] = fn
        return fn
    return deco


def _one(ins, slot) -> VarState:
    vs = ins.get(slot) or [VarState()]
    return vs[0]


def _bcast_shapes(x: AbsShape, y: AbsShape, axis: int) -> AbsShape:
    """Reference elementwise broadcast (ops._bcast): y matches a
    contiguous slice of x's dims starting at ``axis``.  Returns the
    result shape, or raises ValueError when provably incompatible."""
    if x is None or y is None:
        return x or y
    if len(x) == len(y):
        out = []
        for a, b in zip(x, y):
            if a is not None and b is not None and a != b and 1 not in (a, b):
                raise ValueError(f"dims {a} vs {b}")
            # a known dim-1 broadcasts away; an UNKNOWN dim against 1
            # must stay unknown (guessing 1 would fabricate downstream
            # element-count conflicts on valid programs)
            if a == 1:
                out.append(b)
            elif b == 1:
                out.append(a)
            else:
                out.append(a if a is not None else b)
        return tuple(out)
    big, small = (x, y) if len(x) > len(y) else (y, x)
    off = axis if (axis != -1 and len(x) > len(y)) else len(big) - len(small)
    for i, d in enumerate(small):
        j = off + i
        if j >= len(big):
            raise ValueError("rank overflow under axis broadcast")
        b = big[j]
        if d is not None and b is not None and d != b and 1 not in (d, b):
            raise ValueError(f"dim {d} vs {b} at axis {j}")
    return big


@rule("elementwise_add", "elementwise_sub", "elementwise_mul",
      "elementwise_div", "elementwise_pow", "elementwise_max",
      "elementwise_min", "minus")
def _r_elementwise(ins, attrs, emit):
    x, y = _one(ins, "X"), _one(ins, "Y")
    out_shape: AbsShape = None
    try:
        out_shape = _bcast_shapes(x.shape, y.shape,
                                  int(attrs.get("axis", -1)))
    except ValueError as e:
        emit(Severity.ERROR, "shape-mismatch",
             f"elementwise operands do not broadcast: "
             f"{x!r} vs {y!r} ({e})")
    if x.dtype and y.dtype and _is_float(x.dtype) != _is_float(y.dtype):
        emit(Severity.ERROR, "dtype-mismatch",
             f"elementwise mixes float and integer operands "
             f"({x.dtype} vs {y.dtype}); insert a cast op")
    return {"Out": [VarState(out_shape, x.dtype or y.dtype)]}


@rule("sigmoid", "logsigmoid", "exp", "relu", "tanh", "sqrt", "abs",
      "reciprocal", "log", "square", "softsign", "brelu", "soft_relu",
      "pow", "stanh", "leaky_relu", "relu6", "softplus", "hard_shrink",
      "soft_shrink", "elu", "sign", "floor", "ceil", "round", "scale",
      "clip", "softmax", "dropout", "increment", "fill_zeros_like",
      "sequence_softmax")
def _r_same_shape(ins, attrs, emit):
    x = _one(ins, "X")
    out = {"Out": [VarState(x.shape, x.dtype)]}
    out["Mask"] = [VarState(x.shape, x.dtype)]   # dropout's co-output
    return out


@rule("cast")
def _r_cast(ins, attrs, emit):
    x = _one(ins, "X")
    return {"Out": [VarState(x.shape, str(attrs.get("out_dtype", "")))]}


@rule("mul")
def _r_mul(ins, attrs, emit):
    import numpy as np

    x, y = _one(ins, "X"), _one(ins, "Y")
    xn, yn = int(attrs.get("x_num_col_dims", 1)), \
        int(attrs.get("y_num_col_dims", 1))
    out_shape: AbsShape = None
    if x.shape is not None and y.shape is not None:
        xk, yk = x.shape[xn:], y.shape[:yn]
        if _known(xk) and _known(yk) and \
                int(np.prod(xk)) != int(np.prod(yk)):
            emit(Severity.ERROR, "shape-mismatch",
                 f"mul inner dims differ: X{list(x.shape)} flattened at "
                 f"{xn} gives {int(np.prod(xk))} cols, Y{list(y.shape)} "
                 f"flattened at {yn} gives {int(np.prod(yk))} rows")
        out_shape = tuple(x.shape[:xn]) + tuple(y.shape[yn:])
    if x.dtype and y.dtype and x.dtype != y.dtype:
        emit(Severity.WARNING, "dtype-mismatch",
             f"mul operand dtypes differ ({x.dtype} vs {y.dtype})")
    return {"Out": [VarState(out_shape, x.dtype or y.dtype)]}


@rule("matmul")
def _r_matmul(ins, attrs, emit):
    x, y = _one(ins, "X"), _one(ins, "Y")
    xs, ys = x.shape, y.shape
    if xs is not None and attrs.get("transpose_X", False):
        xs = xs[:-2] + (xs[-1], xs[-2]) if len(xs) >= 2 else xs
    if ys is not None and attrs.get("transpose_Y", False):
        ys = ys[:-2] + (ys[-1], ys[-2]) if len(ys) >= 2 else ys
    out_shape: AbsShape = None
    if xs is not None and ys is not None and len(xs) >= 2 and len(ys) >= 2:
        k1, k2 = xs[-1], ys[-2]
        if k1 is not None and k2 is not None and k1 != k2:
            emit(Severity.ERROR, "shape-mismatch",
                 f"matmul contraction dims differ: {k1} vs {k2} "
                 f"(X{list(xs)} @ Y{list(ys)})")
        out_shape = tuple(xs[:-1]) + (ys[-1],)
    return {"Out": [VarState(out_shape, x.dtype or y.dtype)]}


def _conv_out(hw, k, stride, pad, dil=1):
    if hw is None:
        return None
    return (hw + 2 * pad - dil * (k - 1) - 1) // stride + 1


def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (int(v), int(v))


@rule("conv2d")
def _r_conv2d(ins, attrs, emit):
    x, w = _one(ins, "Input"), _one(ins, "Filter")
    groups = int(attrs.get("groups", 1))
    out_shape: AbsShape = None
    if x.shape is not None and w.shape is not None and \
            len(x.shape) == 4 and len(w.shape) == 4:
        cin, wcin = x.shape[1], w.shape[1]
        if cin is not None and wcin is not None and cin != wcin * groups:
            emit(Severity.ERROR, "shape-mismatch",
                 f"conv2d channel mismatch: input has {cin} channels, "
                 f"filter expects {wcin} x groups={groups}")
        s, p = _pair(attrs.get("strides", 1)), _pair(attrs.get("paddings", 0))
        d = _pair(attrs.get("dilations", 1))
        out_shape = (x.shape[0], w.shape[0],
                     _conv_out(x.shape[2], w.shape[2] or 1, s[0], p[0], d[0])
                     if w.shape[2] is not None else None,
                     _conv_out(x.shape[3], w.shape[3] or 1, s[1], p[1], d[1])
                     if w.shape[3] is not None else None)
    return {"Output": [VarState(out_shape, x.dtype)]}


@rule("pool2d")
def _r_pool2d(ins, attrs, emit):
    x = _one(ins, "X")
    out_shape: AbsShape = None
    if x.shape is not None and len(x.shape) == 4:
        if attrs.get("global_pooling", False):
            out_shape = (x.shape[0], x.shape[1], 1, 1)
        else:
            k = _pair(attrs.get("ksize", 2))
            s = _pair(attrs.get("strides", 1) or k)
            p = _pair(attrs.get("paddings", 0))
            out_shape = (x.shape[0], x.shape[1],
                         _conv_out(x.shape[2], k[0], s[0], p[0]),
                         _conv_out(x.shape[3], k[1], s[1], p[1]))
    return {"Out": [VarState(out_shape, x.dtype)]}


@rule("batch_norm")
def _r_batch_norm(ins, attrs, emit):
    x, scale = _one(ins, "X"), _one(ins, "Scale")
    layout = attrs.get("data_layout", "NCHW")
    if x.shape is not None and scale.shape is not None and len(x.shape) >= 2:
        c = x.shape[1 if layout == "NCHW" else -1]
        sc = scale.shape[0] if len(scale.shape) == 1 else None
        if c is not None and sc is not None and c != sc:
            emit(Severity.ERROR, "shape-mismatch",
                 f"batch_norm channel mismatch: input has {c} channels "
                 f"({layout}), Scale has {sc}")
    stat = VarState(scale.shape, x.dtype)
    return {"Y": [VarState(x.shape, x.dtype)], "MeanOut": [stat],
            "VarianceOut": [stat], "SavedMean": [stat],
            "SavedVariance": [stat]}


@rule("layer_norm", "lrn")
def _r_norm_same(ins, attrs, emit):
    x = _one(ins, "X")
    return {"Y": [VarState(x.shape, x.dtype)],
            "Out": [VarState(x.shape, x.dtype)]}


def _label_check(label: VarState, soft: bool, emit, op: str):
    if not soft and label.dtype and not _is_int(label.dtype):
        emit(Severity.ERROR, "dtype-mismatch",
             f"{op} with soft_label=False needs integer labels, got "
             f"{label.dtype}")


@rule("cross_entropy")
def _r_cross_entropy(ins, attrs, emit):
    x, label = _one(ins, "X"), _one(ins, "Label")
    _label_check(label, attrs.get("soft_label", False), emit,
                 "cross_entropy")
    n = x.shape[0] if x.shape else None
    return {"Y": [VarState((n, 1), x.dtype)]}


@rule("softmax_with_cross_entropy")
def _r_softmax_xent(ins, attrs, emit):
    logits, label = _one(ins, "Logits"), _one(ins, "Label")
    _label_check(label, attrs.get("soft_label", False), emit,
                 "softmax_with_cross_entropy")
    n = logits.shape[0] if logits.shape else None
    return {"Softmax": [VarState(logits.shape, logits.dtype)],
            "Loss": [VarState((n, 1), logits.dtype)]}


@rule("squared_l2_distance")
def _r_sq_l2(ins, attrs, emit):
    x, y = _one(ins, "X"), _one(ins, "Y")
    try:
        _bcast_shapes(x.shape, y.shape, -1)
    except ValueError:
        emit(Severity.ERROR, "shape-mismatch",
             f"squared_l2_distance operands differ: {x!r} vs {y!r}")
    n = x.shape[0] if x.shape else None
    return {"sub_result": [VarState(x.shape, x.dtype)],
            "Out": [VarState((n, 1), x.dtype)]}


@rule("mean", "squared_l2_norm")
def _r_scalarize(ins, attrs, emit):
    x = _one(ins, "X")
    return {"Out": [VarState((), x.dtype)]}


@rule("sum")
def _r_sum(ins, attrs, emit):
    xs = ins.get("X") or [VarState()]
    shape = None
    for v in xs:
        if v.shape is None:
            continue
        if shape is None:
            shape = v.shape
        elif _known(shape) and _known(v.shape) and shape != v.shape:
            emit(Severity.ERROR, "shape-mismatch",
                 f"sum inputs disagree: {list(shape)} vs {list(v.shape)}")
    return {"Out": [VarState(shape, xs[0].dtype)]}


@rule("reduce_sum", "reduce_mean", "reduce_max", "reduce_min")
def _r_reduce(ins, attrs, emit):
    x = _one(ins, "X")
    dim = attrs.get("dim")
    if attrs.get("reduce_all", dim is None) or x.shape is None:
        return {"Out": [VarState((), x.dtype)]}
    d = int(dim) % len(x.shape) if x.shape else 0
    if attrs.get("keep_dim", False):
        shape = tuple(1 if i == d else s for i, s in enumerate(x.shape))
    else:
        shape = tuple(s for i, s in enumerate(x.shape) if i != d)
    return {"Out": [VarState(shape, x.dtype)]}


@rule("reshape")
def _r_reshape(ins, attrs, emit):
    import numpy as np

    x = _one(ins, "X")
    target = tuple(int(s) for s in attrs.get("shape", ()))
    if _known(x.shape) and target and all(s > 0 for s in target):
        if int(np.prod(x.shape)) != int(np.prod(target)):
            emit(Severity.ERROR, "shape-mismatch",
                 f"reshape changes element count: {list(x.shape)} "
                 f"({int(np.prod(x.shape))}) -> {list(target)} "
                 f"({int(np.prod(target))})")
    shape = tuple(None if s < 0 else s for s in target) if target else None
    return {"Out": [VarState(shape, x.dtype)]}


@rule("transpose")
def _r_transpose(ins, attrs, emit):
    x = _one(ins, "X")
    perm = [int(p) for p in attrs.get("axis", ())]
    shape: AbsShape = None
    if x.shape is not None and perm:
        if sorted(perm) != list(range(len(x.shape))):
            emit(Severity.ERROR, "shape-mismatch",
                 f"transpose perm {perm} does not match rank "
                 f"{len(x.shape)} input")
        else:
            shape = tuple(x.shape[p] for p in perm)
    return {"Out": [VarState(shape, x.dtype)]}


@rule("concat")
def _r_concat(ins, attrs, emit):
    xs = ins.get("X") or [VarState()]
    axis = int(attrs.get("axis", 0))
    shapes = [v.shape for v in xs]
    if any(s is None for s in shapes):
        return {"Out": [VarState(None, xs[0].dtype)]}
    rank = len(shapes[0])
    ax = axis % rank if rank else 0
    for s in shapes[1:]:
        if len(s) != rank:
            emit(Severity.ERROR, "shape-mismatch",
                 f"concat rank mismatch: {list(shapes[0])} vs {list(s)}")
            return {"Out": [VarState(None, xs[0].dtype)]}
        for i in range(rank):
            if i != ax and s[i] is not None and shapes[0][i] is not None \
                    and s[i] != shapes[0][i]:
                emit(Severity.ERROR, "shape-mismatch",
                     f"concat non-axis dim {i} differs: "
                     f"{list(shapes[0])} vs {list(s)} (axis {ax})")
    cat = 0
    for s in shapes:
        if s[ax] is None:
            cat = None
            break
        cat += s[ax]
    shape = tuple(cat if i == ax else shapes[0][i] for i in range(rank))
    return {"Out": [VarState(shape, xs[0].dtype)]}


@rule("lookup_table")
def _r_lookup(ins, attrs, emit):
    w, ids = _one(ins, "W"), _one(ins, "Ids")
    if ids.dtype and not _is_int(ids.dtype):
        emit(Severity.ERROR, "dtype-mismatch",
             f"lookup_table Ids must be integers, got {ids.dtype}")
    dim = w.shape[1] if w.shape is not None and len(w.shape) == 2 else None
    return {"Out": [VarState((None, dim), w.dtype)]}


@rule("fill_constant")
def _r_fill(ins, attrs, emit):
    shape = tuple(int(s) for s in attrs.get("shape", ()))
    return {"Out": [VarState(shape, str(attrs.get("dtype", "float32")))]}


@rule("uniform_random", "gaussian_random")
def _r_random(ins, attrs, emit):
    shape = tuple(int(s) for s in attrs.get("shape", ()))
    return {"Out": [VarState(shape, str(attrs.get("dtype", "float32")))]}


@rule("top_k")
def _r_top_k(ins, attrs, emit):
    x = _one(ins, "X")
    k = int(attrs.get("k", 1))
    shape = None
    if x.shape is not None:
        shape = tuple(x.shape[:-1]) + (k,)
        if x.shape[-1] is not None and x.shape[-1] < k:
            emit(Severity.ERROR, "shape-mismatch",
                 f"top_k k={k} exceeds last dim {x.shape[-1]}")
    return {"Out": [VarState(shape, x.dtype)],
            "Indices": [VarState(shape, "int32")]}


@rule("argmax")
def _r_argmax(ins, attrs, emit):
    x = _one(ins, "X")
    return {"Out": [VarState(None, "int32")]}


@rule("accuracy")
def _r_accuracy(ins, attrs, emit):
    label = _one(ins, "Label")
    if label.dtype and not _is_int(label.dtype):
        emit(Severity.ERROR, "dtype-mismatch",
             f"accuracy Label must be integers, got {label.dtype}")
    return {"Accuracy": [VarState((), "float32")],
            "Correct": [VarState((), "int32")],
            "Total": [VarState((), "int32")]}


@rule("sgd", "momentum", "adagrad", "adadelta", "rmsprop",
      "decayed_adagrad", "adam", "adamax", "proximal_gd")
def _r_optimizer(ins, attrs, emit):
    p, g = _one(ins, "Param"), _one(ins, "Grad")
    if _known(p.shape) and _known(g.shape) and p.shape != g.shape:
        emit(Severity.ERROR, "shape-mismatch",
             f"optimizer grad shape {list(g.shape)} does not match "
             f"param {list(p.shape)}")
    st = VarState(p.shape, p.dtype)
    return {slot: [st] for slot in
            ("ParamOut", "VelocityOut", "MomentOut", "Moment1Out",
             "Moment2Out", "MeanSquareOut", "AvgSquaredGradOut",
             "AvgSquaredUpdateOut", "InfNormOut")}


# ---------------------------------------------------------------------------
# the verifier walk
# ---------------------------------------------------------------------------


def _op_rule_outputs(op, in_states, emit) -> Dict[str, List[VarState]]:
    fn = _RULES.get(op.type)
    if fn is None:
        return {}
    return fn(in_states, dict(op.attrs), emit)


class _BlockChecker:
    """Def/use + inference walk over one block (sub-blocks get their
    step-local names pre-seeded by the caller)."""

    def __init__(self, program, block, diags: List[Diagnostic],
                 outer_defined: Optional[Dict[str, VarState]] = None):
        self.program = program
        self.block = block
        self.diags = diags
        # name -> abstract state, for everything defined "so far"
        self.defined: Dict[str, VarState] = dict(outer_defined or {})
        self.written_by: Dict[str, List[int]] = {}
        self.first_writer: Dict[str, int] = {}

    # -- scope helpers -----------------------------------------------------

    def _declared(self, name: str):
        b = self.block
        while b is not None:
            if name in b.vars:
                return b.vars[name]
            b = (self.program.blocks[b.parent_idx]
                 if b.parent_idx >= 0 else None)
        return None

    def _initially_defined(self, var) -> bool:
        """Matches Executor._materialize_params: parameters, persistables
        with an initializer or static shape, pre-start."""
        from paddle_tpu_torch.fluid.framework import Parameter

        if isinstance(var, Parameter):
            return True
        if var.persistable and (var.initializer is not None or
                                (var.shape and all(s > 0 for s in var.shape))):
            return True
        return False

    # -- the walk ----------------------------------------------------------

    def run(self, feed_names: Sequence[str] = ()) -> None:
        ops = self.block.ops
        for idx, op in enumerate(ops):
            for n in op.output_names():
                self.written_by.setdefault(n, []).append(idx)
                self.first_writer.setdefault(n, idx)
        # leaves: anything declared that is pre-defined or fed, plus
        # names that are read but never written (presumed feeds — the
        # executor cannot tell either until run time)
        for name, var in self._all_scope_vars().items():
            if self._initially_defined(var) or name in feed_names or \
                    name not in self.first_writer:
                self.defined.setdefault(name, _declared_state(var))

        for idx, op in enumerate(ops):
            self._check_op(idx, op)

    def _all_scope_vars(self):
        out = {}
        b = self.block
        chain = []
        while b is not None:
            chain.append(b)
            b = (self.program.blocks[b.parent_idx]
                 if b.parent_idx >= 0 else None)
        for b in reversed(chain):   # inner shadows outer
            out.update(b.vars)
        return out

    def _emit_for(self, idx, op):
        def emit(severity, code, message, *vars):
            self.diags.append(Diagnostic(
                severity, code, f"op {op.type!r}: {message}",
                block_idx=self.block.idx, op_idx=idx, vars=tuple(vars)))
        return emit

    def _check_op(self, idx, op) -> None:
        emit = self._emit_for(idx, op)
        is_grad = op.type.endswith("_grad")
        in_states: Dict[str, List[VarState]] = {}
        for slot, names in op.inputs.items():
            states = []
            for n in names:
                states.append(self._check_read(idx, op, slot, n, emit,
                                               optional=is_grad))
            in_states[slot] = states
        out_states = {} if is_grad else _op_rule_outputs(op, in_states, emit)
        for slot, names in op.outputs.items():
            inferred = out_states.get(slot, [])
            for j, n in enumerate(names):
                self._check_write(idx, op, slot, n, emit)
                st = inferred[j] if j < len(inferred) else VarState()
                if st.shape is None and st.dtype == "":
                    # no rule: keep at least the declared dtype
                    var = self._declared(n)
                    if var is not None:
                        st = VarState(None, var.dtype)
                self.defined[n] = st
        # sub-block ops: walk the sub-block with its step-locals seeded
        if "sub_block" in op.attrs:
            self._check_sub_block(op)

    def _check_read(self, idx, op, slot, name, emit,
                    optional: bool) -> VarState:
        if name in self.defined:
            return self.defined[name]
        var = self._declared(name)
        if var is None:
            if not optional:
                emit(Severity.ERROR, "undefined-var",
                     f"reads {name!r} (slot {slot}), which no block in "
                     "scope declares", name)
            return VarState()
        if optional:
            # grad-op OutGrad inputs default to zeros when absent — a
            # declared-but-unwritten grad var is the normal case
            return self.defined.get(name, _declared_state(var))
        writer = self.first_writer.get(name)
        if writer is not None and writer > idx:
            emit(Severity.ERROR, "def-before-use",
                 f"reads {name!r} (slot {slot}) but its first writer is "
                 f"op {writer} ({self.block.ops[writer].type!r}) — the "
                 "graph is misordered", name)
        elif writer is None:
            # declared, never written, not pre-defined: unreachable in
            # practice because run() pre-seeds never-written names
            emit(Severity.ERROR, "def-before-use",
                 f"reads {name!r} which nothing defines", name)
        return _declared_state(var)

    def _check_write(self, idx, op, slot, name, emit) -> None:
        from paddle_tpu_torch.fluid import ops as op_lib
        from paddle_tpu_torch.fluid.framework import GRAD_SUFFIX

        writers = self.written_by.get(name, [])
        if len(writers) <= 1 or writers[0] == idx:
            return
        # sanctioned multi-writer aliases:
        if name.endswith(GRAD_SUFFIX):
            return                      # gradient fan-in accumulation
        base = op.type[:-5] if op.type.endswith("_grad") else op.type
        try:
            info = op_lib.get(base)
        except Exception:
            info = None
        if info is not None and slot in info.stateful_outputs:
            return                      # declared stateful slot (bn stats)
        if name in op.input_names():
            return                      # in-place update through own input
        emit(Severity.ERROR, "duplicate-writer",
             f"writes {name!r} (slot {slot}) already written by op(s) "
             f"{[w for w in writers if w != idx]}", name)

    def _check_sub_block(self, op) -> None:
        sub = self.program.blocks[int(op.attrs["sub_block"])]
        seeded: Dict[str, VarState] = {}
        for key in ("step_inputs", "step_states_in", "param_names",
                    "x_names"):
            for n in op.attrs.get(key, []):
                var = sub.vars.get(n) or self._declared(n)
                seeded[n] = (_declared_state(var) if var is not None
                             else VarState())
        inner = _BlockChecker(self.program, sub, self.diags,
                              outer_defined={**self.defined, **seeded})
        inner.run()


def feed_fetch_problems(program, feed_names: Sequence[str],
                        fetch_names: Sequence[str]) -> List[Tuple[str, str]]:
    """THE definition of a valid feed/fetch set, shared by
    ``verify_program`` and ``Executor.run``'s up-front validation (one
    helper so the two can never drift): a feed must name a declared
    variable in some block; a fetch must be produced by an op, stored in
    a persistable variable, or fed.  Returns [(code, message)]."""
    declared: Set[str] = set()
    for b in program.blocks:
        declared.update(b.vars)
    gb = program.global_block()
    written = {n for op in gb.ops for n in op.output_names()}
    persistable = {n for n, v in gb.vars.items() if v.persistable}
    problems: List[Tuple[str, str]] = []
    for n in feed_names:
        if n not in declared:
            problems.append((
                "unknown-feed",
                f"feed {n!r} matches no program variable (it would be "
                "silently ignored)"))
    for n in fetch_names:
        if n not in written and n not in persistable and \
                n not in feed_names:
            problems.append((
                "dangling-fetch",
                f"fetch {n!r} is produced by no op and stored in no "
                "persistable variable"))
    return problems


def verify_program(program, fetch_names: Optional[Sequence[str]] = None,
                   feed_names: Optional[Sequence[str]] = None
                   ) -> List[Diagnostic]:
    """Verify a ``fluid.Program``; returns all diagnostics (possibly
    empty).  ``fetch_names``/``feed_names`` enable the fetch/feed and
    dead-variable checks; without a fetch list dead-var analysis is
    skipped (the verifier cannot know the program's sinks)."""
    diags: List[Diagnostic] = []
    gb = program.global_block()
    checker = _BlockChecker(program, gb, diags)
    checker.run(feed_names=tuple(feed_names or ()))

    for code, msg in feed_fetch_problems(program, tuple(feed_names or ()),
                                         tuple(fetch_names or ())):
        diags.append(Diagnostic(Severity.ERROR, code, msg, block_idx=0))

    if fetch_names is not None:
        _dead_var_scan(program, set(fetch_names), diags)
    return diags


def _dead_var_scan(program, fetches: Set[str],
                   diags: List[Diagnostic]) -> None:
    """Ops none of whose outputs reach a fetch / persistable store /
    stateful slot: prune() candidates, reported as WARNINGs (mirrors
    framework.prune's reverse reachability walk)."""
    from paddle_tpu_torch.fluid import ops as op_lib
    from paddle_tpu_torch.fluid.framework import GRAD_SUFFIX

    gb = program.global_block()
    needed = set(fetches)
    for n, v in gb.vars.items():
        if v.persistable:
            needed.add(n)
    kept: Set[int] = set()
    for idx in range(len(gb.ops) - 1, -1, -1):
        op = gb.ops[idx]
        sink = any(n in needed for n in op.output_names())
        if not sink:
            base = op.type[:-5] if op.type.endswith("_grad") else op.type
            try:
                info = op_lib.get(base)
            except Exception:
                info = None
            if info is not None and info.stateful_outputs and \
                    any(slot in info.stateful_outputs
                        for slot in op.outputs):
                sink = True
        if sink:
            kept.add(idx)
            needed.update(op.input_names())
            # a kept grad op's outputs feed earlier grad ops' OutGrad
            # reads (accumulation is executor-side, not an explicit op),
            # and it differentiates through its FORWARD op's recorded
            # graph: the forward op is live even if nothing else reads
            # its outputs
            if op.type.endswith("_grad"):
                needed.update(op.output_names())
                if "fwd_idx" in op.attrs:
                    fwd = gb.ops[int(op.attrs["fwd_idx"])]
                    needed.update(fwd.output_names())
    for idx, op in enumerate(gb.ops):
        if idx in kept:
            continue
        outs = op.output_names()
        diags.append(Diagnostic(
            Severity.WARNING, "dead-var",
            f"op {op.type!r} is dead: none of its outputs "
            f"{outs} reach a fetch target or persistable store",
            block_idx=0, op_idx=idx, vars=tuple(outs)))


# ---------------------------------------------------------------------------
# layer-DSL (Topology) verification — the paddle_tpu_torch.models surface
# ---------------------------------------------------------------------------


def verify_topology(outputs) -> List[Diagnostic]:
    """Verify a layer-DSL graph (a ``Topology`` or the LayerOutput(s) to
    freeze into one): well-formed DAG (no cycles, no duplicate names),
    every non-data placeholder reachable, parameter/state specs with
    static positive shapes, shared-parameter shape agreement.  These are
    the same diagnostic classes as the fluid pass, mapped onto the graph
    the ``paddle_tpu_torch.models`` zoo actually builds."""
    from paddle_tpu_torch.platform.enforce import EnforceError
    from paddle_tpu_torch.topology import LayerOutput, Topology

    diags: List[Diagnostic] = []
    try:
        topo = outputs if isinstance(outputs, Topology) else \
            Topology(outputs if isinstance(outputs, (list, tuple))
                     else [outputs])
    except EnforceError as e:
        # cycles and duplicate names raise at freeze; map them onto the
        # matching diagnostic classes
        msg = str(e)
        code = "duplicate-writer" if "named" in msg else "def-before-use"
        diags.append(Diagnostic(Severity.ERROR, code, msg))
        return diags

    for node in topo.nodes:
        if node.fn is None and node.layer_type != "data":
            diags.append(Diagnostic(
                Severity.WARNING, "def-before-use",
                f"node {node.name!r} ({node.layer_type}) is a "
                "placeholder with no compute fn outside a step graph — "
                "forward will demand a feed for it", vars=(node.name,)))
        for pname, spec in node.params.items():
            if not all(int(s) > 0 for s in spec.shape):
                diags.append(Diagnostic(
                    Severity.ERROR, "shape-mismatch",
                    f"parameter {node.name}.{pname} needs a static "
                    f"positive shape, got {tuple(spec.shape)}",
                    vars=(f"{node.name}.{pname}",)))
        for sname, spec in node.state.items():
            if not all(int(s) >= 0 for s in spec.shape):
                diags.append(Diagnostic(
                    Severity.ERROR, "shape-mismatch",
                    f"state slot {node.name}/{sname} has negative dims "
                    f"{tuple(spec.shape)}", vars=(f"{node.name}/{sname}",)))
    try:
        topo.param_specs()       # shared-parameter shape agreement
        topo.state_specs()       # shared-state shape agreement
    except EnforceError as e:
        diags.append(Diagnostic(Severity.ERROR, "shape-mismatch", str(e)))
    for out in topo.outputs:
        if out.name not in topo.by_name:
            diags.append(Diagnostic(
                Severity.ERROR, "dangling-fetch",
                f"requested output {out.name!r} is not in the frozen "
                "graph", vars=(out.name,)))
    return diags

"""Merged-model export: one self-contained inference artifact (the port of
``paddle_tpu/export.py``).

Reference analog: ``paddle merge_model`` (trainer/MergeModel.cpp) packs the
model config and its weights into a single file for the C inference API
(paddle/capi).

Two artifacts, both traced from ``Topology.forward(..., train=False)``
with the weights closed over:

- :func:`merge_model` writes a zip holding ``manifest.json`` (format
  version, inputs with dtype and feature shape, outputs, whether the batch
  is symbolic, the device) and ``model.pt2``, the program
  ``torch.export.export`` traced (``torch.export.save``).  Loading needs no
  layer library: :func:`load_merged_model` gives a :class:`MergedModel`
  that runs the program on the device it was traced on, and the C ABI
  (``paddle_tpu_torch/native/capi.cpp``) hosts the same loader.
- :func:`export_aot_program` translates the core-ATen graph of the same
  trace (``run_decompositions()``) into a flat ``.ptnm`` tensor program that
  ``native/src/aot_runtime.cpp`` runs with no Python and no torch in the
  process.  The opcodes are that runtime's ``Op`` enum.

As in the JAX package: dense feeds only, integer feeds as ``[B]`` int32,
data layers in declaration order, and the model state baked from
``topo.init_state()`` — a merged model's batch norm uses the fresh
statistics, not trained ones.
"""

from __future__ import annotations

import io
import json
import operator
import struct
import zipfile
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from paddle_tpu_torch.parameters import Parameters
from paddle_tpu_torch.platform.device import DeviceLike, resolve_device
from paddle_tpu_torch.platform.enforce import EnforceError, enforce_that
from paddle_tpu_torch.topology import Topology

_FORMAT_VERSION = 1


def _is_int_feed(n) -> bool:
    """Integer-id data node (embedding tables): fed as [B] int32."""
    return "INDEX" in str(getattr(n.input_type, "slot", "")).upper()


class _Forward(torch.nn.Module):
    """``topo.forward`` over the feeds with the weights and the initial
    state held as buffers, so ``torch.export`` bakes them into the
    program."""

    def __init__(self, topo: Topology, params: Dict[str, torch.Tensor],
                 state, names: Sequence[str]):
        super().__init__()
        self._topo = topo
        self._names = list(names)
        self._keys = list(params)
        for i, k in enumerate(self._keys):
            self.register_buffer(f"p{i}", params[k])
        self._slots = [(ns, k) for ns, slots in state.items() for k in slots]
        for i, (ns, k) in enumerate(self._slots):
            self.register_buffer(f"s{i}", state[ns][k])

    def forward(self, *feeds):
        params = {k: getattr(self, f"p{i}") for i, k in enumerate(self._keys)}
        state: Dict[str, Dict[str, torch.Tensor]] = {}
        for i, (ns, k) in enumerate(self._slots):
            state.setdefault(ns, {})[k] = getattr(self, f"s{i}")
        outs = self._topo.forward(params, dict(zip(self._names, feeds)),
                                  train=False, state=state)
        return tuple(o.data if hasattr(o, "segment_ids") else o
                     for o in outs)


def _dense_forward_spec(output_layers, parameters: Parameters,
                        dev: torch.device, context: str):
    """Shared export preamble: (output layers, sorted dense data nodes,
    their feed specs, the weights-closed module on ``dev``)."""
    outs = output_layers if isinstance(output_layers, (list, tuple)) \
        else [output_layers]
    topo = Topology(list(outs))
    data_nodes = [n for n in topo.nodes if n.layer_type == "data"]
    data_nodes.sort(key=lambda n: getattr(n, "declare_idx", 0))
    specs = []
    for n in data_nodes:
        enforce_that(not n.is_sequence,
                     f"{context} exports dense-input graphs (sequence feeds "
                     "carry host-side ragged metadata)", context=context)
        if _is_int_feed(n):
            specs.append({"name": n.name, "dtype": "int32",
                          "feature_shape": []})
        else:
            specs.append({"name": n.name, "dtype": "float32",
                          "feature_shape": [int(n.size)]})
    params = {k: v.detach().to(dev) for k, v in parameters.as_dict().items()}
    module = _Forward(topo, params, topo.init_state(dev),
                      [s["name"] for s in specs])
    return outs, specs, module


def _example(specs, batch: int, dev: torch.device):
    return tuple(torch.zeros((batch, *s["feature_shape"]),
                             dtype=getattr(torch, s["dtype"]), device=dev)
                 for s in specs)


# ---------------------------------------------------------------------------
# merged model: an exported torch program in a zip
# ---------------------------------------------------------------------------


def merge_model(output_layers, parameters: Parameters, path: str,
                batch_size: Optional[int] = None,
                device: DeviceLike = None) -> None:
    """Trace forward(feeds) with the weights baked in and write ``path``.

    ``batch_size=None`` exports a symbolic batch (any batch of 1 or more at
    load time; the trace itself runs at a batch of 2, since
    ``torch.export`` specializes sizes 0 and 1); an int pins it.  The trace
    runs on ``cuda`` unless ``device="cpu"``, and the program keeps that
    device."""
    dev = resolve_device(device)
    outs, specs, module = _dense_forward_spec(output_layers, parameters,
                                              dev, "export")
    symbolic = batch_size is None
    args = _example(specs, 2 if symbolic else int(batch_size), dev)
    dynamic = None
    if symbolic:
        batch = torch.export.Dim("batch", min=1)
        # one entry for the module's *feeds, a dict a feed
        dynamic = (tuple({0: batch} for _ in specs),)
    with torch.no_grad():
        ep = torch.export.export(module, args, dynamic_shapes=dynamic)
    blob = io.BytesIO()
    torch.export.save(ep, blob)
    manifest = {
        "format_version": _FORMAT_VERSION,
        "inputs": specs,
        "outputs": [n.name for n in outs],
        "symbolic_batch": symbolic,
        "batch_size": None if symbolic else int(batch_size),
        "device": dev.type,
    }
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("manifest.json", json.dumps(manifest))
        z.writestr("model.pt2", blob.getvalue())


class MergedModel:
    """A loaded merged model: ``infer(feeds)`` with no layer library
    needed (the capi ``paddle_gradient_machine_create_for_inference``
    analog).  The program runs on the device the manifest names."""

    def __init__(self, path: str):
        with zipfile.ZipFile(path) as z:
            self.manifest = json.loads(z.read("manifest.json"))
            enforce_that(
                self.manifest.get("format_version") == _FORMAT_VERSION,
                "unsupported merged-model version", context="export")
            self.device = resolve_device(self.manifest["device"])
            ep = torch.export.load(io.BytesIO(z.read("model.pt2")))
        self._module = ep.module()
        self.input_names = [s["name"] for s in self.manifest["inputs"]]
        self.output_names = self.manifest["outputs"]

    def infer(self, feeds: Dict[str, np.ndarray]) -> List[np.ndarray]:
        args = []
        for spec in self.manifest["inputs"]:
            enforce_that(spec["name"] in feeds,
                         f"missing feed {spec['name']!r}", context="export")
            arr = np.asarray(feeds[spec["name"]],
                             dtype=np.dtype(spec["dtype"]))
            if not arr.flags.writeable:   # torch takes writable buffers
                arr = arr.copy()
            args.append(torch.from_numpy(arr).to(self.device))
        with torch.no_grad():
            outs = self._module(*args)
        return [o.detach().cpu().numpy() for o in outs]

    def _infer_flat(self, name: str, raw: bytes, batch: int,
                    dim: int) -> Tuple[int, int, bytes]:
        """The C ABI's call: one dense f32 feed as raw bytes, the first
        output as (rows, cols, its f32 bytes), rows its leading dim."""
        enforce_that(len(self.input_names) == 1
                     and name == self.input_names[0],
                     f"the C ABI feeds one input, this model takes "
                     f"{self.input_names}", context="export")
        x = np.frombuffer(raw, dtype=np.float32).reshape(batch, dim)
        spec = self.manifest["inputs"][0]
        if spec["dtype"] == "int32":  # ids ride as floats, exact < 2**24
            x = x.reshape(batch)
        out = np.ascontiguousarray(self.infer({name: x})[0],
                                   dtype=np.float32)
        rows = out.shape[0] if out.ndim else 1
        return rows, out.size // max(rows, 1), out.tobytes()

    def create_shared(self) -> "MergedModel":
        """A new inference instance sharing this model's loaded program and
        its one weight copy (``paddle_gradient_machine_create_shared_param``,
        capi/gradient_machine.h:88): hand each serving thread its own
        instance.  ``infer`` holds no state, so either is reentrant."""
        clone = object.__new__(MergedModel)
        clone.manifest = self.manifest
        clone.device = self.device
        clone._module = self._module
        clone.input_names = list(self.input_names)
        clone.output_names = list(self.output_names)
        return clone


def load_merged_model(path: str) -> MergedModel:
    return MergedModel(path)


# ---------------------------------------------------------------------------
# AOT program export: the interpreter-free C inference artifact
# ---------------------------------------------------------------------------
#
# Reference analog: paddle/capi's pure-C embedded deployment
# (capi/gradient_machine.h:36-112) — inference with NO Python interpreter in
# the process.  The core-ATen graph of the forward trace is translated into
# the flat tensor program (.ptnm) native/src/aot_runtime.cpp executes.
# The runtime is f32-only (integers and booleans ride as f32) and its
# convolutions and pools are NHWC x HWIO; ATen's are NCHW, so a tensor may
# carry a pending permutation that is applied only where an op needs the
# logical layout (elementwise ops and constants follow the storage layout).

_PTNM_MAGIC = b"PTNM"
_PTNM_VERSION = 1

# opcodes: aot_runtime.cpp's Op enum
OP_ADD, OP_SUB, OP_MUL, OP_DIV, OP_MAX, OP_MIN = 1, 2, 3, 4, 5, 6
OP_EXP, OP_LOG, OP_TANH, OP_LOGISTIC, OP_RSQRT = 7, 8, 9, 10, 11
OP_SQRT, OP_NEG, OP_ABS = 12, 13, 14
OP_DOT, OP_BCAST, OP_RESHAPE, OP_TRANSPOSE = 15, 16, 17, 18
OP_RSUM, OP_RMAX, OP_CONV2D, OP_MAXPOOL, OP_SUMPOOL = 19, 20, 21, 22, 23
OP_SELECT_N, OP_CLAMP, OP_CONCAT, OP_IPOW, OP_IDENT = 24, 25, 26, 27, 28
OP_LT, OP_LE, OP_GT, OP_GE, OP_EQ, OP_NE = 29, 30, 31, 32, 33, 34
OP_GATHER_ROWS, OP_TRUNC = 35, 36

_UNARY = {"exp": OP_EXP, "log": OP_LOG, "tanh": OP_TANH,
          "sigmoid": OP_LOGISTIC, "rsqrt": OP_RSQRT, "sqrt": OP_SQRT,
          "neg": OP_NEG, "abs": OP_ABS}
_BINARY = {"add": OP_ADD, "sub": OP_SUB, "mul": OP_MUL, "div": OP_DIV,
           "maximum": OP_MAX, "minimum": OP_MIN, "lt": OP_LT, "le": OP_LE,
           "gt": OP_GT, "ge": OP_GE, "eq": OP_EQ, "ne": OP_NE}
_ALIAS = {"clone", "alias", "detach", "lift_fresh_copy", "contiguous"}
_RESHAPE = {"view", "_unsafe_view", "reshape", "squeeze", "unsqueeze",
            "flatten", "view_copy"}
_SKIP = {"_assert_tensor_metadata", "_assert_scalar",
         "sym_constrain_range_for_size", "sym_constrain_range"}


def _code(dtype: torch.dtype) -> int:
    if dtype in (torch.float32, torch.bool):
        return 0                      # booleans ride as f32 0/1
    if dtype in (torch.int32, torch.int64):
        return 1
    raise EnforceError(f"AOT export supports f32/i32/i64/bool tensors, got "
                       f"{dtype}", context="export_aot")


def _inverse(perm: Sequence[int]) -> List[int]:
    inv = [0] * len(perm)
    for i, p in enumerate(perm):
        inv[p] = i
    return inv


class _Val:
    """A runtime tensor ``tid`` whose logical value is ``stored.permute(
    perm)`` (``perm`` None: stored as it is), or a constant."""

    __slots__ = ("tid", "perm", "shape", "const", "dtype")

    def __init__(self, tid=None, perm=None, shape=(), const=None,
                 dtype=torch.float32):
        self.tid, self.perm, self.const = tid, perm, const
        self.shape, self.dtype = tuple(shape), dtype


class _Indices:
    """The indices output of a max pool, which the runtime cannot
    produce: an error only if some op reads it."""


class _AotBuilder:
    def __init__(self):
        self.tensors: List[Tuple[int, Tuple[int, ...]]] = []  # (dtype, dims)
        self.consts: List[Tuple[int, np.ndarray]] = []
        self.ops: List[Tuple[int, List[int], int, List[int]]] = []

    def tensor(self, dtype: torch.dtype, shape) -> int:
        self.tensors.append((_code(dtype), tuple(int(d) for d in shape)))
        return len(self.tensors) - 1

    def const(self, value: torch.Tensor) -> int:
        value = value.detach().cpu()
        if value.dtype in (torch.int32, torch.int64):
            arr = value.to(torch.int32).numpy()
        else:
            arr = value.to(torch.float32).numpy()  # bools become f32 0/1
        tid = self.tensor(torch.int32 if arr.dtype == np.int32
                          else torch.float32, arr.shape)
        self.consts.append((tid, np.ascontiguousarray(arr)))
        return tid

    def emit(self, opcode: int, ins: Sequence[int], out: int,
             attrs: Sequence[int] = ()) -> int:
        self.ops.append((opcode, list(ins), out, [int(a) for a in attrs]))
        return out


def _unsupported(what: str) -> EnforceError:
    return EnforceError(
        f"AOT export: unsupported op {what} — this graph needs the merged "
        "model path (merge_model and the CPython C ABI) instead",
        context="export_aot")


class _Translator:
    """Walk an ``ExportedProgram``'s graph in order, emitting ``.ptnm``
    ops; ops whose inputs are all constants are evaluated here."""

    def __init__(self, ep, b: _AotBuilder):
        self.ep, self.b = ep, b
        self.env: Dict[object, object] = {}

    # -- values ------------------------------------------------------------

    def const_val(self, t: torch.Tensor) -> _Val:
        t = t.detach().cpu()
        return _Val(const=t, shape=t.shape, dtype=t.dtype)

    def tid(self, v) -> int:
        """The runtime tensor holding ``v``'s logical value."""
        if isinstance(v, _Indices):
            raise _unsupported("max_pool2d_with_indices' indices")
        if v.const is not None:
            if v.tid is None:
                v.tid = self.b.const(v.const)
            return v.tid
        if v.perm is not None:
            out = self.b.tensor(v.dtype, v.shape)
            v.tid = self.b.emit(OP_TRANSPOSE, [v.tid], out, v.perm)
            v.perm = None
        return v.tid

    def new(self, opcode: int, ins, shape, dtype, attrs=()) -> _Val:
        out = self.b.tensor(dtype, shape)
        self.b.emit(opcode, ins, out, attrs)
        return _Val(tid=out, shape=shape, dtype=dtype)

    def permuted(self, v: _Val, q: Sequence[int]) -> _Val:
        """``v.permute(q)`` without an op: the permutation stays pending."""
        shape = tuple(v.shape[i] for i in q)
        if v.const is not None:
            return self.const_val(v.const.permute(*q))
        base = list(v.perm) if v.perm is not None else list(range(len(q)))
        r = [base[i] for i in q]
        perm = None if r == list(range(len(r))) else r
        return _Val(tid=v.tid, perm=perm, shape=shape, dtype=v.dtype)

    def stored(self, v: _Val, layout: Sequence[int]) -> int:
        """A runtime tensor holding ``v.permute(layout)``."""
        return self.tid(self.permuted(v, layout))

    # -- the walk ----------------------------------------------------------

    def inputs(self, user_ids: Sequence[int]) -> None:
        sig = self.ep.graph_signature
        user = iter(user_ids)
        values = {**self.ep.state_dict, **self.ep.constants}
        for node, spec in zip(
                (n for n in self.ep.graph.nodes if n.op == "placeholder"),
                sig.input_specs):
            meta = node.meta["val"]
            if spec.kind.name == "USER_INPUT":
                self.env[node] = _Val(tid=next(user), shape=meta.shape,
                                      dtype=meta.dtype)
            else:
                self.env[node] = self.const_val(values[spec.target])

    def run(self) -> List[int]:
        for node in self.ep.graph.nodes:
            if node.op == "placeholder":
                continue
            if node.op == "output":
                return [self.tid(self.env[a]) for a in node.args[0]]
            enforce_that(node.op == "call_function",
                         f"AOT export: graph node {node.op} {node.target}",
                         context="export_aot")
            if node.target is operator.getitem:
                seq, i = node.args
                self.env[node] = self.env[seq][i]
                continue
            name = getattr(node.target, "_overloadpacket", None)
            name = name.__name__ if name is not None else str(node.target)
            if name in _SKIP:
                continue
            args = self.read(node.args)
            kwargs = self.read(node.kwargs)
            if not self.has_runtime((args, kwargs)):
                self.env[node] = self.fold(node, args, kwargs)
                continue
            handler = getattr(self, f"op_{name}", None)
            if handler is None:
                if name in _UNARY:
                    handler = self.unary
                elif name in _BINARY:
                    handler = self.binary
                elif name in _ALIAS:
                    handler = self.alias
                elif name in _RESHAPE:
                    handler = self.reshape
                else:
                    raise _unsupported(f"{node.target}")
            meta = node.meta.get("val")
            self.env[node] = handler(name, meta, *args, **kwargs)
        raise EnforceError("AOT export: graph has no output",
                           context="export_aot")

    def read(self, a):
        import torch.fx

        if isinstance(a, torch.fx.Node):
            return self.env[a]
        if isinstance(a, (list, tuple)):
            return type(a)(self.read(x) for x in a)
        if isinstance(a, dict):
            return {k: self.read(v) for k, v in a.items()}
        return a

    def has_runtime(self, a) -> bool:
        if isinstance(a, _Val):
            return a.const is None
        if isinstance(a, _Indices):
            return True
        if isinstance(a, (list, tuple)):
            return any(self.has_runtime(x) for x in a)
        if isinstance(a, dict):
            return any(self.has_runtime(x) for x in a.values())
        return False

    def fold(self, node, args, kwargs):
        """Evaluate an op over constants on the host."""
        def real(a):
            if isinstance(a, _Val):
                return a.const
            if isinstance(a, (list, tuple)):
                return type(a)(real(x) for x in a)
            return a

        kw = {k: real(v) for k, v in kwargs.items()}
        if "device" in kw:
            kw["device"] = torch.device("cpu")
        if "pin_memory" in kw:
            kw["pin_memory"] = False
        out = node.target(*real(args), **kw)

        def wrap(o):
            if isinstance(o, torch.Tensor):
                return self.const_val(o)
            if isinstance(o, (list, tuple)):
                return type(o)(wrap(x) for x in o)
            return o

        return wrap(out)

    # -- elementwise -------------------------------------------------------

    def as_val(self, x) -> _Val:
        """A scalar as an f32 constant (the runtime is f32-only)."""
        if isinstance(x, _Val):
            return x
        return self.const_val(torch.tensor(float(x)))

    def elementwise(self, opcode: int, operands, meta, attrs=()) -> _Val:
        """``opcode`` over ``operands`` (runtime values or constants) with
        numpy broadcasting to ``meta``'s shape.  When every runtime operand
        has the output's rank and one pending permutation, the op runs in
        that storage layout and the result keeps the permutation."""
        shape = tuple(meta.shape)
        rank = len(shape)
        live = [v for v in operands if v.const is None]
        perms = {tuple(v.perm) if v.perm is not None else None
                 for v in live}
        perm = next(iter(perms)) if len(perms) == 1 else None
        if perm is not None and all(len(v.shape) == rank for v in live):
            inv = _inverse(perm)
            ins = []
            for v in operands:
                if v.const is None:
                    ins.append(v.tid)
                else:
                    c = v.const.reshape((1,) * (rank - v.const.dim())
                                        + tuple(v.const.shape))
                    ins.append(self.b.const(c.permute(*inv)))
            out = self.new(opcode, ins, [shape[i] for i in inv],
                           meta.dtype, attrs)
            out.perm, out.shape = list(perm), shape
            return out
        return self.new(opcode, [self.tid(v) for v in operands], shape,
                        meta.dtype, attrs)

    def unary(self, name, meta, x, *rest, **kw):
        return self.elementwise(_UNARY[name], [x], meta)

    def binary(self, name, meta, a, b, *rest, alpha=1, rounding_mode=None):
        enforce_that(rounding_mode is None and not rest,
                     f"AOT export: {name} with rounding_mode "
                     f"{rounding_mode!r}", context="export_aot")
        a, b = self.as_val(a), self.as_val(b)
        if alpha != 1:
            enforce_that(b.const is not None, "AOT export: add/sub with "
                         "alpha over a runtime tensor", context="export_aot")
            b = self.const_val(b.const * alpha)
        return self.elementwise(_BINARY[name], [a, b], meta)

    def op_reciprocal(self, name, meta, x):
        return self.elementwise(OP_DIV, [self.as_val(1.0), x], meta)

    def op_gelu(self, name, meta, x, approximate="none"):
        """The tanh form, 0.5 x (1 + tanh(sqrt(2 / pi) (x + 0.044715
        x^3))), as JAX's approximate gelu lowers; the erf form has no
        runtime op."""
        if approximate != "tanh":
            raise _unsupported("gelu with the exact (erf) form")
        c = self.as_val

        def ew(op, *vs, attrs=()):
            return self.elementwise(op, list(vs), meta, attrs)

        inner = ew(OP_ADD, x, ew(OP_MUL, ew(OP_IPOW, x, attrs=[3]),
                                 c(0.044715)))
        t = ew(OP_TANH, ew(OP_MUL, inner, c(float(np.sqrt(2.0 / np.pi)))))
        return ew(OP_MUL, ew(OP_MUL, x, c(0.5)), ew(OP_ADD, t, c(1.0)))

    def op_relu(self, name, meta, x):
        return self.elementwise(OP_MAX, [x, self.as_val(0.0)], meta)

    def op_clamp(self, name, meta, x, min=None, max=None):
        if min is not None:
            x = self.elementwise(OP_MAX, [x, self.as_val(min)],
                                 meta)
        if max is not None:
            x = self.elementwise(OP_MIN, [x, self.as_val(max)],
                                 meta)
        return x

    def op_pow(self, name, meta, x, e):
        enforce_that(isinstance(x, _Val) and not isinstance(e, _Val),
                     "AOT export: pow with a tensor exponent",
                     context="export_aot")
        if float(e) == int(e):
            return self.elementwise(OP_IPOW, [x], meta, [int(e)])
        if e in (0.5, -0.5):
            return self.elementwise(OP_SQRT if e > 0 else OP_RSQRT, [x],
                                    meta)
        raise _unsupported(f"pow with exponent {e}")

    def op__to_copy(self, name, meta, x, dtype=None, **kw):
        src_int = not x.dtype.is_floating_point and x.dtype != torch.bool
        if meta.dtype == torch.bool and x.dtype != torch.bool:
            return self.elementwise(OP_NE, [x, self.as_val(0.0)], meta)
        if meta.dtype.is_floating_point or src_int or meta.dtype == x.dtype:
            enforce_that(meta.dtype in (torch.float32, torch.int32,
                                        torch.int64, torch.bool),
                         f"AOT export: the runtime is f32-only, got a cast "
                         f"to {meta.dtype}", context="export_aot")
            return self.alias(name, meta, x)
        # float -> integer truncates toward zero
        return self.elementwise(OP_TRUNC, [x], meta)

    def op_where(self, name, meta, cond, a, b):
        shape = tuple(meta.shape)
        ins = []
        for v in map(self.as_val, (cond, b, a)):
            if tuple(v.shape) != shape:
                v = self.broadcast(v, shape)
            ins.append(self.tid(v))
        # select_n(pred, false_case, true_case)
        return self.new(OP_SELECT_N, ins, shape, meta.dtype)

    # -- layout ------------------------------------------------------------

    def alias(self, name, meta, x, *rest, **kw):
        return _Val(tid=x.tid, perm=x.perm, shape=meta.shape,
                    dtype=meta.dtype)

    def reshape(self, name, meta, x, *rest, **kw):
        shape = tuple(meta.shape)
        if shape == tuple(x.shape):
            return self.alias(name, meta, x)
        return self.new(OP_RESHAPE, [self.tid(x)], shape, meta.dtype)

    def op_permute(self, name, meta, x, dims):
        rank = len(x.shape)
        return self.permuted(x, [d % rank for d in dims])

    def broadcast(self, x: _Val, shape) -> _Val:
        if x.const is not None:
            return self.const_val(x.const.expand(*shape).contiguous())
        lead = len(shape) - len(x.shape)
        return self.new(OP_BCAST, [self.tid(x)], shape, x.dtype,
                        [i + lead for i in range(len(x.shape))])

    def op_cat(self, name, meta, tensors, dim=0):
        rank = len(meta.shape)
        return self.new(OP_CONCAT, [self.tid(self.as_val(t))
                                    for t in tensors],
                        meta.shape, meta.dtype, [dim % rank])

    def op_constant_pad_nd(self, name, meta, x, pad, value=0.0):
        """Padding as a concat with constant blocks, axis by axis (the
        runtime has no pad op)."""
        enforce_that(all(p >= 0 for p in pad),
                     "AOT export: constant_pad_nd with a negative (cropping) "
                     "pad", context="export_aot")
        rank = len(x.shape)
        cur, shape = x, list(x.shape)
        for k in range(len(pad) // 2):
            lo, hi = pad[2 * k], pad[2 * k + 1]
            if not (lo or hi):
                continue
            axis = rank - 1 - k

            def block(n):
                dims = list(shape)
                dims[axis] = n
                return self.const_val(torch.full(dims, float(value)))

            parts = ([block(lo)] if lo else []) + [cur] + \
                ([block(hi)] if hi else [])
            shape[axis] += lo + hi
            cur = self.new(OP_CONCAT, [self.tid(p) for p in parts], shape,
                           x.dtype, [axis])
        return cur

    # -- reductions --------------------------------------------------------

    def op__softmax(self, name, meta, x, dim, half_to_float=False):
        d = dim % len(x.shape)
        keep = tuple(1 if i == d else n for i, n in enumerate(x.shape))
        kept = [n for i, n in enumerate(x.shape) if i != d]
        xt = self.tid(x)
        m = self.new(OP_RMAX, [xt], kept, meta.dtype, [d])
        m = self.new(OP_RESHAPE, [m.tid], keep, meta.dtype)
        z = self.new(OP_SUB, [xt, m.tid], x.shape, meta.dtype)
        e = self.new(OP_EXP, [z.tid], x.shape, meta.dtype)
        s = self.new(OP_RSUM, [e.tid], kept, meta.dtype, [d])
        s = self.new(OP_RESHAPE, [s.tid], keep, meta.dtype)
        return self.new(OP_DIV, [e.tid, s.tid], x.shape, meta.dtype)

    # -- products, convolutions, pools, lookups ----------------------------

    def op_mm(self, name, meta, a, b):
        return self.new(OP_DOT, [self.tid(self.as_val(a)),
                                 self.tid(self.as_val(b))],
                        meta.shape, meta.dtype)

    def op_convolution(self, name, meta, x, w, bias, stride, padding,
                       dilation, transposed, output_padding, groups):
        enforce_that(len(w.shape) == 4 and not transposed and groups == 1
                     and list(dilation) == [1, 1],
                     "AOT export: the runtime's CONV2D is a 2-D, ungrouped, "
                     "undilated NHWC x HWIO convolution", context="export_aot")
        n, co, oh, ow = (int(s) for s in meta.shape)
        xs = self.stored(x, [0, 2, 3, 1])                  # NCHW -> NHWC
        ws = self.stored(self.as_val(w), [2, 3, 1, 0])     # OIHW -> HWIO
        ph, pw = padding
        y = self.new(OP_CONV2D, [xs, ws], (n, oh, ow, co), meta.dtype,
                     [stride[0], stride[1], ph, ph, pw, pw])
        if bias is not None:
            y = self.new(OP_ADD, [y.tid, self.tid(self.as_val(bias))],
                         (n, oh, ow, co), meta.dtype)
        y.perm, y.shape = [0, 3, 1, 2], tuple(meta.shape)
        return y

    def _pool(self, opcode, meta, x, kernel, stride, padding, ceil_mode):
        kh, kw = (kernel * 2)[:2] if len(kernel) == 1 else kernel
        stride = list(stride) or [kh, kw]
        sh, sw = (stride * 2)[:2] if len(stride) == 1 else stride
        pad = list(padding) if isinstance(padding, (list, tuple)) \
            else [padding]
        ph, pw = (pad * 2)[:2] if len(pad) == 1 else pad
        n, c, oh, ow = (int(s) for s in meta.shape)
        _, _, h, w = x.shape
        pb = max(0, (oh - 1) * sh + kh - h - ph)
        pr = max(0, (ow - 1) * sw + kw - w - pw)
        y = self.new(opcode, [self.stored(x, [0, 2, 3, 1])], (n, oh, ow, c),
                     meta.dtype, [kh, kw, sh, sw, ph, pb, pw, pr])
        y.perm, y.shape = [0, 3, 1, 2], tuple(meta.shape)
        return y

    def op_max_pool2d_with_indices(self, name, meta, x, kernel, stride=(),
                                   padding=0, dilation=1, ceil_mode=False):
        enforce_that(dilation in (1, [1, 1], (1, 1)),
                     "AOT export: dilated max pool", context="export_aot")
        return (self._pool(OP_MAXPOOL, meta[0], x, kernel, stride, padding,
                           ceil_mode), _Indices())

    def op_avg_pool2d(self, name, meta, x, kernel, stride=(), padding=0,
                      ceil_mode=False, count_include_pad=True,
                      divisor_override=None):
        y = self._pool(OP_SUMPOOL, meta, x, kernel, stride, padding,
                       ceil_mode)
        # the divisor of each window, as torch counts it: the cells inside
        # the map over the average of a map of ones
        _, _, h, w = x.shape
        ones = torch.ones((1, 1, h, w))
        args = dict(kernel_size=kernel, stride=stride or None,
                    padding=padding, ceil_mode=ceil_mode)
        inside = torch.nn.functional.avg_pool2d(
            ones, count_include_pad=True, divisor_override=1, **args)
        if divisor_override:
            div = torch.full_like(inside, float(divisor_override))
        else:
            div = inside / torch.nn.functional.avg_pool2d(
                ones, count_include_pad=count_include_pad, **args)
        return self.elementwise(OP_DIV, [y, self.const_val(div)], meta)

    def op__native_batch_norm_legit_no_training(self, name, meta, x, w, b,
                                                mean, var, momentum, eps):
        enforce_that(all(v is None or v.const is not None
                         for v in (w, b, mean, var)),
                     "AOT export: batch norm over runtime statistics",
                     context="export_aot")
        scale = torch.rsqrt(var.const.float() + eps)
        if w is not None:
            scale = scale * w.const.float()
        shift = -mean.const.float() * scale
        if b is not None:
            shift = shift + b.const.float()
        bshape = [1] * len(x.shape)
        bshape[1] = -1
        y = self.elementwise(OP_MUL, [x, self.const_val(
            scale.reshape(bshape))], meta[0])
        return (self.elementwise(OP_ADD, [y, self.const_val(
            shift.reshape(bshape))], meta[0]), None, None)

    def op_embedding(self, name, meta, weight, ids, padding_idx=-1,
                     *rest, **kw):
        n = int(np.prod(ids.shape)) if ids.shape else 1
        idx = self.new(OP_RESHAPE, [self.tid(ids)], (n, 1), ids.dtype)
        d = int(weight.shape[1])
        rows = self.new(OP_GATHER_ROWS, [self.tid(self.as_val(weight)),
                                         idx.tid], (n, d), meta.dtype)
        if tuple(meta.shape) == (n, d):
            return rows
        return self.new(OP_RESHAPE, [rows.tid], meta.shape, meta.dtype)


def export_aot_program(output_layers, parameters: Parameters, path: str,
                       batch_size: int, device: DeviceLike = None) -> None:
    """Translate the forward graph into a ``.ptnm`` tensor program that
    ``native/src/aot_runtime.cpp`` executes with no Python and no torch in
    the process (the embedded-deployment property of the reference's
    paddle/capi).  The trace runs in f32 (``FLAGS.use_bf16`` off: the
    runtime is f32-only) on ``cuda`` unless ``device="cpu"``;
    ``batch_size`` is pinned (export one program a batch size).  An op the
    translator does not know raises :class:`EnforceError` naming it."""
    from paddle_tpu_torch.platform.flags import FLAGS

    dev = resolve_device(device)
    old_bf16 = FLAGS.use_bf16
    FLAGS.use_bf16 = False
    try:
        outs, specs, module = _dense_forward_spec(
            output_layers, parameters, dev, "export_aot")
        enforce_that(len(specs) == 1,
                     "AOT export is single-input (the C ABI binds one dense "
                     "feed); concat extra features host-side or use the "
                     "merged model path", context="export_aot")
        with torch.no_grad():
            ep = torch.export.export(
                module, _example(specs, int(batch_size), dev))
            ep = ep.run_decompositions()
    finally:
        FLAGS.use_bf16 = old_bf16

    b = _AotBuilder()
    arg_ids = [b.tensor(torch.int32, (int(batch_size),))
               if s["dtype"] == "int32"
               else b.tensor(torch.float32, (int(batch_size),
                                             *s["feature_shape"]))
               for s in specs]
    tr = _Translator(ep, b)
    tr.inputs(arg_ids)
    out_ids = tr.run()

    with open(path, "wb") as f:
        w = f.write
        w(_PTNM_MAGIC)
        w(struct.pack("<I", _PTNM_VERSION))
        w(struct.pack("<I", len(b.tensors)))
        for dtype, dims in b.tensors:
            w(struct.pack("<BB", dtype, len(dims)))
            w(struct.pack(f"<{len(dims)}q", *dims))
        w(struct.pack("<I", len(specs)))
        for s, tid in zip(specs, arg_ids):
            name = s["name"].encode()
            w(struct.pack("<IH", tid, len(name)))
            w(name)
        w(struct.pack("<I", len(out_ids)))
        for tid in out_ids:
            w(struct.pack("<I", tid))
        w(struct.pack("<I", len(b.consts)))
        for tid, arr in b.consts:
            raw = arr.tobytes()
            w(struct.pack("<IQ", tid, len(raw)))
            w(raw)
        w(struct.pack("<I", len(b.ops)))
        for opcode, ins, out, attrs in b.ops:
            w(struct.pack("<II", opcode, len(ins)))
            if ins:
                w(struct.pack(f"<{len(ins)}I", *ins))
            w(struct.pack("<II", out, len(attrs)))
            if attrs:
                w(struct.pack(f"<{len(attrs)}q", *attrs))

"""The layer DSL (the port of ``paddle_tpu/layer.py``: the transformer
subset ``data``, ``fc``, ``embedding``, ``layer_norm``, ``addto``,
``multi_head_attention``, ``classification_cost`` and the fused
``lm_head_cost``, the recurrent subset ``lstmemory``, ``grumemory``,
``pooling``, ``first_seq``, ``last_seq``, ``expand``, the Elman
``recurrent`` layer, the step layers ``gru_step``/``lstm_step`` with
``recurrent_group``, ``memory``, ``StaticInput`` and ``SubsequenceInput``
from ``recurrent.py``, ``mixed`` with every projection (full matrix,
transposed, identity, slice, dotmul, scaling, table, context) and
operator (dotmul, conv), ``dotmul``, ``dotmul_bcast`` and
``cross_entropy_cost``, the convnet subset
``img_conv``, ``img_pool``, ``batch_norm``, ``img_cmrnorm``, ``dropout``
and ``concat``, the CTR/GAN subset ``slope_intercept`` and
``multi_binary_label_cross_entropy_cost``, the tagging subset ``crf`` and
``crf_decoding``, the sequence layers ``seq_concat``, ``seq_reshape``,
``seq_slice``, ``kmax_seq_score``, ``sub_nested_seq``, ``max_id`` and
``get_output``, and the beam cost ``cross_entropy_over_beam`` with its
``BeamInput``).

Each function returns a ``LayerOutput`` graph node whose compute fn is
plain PyTorch on tensors or :class:`SequenceBatch` values; the dtype
policy of each layer is the JAX package's (``ops/math.py``,
``ops/conv.py``).  Image maps are NHWC tensors, as in the JAX package; a
node carries its (H, W, C) in ``img_shape``.  Cost layers return
per-example (per-token) losses; the trainer reduces them.
"""

from __future__ import annotations

import math
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from paddle_tpu_torch import activation as act_mod
from paddle_tpu_torch import pooling as pooling_mod
from paddle_tpu_torch.attr import ExtraAttr, ParamAttr
from paddle_tpu_torch.data_type import InputType, SeqKind
from paddle_tpu_torch.initializer import Constant
from paddle_tpu_torch.ops import attention as pattn
from paddle_tpu_torch.ops import conv as pconv
from paddle_tpu_torch.ops import crf as pcrf
from paddle_tpu_torch.ops import losses as ploss
from paddle_tpu_torch.ops import math as pmath
from paddle_tpu_torch.ops import norm as pnorm
from paddle_tpu_torch.ops import pool as ppool
from paddle_tpu_torch.ops import rnn as prnn
from paddle_tpu_torch.ops import sequence_ops as pseq
from paddle_tpu_torch.ops.embedding import embedding_lookup
from paddle_tpu_torch.platform.enforce import EnforceError, enforce_that
from paddle_tpu_torch.sequence import SequenceBatch
from paddle_tpu_torch.topology import Context, LayerOutput, ParamSpec, \
    StateSpec, unique_name

__all__ = ["data", "fc", "embedding", "layer_norm", "addto", "concat",
           "dropout", "img_conv", "img_pool", "batch_norm", "img_cmrnorm",
           "multi_head_attention", "pooling", "lstmemory", "grumemory",
           "classification_cost", "full_matrix_projection",
           "identity_projection", "mixed", "dotmul", "dotmul_bcast",
           "first_seq", "last_seq", "expand", "recurrent",
           "cross_entropy_cost", "StaticInput", "memory", "recurrent_group",
           "gru_step", "lstm_step", "lstm_step_output", "lstm_step_state",
           "slope_intercept", "multi_binary_label_cross_entropy_cost",
           "trans_full_matrix_projection", "slice_projection",
           "dotmul_projection", "scaling_projection", "table_projection",
           "context_projection", "dotmul_operator", "conv_operator", "crf",
           "crf_decoding", "seq_concat", "seq_reshape", "seq_slice",
           "kmax_seq_score", "sub_nested_seq", "max_id", "get_output",
           "BeamInput", "cross_entropy_over_beam", "SubsequenceInput",
           "lm_head_cost"]


def _as_list(x) -> list:
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _data_of(v):
    return v.data if isinstance(v, SequenceBatch) else v


def _like(template, data):
    if isinstance(template, SequenceBatch):
        return template.with_data(data)
    return data


def _cast_value(value, dtype):
    return _like(value, _data_of(value).to(dtype))


def _apply_act(activation, value):
    """Apply an activation to a dense tensor or tokenwise to a
    SequenceBatch; ``sequence_softmax`` normalizes over each sequence."""
    if isinstance(activation, act_mod.SequenceSoftmaxActivation):
        enforce_that(isinstance(value, SequenceBatch),
                     "sequence_softmax needs a sequence input",
                     context="layer")
        return pseq.sequence_softmax(value)
    if activation.fn is None:
        return value
    return _like(value, activation.fn(_data_of(value)))


def _act_then_cast(activation, value, dtype):
    """Activation and cast to the storage dtype: the softmax family
    normalizes a row or a sequence, so it runs on the f32 accumulator
    before the cast; the pointwise ones run after it (the JAX package's
    order)."""
    if isinstance(activation, (act_mod.SoftmaxActivation,
                               act_mod.SequenceSoftmaxActivation)):
        return _cast_value(_apply_act(activation, value), dtype)
    return _apply_act(activation, _cast_value(value, dtype))


class _ClipError(torch.autograd.Function):
    """Identity forward, backward clipped to [-t, t]: the reference's
    per-layer ``error_clipping_threshold`` (Layer.cpp backwardActivation
    clips the output gradient before it propagates)."""

    @staticmethod
    def forward(ctx, x, threshold: float):
        ctx.threshold = threshold
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.clamp(-ctx.threshold, ctx.threshold), None


def _apply_extra(ctx: Context, name: str, value, layer_attr):
    """The layer's ``ExtraAttr``: dropout at ``drop_rate`` from the
    node's random stream, then the error clip (last in the forward, so
    first in the backward: the raw upstream gradient is clipped before
    dropout's 1/(1-p) rescale, as in the JAX package).  ``sharding`` and
    ``device`` need a mesh and are carried as data."""
    attr = ExtraAttr.to_attr(layer_attr)
    if attr.drop_rate > 0.0:
        value = _like(value, pmath.dropout(_data_of(value), attr.drop_rate,
                                           ctx.rng_for(name), ctx.train))
    if attr.error_clipping_threshold > 0.0:
        value = _like(value, _ClipError.apply(
            _data_of(value), float(attr.error_clipping_threshold)))
    return value


def _img_shape_of(node: LayerOutput) -> Optional[Tuple[int, int, int]]:
    """(H, W, C) of a node's maps: its ``img_shape``, else a data layer's
    height and width."""
    if node.img_shape is not None:
        return node.img_shape
    h, w = node.height, node.width
    if h and w and node.size and node.size % (h * w) == 0:
        return (h, w, node.size // (h * w))
    return None


def _propagate_img_shape(node: LayerOutput, *sources) -> LayerOutput:
    """Carry the first source's (H, W, C) through a shape-keeping
    layer."""
    for src in sources:
        shp = _img_shape_of(src)
        if shp is not None:
            node.img_shape = shp
            break
    return node


def _to_nhwc(v: torch.Tensor, shape_hwc: Tuple[int, int, int]
             ) -> torch.Tensor:
    """A [B, H, W, C] map passes through; a flat [B, C * H * W] row
    (CHW-major, the reference's dense image slot) becomes a contiguous
    NHWC map, so the convs downstream run channels-last."""
    if v.dim() == 4:
        return v
    h, w, c = shape_hwc
    return v.reshape(v.shape[0], c, h, w).permute(0, 2, 3, 1).contiguous()


def _conv_out_dim(in_size: int, k: int, pad: int, stride: int) -> int:
    return (in_size + 2 * pad - k) // stride + 1


def _need_seq(node: LayerOutput, ctx_name: str) -> None:
    enforce_that(node.is_sequence,
                 f"{ctx_name} needs a sequence input, got {node.name!r}",
                 context=ctx_name)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

_data_counter = [0]


def data(name: str, type: InputType, height: int = None, width: int = None,
         **_ignored) -> LayerOutput:
    """Input placeholder; declaration order is the default feeding order.
    ``height`` and ``width`` give a dense slot its image geometry."""
    node = LayerOutput(name=name, layer_type="data", inputs=[], fn=None,
                       size=type.dim,
                       is_sequence=type.seq != SeqKind.NO_SEQUENCE,
                       input_type=type, declare_idx=_data_counter[0],
                       height=height, width=width)
    _data_counter[0] += 1
    return node


# ---------------------------------------------------------------------------
# fc / embedding / norm / addto
# ---------------------------------------------------------------------------


def fc(input, size: int, act=None, name: Optional[str] = None,
       param_attr=None, bias_attr=True, layer_attr=None) -> LayerOutput:
    """Fully connected layer; several inputs are projected and summed (an
    image map flattened in NHWC order).  Products accumulate in f32; the
    output is stored in ``dense_activation_dtype``."""
    inputs = _as_list(input)
    name = name or unique_name("fc")
    activation = act_mod.get(act)
    attrs = (_as_list(param_attr) if isinstance(param_attr, (list, tuple))
             else [param_attr] * len(inputs))
    params: Dict[str, ParamSpec] = {}
    for i, (inp, pa) in enumerate(zip(inputs, attrs)):
        enforce_that(inp.size is not None, f"input {inp.name} has no size",
                     context="fc")
        params[f"w{i}"] = ParamSpec((inp.size, size), ParamAttr.to_attr(pa))
    has_bias = bool(bias_attr)
    if has_bias:
        params["b"] = ParamSpec((size,), ParamAttr.to_attr(
            None if bias_attr is True else bias_attr))

    def compute(ctx: Context, p, ins):
        total = None
        for i, v in enumerate(ins):
            d = _data_of(v)
            if not isinstance(v, SequenceBatch) and d.dim() > 2:
                d = d.reshape(d.shape[0], -1)
            y = pmath.matmul(d, p[f"w{i}"])
            total = y if total is None else total + y
        if has_bias:
            total = total + p["b"]
        out = _like(ins[0], total)
        out = _act_then_cast(activation, out,
                             pmath.dense_activation_dtype())
        return _apply_extra(ctx, name, out, layer_attr)

    return LayerOutput(name=name, layer_type="fc", inputs=inputs, fn=compute,
                       params=params, size=size,
                       is_sequence=inputs[0].is_sequence)


def embedding(input, size: int, name: Optional[str] = None,
              param_attr=None, layer_attr=None) -> LayerOutput:
    """Table lookup."""
    name = name or unique_name("embedding")
    params = {"w": ParamSpec((input.size, size),
                             ParamAttr.to_attr(param_attr))}

    def compute(ctx, p, ins):
        v = ins[0]
        out = embedding_lookup(p["w"], _data_of(v))
        return _like(v, out.to(pmath.dense_activation_dtype()))

    return LayerOutput(name=name, layer_type="embedding", inputs=[input],
                       fn=compute, params=params, size=size,
                       is_sequence=input.is_sequence)


def layer_norm(input, act=None, name: Optional[str] = None, param_attr=None,
               bias_attr=None, epsilon: float = 1e-5, **_kw) -> LayerOutput:
    """Per-row layer normalization over the feature axis (statistics in
    f32, output in the input dtype)."""
    name = name or unique_name("layer_norm")
    activation = act_mod.get(act)
    params = {
        "gamma": ParamSpec((input.size,), ParamAttr.to_attr(param_attr)
                           if param_attr else
                           ParamAttr(initializer=Constant(1.0))),
        "beta": ParamSpec((input.size,), ParamAttr.to_attr(bias_attr)
                          if bias_attr else
                          ParamAttr(initializer=Constant(0.0))),
    }

    def compute(ctx, p, ins):
        v = ins[0]
        y = pnorm.layer_norm(_data_of(v), p["gamma"], p["beta"], eps=epsilon)
        return _like(v, _apply_act(activation, y))

    return LayerOutput(name=name, layer_type="layer_norm", inputs=[input],
                       fn=compute, params=params, size=input.size,
                       is_sequence=input.is_sequence)


def addto(input, act=None, name: Optional[str] = None, bias_attr=False,
          layer_attr=None) -> LayerOutput:
    """Elementwise sum; image maps keep their geometry."""
    inputs = _as_list(input)
    name = name or unique_name("addto")
    activation = act_mod.get(act)
    params = {}
    has_bias = bool(bias_attr)
    if has_bias:
        params["b"] = ParamSpec((inputs[0].size,), ParamAttr.to_attr(
            None if bias_attr is True else bias_attr))

    def compute(ctx, p, ins):
        total = _data_of(ins[0])
        for v in ins[1:]:
            total = total + _data_of(v)
        if has_bias:
            total = total + p["b"].to(total.dtype)
        out = _apply_act(activation, _like(ins[0], total))
        return _apply_extra(ctx, name, out, layer_attr)

    node = LayerOutput(name=name, layer_type="addto", inputs=inputs,
                       fn=compute, params=params, size=inputs[0].size,
                       is_sequence=inputs[0].is_sequence)
    return _propagate_img_shape(node, *inputs)


def concat(input, name: Optional[str] = None, act=None,
           layer_attr=None) -> LayerOutput:
    """Concatenation on the feature (last) axis: the channels of image
    maps of one geometry (inception towers), which keeps (H, W, sum C)."""
    inputs = _as_list(input)
    name = name or unique_name("concat")
    activation = act_mod.get(act)

    def compute(ctx, p, ins):
        out = torch.cat([_data_of(v) for v in ins], dim=-1)
        out = _apply_act(activation, _like(ins[0], out))
        return _apply_extra(ctx, name, out, layer_attr)

    node = LayerOutput(name=name, layer_type="concat", inputs=inputs,
                       fn=compute, size=sum(i.size for i in inputs),
                       is_sequence=inputs[0].is_sequence)
    shapes = [_img_shape_of(i) for i in inputs]
    if all(s is not None for s in shapes) and \
            len({(h, w) for h, w, _ in shapes}) == 1:
        h, w, _ = shapes[0]
        node.img_shape = (h, w, sum(c for _, _, c in shapes))
    return node


def dropout(input, dropout_rate: float,
            name: Optional[str] = None) -> LayerOutput:
    """Inverted dropout at ``dropout_rate`` in training, the identity
    otherwise."""
    name = name or unique_name("dropout")

    def compute(ctx, p, ins):
        v = ins[0]
        return _like(v, pmath.dropout(_data_of(v), dropout_rate,
                                      ctx.rng_for(name), ctx.train))

    node = LayerOutput(name=name, layer_type="dropout", inputs=[input],
                       fn=compute, size=input.size,
                       is_sequence=input.is_sequence)
    return _propagate_img_shape(node, input)


# ---------------------------------------------------------------------------
# mixed and its projections, elementwise products
# ---------------------------------------------------------------------------


class Projection:
    """A projection for :func:`mixed`: one input's [*, size]
    contribution to the sum, with its own parameters."""

    def __init__(self, input: LayerOutput, size: Optional[int]):
        self.input = input
        self.size = size
        self.params: Dict[str, ParamSpec] = {}

    def compute(self, p: Dict[str, torch.Tensor], value) -> torch.Tensor:
        raise NotImplementedError


class _FullMatrixProjection(Projection):
    def __init__(self, input, size, param_attr=None, trans=False):
        super().__init__(input, size)
        self.trans = trans
        shape = (size, input.size) if trans else (input.size, size)
        self.params["w"] = ParamSpec(shape, ParamAttr.to_attr(param_attr))

    def compute(self, p, value):
        return pmath.matmul(_data_of(value), p["w"], trans_b=self.trans)


class _IdentityProjection(Projection):
    def __init__(self, input, offset=0, size=None):
        super().__init__(input, size or input.size)
        self.offset = offset

    def compute(self, p, value):
        return _data_of(value)[..., self.offset:self.offset + self.size]


def full_matrix_projection(input, size: int, param_attr=None) -> Projection:
    """``x W``, W [input.size, size]."""
    return _FullMatrixProjection(input, size, param_attr)


def trans_full_matrix_projection(input, size: int,
                                 param_attr=None) -> Projection:
    """``x W^T``, W [size, input.size]."""
    return _FullMatrixProjection(input, size, param_attr, trans=True)


def identity_projection(input, offset: int = 0,
                        size: int = None) -> Projection:
    """Columns ``offset:offset + size`` of the input (all by default)."""
    return _IdentityProjection(input, offset, size)


class _SliceProjection(Projection):
    def __init__(self, input, slices):
        super().__init__(input, sum(e - b for b, e in slices))
        self.slices = list(slices)

    def compute(self, p, value):
        d = _data_of(value)
        return torch.cat([d[..., b:e] for b, e in self.slices], dim=-1)


def slice_projection(input, slices: Sequence[Tuple[int, int]],
                     **_kw) -> Projection:
    """The input's column ranges ``[(begin, end), ...]`` side by side."""
    return _SliceProjection(input, slices)


class _DotMulProjection(Projection):
    def __init__(self, input, param_attr=None):
        super().__init__(input, input.size)
        self.params["w"] = ParamSpec((input.size,),
                                     ParamAttr.to_attr(param_attr))

    def compute(self, p, value):
        return _data_of(value) * p["w"]


def dotmul_projection(input, param_attr=None) -> Projection:
    """``x * w``, one weight a column."""
    return _DotMulProjection(input, param_attr)


class _ScalingProjection(Projection):
    def __init__(self, input, param_attr=None):
        super().__init__(input, input.size)
        self.params["w"] = ParamSpec((1,), ParamAttr.to_attr(param_attr))

    def compute(self, p, value):
        return _data_of(value) * p["w"][0]


def scaling_projection(input, param_attr=None) -> Projection:
    """``x * w``, one learned scalar."""
    return _ScalingProjection(input, param_attr)


class _TableProjection(Projection):
    def __init__(self, input, size, param_attr=None):
        super().__init__(input, size)
        self.params["w"] = ParamSpec((input.size, size),
                                     ParamAttr.to_attr(param_attr))

    def compute(self, p, value):
        return embedding_lookup(p["w"], _data_of(value))


def table_projection(input, size: int, param_attr=None) -> Projection:
    """Rows of W [input.size, size] by the input's ids."""
    return _TableProjection(input, size, param_attr)


class _ContextProjection(Projection):
    """Each token's window of ``context_len`` tokens starting
    ``context_start`` away, side by side; positions outside the sequence
    give zeros.  With ``trainable_padding`` it declares a ``pad``
    parameter that, as in the JAX package, nothing reads (its gradient is
    zero)."""

    def __init__(self, input, context_len, context_start, param_attr=None,
                 trainable_padding=False):
        super().__init__(input, input.size * context_len)
        self.context_len = context_len
        self.context_start = context_start
        if trainable_padding:
            pad_rows = max(0, -context_start) + \
                max(0, context_start + context_len - 1)
            self.params["pad"] = ParamSpec((max(1, pad_rows), input.size),
                                           ParamAttr.to_attr(param_attr))

    def compute(self, p, value):
        enforce_that(isinstance(value, SequenceBatch),
                     "context projection needs sequence input",
                     context="mixed")
        padded, _ = value.to_padded()
        T = padded.shape[1]
        t = torch.arange(T, device=padded.device)[None, :]
        cols = []
        for k in range(self.context_len):
            off = self.context_start + k
            shifted = torch.roll(padded, -off, dims=1)
            valid = (t + off >= 0) & (t + off < value.lengths[:, None])
            cols.append(torch.where(valid[..., None], shifted,
                                    torch.zeros_like(shifted)))
        out = torch.cat(cols, dim=-1)
        return SequenceBatch.from_padded(out, value.lengths,
                                         capacity=value.capacity).data


def context_projection(input, context_len: int, context_start: int = None,
                       padding_attr=False, **_kw) -> Projection:
    """The sliding window of :class:`_ContextProjection`, centred by
    default (``context_start = -(context_len // 2)``)."""
    start = context_start if context_start is not None \
        else -(context_len // 2)
    trainable = padding_attr is not False and padding_attr is not None
    attr = None if padding_attr in (False, True, None) else padding_attr
    return _ContextProjection(input, context_len, start, param_attr=attr,
                              trainable_padding=trainable)


class Operator:
    """A :func:`mixed` component over several layers, without
    parameters."""

    def __init__(self, inputs: List[LayerOutput], size: Optional[int]):
        self.inputs = inputs
        self.size = size

    def compute(self, values: list):
        raise NotImplementedError


class _DotMulOperator(Operator):
    def __init__(self, a, b, scale):
        super().__init__([a, b], a.size)
        self.scale = scale

    def compute(self, values):
        return self.scale * _data_of(values[0]) * _data_of(values[1])


def dotmul_operator(a: LayerOutput, b: LayerOutput,
                    scale: float = 1.0) -> Operator:
    """``scale * a * b``."""
    return _DotMulOperator(a, b, scale)


class _ConvOperator(Operator):
    def __init__(self, img, filt, filter_size, num_filters, num_channels,
                 stride, padding):
        super().__init__([img, filt], None)
        self.k, self.nf, self.c = filter_size, num_filters, num_channels
        self.stride, self.padding = stride, padding

    def compute(self, values):
        x, f = _data_of(values[0]), _data_of(values[1])
        B, k, nf, c = x.shape[0], self.k, self.nf, self.c
        if x.dim() == 2:
            # flat dense image rows are CHW-major, as every image layer's
            h = int(round((x.shape[-1] // c) ** 0.5))
            x = x.reshape(B, c, h, h).permute(0, 2, 3, 1)
        # each sample convolved with its own filter: one grouped conv, the
        # batch folded into the channels
        _, h, w, _ = x.shape
        xg = x.permute(1, 2, 0, 3).reshape(1, h, w, B * c)
        wg = f.reshape(B, k, k, c, nf).permute(1, 2, 3, 0, 4).reshape(
            k, k, c, B * nf)
        y = pconv.conv2d(xg, wg, stride=self.stride, padding=self.padding,
                         groups=B)
        oh, ow = y.shape[1], y.shape[2]
        return y.reshape(oh, ow, B, nf).permute(2, 0, 1, 3).reshape(B, -1)


def conv_operator(img: LayerOutput, filter: LayerOutput, filter_size: int,
                  num_filters: int, num_channels: int, stride: int = 1,
                  padding: int = 0) -> Operator:
    """A conv of each sample's image with the filter another layer gives
    it ([k, k, C, num_filters] a row)."""
    return _ConvOperator(img, filter, filter_size, num_filters,
                         num_channels, stride, padding)


def mixed(size: int = None, input=None, name: Optional[str] = None,
          act=None, bias_attr=False, layer_attr=None) -> LayerOutput:
    """Sum of projections and operators (a bare layer counts as its
    identity projection), plus a bias, then the activation.  Component
    i's parameters are ``p{i}_<name>``."""
    name = name or unique_name("mixed")
    comps = _as_list(input)
    enforce_that(len(comps) > 0, "mixed needs at least one projection",
                 context="mixed")
    activation = act_mod.get(act)
    if size is None:
        sizes = [c.size for c in comps if c.size is not None]
        enforce_that(len(sizes) > 0, "mixed size cannot be inferred",
                     context="mixed")
        size = sizes[0]
    inputs: List[LayerOutput] = []
    plan = []            # (component, its input indices, parameter prefix)
    params: Dict[str, ParamSpec] = {}
    for ci, comp in enumerate(comps):
        if isinstance(comp, LayerOutput):
            comp = identity_projection(comp)
        if isinstance(comp, Projection):
            for pn, spec in comp.params.items():
                params[f"p{ci}_{pn}"] = spec
            plan.append((comp, [len(inputs)], f"p{ci}_"))
            inputs.append(comp.input)
        elif isinstance(comp, Operator):
            plan.append((comp, list(range(len(inputs),
                                          len(inputs) + len(comp.inputs))),
                         None))
            inputs.extend(comp.inputs)
        else:
            raise EnforceError(f"bad mixed component {comp!r}",
                               context="mixed")
    has_bias = bool(bias_attr)
    if has_bias:
        params["b"] = ParamSpec((size,), ParamAttr.to_attr(
            None if bias_attr is True else bias_attr))

    def compute(ctx, p, ins):
        total = None
        for comp, idx, prefix in plan:
            if prefix is None:
                y = comp.compute([ins[i] for i in idx])
            else:
                local = {k[len(prefix):]: t for k, t in p.items()
                         if k.startswith(prefix)}
                y = comp.compute(local, ins[idx[0]])
            total = y if total is None else total + y
        if has_bias:
            total = total + p["b"]
        out = _apply_act(activation, _like(ins[0], total))
        return _apply_extra(ctx, name, out, layer_attr)

    return LayerOutput(name=name, layer_type="mixed", inputs=inputs,
                       fn=compute, params=params, size=size,
                       is_sequence=inputs[0].is_sequence)


def dotmul(a, b, name: Optional[str] = None) -> LayerOutput:
    """Elementwise product of two layers."""
    name = name or unique_name("dotmul")

    def compute(ctx, p, ins):
        return _like(ins[0], _data_of(ins[0]) * _data_of(ins[1]))

    return LayerOutput(name=name, layer_type="dotmul", inputs=[a, b],
                       fn=compute, size=a.size, is_sequence=a.is_sequence)


def dotmul_bcast(a, b, name: Optional[str] = None) -> LayerOutput:
    """Tokenwise product broadcast over the feature axis: each token of
    ``a`` scaled by its scalar in ``b`` (attention weights)."""
    name = name or unique_name("dotmul_bcast")

    def compute(ctx, p, ins):
        va, vb = _data_of(ins[0]), _data_of(ins[1])
        if vb.dim() < va.dim():
            vb = vb[..., None]
        return _like(ins[0], va * vb)

    return LayerOutput(name=name, layer_type="dotmul_bcast", inputs=[a, b],
                       fn=compute, size=a.size, is_sequence=a.is_sequence)


def slope_intercept(input, slope: float = 1.0, intercept: float = 0.0,
                    name: Optional[str] = None) -> LayerOutput:
    """``y = slope * x + intercept``."""
    name = name or unique_name("slope_intercept")

    def compute(ctx, p, ins):
        return _like(ins[0], slope * _data_of(ins[0]) + intercept)

    return LayerOutput(name=name, layer_type="slope_intercept",
                       inputs=[input], fn=compute, size=input.size,
                       is_sequence=input.is_sequence)


# ---------------------------------------------------------------------------
# image layers
# ---------------------------------------------------------------------------


def img_conv(input, filter_size: int, num_filters: int,
             num_channels: int = None, stride: int = 1, padding: int = 0,
             groups: int = 1, act=None, name: Optional[str] = None,
             param_attr=None, bias_attr=True, shared_biases: bool = True,
             trans: bool = False, dilation: int = 1,
             layer_attr=None) -> LayerOutput:
    """2-D convolution (``trans=True``: transposed), weights HWIO
    ``[k, k, C / groups, num_filters]`` (``[k, k, C, num_filters]`` when
    transposed), maps NHWC (``ops/conv.py``).  A shared bias is one per
    filter, else one per output cell; it is cast to the activation dtype
    before the add."""
    inp = input
    name = name or unique_name("conv")
    activation = act_mod.get(act)
    in_shape = _img_shape_of(inp)
    enforce_that(in_shape is not None or num_channels is not None,
                 "img_conv needs image shape metadata or num_channels",
                 context="img_conv")
    if in_shape is None:        # a square image
        hw = int(round(math.sqrt(inp.size // num_channels)))
        in_shape = (hw, hw, num_channels)
    h, w, c = in_shape
    num_channels = num_channels or c
    if trans:
        oh = (h - 1) * stride + filter_size - 2 * padding
        ow = (w - 1) * stride + filter_size - 2 * padding
        wshape = (filter_size, filter_size, num_channels, num_filters)
    else:
        oh = _conv_out_dim(h, filter_size, padding, stride)
        ow = _conv_out_dim(w, filter_size, padding, stride)
        wshape = (filter_size, filter_size, num_channels // groups,
                  num_filters)
    params = {"w": ParamSpec(wshape, ParamAttr.to_attr(param_attr))}
    has_bias = bool(bias_attr)
    if has_bias:
        bshape = (num_filters,) if shared_biases else \
            (num_filters * oh * ow,)
        params["b"] = ParamSpec(bshape, ParamAttr.to_attr(
            None if bias_attr is True else bias_attr))

    def compute(ctx, p, ins):
        x = _to_nhwc(_data_of(ins[0]), in_shape)
        if trans:
            y = pconv.conv2d_transpose(x, p["w"], stride=stride,
                                       padding=padding)
        else:
            y = pconv.conv2d(x, p["w"], stride=stride, padding=padding,
                             dilation=dilation, groups=groups)
        if has_bias:
            b = p["b"] if shared_biases else \
                p["b"].reshape(1, oh, ow, num_filters)
            y = y + b.to(y.dtype)
        y = _apply_act(activation, y)
        return _apply_extra(ctx, name, y, layer_attr)

    node = LayerOutput(name=name, layer_type="conv", inputs=[inp],
                       fn=compute, params=params, size=oh * ow * num_filters)
    node.img_shape = (oh, ow, num_filters)
    return node


def img_pool(input, pool_size: int, pool_type=None, stride: int = None,
             padding: int = 0, name: Optional[str] = None,
             layer_attr=None, **_kw) -> LayerOutput:
    """Max (default) or average pooling of image maps, floor-mode output
    sizes."""
    inp = input
    name = name or unique_name("pool")
    ptype = pooling_mod.get(pool_type)
    stride = stride if stride is not None else pool_size
    in_shape = _img_shape_of(inp)
    enforce_that(in_shape is not None, "img_pool needs image shape",
                 context="img_pool")
    h, w, c = in_shape
    oh = _conv_out_dim(h, pool_size, padding, stride)
    ow = _conv_out_dim(w, pool_size, padding, stride)

    def compute(ctx, p, ins):
        x = _to_nhwc(_data_of(ins[0]), in_shape)
        if isinstance(ptype, pooling_mod.MaxPooling):
            y = ppool.max_pool2d(x, pool_size, stride, padding)
        else:
            y = ppool.avg_pool2d(x, pool_size, stride, padding)
        return _apply_extra(ctx, name, y, layer_attr)

    node = LayerOutput(name=name, layer_type="pool", inputs=[inp],
                       fn=compute, size=oh * ow * c)
    node.img_shape = (oh, ow, c)
    return node


def batch_norm(input, act=None, name: Optional[str] = None,
               num_channels: int = None, bias_attr=None, param_attr=None,
               use_global_stats: bool = None,
               moving_average_fraction: float = 0.9, layer_attr=None,
               **_kw) -> LayerOutput:
    """Batch normalization over the channels of image maps (or the
    features of rows), its moving statistics in the state slots
    ``moving_mean`` (0) and ``moving_var`` (1)."""
    inp = input
    name = name or unique_name("batch_norm")
    activation = act_mod.get(act)
    in_shape = _img_shape_of(inp)
    c = in_shape[2] if in_shape is not None else inp.size
    params = {
        "gamma": ParamSpec((c,), ParamAttr.to_attr(param_attr) if param_attr
                           else ParamAttr(initializer=Constant(1.0))),
        "beta": ParamSpec((c,), ParamAttr.to_attr(bias_attr) if bias_attr
                          else ParamAttr(initializer=Constant(0.0))),
    }
    state = {"moving_mean": StateSpec((c,), 0.0),
             "moving_var": StateSpec((c,), 1.0)}

    def compute(ctx, p, ins):
        v = ins[0]
        x = _data_of(v)
        if in_shape is not None:
            x = _to_nhwc(x, in_shape)
        y, nm, nv = pnorm.batch_norm(
            x, p["gamma"], p["beta"], ctx.get_state(name, "moving_mean"),
            ctx.get_state(name, "moving_var"), train=ctx.train,
            momentum=moving_average_fraction,
            use_global_stats=use_global_stats)
        ctx.set_state(name, "moving_mean", nm)
        ctx.set_state(name, "moving_var", nv)
        y = _apply_extra(ctx, name, _apply_act(activation, y), layer_attr)
        return _like(v, y)

    node = LayerOutput(name=name, layer_type="batch_norm", inputs=[inp],
                       fn=compute, params=params, state=state,
                       size=inp.size, is_sequence=inp.is_sequence)
    node.img_shape = in_shape
    return node


def img_cmrnorm(input, size: int = 5, scale: float = 0.0001,
                power: float = 0.75, name: Optional[str] = None,
                **_kw) -> LayerOutput:
    """Local response normalization across channels
    (``ops/norm.cross_map_norm``)."""
    inp = input
    name = name or unique_name("cmrnorm")
    in_shape = _img_shape_of(inp)
    enforce_that(in_shape is not None, "cmrnorm needs image shape",
                 context="cmrnorm")

    def compute(ctx, p, ins):
        x = _to_nhwc(_data_of(ins[0]), in_shape)
        return pnorm.cross_map_norm(x, size, scale, power)

    node = LayerOutput(name=name, layer_type="cmrnorm", inputs=[inp],
                       fn=compute, size=inp.size)
    node.img_shape = in_shape
    return node


# ---------------------------------------------------------------------------
# sequence pooling and recurrent layers
# ---------------------------------------------------------------------------


def pooling(input, pooling_type=None, name: Optional[str] = None,
            **_kw) -> LayerOutput:
    """Sequence pooling to one vector per sequence (max, avg, sum or
    sqrtn; max by default)."""
    _need_seq(input, "pooling")
    name = name or unique_name("seq_pool")
    ptype = pooling_mod.get(pooling_type)
    fn = {"max": pseq.seq_pool_max, "avg": pseq.seq_pool_avg,
          "sum": pseq.seq_pool_sum}.get(ptype.name, pseq.seq_pool_sqrtn)

    def compute(ctx, p, ins):
        return fn(ins[0])

    return LayerOutput(name=name, layer_type="seq_pool", inputs=[input],
                       fn=compute, size=input.size, is_sequence=False)


def last_seq(input, name: Optional[str] = None, **_kw) -> LayerOutput:
    """Last token of each sequence."""
    _need_seq(input, "last_seq")
    name = name or unique_name("last_seq")
    return LayerOutput(name=name, layer_type="last_seq", inputs=[input],
                       fn=lambda ctx, p, ins: pseq.seq_last(ins[0]),
                       size=input.size, is_sequence=False)


def first_seq(input, name: Optional[str] = None, **_kw) -> LayerOutput:
    """First token of each sequence."""
    _need_seq(input, "first_seq")
    name = name or unique_name("first_seq")
    return LayerOutput(name=name, layer_type="first_seq", inputs=[input],
                       fn=lambda ctx, p, ins: pseq.seq_first(ins[0]),
                       size=input.size, is_sequence=False)


def expand(input, expand_as, name: Optional[str] = None,
           **_kw) -> LayerOutput:
    """Each sequence's row of ``input`` copied to every token of its
    sequence in ``expand_as``."""
    name = name or unique_name("expand")
    return LayerOutput(name=name, layer_type="expand",
                       inputs=[input, expand_as],
                       fn=lambda ctx, p, ins: pseq.seq_expand(ins[0],
                                                              ins[1]),
                       size=input.size, is_sequence=True)


def lstmemory(input, size: int = None, reverse: bool = False, act=None,
              gate_act=None, state_act=None, name: Optional[str] = None,
              param_attr=None, bias_attr=True, layer_attr=None
              ) -> LayerOutput:
    """LSTM over a sequence whose input is already projected to 4 * size
    (the reference's contract: the projection lives in the upstream fc;
    ``networks.simple_lstm`` composes both).  Runs ``ops/rnn.lstm_scan``
    over the [B, T] view, T the feeder's bucketed ``max_len``."""
    _need_seq(input, "lstmemory")
    enforce_that(input.size % 4 == 0, "lstmemory input size must be 4*size",
                 context="lstmemory")
    size = size or input.size // 4
    name = name or unique_name("lstmemory")
    out_act = act_mod.get(act or "tanh")
    g_act = act_mod.get(gate_act or "sigmoid")
    s_act = act_mod.get(state_act or "tanh")
    params = {"w": ParamSpec((size, 4 * size), ParamAttr.to_attr(param_attr))}
    if bias_attr:
        params["b"] = ParamSpec((4 * size,), ParamAttr.to_attr(
            None if bias_attr is True else bias_attr))

    def compute(ctx, p, ins):
        sb: SequenceBatch = ins[0]
        padded, mask = sb.to_padded()
        hs, _ = prnn.lstm_scan(padded, mask, None, p["w"], p.get("b"),
                               reverse=reverse, gate_act=g_act.fn,
                               cell_act=s_act.fn, out_act=out_act.fn)
        out = SequenceBatch.from_padded(hs, sb.lengths, capacity=sb.capacity)
        return _apply_extra(ctx, name, out, layer_attr)

    return LayerOutput(name=name, layer_type="lstmemory", inputs=[input],
                       fn=compute, params=params, size=size,
                       is_sequence=True)


def grumemory(input, size: int = None, reverse: bool = False, act=None,
              gate_act=None, name: Optional[str] = None, param_attr=None,
              bias_attr=True, layer_attr=None) -> LayerOutput:
    """GRU over a sequence with input pre-projected to 3 * size.  ``act``
    and ``gate_act`` are accepted and unused, as in the JAX package: the
    GRU's gates are sigmoid and its candidate tanh."""
    del act, gate_act
    _need_seq(input, "grumemory")
    enforce_that(input.size % 3 == 0, "grumemory input size must be 3*size",
                 context="grumemory")
    size = size or input.size // 3
    name = name or unique_name("grumemory")
    params = {"w": ParamSpec((size, 3 * size), ParamAttr.to_attr(param_attr))}
    if bias_attr:
        params["b"] = ParamSpec((3 * size,), ParamAttr.to_attr(
            None if bias_attr is True else bias_attr))

    def compute(ctx, p, ins):
        sb: SequenceBatch = ins[0]
        padded, mask = sb.to_padded()
        hs, _ = prnn.gru_scan(padded, mask, None, p["w"], p.get("b"),
                              reverse=reverse)
        out = SequenceBatch.from_padded(hs, sb.lengths, capacity=sb.capacity)
        return _apply_extra(ctx, name, out, layer_attr)

    return LayerOutput(name=name, layer_type="grumemory", inputs=[input],
                       fn=compute, params=params, size=size,
                       is_sequence=True)


def recurrent(input, size: int = None, act=None, reverse: bool = False,
              name: Optional[str] = None, param_attr=None,
              bias_attr=True) -> LayerOutput:
    """Elman recurrent layer, ``h_t = act(x_t + h_{t-1} W + b)``, over the
    [B, T] view with masked carry (``reverse`` scans from the last
    frame)."""
    _need_seq(input, "recurrent")
    size = size or input.size
    name = name or unique_name("recurrent")
    activation = act_mod.get(act or "tanh")
    params = {"w": ParamSpec((size, size), ParamAttr.to_attr(param_attr))}
    has_bias = bool(bias_attr)
    if has_bias:
        params["b"] = ParamSpec((size,), ParamAttr.to_attr(
            None if bias_attr is True else bias_attr))

    def compute(ctx, p, ins):
        sb: SequenceBatch = ins[0]
        padded, mask = sb.to_padded()
        B, T, _ = padded.shape
        xs, ms = padded.unbind(1), mask.unbind(1)
        h = padded.new_zeros((B, size))
        hs = [None] * T
        for t in (range(T - 1, -1, -1) if reverse else range(T)):
            pre = xs[t] + pmath.matmul(h, p["w"])
            nh = activation.fn(pre + p["b"] if has_bias else pre)
            m = ms[t][:, None].to(nh.dtype)
            h = m * nh + (1 - m) * h
            hs[t] = h
        return SequenceBatch.from_padded(torch.stack(hs, dim=1), sb.lengths,
                                         capacity=sb.capacity)

    return LayerOutput(name=name, layer_type="recurrent", inputs=[input],
                       fn=compute, params=params, size=size,
                       is_sequence=True)


# ---------------------------------------------------------------------------
# attention and cost
# ---------------------------------------------------------------------------


def multi_head_attention(query, key=None, value=None, *, num_heads: int,
                         size: int = None, causal: bool = False,
                         name: Optional[str] = None, param_attr=None,
                         layer_attr=None) -> LayerOutput:
    """Multi-head flash attention over packed sequences: the segment ids
    are the mask (no token attends across sequences), ``causal`` masks on
    absolute positions in the packed buffer.  key/value default to the
    query (self-attention)."""
    q_in = query
    k_in = key if key is not None else query
    v_in = value if value is not None else k_in
    for node in (q_in, k_in, v_in):
        _need_seq(node, "multi_head_attention")
    # two independently packed buffers have incomparable positions
    enforce_that(not (causal and key is not None and key is not query),
                 "causal=True is self-attention only (packed positions "
                 "are incomparable across different key/query buffers)",
                 context="multi_head_attention")
    size = size or q_in.size
    enforce_that(size % num_heads == 0,
                 f"num_heads {num_heads} must divide size {size}",
                 context="multi_head_attention")
    name = name or unique_name("mha")
    attr = ParamAttr.to_attr(param_attr)
    params = {
        "wq": ParamSpec((q_in.size, size), attr),
        "wk": ParamSpec((k_in.size, size), attr),
        "wv": ParamSpec((v_in.size, size), attr),
        "wo": ParamSpec((size, size), attr),
    }
    head_dim = size // num_heads

    def compute(ctx, p, ins):
        qs, ks, vs = ins
        cap_q, cap_k = qs.capacity, ks.capacity
        enforce_that(vs.capacity == cap_k,
                     f"key/value capacities differ ({cap_k} vs "
                     f"{vs.capacity}) — they must come from the same "
                     "feeder bucket", context="multi_head_attention")
        # q/k/v ride into flash attention in the compute dtype (bf16 under
        # the policy); the projections accumulate in f32 and round once
        qkv_t = pmath.compute_dtype(qs.data)
        q = pmath.matmul(qs.data, p["wq"]).to(qkv_t).reshape(
            1, cap_q, num_heads, head_dim)
        k = pmath.matmul(ks.data, p["wk"]).to(qkv_t).reshape(
            1, cap_k, num_heads, head_dim)
        v = pmath.matmul(vs.data, p["wv"]).to(qkv_t).reshape(
            1, cap_k, num_heads, head_dim)
        out = pattn.flash_attention(
            q, k, v, segment_ids=qs.segment_ids[None, :],
            kv_segment_ids=ks.segment_ids[None, :], causal=causal)
        y = pmath.matmul(out.reshape(cap_q, size), p["wo"])
        out = qs.with_data(y.to(pmath.dense_activation_dtype()))
        return _apply_extra(ctx, name, out, layer_attr)

    return LayerOutput(name=name, layer_type="multi_head_attention",
                       inputs=[q_in, k_in, v_in], fn=compute, params=params,
                       size=size, is_sequence=True)


def _per_example(fn_dense, value, *args):
    """Run a per-row loss on dense or sequence (per-token) input; padding
    tokens get 0."""
    if isinstance(value, SequenceBatch):
        out = fn_dense(value.data, *[_data_of(a) for a in args])
        masked = torch.where(value.valid_mask, out, torch.zeros_like(out))
        return value.with_data(masked)
    return fn_dense(value, *[_data_of(a) for a in args])


def classification_cost(input, label, name: Optional[str] = None,
                        **_kw) -> LayerOutput:
    """Softmax cross-entropy on logits, per example (per token for a
    sequence)."""
    name = name or unique_name("classification_cost")

    def compute(ctx, p, ins):
        def f(lg, lb):
            return ploss.softmax_cross_entropy(lg, lb.reshape(lb.shape[0]))

        return _per_example(f, ins[0], ins[1])

    return LayerOutput(name=name, layer_type="classification_cost",
                       inputs=[input, label], fn=compute, size=1,
                       is_cost=True)


def lm_head_cost(input, label, vocab_size: int, name: Optional[str] = None,
                 param_attr=None, bias_attr=True,
                 block_size: int = 4096) -> LayerOutput:
    """Fused LM head and softmax cross-entropy over a large vocabulary,
    per token: ``fc(vocab) -> classification_cost`` computed in vocabulary
    blocks of ``block_size`` with an online logsumexp, so the [tokens,
    vocab] logits never exist whole in either pass
    (``ops/losses.lm_head_xent``).  Parameters ``w`` [size, vocab] and
    ``b`` [vocab] (``bias_attr=False``: none)."""
    name = name or unique_name("lm_head_cost")
    params = {"w": ParamSpec((input.size, vocab_size),
                             ParamAttr.to_attr(param_attr))}
    has_bias = bool(bias_attr)
    if has_bias:
        params["b"] = ParamSpec((vocab_size,), ParamAttr.to_attr(
            None if bias_attr is True else bias_attr))

    def compute(ctx, p, ins):
        def f(x, lb):
            return ploss.lm_head_xent(x, p["w"], p.get("b"),
                                      lb.reshape(x.shape[0]),
                                      block_v=block_size)

        return _per_example(f, ins[0], ins[1])

    return LayerOutput(name=name, layer_type="lm_head_cost",
                       inputs=[input, label], fn=compute, params=params,
                       size=1, is_cost=True)


def cross_entropy_cost(input, label, name: Optional[str] = None,
                       **_kw) -> LayerOutput:
    """Cross entropy on probabilities, ``-log(clip(p[label], 1e-10, 1))``
    per example (per token for a sequence)."""
    name = name or unique_name("cross_entropy")

    def compute(ctx, p, ins):
        def f(pr, lb):
            lb = lb.reshape(lb.shape[0]).long()
            picked = torch.gather(pr, -1, lb[:, None])[:, 0]
            return -torch.log(torch.clamp(picked, 1e-10, 1.0))

        return _per_example(f, ins[0], ins[1])

    return LayerOutput(name=name, layer_type="cross_entropy",
                       inputs=[input, label], fn=compute, size=1,
                       is_cost=True)


def multi_binary_label_cross_entropy_cost(input, label,
                                          name: Optional[str] = None
                                          ) -> LayerOutput:
    """Sigmoid cross entropy on logits summed over the feature axis, per
    example (per token for a sequence); the label is cast to the logits'
    dtype.  An integer ``[B]`` label against ``[B, 1]`` logits is
    reshaped to them, not broadcast to ``[B, B]``."""
    name = name or unique_name("multi_binary_label_xent")

    def compute(ctx, p, ins):
        def f(lg, lb):
            if lb.numel() == lg.numel():
                lb = lb.reshape(lg.shape)
            return ploss.multi_binary_label_cross_entropy(lg,
                                                          lb.to(lg.dtype))

        return _per_example(f, ins[0], ins[1])

    return LayerOutput(name=name, layer_type="multi_binary_label_xent",
                       inputs=[input, label], fn=compute, size=1,
                       is_cost=True)


def _crf_params(size: int, param_attr) -> Dict[str, ParamSpec]:
    """The CRF's transitions, start and stop.  An explicit
    ``ParamAttr.name`` is a prefix (``<name>.transitions`` and so on), so
    a ``crf`` cost and its ``crf_decoding`` twin share them."""
    attr = ParamAttr.to_attr(param_attr)

    def per(pname):
        if attr.name:
            return dataclasses.replace(attr, name=f"{attr.name}.{pname}")
        return attr

    return {"transitions": ParamSpec((size, size), per("transitions")),
            "start": ParamSpec((size,), per("start")),
            "stop": ParamSpec((size,), per("stop"))}


def _padded_labels(lb) -> torch.Tensor:
    labels = lb.to_padded()[0] if isinstance(lb, SequenceBatch) else lb
    return labels[..., 0] if labels.dim() == 3 else labels


def crf(input, label, size: int = None, name: Optional[str] = None,
        param_attr=None, **_kw) -> LayerOutput:
    """Linear-chain CRF cost, the negative log-likelihood of the label
    sequence per sequence (``ops/crf.crf_forward``)."""
    _need_seq(input, "crf")
    size = size or input.size
    name = name or unique_name("crf")

    def compute(ctx, p, ins):
        emissions, mask = ins[0].to_padded()
        return pcrf.crf_forward(emissions, mask, p["transitions"],
                                p["start"], p["stop"],
                                _padded_labels(ins[1]))

    return LayerOutput(name=name, layer_type="crf", inputs=[input, label],
                       fn=compute, params=_crf_params(size, param_attr),
                       size=1, is_cost=True)


def crf_decoding(input, size: int = None, label=None,
                 name: Optional[str] = None, param_attr=None,
                 **_kw) -> LayerOutput:
    """Viterbi decode: the best path's ids as a sequence (int32 [capacity,
    1]), or with ``label`` the per-token error (f32 1.0 where the path
    differs)."""
    _need_seq(input, "crf_decoding")
    size = size or input.size
    name = name or unique_name("crf_decoding")
    inputs = [input] + ([label] if label is not None else [])

    def compute(ctx, p, ins):
        sb = ins[0]
        emissions, mask = sb.to_padded()
        path = pcrf.crf_viterbi(emissions, mask, p["transitions"],
                                p["start"], p["stop"])
        if label is not None:
            labels = _padded_labels(ins[1]).to(path.dtype)
            out = ((path != labels) & mask)[..., None].float()
        else:
            out = path[..., None]
        return SequenceBatch.from_padded(out, sb.lengths,
                                         capacity=sb.capacity)

    return LayerOutput(name=name, layer_type="crf_decoding", inputs=inputs,
                       fn=compute, params=_crf_params(size, param_attr),
                       size=1, is_sequence=True)


# ---------------------------------------------------------------------------
# sequence surgery
# ---------------------------------------------------------------------------


def seq_concat(a, b, name: Optional[str] = None, **_kw) -> LayerOutput:
    """Sequence i of ``a`` then sequence i of ``b``, along time."""
    name = name or unique_name("seq_concat")
    return LayerOutput(name=name, layer_type="seq_concat", inputs=[a, b],
                       fn=lambda ctx, p, ins: pseq.seq_concat(ins[0],
                                                              ins[1]),
                       size=a.size, is_sequence=True)


def seq_reshape(input, reshape_size: int, name: Optional[str] = None,
                **_kw) -> LayerOutput:
    """Each sequence's tokens re-cut to width ``reshape_size``."""
    _need_seq(input, "seq_reshape")
    name = name or unique_name("seq_reshape")
    return LayerOutput(name=name, layer_type="seq_reshape", inputs=[input],
                       fn=lambda ctx, p, ins: pseq.seq_reshape(
                           ins[0], reshape_size),
                       size=reshape_size, is_sequence=True)


def seq_slice(input, starts=None, ends=None,
              name: Optional[str] = None) -> LayerOutput:
    """Positions [start, end) of each sequence; ``starts``/``ends`` are
    layers of per-sequence positions, or None for 0 and the length."""
    _need_seq(input, "seq_slice")
    name = name or unique_name("seq_slice")
    extra = [x for x in (starts, ends) if x is not None]

    def compute(ctx, p, ins):
        sb = ins[0]
        rest = iter(ins[1:])
        s = (_data_of(next(rest)).reshape(-1).to(torch.int32)
             if starts is not None else
             torch.zeros((sb.num_seqs,), dtype=torch.int32,
                         device=sb.lengths.device))
        e = (_data_of(next(rest)).reshape(-1).to(torch.int32)
             if ends is not None else sb.lengths)
        return pseq.seq_slice(sb, s, e)

    return LayerOutput(name=name, layer_type="seq_slice",
                       inputs=[input] + extra, fn=compute, size=input.size,
                       is_sequence=True)


def kmax_seq_score(input, beam_size: int,
                   name: Optional[str] = None) -> LayerOutput:
    """Positions of each sequence's ``beam_size`` best scores."""
    _need_seq(input, "kmax_seq_score")
    name = name or unique_name("kmax_seq_score")
    return LayerOutput(name=name, layer_type="kmax_seq_score",
                       inputs=[input],
                       fn=lambda ctx, p, ins: pseq.kmax_seq_score(
                           ins[0], beam_size),
                       size=beam_size, is_sequence=False)


def sub_nested_seq(input, selected_indices,
                   name: Optional[str] = None) -> LayerOutput:
    """The inner sequences of a nested sequence that ``selected_indices``
    names."""
    name = name or unique_name("sub_nested_seq")
    return LayerOutput(name=name, layer_type="sub_nested_seq",
                       inputs=[input, selected_indices],
                       fn=lambda ctx, p, ins: pseq.sub_nested_seq(
                           ins[0], _data_of(ins[1]).to(torch.int32)),
                       size=input.size, is_sequence=True)


def max_id(input, name: Optional[str] = None) -> LayerOutput:
    """The argmax id of each row (token)."""
    name = name or unique_name("max_id")
    return LayerOutput(name=name, layer_type="max_id", inputs=[input],
                       fn=lambda ctx, p, ins: _like(
                           ins[0], pseq.max_id(_data_of(ins[0]))),
                       size=1, is_sequence=input.is_sequence)


def get_output(input, arg_name: str = "default",
               name: Optional[str] = None) -> LayerOutput:
    """A named output of a layer: an :func:`lstm_step`'s c_t for
    ``arg_name`` "state" or "cell", else the layer's value under a new
    name."""
    if arg_name in ("state", "cell") and getattr(input, "lstm_size", None):
        return lstm_step_state(input, name=name)
    name = name or unique_name("get_output")
    node = LayerOutput(name=name, layer_type="get_output", inputs=[input],
                       fn=lambda ctx, p, ins: ins[0], size=input.size,
                       is_sequence=input.is_sequence)
    return _propagate_img_shape(node, input)


class BeamInput:
    """One beam expansion of :func:`cross_entropy_over_beam`: candidate
    scores, the selected candidates' ids, the gold id and, optionally,
    each candidate's parent slot in the previous expansion."""

    def __init__(self, candidate_scores, selected_candidates, gold,
                 prev_ids=None):
        self.candidate_scores = candidate_scores
        self.selected_candidates = selected_candidates
        self.gold = gold
        self.prev_ids = prev_ids


def cross_entropy_over_beam(input, name: Optional[str] = None
                            ) -> LayerOutput:
    """The globally normalized beam cost (``ops/losses.
    cross_entropy_over_beam``) over a list of :class:`BeamInput`."""
    beams = [input] if isinstance(input, BeamInput) else list(input)
    for b in beams:
        enforce_that(isinstance(b, BeamInput),
                     "cross_entropy_over_beam takes BeamInput(s)",
                     context="cross_entropy_over_beam")
    name = name or unique_name("cross_entropy_over_beam")
    inputs, arity = [], []
    for b in beams:
        ins_b = [b.candidate_scores, b.selected_candidates, b.gold] + \
            ([b.prev_ids] if b.prev_ids is not None else [])
        arity.append(len(ins_b))
        inputs += ins_b

    def rows(x):
        x = _data_of(x)
        return x.reshape(1, -1) if x.dim() == 1 else x

    def compute(ctx, p, ins):
        entries, i = [], 0
        for n in arity:
            entry = [rows(ins[i]), rows(ins[i + 1]).long(),
                     _data_of(ins[i + 2]).reshape(-1)]
            if n == 4:
                entry.append(rows(ins[i + 3]).long())
            entries.append(tuple(entry))
            i += n
        return ploss.cross_entropy_over_beam(entries)

    return LayerOutput(name=name, layer_type="cross_entropy_over_beam",
                       inputs=inputs, fn=compute, size=1, is_cost=True)


# ---------------------------------------------------------------------------
# the recurrent group surface (recurrent.py) and its step layers
# ---------------------------------------------------------------------------

from paddle_tpu_torch.recurrent import (StaticInput,  # noqa: E402
                                        SubsequenceInput, memory,
                                        recurrent_group)


def gru_step(input, output_mem, size: int = None, act=None, gate_act=None,
             name: Optional[str] = None, param_attr=None,
             bias_attr=True) -> LayerOutput:
    """One GRU step inside a ``recurrent_group``: ``input`` is x_t
    projected to [B, 3 * size], ``output_mem`` the memory of h_{t-1}.
    The plain cell (``ops/rnn.gru_cell``), as in the JAX package."""
    size = size or output_mem.size
    name = name or unique_name("gru_step")
    params = {"w": ParamSpec((size, 3 * size), ParamAttr.to_attr(param_attr))}
    has_bias = bool(bias_attr)
    if has_bias:
        params["b"] = ParamSpec((3 * size,), ParamAttr.to_attr(
            None if bias_attr is True else bias_attr))
    cand = act_mod.get(act or "tanh")
    gate = act_mod.get(gate_act or "sigmoid")

    def compute(ctx, p, ins):
        return prnn.gru_cell(_data_of(ins[0]), _data_of(ins[1]), p["w"],
                             p.get("b"), gate_act=gate.fn, cand_act=cand.fn)

    return LayerOutput(name=name, layer_type="gru_step",
                       inputs=[input, output_mem], fn=compute, params=params,
                       size=size, is_sequence=False)


def lstm_step(input, state_mem, output_mem=None, size: int = None, act=None,
              gate_act=None, state_act=None, name: Optional[str] = None,
              param_attr=None, bias_attr=True) -> LayerOutput:
    """One LSTM step: ``input`` is x_t projected to [B, 4 * size],
    ``state_mem`` the memory of c_{t-1}, ``output_mem`` that of h_{t-1}
    (without it the recurrence is pre-projected into ``input`` and the
    step has no weight).  Its value is [h_t, c_t] side by side; split it
    with :func:`lstm_step_output` and :func:`lstm_step_state`."""
    size = size or state_mem.size
    name = name or unique_name("lstm_step")
    params = {}
    if output_mem is not None:
        params["w"] = ParamSpec((size, 4 * size),
                                ParamAttr.to_attr(param_attr))
    if bias_attr:
        params["b"] = ParamSpec((4 * size,), ParamAttr.to_attr(
            None if bias_attr is True else bias_attr))
    o_act = act_mod.get(act or "tanh")
    g_act = act_mod.get(gate_act or "sigmoid")
    s_act = act_mod.get(state_act or "tanh")
    inputs = [input, state_mem] + ([output_mem] if output_mem is not None
                                   else [])

    def compute(ctx, p, ins):
        x, c = _data_of(ins[0]), _data_of(ins[1])
        h = _data_of(ins[2]) if len(ins) > 2 else torch.zeros_like(c)
        new_h, st = prnn.lstm_cell(x, prnn.LSTMState(h, c), p.get("w"),
                                   p.get("b"), gate_act=g_act.fn,
                                   cell_act=s_act.fn, out_act=o_act.fn)
        return torch.cat([new_h, st.c], dim=-1)

    node = LayerOutput(name=name, layer_type="lstm_step", inputs=inputs,
                       fn=compute, params=params, size=2 * size,
                       is_sequence=False)
    node.lstm_size = size
    return node


def lstm_step_output(step_node, name: Optional[str] = None) -> LayerOutput:
    """The h_t half of an :func:`lstm_step` node."""
    size = step_node.lstm_size
    return LayerOutput(name=name or unique_name("lstm_h"),
                       layer_type="lstm_h", inputs=[step_node],
                       fn=lambda ctx, p, ins: _data_of(ins[0])[..., :size],
                       size=size, is_sequence=False)


def lstm_step_state(step_node, name: Optional[str] = None) -> LayerOutput:
    """The c_t half of an :func:`lstm_step` node."""
    size = step_node.lstm_size
    return LayerOutput(name=name or unique_name("lstm_c"),
                       layer_type="lstm_c", inputs=[step_node],
                       fn=lambda ctx, p, ins: _data_of(ins[0])[..., size:],
                       size=size, is_sequence=False)

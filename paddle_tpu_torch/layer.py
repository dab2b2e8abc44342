"""The layer DSL (the port of ``paddle_tpu/layer.py``, all of its 112
names): data, fc, embedding, norms, addto, concat and dropout; ``mixed``
with every projection and operator; the image layers (2-D and 3-D
convolutions and pools, batch norm, cross-map norm, spp, maxout,
bilinear resize, pad, crop, rotate, block expand, switch order); the
recurrent layers, the step layers and ``recurrent_group``'s surface from
``recurrent.py``, the 2-D ``mdlstmemory``; multi-head attention; the
vector layers (interpolation, scaling, power, norms, cosines, clip,
resize, prelu, scale-shift, data norm, trans, tensor, outer product,
multiplex, conv shift, linear and convex combinations, row conv,
featmap expand, print); the sequence layers; every cost (classification,
cross entropies, square error and regression, the binary and soft
binary ones, rank and lambda, huber, smooth L1, sum, nce, hsigmoid,
ctc, the CRF, the beam cost, the fused LM head); sampling_id,
selective_fc, eos; the SSD suite (priorbox, multibox_loss,
detection_output).  ``moe_ffn`` raises: it comes with the parallel
slice.

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

import numpy as np
import torch

from paddle_tpu_torch import activation as act_mod
from paddle_tpu_torch import pooling as pooling_mod
from paddle_tpu_torch.attr import ExtraAttr, ParamAttr
from paddle_tpu_torch.data_type import InputType, SeqKind
from paddle_tpu_torch.initializer import Constant
from paddle_tpu_torch.ops import attention as pattn
from paddle_tpu_torch.ops import conv as pconv
from paddle_tpu_torch.ops import crf as pcrf
from paddle_tpu_torch.ops import detection as pdet
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
           "lm_head_cost",
           # the rest of the v2 surface
           "interpolation", "scaling", "power", "sum_to_one_norm",
           "row_l2_norm", "cos_sim", "clip", "resize", "spp", "maxout",
           "bilinear_interp", "pad", "crop", "rotate", "block_expand",
           "sampling_id", "selective_fc", "nce", "hsigmoid", "ctc",
           "warp_ctc", "cross_entropy_with_selfnorm_cost",
           "square_error_cost", "regression_cost",
           "soft_binary_class_cross_entropy_cost", "rank_cost",
           "lambda_cost", "huber_regression_cost",
           "huber_classification_cost", "smooth_l1_cost", "sum_cost",
           "moe_ffn", "eos", "prelu", "scale_shift", "data_norm", "trans",
           "switch_order", "tensor", "out_prod", "multiplex", "conv_shift",
           "linear_comb", "convex_comb", "cos_vm", "row_conv", "subseq",
           "featmap_expand", "print_layer", "img_conv3d", "img_pool3d",
           "mdlstmemory", "priorbox", "multibox_loss", "detection_output",
           "gated_recurrent"]


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


# ---------------------------------------------------------------------------
# the rest of the v2 surface: vector layers
# ---------------------------------------------------------------------------


def _per_row(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-example scalar column [B, 1, ...] against ``like``."""
    return w.reshape(w.shape[0], *([1] * (like.dim() - 1)))


def interpolation(input, weight, name: Optional[str] = None) -> LayerOutput:
    """``w a + (1 - w) b``, w a scalar an example; ``input`` is [a, b]."""
    a, b = _as_list(input)
    name = name or unique_name("interpolation")

    def compute(ctx, p, ins):
        va, vb, w = _data_of(ins[0]), _data_of(ins[1]), _data_of(ins[2])
        w = _per_row(w, va)
        return _like(ins[0], w * va + (1.0 - w) * vb)

    return LayerOutput(name=name, layer_type="interpolation",
                       inputs=[a, b, weight], fn=compute, size=a.size,
                       is_sequence=a.is_sequence)


def scaling(input, weight, name: Optional[str] = None) -> LayerOutput:
    """Each row scaled by its example's scalar."""
    name = name or unique_name("scaling")

    def compute(ctx, p, ins):
        v, w = _data_of(ins[0]), _data_of(ins[1])
        return _like(ins[0], _per_row(w, v) * v)

    return LayerOutput(name=name, layer_type="scaling", inputs=[input, weight],
                       fn=compute, size=input.size,
                       is_sequence=input.is_sequence)


def power(input, weight, name: Optional[str] = None) -> LayerOutput:
    """``x ** w`` elementwise, w a scalar an example."""
    name = name or unique_name("power")

    def compute(ctx, p, ins):
        v, w = _data_of(ins[0]), _data_of(ins[1])
        return _like(ins[0], torch.pow(v, _per_row(w, v)))

    return LayerOutput(name=name, layer_type="power", inputs=[input, weight],
                       fn=compute, size=input.size,
                       is_sequence=input.is_sequence)


def sum_to_one_norm(input, name: Optional[str] = None) -> LayerOutput:
    """Each row over its sum."""
    name = name or unique_name("sum_to_one_norm")
    return LayerOutput(name=name, layer_type="sum_to_one_norm",
                       inputs=[input],
                       fn=lambda ctx, p, ins: _like(
                           ins[0], pnorm.sum_to_one_norm(_data_of(ins[0]))),
                       size=input.size, is_sequence=input.is_sequence)


def row_l2_norm(input, name: Optional[str] = None) -> LayerOutput:
    """Each row over its L2 norm."""
    name = name or unique_name("row_l2_norm")
    return LayerOutput(name=name, layer_type="row_l2_norm", inputs=[input],
                       fn=lambda ctx, p, ins: _like(
                           ins[0], pnorm.row_l2_norm(_data_of(ins[0]))),
                       size=input.size, is_sequence=input.is_sequence)


def cos_sim(a, b, scale: float = 1.0,
            name: Optional[str] = None) -> LayerOutput:
    """Cosine similarity of two layers' rows, times ``scale`` ([B, 1])."""
    name = name or unique_name("cos_sim")

    def compute(ctx, p, ins):
        return ploss.cosine_similarity(_data_of(ins[0]), _data_of(ins[1]),
                                       scale)[..., None]

    return LayerOutput(name=name, layer_type="cos_sim", inputs=[a, b],
                       fn=compute, size=1, is_sequence=a.is_sequence)


def clip(input, min: float, max: float,
         name: Optional[str] = None) -> LayerOutput:
    """Elementwise clip to [min, max]; a value on a bound passes half its
    gradient, as ``jnp.clip`` does."""
    name = name or unique_name("clip")
    lo, hi = min, max

    def compute(ctx, p, ins):
        return _like(ins[0], ploss.clip(_data_of(ins[0]), lo, hi))

    return LayerOutput(name=name, layer_type="clip", inputs=[input],
                       fn=compute, size=input.size,
                       is_sequence=input.is_sequence)


def resize(input, size: int, name: Optional[str] = None) -> LayerOutput:
    """The batch matrix re-cut to rows of ``size`` (B * input.size / size
    rows); a sequence takes ``seq_reshape``."""
    name = name or unique_name("resize")
    enforce_that(not input.is_sequence,
                 "resize reshapes the dense batch matrix; use seq_reshape "
                 "for sequences", context="resize")
    return LayerOutput(name=name, layer_type="resize", inputs=[input],
                       fn=lambda ctx, p, ins: _data_of(ins[0]).reshape(
                           -1, size),
                       size=size, is_sequence=False)


def prelu(input, partial_sum: int = 1, param_attr=None,
          name: Optional[str] = None) -> LayerOutput:
    """Parametric ReLU, one slope ``w`` a group of ``partial_sum``
    features."""
    name = name or unique_name("prelu")
    enforce_that(input.size % partial_sum == 0,
                 "prelu partial_sum must divide input size", context="prelu")
    n_slopes = input.size // partial_sum
    params = {"w": ParamSpec((n_slopes,), ParamAttr.to_attr(param_attr))}

    def compute(ctx, p, ins):
        x = _data_of(ins[0])
        flat = x.reshape(x.shape[0], n_slopes, partial_sum)
        slope = p["w"].reshape(1, n_slopes, 1)
        y = torch.where(flat >= 0, flat, slope * flat).reshape(x.shape)
        return _like(ins[0], y)

    node = LayerOutput(name=name, layer_type="prelu", inputs=[input],
                       fn=compute, params=params, size=input.size,
                       is_sequence=input.is_sequence)
    return _propagate_img_shape(node, input)


def scale_shift(input, param_attr=None, bias_attr=True,
                name: Optional[str] = None) -> LayerOutput:
    """``w x + b``, w and b learned scalars."""
    name = name or unique_name("scale_shift")
    params = {"w": ParamSpec((1,), ParamAttr.to_attr(param_attr))}
    has_bias = bool(bias_attr)
    if has_bias:
        params["b"] = ParamSpec((1,), ParamAttr.to_attr(
            None if bias_attr is True else bias_attr))

    def compute(ctx, p, ins):
        y = _data_of(ins[0]) * p["w"][0]
        if has_bias:
            y = y + p["b"][0]
        return _like(ins[0], y)

    return LayerOutput(name=name, layer_type="scale_shift", inputs=[input],
                       fn=compute, params=params, size=input.size,
                       is_sequence=input.is_sequence)


def data_norm(input, mean=None, std=None, mode: str = "z-score",
              name: Optional[str] = None) -> LayerOutput:
    """Normalization by fixed statistics: ``z-score`` and ``min-max``
    compute ``(x - mean) / max(std, 1e-8)`` (min-max reads them as the
    minimum and the range), ``decimal-scaling`` ``x / 10 **
    ceil(log10(std))``."""
    name = name or unique_name("data_norm")
    enforce_that(mode in ("z-score", "min-max", "decimal-scaling"),
                 f"bad data_norm mode {mode}", context="data_norm")
    mean_a = torch.as_tensor(0.0 if mean is None else mean,
                             dtype=torch.float32)
    std_a = torch.as_tensor(1.0 if std is None else std, dtype=torch.float32)

    def compute(ctx, p, ins):
        x = _data_of(ins[0])
        m, s = mean_a.to(x.device), torch.clamp(std_a.to(x.device),
                                                min=1e-8)
        if mode == "decimal-scaling":
            y = x / torch.pow(10.0, torch.ceil(torch.log10(s)))
        else:
            y = (x - m) / s
        return _like(ins[0], y)

    return LayerOutput(name=name, layer_type="data_norm", inputs=[input],
                       fn=compute, size=input.size,
                       is_sequence=input.is_sequence)


def trans(input, name: Optional[str] = None) -> LayerOutput:
    """The [B, size] batch matrix transposed."""
    name = name or unique_name("trans")
    return LayerOutput(name=name, layer_type="trans", inputs=[input],
                       fn=lambda ctx, p, ins: _data_of(ins[0]).t(),
                       size=None, is_sequence=False)


def switch_order(input, reshape_to=("h", "w", "c"),
                 name: Optional[str] = None) -> LayerOutput:
    """Flat image rows switched between CHW and HWC order (to HWC by
    default)."""
    name = name or unique_name("switch_order")
    in_shape = _img_shape_of(input)
    enforce_that(in_shape is not None, "switch_order needs image shape",
                 context="switch_order")
    h, w, c = in_shape
    to_hwc = tuple(reshape_to) == ("h", "w", "c")

    def compute(ctx, p, ins):
        x = _data_of(ins[0])
        n = x.shape[0]
        if to_hwc:
            y = x.reshape(n, c, h, w).permute(0, 2, 3, 1)
        else:
            y = x.reshape(n, h, w, c).permute(0, 3, 1, 2)
        return y.reshape(n, -1)

    node = LayerOutput(name=name, layer_type="switch_order", inputs=[input],
                       fn=compute, size=input.size)
    node.img_shape = (h, w, c)
    return node


def tensor(a, b, size: int, act=None, param_attr=None,
           name: Optional[str] = None) -> LayerOutput:
    """Bilinear product ``out[k] = a W_k b^T``, W [size, a.size, b.size]."""
    name = name or unique_name("tensor")
    activation = act_mod.get(act)
    params = {"w": ParamSpec((size, a.size, b.size),
                             ParamAttr.to_attr(param_attr))}

    def compute(ctx, p, ins):
        x, y = _data_of(ins[0]), _data_of(ins[1])
        return _apply_act(activation,
                          torch.einsum("bi,kij,bj->bk", x, p["w"], y))

    return LayerOutput(name=name, layer_type="tensor", inputs=[a, b],
                       fn=compute, params=params, size=size)


def out_prod(a, b, name: Optional[str] = None) -> LayerOutput:
    """Each example's outer product of its two rows, flattened."""
    name = name or unique_name("out_prod")

    def compute(ctx, p, ins):
        x, y = _data_of(ins[0]), _data_of(ins[1])
        return (x[:, :, None] * y[:, None, :]).reshape(x.shape[0], -1)

    return LayerOutput(name=name, layer_type="out_prod", inputs=[a, b],
                       fn=compute, size=a.size * b.size)


def multiplex(index, inputs, name: Optional[str] = None) -> LayerOutput:
    """Row i from the candidate layer ``index[i]`` names."""
    cands = _as_list(inputs)
    name = name or unique_name("multiplex")

    def compute(ctx, p, ins):
        idx = _data_of(ins[0]).reshape(-1).long()
        stack = torch.stack([_data_of(v) for v in ins[1:]], dim=0)
        sel = idx[None, :, None].expand(1, -1, stack.shape[2])
        return torch.gather(stack, 0, sel)[0]

    return LayerOutput(name=name, layer_type="multiplex",
                       inputs=[index] + cands, fn=compute,
                       size=cands[0].size)


def conv_shift(a, b, name: Optional[str] = None) -> LayerOutput:
    """Circular convolution of each row of ``a`` with its row of ``b``
    (an odd-width kernel centred on the row's position)."""
    name = name or unique_name("conv_shift")
    enforce_that(b.size % 2 == 1, "conv_shift kernel width must be odd",
                 context="conv_shift")
    half = b.size // 2

    def compute(ctx, p, ins):
        x, k = _data_of(ins[0]), _data_of(ins[1])
        stack = torch.stack([torch.roll(x, half - j, dims=1)
                             for j in range(k.shape[1])], dim=-1)
        return torch.einsum("bmk,bk->bm", stack, k)

    return LayerOutput(name=name, layer_type="conv_shift", inputs=[a, b],
                       fn=compute, size=a.size)


def linear_comb(weights, vectors, size: int,
                name: Optional[str] = None) -> LayerOutput:
    """``sum_m w[:, m] x[:, m, :]`` over the M sub-vectors of ``vectors``
    [B, M * size]."""
    name = name or unique_name("linear_comb")

    def compute(ctx, p, ins):
        w, x = _data_of(ins[0]), _data_of(ins[1])
        return torch.einsum("bm,bmd->bd", w,
                            x.reshape(x.shape[0], w.shape[1], size))

    return LayerOutput(name=name, layer_type="linear_comb",
                       inputs=[weights, vectors], fn=compute, size=size)


def convex_comb(weights, vectors, size: int,
                name: Optional[str] = None) -> LayerOutput:
    """:func:`linear_comb` under its other registered name."""
    return linear_comb(weights, vectors, size, name=name)


def cos_vm(a, b, size: int, scale: float = 1.0,
           name: Optional[str] = None) -> LayerOutput:
    """Cosine similarity of ``a`` [B, D] against each of the M rows packed
    in ``b`` [B, M * D], times ``scale``."""
    name = name or unique_name("cos_vm")

    def compute(ctx, p, ins):
        x, y = _data_of(ins[0]), _data_of(ins[1])
        m = y.shape[1] // x.shape[1]
        ym = y.reshape(y.shape[0], m, x.shape[1])
        num = torch.einsum("bd,bmd->bm", x, ym)
        den = torch.linalg.norm(x, dim=1, keepdim=True) * \
            torch.linalg.norm(ym, dim=2)
        return scale * num / torch.clamp(den, min=1e-8)

    return LayerOutput(name=name, layer_type="cos_vm", inputs=[a, b],
                       fn=compute, size=size)


def row_conv(input, context_len: int, act=None, param_attr=None,
             name: Optional[str] = None) -> LayerOutput:
    """Lookahead convolution over each sequence's next ``context_len``
    frames (``w`` [context_len, size]); frames past a sequence's end
    count zero."""
    _need_seq(input, "row_conv")
    name = name or unique_name("row_conv")
    activation = act_mod.get(act)
    params = {"w": ParamSpec((context_len, input.size),
                             ParamAttr.to_attr(param_attr))}

    def compute(ctx, p, ins):
        sb = ins[0]
        x, seg = sb.data, sb.segment_ids
        total = torch.zeros_like(x)
        for j in range(context_len):
            shifted = torch.cat([x[j:], x.new_zeros((j,) + x.shape[1:])])
            seg_sh = torch.cat([seg[j:], seg.new_full((j,), -1)])
            ok = (seg_sh == seg)[:, None]
            total = total + torch.where(ok, shifted * p["w"][j][None, :],
                                        torch.zeros_like(x))
        return sb.with_data(_apply_act(activation, total))

    return LayerOutput(name=name, layer_type="row_conv", inputs=[input],
                       fn=compute, params=params, size=input.size,
                       is_sequence=True)


def subseq(input, offsets, sizes, name: Optional[str] = None) -> LayerOutput:
    """Positions [offset, offset + size) of each sequence; ``offsets`` and
    ``sizes`` are layers of one integer a sequence."""
    _need_seq(input, "subseq")
    name = name or unique_name("subseq")

    def compute(ctx, p, ins):
        s = _data_of(ins[1]).reshape(-1).to(torch.int32)
        n = _data_of(ins[2]).reshape(-1).to(torch.int32)
        return pseq.seq_slice(ins[0], s, s + n)

    return LayerOutput(name=name, layer_type="subseq",
                       inputs=[input, offsets, sizes], fn=compute,
                       size=input.size, is_sequence=True)


def featmap_expand(input, num_filters: int, as_row_vector: bool = True,
                   name: Optional[str] = None) -> LayerOutput:
    """Each row tiled ``num_filters`` times (``as_row_vector=False``:
    each element repeated ``num_filters`` times)."""
    name = name or unique_name("featmap_expand")

    def compute(ctx, p, ins):
        x = _data_of(ins[0])
        y = x.repeat(1, num_filters) if as_row_vector else \
            torch.repeat_interleave(x, num_filters, dim=1)
        return _like(ins[0], y)

    return LayerOutput(name=name, layer_type="featmap_expand",
                       inputs=[input], fn=compute,
                       size=input.size * num_filters,
                       is_sequence=input.is_sequence)


def print_layer(input, format: Optional[str] = None,
                name: Optional[str] = None) -> LayerOutput:
    """Prints its input at each forward (``format`` with ``{x}``, the
    value as numpy prints it) and passes it on unchanged."""
    name = name or unique_name("print")
    fmt = format or (name + ": {x}")

    def compute(ctx, p, ins):
        v = ins[0]
        print(fmt.format(x=_data_of(v).detach().cpu().numpy()))
        return v

    node = LayerOutput(name=name, layer_type="print", inputs=[input],
                       fn=compute, size=input.size,
                       is_sequence=input.is_sequence)
    return _propagate_img_shape(node, input)


def eos(input, eos_id: int, name: Optional[str] = None) -> LayerOutput:
    """Each sequence cut before its first ``eos_id`` token."""
    _need_seq(input, "eos")
    name = name or unique_name("eos")

    def compute(ctx, p, ins):
        sb: SequenceBatch = ins[0]
        ids, mask = sb.to_padded()
        tok = ids[..., 0] if ids.dim() == 3 else ids
        is_eos = (tok == eos_id) & mask
        first = torch.argmax(is_eos.to(torch.int32), dim=1)
        new_len = torch.where(is_eos.any(dim=1), first,
                              sb.lengths.long()).to(torch.int32)
        return pseq.seq_slice(sb, torch.zeros_like(new_len), new_len)

    return LayerOutput(name=name, layer_type="eos", inputs=[input],
                       fn=compute, size=input.size, is_sequence=True)


def moe_ffn(input, num_experts: int = 0, expert_hidden: int = 0, **_kw):
    """The mixture-of-experts FFN comes with the parallel slice."""
    raise EnforceError("moe_ffn comes with the parallel slice (A12: the "
                       "expert mesh, parallel/moe.py); the port has no "
                       "expert routing yet", context="moe_ffn")


# ---------------------------------------------------------------------------
# the rest of the v2 surface: image layers
# ---------------------------------------------------------------------------


def spp(input, pyramid_height: int, num_channels: int = None, pool_type=None,
        name: Optional[str] = None) -> LayerOutput:
    """Spatial pyramid pooling (``ops/pool.spatial_pyramid_pool``)."""
    name = name or unique_name("spp")
    in_shape = _img_shape_of(input)
    enforce_that(in_shape is not None, "spp needs image shape", context="spp")
    ptype = pooling_mod.get(pool_type)
    out_size = sum(4 ** lv for lv in range(pyramid_height)) * in_shape[2]

    def compute(ctx, p, ins):
        x = _to_nhwc(_data_of(ins[0]), in_shape)
        return ppool.spatial_pyramid_pool(
            x, pyramid_height,
            "max" if isinstance(ptype, pooling_mod.MaxPooling) else "avg")

    return LayerOutput(name=name, layer_type="spp", inputs=[input],
                       fn=compute, size=out_size)


def maxout(input, groups: int, num_channels: int = None,
           name: Optional[str] = None) -> LayerOutput:
    """Max over channel groups (``ops/pool.maxout``)."""
    name = name or unique_name("maxout")
    in_shape = _img_shape_of(input)
    enforce_that(in_shape is not None, "maxout needs image shape",
                 context="maxout")
    h, w, c = in_shape
    oc = c // groups

    def compute(ctx, p, ins):
        return ppool.maxout(_to_nhwc(_data_of(ins[0]), in_shape), groups)

    node = LayerOutput(name=name, layer_type="maxout", inputs=[input],
                       fn=compute, size=h * w * oc)
    node.img_shape = (h, w, oc)
    return node


def bilinear_interp(input, out_size_x: int, out_size_y: int,
                    name: Optional[str] = None) -> LayerOutput:
    """Bilinear resize to (out_size_y, out_size_x): half-pixel centres,
    antialiased when shrinking, as ``jax.image.resize(..., "bilinear")``
    (``F.interpolate(..., antialias=True)``)."""
    name = name or unique_name("bilinear_interp")
    in_shape = _img_shape_of(input)
    enforce_that(in_shape is not None, "bilinear_interp needs image shape",
                 context="bilinear_interp")
    c = in_shape[2]

    def compute(ctx, p, ins):
        x = _to_nhwc(_data_of(ins[0]), in_shape).permute(0, 3, 1, 2)
        y = torch.nn.functional.interpolate(
            x, size=(out_size_y, out_size_x), mode="bilinear",
            align_corners=False, antialias=True)
        return y.permute(0, 2, 3, 1)

    node = LayerOutput(name=name, layer_type="bilinear_interp",
                       inputs=[input], fn=compute,
                       size=out_size_x * out_size_y * c)
    node.img_shape = (out_size_y, out_size_x, c)
    return node


def pad(input, pad_c=(0, 0), pad_h=(0, 0), pad_w=(0, 0),
        name: Optional[str] = None) -> LayerOutput:
    """Zeros added around the channels, rows and columns of image maps."""
    name = name or unique_name("pad")
    in_shape = _img_shape_of(input)
    enforce_that(in_shape is not None, "pad needs image shape", context="pad")
    h, w, c = in_shape
    oshape = (h + sum(pad_h), w + sum(pad_w), c + sum(pad_c))

    def compute(ctx, p, ins):
        x = _to_nhwc(_data_of(ins[0]), in_shape)
        return torch.nn.functional.pad(
            x, tuple(pad_c) + tuple(pad_w) + tuple(pad_h))

    node = LayerOutput(name=name, layer_type="pad", inputs=[input],
                       fn=compute, size=oshape[0] * oshape[1] * oshape[2])
    node.img_shape = oshape
    return node


def crop(input, offset_h: int = 0, offset_w: int = 0, crop_h: int = None,
         crop_w: int = None, name: Optional[str] = None) -> LayerOutput:
    """A window of image maps (to the far edges by default)."""
    name = name or unique_name("crop")
    in_shape = _img_shape_of(input)
    enforce_that(in_shape is not None, "crop needs image shape",
                 context="crop")
    h, w, c = in_shape
    ch = crop_h or h - offset_h
    cw = crop_w or w - offset_w

    def compute(ctx, p, ins):
        x = _to_nhwc(_data_of(ins[0]), in_shape)
        return x[:, offset_h:offset_h + ch, offset_w:offset_w + cw, :]

    node = LayerOutput(name=name, layer_type="crop", inputs=[input],
                       fn=compute, size=ch * cw * c)
    node.img_shape = (ch, cw, c)
    return node


def rotate(input, name: Optional[str] = None) -> LayerOutput:
    """Image maps turned 90 degrees counter-clockwise."""
    name = name or unique_name("rotate")
    in_shape = _img_shape_of(input)
    enforce_that(in_shape is not None, "rotate needs image shape",
                 context="rotate")
    h, w, c = in_shape

    def compute(ctx, p, ins):
        return torch.rot90(_to_nhwc(_data_of(ins[0]), in_shape), 1,
                           dims=(1, 2))

    node = LayerOutput(name=name, layer_type="rotate", inputs=[input],
                       fn=compute, size=input.size)
    node.img_shape = (w, h, c)
    return node


def block_expand(input, block_x: int, block_y: int, stride_x: int = 1,
                 stride_y: int = 1, padding_x: int = 0, padding_y: int = 0,
                 num_channels: int = None,
                 name: Optional[str] = None) -> LayerOutput:
    """im2col: each block of image maps a row (``ops/conv.block_expand``)."""
    name = name or unique_name("block_expand")
    in_shape = _img_shape_of(input)
    enforce_that(in_shape is not None, "block_expand needs image shape",
                 context="block_expand")
    c = in_shape[2]

    def compute(ctx, p, ins):
        x = _to_nhwc(_data_of(ins[0]), in_shape)
        return pconv.block_expand(x, (block_y, block_x), (stride_y, stride_x),
                                  (padding_y, padding_x))

    return LayerOutput(name=name, layer_type="block_expand", inputs=[input],
                       fn=compute, size=block_x * block_y * c)


def _vol_shape_of(node: LayerOutput):
    """(D, H, W, C) of a node's volumes."""
    return getattr(node, "vol_shape", None)


def img_conv3d(input, filter_size, num_filters: int, num_channels=None,
               stride: int = 1, padding: int = 0, act=None,
               bias_attr=True, param_attr=None, trans: bool = False,
               depth: int = None, height: int = None, width: int = None,
               name: Optional[str] = None) -> LayerOutput:
    """3-D convolution (``trans=True``: transposed) of flat DHWC volumes;
    weights ``[kd, kh, kw, C, num_filters]`` (``[kd, kh, kw, num_filters,
    C]`` transposed), the JAX package's layout.  The forward conv takes
    ``ops/conv.conv3d`` (cuDNN, channels-last), the transposed one
    ``F.conv_transpose3d`` in the input's dtype, as the JAX package runs
    its ``lax`` conv."""
    name = name or unique_name("conv3d")
    activation = act_mod.get(act)
    vol = _vol_shape_of(input)
    if vol is None:
        enforce_that(None not in (depth, height, width, num_channels),
                     "img_conv3d needs vol shape metadata or "
                     "depth/height/width/num_channels", context="conv3d")
        vol = (depth, height, width, num_channels)
    d, h, w, c = vol
    k = (filter_size,) * 3 if isinstance(filter_size, int) \
        else tuple(filter_size)
    if trans:
        od, oh, ow = ((n - 1) * stride + kk - 2 * padding
                      for n, kk in zip((d, h, w), k))
    else:
        od, oh, ow = (_conv_out_dim(n, kk, padding, stride)
                      for n, kk in zip((d, h, w), k))
    wshape = k + ((num_filters, c) if trans else (c, num_filters))
    params = {"w": ParamSpec(wshape, ParamAttr.to_attr(param_attr))}
    has_bias = bool(bias_attr)
    if has_bias:
        params["b"] = ParamSpec((num_filters,), ParamAttr.to_attr(
            None if bias_attr is True else bias_attr))

    def compute(ctx, p, ins):
        x = _data_of(ins[0]).reshape(-1, d, h, w, c)
        if trans:
            wt = p["w"].permute(4, 3, 0, 1, 2).to(x.dtype)
            y = torch.nn.functional.conv_transpose3d(
                x.permute(0, 4, 1, 2, 3), wt, stride=stride,
                padding=padding).permute(0, 2, 3, 4, 1)
        else:
            y = pconv.conv3d(x, p["w"], stride=stride, padding=padding)
        if has_bias:
            y = y + p["b"]
        y = _apply_act(activation, y)
        return y.reshape(y.shape[0], -1)

    node = LayerOutput(name=name, layer_type="conv3d", inputs=[input],
                       fn=compute, params=params,
                       size=od * oh * ow * num_filters)
    node.vol_shape = (od, oh, ow, num_filters)
    return node


def img_pool3d(input, pool_size, pool_type=None, stride: int = None,
               padding: int = 0, name: Optional[str] = None,
               **_kw) -> LayerOutput:
    """Max (default) or average 3-D pooling of flat DHWC volumes; the
    average divides by the whole window, padding included."""
    name = name or unique_name("pool3d")
    ptype = pooling_mod.get(pool_type)
    stride = stride if stride is not None else pool_size
    vol = _vol_shape_of(input)
    enforce_that(vol is not None, "img_pool3d needs vol shape",
                 context="pool3d")
    d, h, w, c = vol
    k = (pool_size,) * 3 if isinstance(pool_size, int) else tuple(pool_size)
    od, oh, ow = (_conv_out_dim(n, kk, padding, stride)
                  for n, kk in zip((d, h, w), k))
    is_max = isinstance(ptype, pooling_mod.MaxPooling)

    def compute(ctx, p, ins):
        x = _data_of(ins[0]).reshape(-1, d, h, w, c).permute(0, 4, 1, 2, 3)
        if padding:
            # padded explicitly (-inf for max, zeros counted for avg, as
            # JAX's reduce_window): torch pads at most half a window
            x = torch.nn.functional.pad(
                x, (padding,) * 6, value=-float("inf") if is_max else 0.0)
        if is_max:
            y = torch.nn.functional.max_pool3d(x, k, stride)
        else:
            y = torch.nn.functional.avg_pool3d(x, k, stride)
        return y.permute(0, 2, 3, 4, 1).reshape(y.shape[0], -1)

    node = LayerOutput(name=name, layer_type="pool3d", inputs=[input],
                       fn=compute, size=od * oh * ow * c)
    node.vol_shape = (od, oh, ow, c)
    return node


# ---------------------------------------------------------------------------
# the rest of the v2 surface: sampling, selective and tree costs, CTC
# ---------------------------------------------------------------------------


def _draw_ids(gen: torch.Generator, probs: torch.Tensor) -> torch.Tensor:
    """One id a row drawn from the row's distribution (probabilities
    clipped to [1e-20, 1], unnormalized), from ``gen``."""
    p = torch.clamp(probs.float(), 1e-20, 1.0)
    return torch.multinomial(p, 1, generator=gen)[:, 0]


def sampling_id(input, name: Optional[str] = None) -> LayerOutput:
    """An id drawn from each row's distribution (int32), from the step's
    stream of this node.  The JAX package draws from ``jax.random``,
    which torch cannot replay: the law is the same, the draws are not."""
    name = name or unique_name("sampling_id")

    def compute(ctx, p, ins):
        v = ins[0]
        ids = _draw_ids(ctx.rng_for(name), _data_of(v))
        return _like(v, ids.to(torch.int32))

    return LayerOutput(name=name, layer_type="sampling_id", inputs=[input],
                       fn=compute, size=1, is_sequence=input.is_sequence)


def selective_fc(input, size: int, select=None, act=None,
                 name: Optional[str] = None, param_attr=None,
                 bias_attr=True, **_kw) -> LayerOutput:
    """An fc whose output columns outside ``select`` (a [B, size] 0/1
    layer, sparse binary rows) are 0; the whole product is computed."""
    inputs = [input] + ([select] if select is not None else [])
    name = name or unique_name("selective_fc")
    activation = act_mod.get(act)
    params = {"w": ParamSpec((input.size, size),
                             ParamAttr.to_attr(param_attr))}
    has_bias = bool(bias_attr)
    if has_bias:
        params["b"] = ParamSpec((size,), ParamAttr.to_attr(
            None if bias_attr is True else bias_attr))

    def compute(ctx, p, ins):
        y = pmath.fc(_data_of(ins[0]), p["w"], p.get("b"))
        if select is not None:
            y = torch.where(_data_of(ins[1]) > 0, y, torch.zeros_like(y))
        return _apply_act(activation, _like(ins[0], y))

    return LayerOutput(name=name, layer_type="selective_fc", inputs=inputs,
                       fn=compute, params=params, size=size,
                       is_sequence=input.is_sequence)


def _nce_negatives(gen: torch.Generator, batch: int, k: int,
                   num_classes: int, dist, device) -> torch.Tensor:
    """[batch, k] negative class ids: uniform, or from ``dist``."""
    if dist is None:
        return torch.randint(0, num_classes, (batch, k), generator=gen,
                             device=device)
    d = torch.clamp(torch.as_tensor(dist, dtype=torch.float32,
                                    device=device), 1e-20, 1.0)
    return torch.multinomial(d.expand(batch, -1), k, replacement=True,
                             generator=gen)


def nce(input, label, num_classes: int, num_neg_samples: int = 10,
        name: Optional[str] = None, param_attr=None, bias_attr=True,
        neg_distribution=None) -> LayerOutput:
    """Noise-contrastive estimation cost per example: logistic loss of
    the label's logit (target 1) and of ``num_neg_samples`` noise
    classes' (target 0), drawn uniformly or from ``neg_distribution``
    from the step's stream of this node.  ``w`` [num_classes, size]."""
    name = name or unique_name("nce")
    params = {"w": ParamSpec((num_classes, input.size),
                             ParamAttr.to_attr(param_attr))}
    has_bias = bool(bias_attr)
    if has_bias:
        params["b"] = ParamSpec((num_classes,), ParamAttr.to_attr(
            None if bias_attr is True else bias_attr))

    def compute(ctx, p, ins):
        x = _data_of(ins[0])
        y = _data_of(ins[1]).reshape(-1).long()
        B = x.shape[0]
        neg = _nce_negatives(ctx.rng_for(name), B, num_neg_samples,
                             num_classes, neg_distribution, x.device)
        ids = torch.cat([y[:, None], neg.long()], dim=1)      # [B, 1 + k]
        rows = p["w"][ids]                                    # [B, 1 + k, D]
        logits = torch.einsum("bd,bkd->bk", x, rows)
        if has_bias:
            logits = logits + p["b"][ids]
        labels01 = torch.cat([logits.new_ones((B, 1)),
                              logits.new_zeros((B, num_neg_samples))], 1)
        return ploss.sigmoid_cross_entropy_with_logits(logits, labels01)

    return LayerOutput(name=name, layer_type="nce", inputs=[input, label],
                       fn=compute, params=params, size=1, is_cost=True)


def hsigmoid(input, label, num_classes: int, name: Optional[str] = None,
             param_attr=None, bias_attr=True) -> LayerOutput:
    """Hierarchical sigmoid cost over a complete binary tree of
    ``num_classes`` leaves: the sum of the logistic losses of the nodes
    on the label's path (a node's target 1 when the path turns left),
    ``w`` [num_classes - 1, size]."""
    name = name or unique_name("hsigmoid")
    num_nodes = num_classes - 1
    code_len = max(1, int(math.ceil(math.log2(max(2, num_classes)))))
    params = {"w": ParamSpec((num_nodes, input.size),
                             ParamAttr.to_attr(param_attr))}
    has_bias = bool(bias_attr)
    if has_bias:
        params["b"] = ParamSpec((num_nodes,), ParamAttr.to_attr(
            None if bias_attr is True else bias_attr))

    def compute(ctx, p, ins):
        x = _data_of(ins[0])
        node = _data_of(ins[1]).reshape(-1).long() + num_nodes + 1
        losses = x.new_zeros((x.shape[0],))
        for _ in range(code_len):
            parent = node >> 1
            t = 1.0 - (node & 1).to(x.dtype)        # left child: target 1
            idx = torch.clamp(parent - 1, 0, num_nodes - 1)
            logit = (x * p["w"][idx]).sum(-1)
            if has_bias:
                logit = logit + p["b"][idx]
            step = torch.maximum(logit, logit.new_zeros(())) - logit * t + \
                torch.log1p(torch.exp(-logit.abs()))
            losses = losses + torch.where(parent >= 1, step,
                                          torch.zeros_like(step))
            node = parent
        return losses

    return LayerOutput(name=name, layer_type="hsigmoid",
                       inputs=[input, label], fn=compute, params=params,
                       size=1, is_cost=True)


def ctc(input, label, size: int = None, blank: int = 0,
        norm_by_times: bool = False,
        name: Optional[str] = None) -> LayerOutput:
    """CTC cost per sequence on unnormalized logits (``ops/losses.
    ctc_loss``, ``optax.ctc_loss``'s recursion); ``norm_by_times``
    divides by the input's length."""
    _need_seq(input, "ctc")
    name = name or unique_name("ctc")

    def compute(ctx, p, ins):
        sb, lb = ins[0], ins[1]
        logits, mask = sb.to_padded()
        labels, lab_mask = lb.to_padded()
        if labels.dim() == 3:
            labels = labels[..., 0]
        loss = ploss.ctc_loss(logits, 1.0 - mask.to(torch.float32),
                              labels.to(torch.int32),
                              1.0 - lab_mask.to(torch.float32),
                              blank_id=blank)
        if norm_by_times:
            loss = loss / torch.clamp(sb.lengths.to(loss.dtype), min=1.0)
        return loss

    return LayerOutput(name=name, layer_type="ctc", inputs=[input, label],
                       fn=compute, size=1, is_cost=True)


def warp_ctc(input, label, size: int = None, blank: int = 0,
             norm_by_times: bool = False,
             name: Optional[str] = None) -> LayerOutput:
    """:func:`ctc` under the reference's warp-ctc name."""
    return ctc(input, label, size=size, blank=blank,
               norm_by_times=norm_by_times,
               name=name or unique_name("warp_ctc"))


# ---------------------------------------------------------------------------
# the rest of the v2 surface: cost layers
# ---------------------------------------------------------------------------


def _cost_node(name, ltype, inputs, fn) -> LayerOutput:
    return LayerOutput(name=name, layer_type=ltype, inputs=inputs, fn=fn,
                       size=1, is_cost=True)


def cross_entropy_with_selfnorm_cost(input, label,
                                     softmax_selfnorm_alpha: float = 0.1,
                                     name: Optional[str] = None
                                     ) -> LayerOutput:
    """Softmax cross entropy plus ``alpha logZ^2`` per example."""
    name = name or unique_name("cross_entropy_with_selfnorm")

    def compute(ctx, p, ins):
        return _per_example(
            lambda lg, lb: ploss.cross_entropy_with_selfnorm(
                lg, lb.reshape(lb.shape[0]), softmax_selfnorm_alpha),
            ins[0], ins[1])

    return _cost_node(name, "cross_entropy_with_selfnorm", [input, label],
                      compute)


def square_error_cost(input, label, name: Optional[str] = None,
                      **_kw) -> LayerOutput:
    """``0.5 ||p - t||^2`` per example."""
    name = name or unique_name("square_error")

    def compute(ctx, p, ins):
        return _per_example(lambda a, b: ploss.square_error(
            a, b.reshape(a.shape)), ins[0], ins[1])

    return _cost_node(name, "square_error", [input, label], compute)


regression_cost = square_error_cost


def soft_binary_class_cross_entropy_cost(input, label,
                                         name: Optional[str] = None
                                         ) -> LayerOutput:
    """Binary cross entropy on probabilities (clipped to [1e-7, 1 -
    1e-7]) against soft labels, summed over the features."""
    name = name or unique_name("soft_binary_xent")

    def f(pr, lb):
        pr = ploss.clip(pr, 1e-7, 1 - 1e-7)
        return -(lb * torch.log(pr) + (1 - lb) * torch.log(1 - pr)).sum(-1)

    return _cost_node(name, "soft_binary_xent", [input, label],
                      lambda ctx, p, ins: _per_example(f, ins[0], ins[1]))


def rank_cost(left, right, label, weight=None,
              name: Optional[str] = None) -> LayerOutput:
    """Pairwise ranking cost (``ops/losses.rank_cost``)."""
    name = name or unique_name("rank_cost")
    inputs = [left, right, label] + ([weight] if weight is not None else [])

    def compute(ctx, p, ins):
        w = _data_of(ins[3]) if weight is not None else None
        return ploss.rank_cost(_data_of(ins[0]), _data_of(ins[1]),
                               _data_of(ins[2]), w)

    return _cost_node(name, "rank_cost", inputs, compute)


def lambda_cost(input, score, NDCG_num: int = 5, max_sort_size: int = -1,
                name: Optional[str] = None) -> LayerOutput:
    """LambdaRank-style cost of each query (a sequence of document
    scores, ``score`` their relevances): the mean logistic loss over the
    pairs a more relevant document should win, over the ideal DCG of the
    top ``NDCG_num`` relevances (at least 1)."""
    name = name or unique_name("lambda_cost")
    _need_seq(input, "lambda_cost")

    def compute(ctx, p, ins):
        pred, mask = ins[0].to_padded()
        rel, _ = ins[1].to_padded()
        pred = pred[..., 0] if pred.dim() == 3 else pred
        rel = rel[..., 0] if rel.dim() == 3 else rel
        T = pred.shape[1]
        neg_inf = rel.new_full((), -float("inf"))
        # stable, as JAX's sort: tied relevances pass their gradients to
        # the same positions
        sorted_rel = torch.sort(torch.where(mask, rel, neg_inf), dim=1,
                                descending=True, stable=True).values
        k = torch.arange(T, device=pred.device, dtype=rel.dtype)
        disc = 1.0 / torch.log2(k + 2.0)
        topk = (k < NDCG_num)[None, :]
        finite = torch.isfinite(sorted_rel)
        gains = torch.pow(2.0, torch.where(finite, sorted_rel,
                                           torch.zeros_like(rel))) - 1.0
        idcg = (gains * disc * topk * finite).sum(dim=1)
        sdiff = pred[:, :, None] - pred[:, None, :]
        rdiff = rel[:, :, None] - rel[:, None, :]
        pair = mask[:, :, None] & mask[:, None, :] & (rdiff > 0)
        logistic = torch.log1p(torch.exp(-sdiff))
        loss = torch.where(pair, logistic,
                           torch.zeros_like(logistic)).sum(dim=(1, 2))
        denom = torch.clamp(pair.sum(dim=(1, 2)), min=1)
        return loss / denom / torch.clamp(idcg, min=1.0)

    return _cost_node(name, "lambda_cost", [input, score], compute)


def huber_regression_cost(input, label, delta: float = 1.0,
                          name: Optional[str] = None) -> LayerOutput:
    """Huber loss at ``delta`` per example."""
    name = name or unique_name("huber_regression")

    def compute(ctx, p, ins):
        return _per_example(lambda a, b: ploss.huber_regression(
            a, b.reshape(a.shape), delta), ins[0], ins[1])

    return _cost_node(name, "huber_regression", [input, label], compute)


def huber_classification_cost(input, label,
                              name: Optional[str] = None) -> LayerOutput:
    """Two-class huber loss per example on 0/1 labels."""
    name = name or unique_name("huber_classification")
    return _cost_node(name, "huber_classification", [input, label],
                      lambda ctx, p, ins: _per_example(
                          ploss.huber_classification, ins[0], ins[1]))


def smooth_l1_cost(input, label, name: Optional[str] = None) -> LayerOutput:
    """Smooth L1 per example."""
    name = name or unique_name("smooth_l1")

    def compute(ctx, p, ins):
        return _per_example(lambda a, b: ploss.smooth_l1(
            a, b.reshape(a.shape)), ins[0], ins[1])

    return _cost_node(name, "smooth_l1", [input, label], compute)


def sum_cost(input, name: Optional[str] = None) -> LayerOutput:
    """The input summed as a cost: per example, or per sequence (its
    tokens summed in order)."""
    name = name or unique_name("sum_cost")

    def compute(ctx, p, ins):
        v = ins[0]
        d = _data_of(v)
        out = d.sum(dim=tuple(range(1, d.dim()))) if d.dim() > 1 else d
        if isinstance(v, SequenceBatch):
            return pseq.seq_pool_sum(v.with_data(out))
        return out

    return _cost_node(name, "sum_cost", [input], compute)


# ---------------------------------------------------------------------------
# the rest of the v2 surface: the 2-D LSTM
# ---------------------------------------------------------------------------


def mdlstmemory(input, size: int, height: int, width: int,
                param_attr=None, bias_attr=True,
                name: Optional[str] = None) -> LayerOutput:
    """2-D LSTM over [B, H * W * C] images: cell (i, j) reads the states
    of (i - 1, j) and (i, j - 1); gates input, forget a direction, output
    and candidate (``wx`` [C, 5 size], ``wr``/``wc`` [size, 5 size],
    ``b``).  Output [B, H * W * size].

    The JAX package scans rows, then columns in a row (H x W steps).  The
    cells of one anti-diagonal i + j = d depend only on diagonal d - 1,
    so here each of the H + W - 1 diagonals is one batched step over its
    cells, the same arithmetic a cell."""
    name = name or unique_name("mdlstm")
    enforce_that(input.size % (height * width) == 0,
                 "mdlstm input size must be H*W*C", context="mdlstm")
    c_in = input.size // (height * width)
    attr = ParamAttr.to_attr(param_attr)
    params = {"wx": ParamSpec((c_in, 5 * size), attr),
              "wr": ParamSpec((size, 5 * size), attr),
              "wc": ParamSpec((size, 5 * size), attr)}
    has_bias = bool(bias_attr)
    if has_bias:
        params["b"] = ParamSpec((5 * size,), ParamAttr.to_attr(
            None if bias_attr is True else bias_attr))
    diags = [[(i, d - i) for i in range(max(0, d - width + 1),
                                        min(d, height - 1) + 1)]
             for d in range(height + width - 1)]
    # row-major cell (i, j) -> its slot in the diagonals' concatenation
    slot = {cell: n for n, cell in
            enumerate(cell for diag in diags for cell in diag)}
    order = torch.tensor([slot[(i, j)] for i in range(height)
                          for j in range(width)])

    def compute(ctx, p, ins):
        x = _data_of(ins[0])
        b = x.shape[0]
        grid = x.reshape(b, height * width, c_in)
        xs = torch.einsum("bnc,cg->nbg", grid, p["wx"])    # [H W, B, 5s]
        if has_bias:
            xs = xs + p["b"]
        zeros = x.new_zeros((1, b, size))
        hs, h_prev, c_prev, lo_prev = [], None, None, 0
        for diag in diags:
            lo, n = diag[0][0], len(diag)
            pre = xs[torch.tensor([i * width + j for i, j in diag],
                                  device=x.device)]
            if h_prev is None:
                h_up = c_up = h_left = c_left = zeros.expand(n, -1, -1)
            else:
                hp = torch.cat([zeros, h_prev, zeros])
                cp = torch.cat([zeros, c_prev, zeros])
                a = lo - lo_prev
                h_up, c_up = hp[a:a + n], cp[a:a + n]
                h_left, c_left = hp[a + 1:a + 1 + n], cp[a + 1:a + 1 + n]
            z = pre + h_up @ p["wr"] + h_left @ p["wc"]
            i_g, f_r, f_c, o_g, g = torch.chunk(z, 5, dim=-1)
            c_new = torch.sigmoid(f_r) * c_up + torch.sigmoid(f_c) * c_left \
                + torch.sigmoid(i_g) * torch.tanh(g)
            h_new = torch.sigmoid(o_g) * torch.tanh(c_new)
            hs.append(h_new)
            h_prev, c_prev, lo_prev = h_new, c_new, lo
        cells = torch.cat(hs).index_select(0, order.to(x.device))
        return cells.permute(1, 0, 2).reshape(b, -1)

    node = LayerOutput(name=name, layer_type="mdlstm", inputs=[input],
                       fn=compute, params=params,
                       size=height * width * size)
    node.img_shape = (height, width, size)
    return node


gated_recurrent = grumemory


# ---------------------------------------------------------------------------
# the rest of the v2 surface: the SSD detection suite
# ---------------------------------------------------------------------------


def priorbox(input, image_size, min_size, max_size=(), aspect_ratio=(2.0,),
             variance=(0.1, 0.1, 0.2, 0.2),
             name: Optional[str] = None) -> LayerOutput:
    """The prior boxes of a feature map as one row [1, P * 8]: the boxes,
    then their variances (``ops/detection.prior_boxes``)."""
    name = name or unique_name("priorbox")
    in_shape = _img_shape_of(input)
    enforce_that(in_shape is not None, "priorbox needs image shape",
                 context="priorbox")
    fh, fw, _ = in_shape
    ih, iw = (image_size, image_size) if isinstance(image_size, int) \
        else tuple(image_size)
    min_sizes = [min_size] if isinstance(min_size, (int, float)) \
        else list(min_size)
    max_sizes = [max_size] if isinstance(max_size, (int, float)) \
        else list(max_size)
    boxes_np, var_np = pdet.prior_boxes(fh, fw, ih, iw, min_sizes,
                                        max_sizes, list(aspect_ratio),
                                        list(variance))
    flat = torch.from_numpy(np.concatenate([boxes_np.reshape(-1),
                                            var_np.reshape(-1)]))[None, :]

    def compute(ctx, p, ins):
        return flat.to(_data_of(ins[0]).device)

    node = LayerOutput(name=name, layer_type="priorbox", inputs=[input],
                       fn=compute, size=boxes_np.shape[0] * 8)
    node.num_priors = boxes_np.shape[0]
    return node


def _gather_ssd_preds(ins, k, num_classes):
    """The feature maps' location and confidence predictions side by side
    ([B, P, 4], [B, P, C]) and the prior row: one packing for the loss
    and the detection output."""
    loc = torch.cat([_data_of(v).reshape(_data_of(v).shape[0], -1, 4)
                     for v in ins[:k]], dim=1)
    conf = torch.cat([_data_of(v).reshape(_data_of(v).shape[0], -1,
                                          num_classes)
                      for v in ins[k:2 * k]], dim=1)
    return loc, conf, _data_of(ins[2 * k])[0]


def _split_priors(pb_flat, num_p):
    return pb_flat[:num_p * 4].reshape(num_p, 4), \
        pb_flat[num_p * 4:].reshape(num_p, 4)


def multibox_loss(input_loc, input_conf, priorbox, label, num_classes: int,
                  overlap_threshold: float = 0.5, neg_pos_ratio: float = 3.0,
                  background_id: int = 0, max_boxes: int = 16,
                  name: Optional[str] = None) -> LayerOutput:
    """SSD loss per example ([B, 1]); ``label`` is a dense [B, max_boxes *
    5] layer of (class, xmin, ymin, xmax, ymax) rows, class < 0 padding
    (``ops/detection.multibox_loss``)."""
    locs, confs = _as_list(input_loc), _as_list(input_conf)
    name = name or unique_name("multibox_loss")
    num_p = priorbox.num_priors

    def compute(ctx, p, ins):
        k = len(locs)
        loc, conf, pb = _gather_ssd_preds(ins, k, num_classes)
        gt = _data_of(ins[2 * k + 1]).reshape(loc.shape[0], max_boxes, 5)
        boxes, var = _split_priors(pb, num_p)
        return pdet.multibox_loss(
            loc, conf, boxes, var, gt[..., 1:5],
            torch.clamp(gt[..., 0], min=0).to(torch.int32), gt[..., 0] >= 0,
            num_classes, overlap_threshold, neg_pos_ratio,
            background_id)[:, None]

    return LayerOutput(name=name, layer_type="multibox_loss",
                       inputs=locs + confs + [priorbox, label], fn=compute,
                       size=1, is_cost=True)


def detection_output(input_loc, input_conf, priorbox, num_classes: int,
                     nms_threshold: float = 0.45,
                     confidence_threshold: float = 0.01,
                     keep_top_k: int = 100, background_id: int = 0,
                     name: Optional[str] = None) -> LayerOutput:
    """Decoded boxes after each class's NMS: [B, keep_top_k * 6] rows of
    (label, score, xmin, ymin, xmax, ymax), label -1 an empty row
    (``ops/detection.detection_output``)."""
    locs, confs = _as_list(input_loc), _as_list(input_conf)
    name = name or unique_name("detection_output")
    num_p = priorbox.num_priors

    def compute(ctx, p, ins):
        k = len(locs)
        loc, conf, pb = _gather_ssd_preds(ins, k, num_classes)
        boxes, var = _split_priors(pb, num_p)
        return pdet.detection_output(
            loc, conf, boxes, var, num_classes, nms_threshold,
            confidence_threshold, keep_top_k, background_id
        ).reshape(loc.shape[0], -1)

    return LayerOutput(name=name, layer_type="detection_output",
                       inputs=locs + confs + [priorbox], fn=compute,
                       size=keep_top_k * 6)

"""The layer DSL (the port of ``paddle_tpu/layer.py``: the transformer
subset ``data``, ``fc``, ``embedding``, ``layer_norm``, ``addto``,
``multi_head_attention`` and ``classification_cost``, the recurrent
subset ``lstmemory``, ``grumemory``, ``pooling``, ``first_seq``,
``last_seq``, ``expand``, the Elman ``recurrent`` layer, the step layers
``gru_step``/``lstm_step`` with ``recurrent_group``, ``memory`` and
``StaticInput`` from ``recurrent.py``, the attention subset ``mixed``
(with ``full_matrix_projection`` and ``identity_projection``),
``dotmul``, ``dotmul_bcast`` and ``cross_entropy_cost``, the convnet
subset ``img_conv``, ``img_pool``, ``batch_norm``, ``img_cmrnorm``,
``dropout`` and ``concat``, and the CTR/GAN subset ``slope_intercept``
and ``multi_binary_label_cross_entropy_cost``).

Each function returns a ``LayerOutput`` graph node whose compute fn is
plain PyTorch on tensors or :class:`SequenceBatch` values; the dtype
policy of each layer is the JAX package's (``ops/math.py``,
``ops/conv.py``).  Image maps are NHWC tensors, as in the JAX package; a
node carries its (H, W, C) in ``img_shape``.  Cost layers return
per-example (per-token) losses; the trainer reduces them.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from paddle_tpu_torch import activation as act_mod
from paddle_tpu_torch import pooling as pooling_mod
from paddle_tpu_torch.attr import ExtraAttr, ParamAttr
from paddle_tpu_torch.data_type import InputType, SeqKind
from paddle_tpu_torch.initializer import Constant
from paddle_tpu_torch.ops import attention as pattn
from paddle_tpu_torch.ops import conv as pconv
from paddle_tpu_torch.ops import losses as ploss
from paddle_tpu_torch.ops import math as pmath
from paddle_tpu_torch.ops import norm as pnorm
from paddle_tpu_torch.ops import pool as ppool
from paddle_tpu_torch.ops import rnn as prnn
from paddle_tpu_torch.ops import sequence_ops as pseq
from paddle_tpu_torch.ops.embedding import embedding_lookup
from paddle_tpu_torch.platform.enforce import enforce_that
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
           "slope_intercept", "multi_binary_label_cross_entropy_cost"]


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


def _apply_extra(ctx: Context, name: str, value, layer_attr):
    """The layer's ``ExtraAttr``: dropout at ``drop_rate`` from the
    node's random stream."""
    rate = ExtraAttr.to_attr(layer_attr).drop_rate
    if rate > 0.0:
        value = _like(value, pmath.dropout(_data_of(value), rate,
                                           ctx.rng_for(name), ctx.train))
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
    def __init__(self, input, size, param_attr=None):
        super().__init__(input, size)
        self.params["w"] = ParamSpec((input.size, size),
                                     ParamAttr.to_attr(param_attr))

    def compute(self, p, value):
        return pmath.matmul(_data_of(value), p["w"])


class _IdentityProjection(Projection):
    def __init__(self, input, offset=0, size=None):
        super().__init__(input, size or input.size)
        self.offset = offset

    def compute(self, p, value):
        return _data_of(value)[..., self.offset:self.offset + self.size]


def full_matrix_projection(input, size: int, param_attr=None) -> Projection:
    """``x W``, W [input.size, size]."""
    return _FullMatrixProjection(input, size, param_attr)


def identity_projection(input, offset: int = 0,
                        size: int = None) -> Projection:
    """Columns ``offset:offset + size`` of the input (all by default)."""
    return _IdentityProjection(input, offset, size)


def mixed(size: int = None, input=None, name: Optional[str] = None,
          act=None, bias_attr=False, layer_attr=None) -> LayerOutput:
    """Sum of projections (a bare layer counts as its identity
    projection), plus a bias, then the activation.  Component i's
    parameters are ``p{i}_<name>``."""
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
    projs = []
    params: Dict[str, ParamSpec] = {}
    for ci, comp in enumerate(comps):
        if isinstance(comp, LayerOutput):
            comp = identity_projection(comp)
        enforce_that(isinstance(comp, Projection),
                     f"bad mixed component {comp!r} (the port has the full "
                     "matrix and identity projections so far)",
                     context="mixed")
        for pn, spec in comp.params.items():
            params[f"p{ci}_{pn}"] = spec
        projs.append((f"p{ci}_", comp))
    has_bias = bool(bias_attr)
    if has_bias:
        params["b"] = ParamSpec((size,), ParamAttr.to_attr(
            None if bias_attr is True else bias_attr))

    def compute(ctx, p, ins):
        total = None
        for (prefix, comp), v in zip(projs, ins):
            local = {k[len(prefix):]: t for k, t in p.items()
                     if k.startswith(prefix)}
            y = comp.compute(local, v)
            total = y if total is None else total + y
        if has_bias:
            total = total + p["b"]
        out = _apply_act(activation, _like(ins[0], total))
        return _apply_extra(ctx, name, out, layer_attr)

    inputs = [comp.input for _, comp in projs]
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


# ---------------------------------------------------------------------------
# the recurrent group surface (recurrent.py) and its step layers
# ---------------------------------------------------------------------------

from paddle_tpu_torch.recurrent import (StaticInput, memory,  # noqa: E402
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

"""Fluid-analog operator library: the registry + one torch compute per op
(the port of ``paddle_tpu/fluid/ops.py``).

Reference analog: paddle/operators/ (76 op families, each a CPU .cc + GPU .cu
kernel pair registered via REGISTER_OP*, framework/op_registry.h) and
paddle/operators/math (shared kernel lib).

ONE implementation per op, written in torch ops: the same function runs on
the CPU and on the card, and no op has a hand-written gradient (grad ops are
``torch.autograd.grad`` through the graph the forward recorded; see
backward.py/executor.py).  The registry equals the JAX package's: the same
103 names, families and flags.

``compute(ins, attrs, ctx)`` takes a dict slot -> list of values and returns
a dict slot -> list of values. Values are ``torch.Tensor`` or ``LoDArray``
(ragged sequence batch; lod_tensor.h:57-80 analog).  Dtypes follow the JAX
package with x64 off: floats compute in float32 (the Executor narrows
float64 feeds), integer results are int32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.platform.enforce import EnforceError, enforce_that

# ---------------------------------------------------------------------------
# LoDArray: the LoDTensor analog flowing through fluid programs
# ---------------------------------------------------------------------------


@dataclass
class LoDArray:
    """Dense data + level-of-detail ragged boundaries.

    ``lod`` is a list of levels, each a python list of monotonically
    increasing offsets (lod_tensor.h:57: LoD = vector<Vector<size_t>>).
    Offsets are host data: the ops that read them build their index plans
    on the host."""

    data: Any
    lod: Tuple[Tuple[int, ...], ...]

    def sequence_ids(self) -> np.ndarray:
        """Per-row segment id from the finest lod level."""
        offs = self.lod[-1]
        ids = np.zeros(offs[-1], np.int32)
        for i in range(len(offs) - 1):
            ids[offs[i]:offs[i + 1]] = i
        return ids

    @property
    def num_sequences(self) -> int:
        return len(self.lod[-1]) - 1


def _dat(v):
    return v.data if isinstance(v, LoDArray) else v


def _like(template, data):
    if isinstance(template, LoDArray):
        return LoDArray(data, template.lod)
    return data


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


@dataclass
class OpInfo:
    type: str
    compute: Callable
    family: str = "misc"
    stateful_outputs: Tuple[str, ...] = ()   # outputs that alias persistables
    no_grad: bool = False                    # not differentiable (metrics etc.)
    uses_rng: bool = False


_REGISTRY: Dict[str, OpInfo] = {}


def register(type: str, *, family: str = "misc", stateful: Sequence[str] = (),
             no_grad: bool = False, uses_rng: bool = False):
    def deco(fn):
        enforce_that(type not in _REGISTRY, f"op {type} already registered",
                     context="fluid")
        _REGISTRY[type] = OpInfo(type, fn, family, tuple(stateful), no_grad,
                                 uses_rng)
        return fn
    return deco


def get(type: str) -> OpInfo:
    enforce_that(type in _REGISTRY, f"unknown op type {type!r}",
                 context="fluid")
    return _REGISTRY[type]


def check_registered(type: str) -> None:
    if type.endswith("_grad"):
        type = type[:-5]
    get(type)


def registered_ops() -> List[str]:
    return sorted(_REGISTRY)


class ComputeCtx:
    """Per-run context: the run's seed, test mode, the device, and the
    sub-block runner hook (set by the Executor)."""

    def __init__(self, seed: int, is_test: bool, device=None,
                 trace_block: Optional[Callable] = None):
        self.seed = int(seed)
        self.is_test = is_test
        self.device = torch.device("cpu") if device is None else device
        self.trace_block = trace_block

    def rng_for(self, salt: int) -> torch.Generator:
        """An explicit generator for one random op of this run, seeded
        from the run's seed and the op's salt (its position)."""
        g = torch.Generator(device=self.device)
        g.manual_seed((self.seed * 1_000_003 + int(salt)) % (2 ** 63))
        return g


def draw_uniform(ctx: ComputeCtx, salt: int, shape, low: float = 0.0,
                 high: float = 1.0) -> torch.Tensor:
    """Uniform [low, high) f32 draws of a random op (one generator a
    draw; the tests replace this function with the JAX package's draws)."""
    u = torch.rand(tuple(shape), generator=ctx.rng_for(salt),
                   device=ctx.device, dtype=torch.float32)
    return u * (high - low) + low


def draw_normal(ctx: ComputeCtx, salt: int, shape) -> torch.Tensor:
    """Standard normal f32 draws of a random op (see draw_uniform)."""
    return torch.randn(tuple(shape), generator=ctx.rng_for(salt),
                       device=ctx.device, dtype=torch.float32)


def _one(ins, slot):
    vs = ins.get(slot, [])
    enforce_that(len(vs) == 1, f"slot {slot} expects 1 input, got {len(vs)}",
                 context="fluid")
    return vs[0]


def _opt(ins, slot, default=None):
    vs = ins.get(slot, [])
    return vs[0] if vs else default


_DTYPES = {"float32": torch.float32, "float64": torch.float32,
           "float16": torch.float16, "bfloat16": torch.bfloat16,
           "int32": torch.int32, "int64": torch.int32, "bool": torch.bool,
           "uint8": torch.uint8}


def _torch_dtype(name) -> torch.dtype:
    """A fluid dtype name as the JAX package computes it (x64 off: the
    64-bit types are 32-bit)."""
    return _DTYPES[str(np.dtype(name).name if not isinstance(name, str)
                       else name)]


def _index(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).long()


# ---------------------------------------------------------------------------
# elementwise family (elementwise_op.cc analog, with axis broadcast)
# ---------------------------------------------------------------------------


def _bcast(x, y, axis: int):
    """Reference broadcast semantics: y's shape matches a contiguous slice of
    x's dims starting at `axis` (elementwise_op.h); -1 = rank(x)-rank(y)."""
    if x.dim() == y.dim():
        return y
    if axis == -1:
        axis = x.dim() - y.dim()
    shape = [1] * x.dim()
    for i, s in enumerate(y.shape):
        shape[axis + i] = s
    return y.reshape(shape)


def _elementwise(fn):
    def compute(ins, attrs, ctx):
        x, y = _one(ins, "X"), _one(ins, "Y")
        xd, yd = _dat(x), _dat(y)
        out = fn(xd, _bcast(xd, yd, int(attrs.get("axis", -1))))
        return {"Out": [_like(x, out)]}
    return compute


for _name, _fn in [("elementwise_add", torch.add),
                   ("elementwise_sub", torch.sub),
                   ("elementwise_mul", torch.mul),
                   ("elementwise_div", torch.div),
                   ("elementwise_pow", torch.pow),
                   ("elementwise_max", torch.maximum),
                   ("elementwise_min", torch.minimum)]:
    register(_name, family="elementwise")(_elementwise(_fn))


# ---------------------------------------------------------------------------
# activations (activation_op.cc bundle)
# ---------------------------------------------------------------------------


def _unary(fn):
    def compute(ins, attrs, ctx):
        x = _one(ins, "X")
        return {"Out": [_like(x, fn(_dat(x), attrs))]}
    return compute


_ACTS = {
    "sigmoid": lambda x, a: torch.sigmoid(x),
    "logsigmoid": lambda x, a: F.logsigmoid(x),
    "exp": lambda x, a: torch.exp(x),
    "relu": lambda x, a: torch.relu(x),
    "tanh": lambda x, a: torch.tanh(x),
    "sqrt": lambda x, a: torch.sqrt(x),
    "abs": lambda x, a: torch.abs(x),
    "reciprocal": lambda x, a: 1.0 / x,
    "log": lambda x, a: torch.log(x),
    "square": lambda x, a: torch.square(x),
    "softsign": lambda x, a: x / (1.0 + torch.abs(x)),
    "brelu": lambda x, a: torch.clamp(x, a.get("t_min", 0.0),
                                      a.get("t_max", 24.0)),
    "soft_relu": lambda x, a: torch.log1p(torch.exp(torch.clamp(
        x, -a.get("threshold", 40.0), a.get("threshold", 40.0)))),
    "pow": lambda x, a: torch.pow(x, a.get("factor", 1.0)),
    "stanh": lambda x, a: a.get("scale_b", 1.7159) * torch.tanh(
        a.get("scale_a", 2.0 / 3.0) * x),
    "leaky_relu": lambda x, a: torch.where(x >= 0, x,
                                           a.get("alpha", 0.02) * x),
    "relu6": lambda x, a: torch.clamp(x, 0.0, a.get("threshold", 6.0)),
    "softplus": lambda x, a: torch.logaddexp(x, torch.zeros_like(x)),
    "hard_shrink": lambda x, a: torch.where(
        torch.abs(x) > a.get("threshold", 0.5), x, torch.zeros_like(x)),
    "soft_shrink": lambda x, a: torch.sign(x) * torch.relu(
        torch.abs(x) - a.get("lambda", 0.5)),
    "elu": lambda x, a: torch.where(x > 0, x, a.get("alpha", 1.0)
                                    * (torch.exp(x) - 1.0)),
    "sign": lambda x, a: torch.sign(x),
    "floor": lambda x, a: torch.floor(x),
    "ceil": lambda x, a: torch.ceil(x),
    "round": lambda x, a: torch.round(x),
}

for _name, _fn in _ACTS.items():
    register(_name, family="activation")(_unary(_fn))


@register("scale", family="elementwise")
def _scale(ins, attrs, ctx):
    x = _one(ins, "X")
    out = _dat(x) * attrs.get("scale", 1.0) + attrs.get("bias", 0.0)
    return {"Out": [_like(x, out)]}


@register("clip", family="elementwise")
def _clip(ins, attrs, ctx):
    x = _one(ins, "X")
    return {"Out": [_like(x, torch.clamp(_dat(x), attrs["min"],
                                         attrs["max"]))]}


@register("cast", family="elementwise")
def _cast(ins, attrs, ctx):
    x = _one(ins, "X")
    return {"Out": [_like(x, _dat(x).to(_torch_dtype(attrs["out_dtype"])))]}


# ---------------------------------------------------------------------------
# matmul family (mul_op / matmul_op)
# ---------------------------------------------------------------------------


@register("mul", family="matmul")
def _mul(ins, attrs, ctx):
    x, y = _dat(_one(ins, "X")), _dat(_one(ins, "Y"))
    xn = int(attrs.get("x_num_col_dims", 1))
    yn = int(attrs.get("y_num_col_dims", 1))
    xm = x.reshape((int(np.prod(x.shape[:xn])), -1))
    ym = y.reshape((int(np.prod(y.shape[:yn])), -1))
    out = xm @ ym
    out_shape = tuple(x.shape[:xn]) + tuple(y.shape[yn:])
    return {"Out": [_like(_one(ins, "X"), out.reshape(out_shape))]}


@register("matmul", family="matmul")
def _matmul(ins, attrs, ctx):
    x, y = _dat(_one(ins, "X")), _dat(_one(ins, "Y"))
    if attrs.get("transpose_X", False):
        x = torch.swapaxes(x, -1, -2)
    if attrs.get("transpose_Y", False):
        y = torch.swapaxes(y, -1, -2)
    return {"Out": [x @ y]}


# ---------------------------------------------------------------------------
# conv / pool (NCHW like the reference).  The JAX package convolves in f32
# whatever its bf16 policy says, so these call cuDNN through
# torch.nn.functional on the NCHW maps as they come, not ops/conv.py's
# NHWC route with its bf16 cast.
# ---------------------------------------------------------------------------


def _pair(v):
    return tuple(int(a) for a in v) if isinstance(v, (list, tuple)) \
        else (int(v), int(v))


@register("conv2d", family="conv")
def _conv2d(ins, attrs, ctx):
    x, w = _dat(_one(ins, "Input")), _dat(_one(ins, "Filter"))
    s, p = _pair(attrs.get("strides", 1)), _pair(attrs.get("paddings", 0))
    d = _pair(attrs.get("dilations", 1))
    groups = int(attrs.get("groups", 1))
    out = F.conv2d(x, w, stride=s, padding=p, dilation=d, groups=groups)
    b = _opt(ins, "Bias")
    if b is not None:
        out = out + _dat(b).reshape(1, -1, 1, 1)
    return {"Output": [out]}


def _dilate(x, s):
    """Insert s - 1 zeros between the spatial elements (lhs dilation)."""
    if all(k == 1 for k in s):
        return x
    size = [(n - 1) * k + 1 for n, k in zip(x.shape[2:], s)]
    out = x.new_zeros(tuple(x.shape[:2]) + tuple(size))
    idx = (slice(None), slice(None)) + tuple(slice(None, None, k)
                                             for k in s)
    out[idx] = x
    return out


@register("conv2d_transpose", family="conv")
def _conv2d_transpose(ins, attrs, ctx):
    """``lax.conv_transpose`` as the JAX package calls it: the input
    dilated by the strides, the explicit paddings applied as given, the
    [in, out, H, W] filter unflipped (no ``transpose_kernel``)."""
    x, w = _dat(_one(ins, "Input")), _dat(_one(ins, "Filter"))
    s, p = _pair(attrs.get("strides", 1)), _pair(attrs.get("paddings", 0))
    out = F.conv2d(_dilate(x, s), w.transpose(0, 1), padding=p)
    return {"Output": [out]}


@register("conv3d", family="conv")
def _conv3d(ins, attrs, ctx):
    x, w = _dat(_one(ins, "Input")), _dat(_one(ins, "Filter"))
    s = tuple(int(a) for a in attrs.get("strides", (1, 1, 1)))
    p = tuple(int(a) for a in attrs.get("paddings", (0, 0, 0)))
    return {"Output": [F.conv3d(x, w, stride=s, padding=p)]}


def _pool(x, ksize, strides, paddings, ptype, exclusive=True):
    k, s, p = _pair(ksize), _pair(strides), _pair(paddings)
    pad = (p[1], p[1], p[0], p[0])
    if ptype == "max":
        xp = F.pad(x, pad, value=float("-inf")) if any(p) else x
        return F.max_pool2d(xp, k, s)
    xp = F.pad(x, pad) if any(p) else x
    mean = F.avg_pool2d(xp, k, s)
    if exclusive and (p[0] or p[1]):
        ones = F.pad(torch.ones_like(x), pad)
        counts = F.avg_pool2d(ones, k, s)
        return mean / counts
    return mean


@register("pool2d", family="pool")
def _pool2d(ins, attrs, ctx):
    x = _dat(_one(ins, "X"))
    if attrs.get("global_pooling", False):
        k = tuple(x.shape[2:4])
        return {"Out": [_pool(x, k, k, 0, attrs.get("pooling_type", "max"))]}
    return {"Out": [_pool(x, attrs.get("ksize", 2),
                          attrs.get("strides", 1), attrs.get("paddings", 0),
                          attrs.get("pooling_type", "max"))]}


@register("pool2d_with_index", family="pool")
def _pool2d_with_index(ins, attrs, ctx):
    """Max pool and each window's argmax as a flat index into the
    unpadded H x W map (the first maximum in the window wins)."""
    x = _dat(_one(ins, "X"))
    k, s = _pair(attrs.get("ksize", 2)), _pair(attrs.get("strides", 1))
    p = _pair(attrs.get("paddings", 0))
    out, idx = F.max_pool2d(x, k, s, padding=p, return_indices=True)
    return {"Out": [out], "Mask": [idx.to(torch.int32)]}


# ---------------------------------------------------------------------------
# batch_norm (batch_norm_op.cc; stateful moving stats)
# ---------------------------------------------------------------------------


@register("batch_norm", family="norm",
          stateful=("MeanOut", "VarianceOut"))
def _batch_norm(ins, attrs, ctx):
    x = _dat(_one(ins, "X"))
    scale, bias = _dat(_one(ins, "Scale")), _dat(_one(ins, "Bias"))
    mean_in = _dat(_one(ins, "Mean"))
    var_in = _dat(_one(ins, "Variance"))
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    layout = attrs.get("data_layout", "NCHW")
    axes = tuple(i for i in range(x.dim())
                 if i != (1 if layout == "NCHW" else x.dim() - 1))
    shape = [1] * x.dim()
    shape[1 if layout == "NCHW" else -1] = -1
    if ctx.is_test or attrs.get("is_test", False):
        mean, var = mean_in, var_in
        mean_out, var_out = mean_in, var_in
    else:
        mean = torch.mean(x, dim=axes)
        var = torch.mean(torch.square(x - mean.reshape(shape)), dim=axes)
        mean_out = momentum * mean_in + (1 - momentum) * mean
        var_out = momentum * var_in + (1 - momentum) * var
    inv = torch.rsqrt(var.reshape(shape) + eps)
    y = (x - mean.reshape(shape)) * inv * scale.reshape(shape) \
        + bias.reshape(shape)
    return {"Y": [y], "MeanOut": [mean_out], "VarianceOut": [var_out],
            "SavedMean": [mean], "SavedVariance": [var]}


@register("lrn", family="norm")
def _lrn(ins, attrs, ctx):
    x = _dat(_one(ins, "X"))
    n = int(attrs.get("n", 5))
    k, alpha, beta = (attrs.get("k", 2.0), attrs.get("alpha", 1e-4),
                      attrs.get("beta", 0.75))
    sq = torch.square(x)
    pad = n // 2
    sq = F.pad(sq, (0, 0, 0, 0, pad, pad))
    acc = sum(sq[:, i:i + x.shape[1]] for i in range(n))
    return {"Out": [x / torch.pow(k + alpha * acc, beta)]}


@register("layer_norm", family="norm")
def _layer_norm(ins, attrs, ctx):
    x = _dat(_one(ins, "X"))
    eps = attrs.get("epsilon", 1e-5)
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    scale, bias = _opt(ins, "Scale"), _opt(ins, "Bias")
    if scale is not None:
        y = y * _dat(scale)
    if bias is not None:
        y = y + _dat(bias)
    return {"Y": [y]}


# ---------------------------------------------------------------------------
# softmax / losses
# ---------------------------------------------------------------------------


@register("softmax", family="softmax")
def _softmax(ins, attrs, ctx):
    x = _one(ins, "X")
    return {"Out": [_like(x, torch.softmax(_dat(x), dim=-1))]}


def _xent(probs, label, soft):
    if soft:
        return -torch.sum(label * torch.log(torch.clamp(probs, min=1e-10)),
                          dim=-1, keepdim=True)
    picked = torch.gather(probs, -1, _index(label)[:, None])
    return -torch.log(torch.clamp(picked, min=1e-10))


@register("cross_entropy", family="loss")
def _cross_entropy(ins, attrs, ctx):
    x, label = _dat(_one(ins, "X")), _dat(_one(ins, "Label"))
    return {"Y": [_xent(x, label, attrs.get("soft_label", False))]}


@register("softmax_with_cross_entropy", family="loss")
def _softmax_xent(ins, attrs, ctx):
    logits, label = _dat(_one(ins, "Logits")), _dat(_one(ins, "Label"))
    logp = torch.log_softmax(logits, dim=-1)
    if attrs.get("soft_label", False):
        loss = -torch.sum(label * logp, dim=-1, keepdim=True)
    else:
        loss = -torch.gather(logp, -1, _index(label)[:, None])
    return {"Softmax": [torch.exp(logp)], "Loss": [loss]}


@register("sigmoid_cross_entropy_with_logits", family="loss")
def _sigmoid_xent(ins, attrs, ctx):
    x, label = _dat(_one(ins, "X")), _dat(_one(ins, "Labels"))
    loss = torch.clamp(x, min=0) - x * label \
        + torch.log1p(torch.exp(-torch.abs(x)))
    return {"Out": [loss]}


@register("squared_l2_distance", family="loss")
def _sq_l2_dist(ins, attrs, ctx):
    x, y = _dat(_one(ins, "X")), _dat(_one(ins, "Y"))
    sub = x - y
    return {"sub_result": [sub],
            "Out": [torch.sum(torch.square(sub), dim=-1, keepdim=True)]}


@register("squared_l2_norm", family="loss")
def _sq_l2_norm(ins, attrs, ctx):
    x = _dat(_one(ins, "X"))
    return {"Out": [torch.sum(torch.square(x)).reshape(1)]}


@register("rank_loss", family="loss")
def _rank_loss(ins, attrs, ctx):
    label = _dat(_one(ins, "Label"))
    left, right = _dat(_one(ins, "Left")), _dat(_one(ins, "Right"))
    d = left - right
    return {"Out": [torch.log1p(torch.exp(d)) - label * d]}


@register("margin_rank_loss", family="loss")
def _margin_rank_loss(ins, attrs, ctx):
    label = _dat(_one(ins, "Label"))
    x1, x2 = _dat(_one(ins, "X1")), _dat(_one(ins, "X2"))
    margin = attrs.get("margin", 0.0)
    out = torch.relu(-label * (x1 - x2) + margin)
    return {"Out": [out], "Activated": [(out > 0).to(x1.dtype)]}


@register("smooth_l1_loss", family="loss")
def _smooth_l1(ins, attrs, ctx):
    x, y = _dat(_one(ins, "X")), _dat(_one(ins, "Y"))
    sigma2 = attrs.get("sigma", 1.0) ** 2
    diff = x - y
    iw, ow = _opt(ins, "InsideWeight"), _opt(ins, "OutsideWeight")
    if iw is not None:
        diff = diff * _dat(iw)
    ad = torch.abs(diff)
    val = torch.where(ad < 1.0 / sigma2, 0.5 * sigma2 * diff * diff,
                      ad - 0.5 / sigma2)
    if ow is not None:
        val = val * _dat(ow)
    return {"Diff": [diff],
            "Out": [torch.sum(val, dim=-1, keepdim=True)]}


@register("huber_loss", family="loss")
def _huber(ins, attrs, ctx):
    x, y = _dat(_one(ins, "X")), _dat(_one(ins, "Y"))
    delta = attrs.get("delta", 1.0)
    r = y - x
    ar = torch.abs(r)
    out = torch.where(ar <= delta, 0.5 * r * r, delta * (ar - 0.5 * delta))
    return {"Residual": [r], "Out": [out]}


# ---------------------------------------------------------------------------
# embeddings / gather / scatter
# ---------------------------------------------------------------------------


@register("lookup_table", family="embedding")
def _lookup_table(ins, attrs, ctx):
    w, ids = _dat(_one(ins, "W")), _one(ins, "Ids")
    out = w.index_select(0, _index(_dat(ids)))
    return {"Out": [_like(ids, out)]}


@register("gather", family="embedding")
def _gather(ins, attrs, ctx):
    x, idx = _dat(_one(ins, "X")), _dat(_one(ins, "Index"))
    return {"Out": [x.index_select(0, _index(idx))]}


@register("scatter", family="embedding")
def _scatter(ins, attrs, ctx):
    ref = _dat(_one(ins, "Ref"))
    idx = _index(_dat(_one(ins, "Index")))
    upd = _dat(_one(ins, "Updates"))
    return {"Out": [ref.index_put((idx,), upd.to(ref.dtype))]}


# ---------------------------------------------------------------------------
# shape ops
# ---------------------------------------------------------------------------


@register("reshape", family="shape")
def _reshape(ins, attrs, ctx):
    x = _dat(_one(ins, "X"))
    return {"Out": [x.reshape([int(s) for s in attrs["shape"]])]}


@register("transpose", family="shape")
def _transpose(ins, attrs, ctx):
    x = _dat(_one(ins, "X"))
    return {"Out": [x.permute(*[int(a) for a in attrs["axis"]])]}


@register("concat", family="shape")
def _concat(ins, attrs, ctx):
    xs = [_dat(v) for v in ins["X"]]
    return {"Out": [torch.cat(xs, dim=int(attrs.get("axis", 0)))]}


@register("split", family="shape")
def _split(ins, attrs, ctx):
    x = _dat(_one(ins, "X"))
    axis = int(attrs.get("axis", 0))
    if "sections" in attrs and attrs["sections"]:
        outs = torch.split(x, [int(s) for s in attrs["sections"]], dim=axis)
    else:
        n = int(attrs["num"])
        outs = torch.split(x, x.shape[axis] // n, dim=axis)
    return {"Out": list(outs)}


@register("pad", family="shape")
def _pad(ins, attrs, ctx):
    x = _dat(_one(ins, "X"))
    p = attrs["paddings"]
    pads = []
    for i in reversed(range(x.dim())):      # F.pad: last dim first
        pads += [int(p[2 * i]), int(p[2 * i + 1])]
    return {"Out": [F.pad(x, pads, value=float(attrs.get("pad_value",
                                                         0.0)))]}


@register("crop", family="shape")
def _crop(ins, attrs, ctx):
    x = _dat(_one(ins, "X"))
    idx = tuple(slice(int(o), int(o) + int(s))
                for o, s in zip(attrs["offsets"], attrs["shape"]))
    return {"Out": [x[idx]]}


@register("squeeze", family="shape")
def _squeeze(ins, attrs, ctx):
    x = _dat(_one(ins, "X"))
    axes = attrs.get("axes")
    if not axes:
        return {"Out": [torch.squeeze(x)]}
    return {"Out": [torch.squeeze(x, dim=tuple(int(a) for a in axes))]}


@register("unsqueeze", family="shape")
def _unsqueeze(ins, attrs, ctx):
    out = _dat(_one(ins, "X"))
    for a in sorted(attrs["axes"]):
        out = torch.unsqueeze(out, int(a))
    return {"Out": [out]}


# ---------------------------------------------------------------------------
# reductions / stats
# ---------------------------------------------------------------------------


def _reduce(fn):
    def compute(ins, attrs, ctx):
        x = _dat(_one(ins, "X"))
        dim = attrs.get("dim")
        keep = attrs.get("keep_dim", False)
        if attrs.get("reduce_all", dim is None):
            return {"Out": [fn(x, tuple(range(x.dim())), False)]}
        return {"Out": [fn(x, int(dim), keep)]}
    return compute


for _name, _fn in [
        ("reduce_sum", lambda x, d, k: torch.sum(x, dim=d, keepdim=k)),
        ("reduce_mean", lambda x, d, k: torch.mean(x, dim=d, keepdim=k)),
        # amax/amin: a tie's gradient is shared evenly, as JAX's max
        ("reduce_max", lambda x, d, k: torch.amax(x, dim=d, keepdim=k)),
        ("reduce_min", lambda x, d, k: torch.amin(x, dim=d, keepdim=k))]:
    register(_name, family="reduce")(_reduce(_fn))


@register("mean", family="reduce")
def _mean(ins, attrs, ctx):
    return {"Out": [torch.mean(_dat(_one(ins, "X")))]}


@register("sum", family="reduce")
def _sum(ins, attrs, ctx):
    xs = [_dat(v) for v in ins["X"]]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": [out]}


@register("minus", family="elementwise")
def _minus(ins, attrs, ctx):
    return {"Out": [_dat(_one(ins, "X")) - _dat(_one(ins, "Y"))]}


@register("top_k", family="search", no_grad=True)
def _top_k(ins, attrs, ctx):
    x = _dat(_one(ins, "X"))
    vals, idx = torch.topk(x, int(attrs.get("k", 1)), dim=-1)
    return {"Out": [vals], "Indices": [idx.to(torch.int32)]}


@register("accuracy", family="metric", no_grad=True)
def _accuracy(ins, attrs, ctx):
    pred = _dat(_one(ins, "Out"))          # top-k indices [N, k]
    label = _dat(_one(ins, "Label")).reshape(-1, 1)
    correct = torch.any(pred.long() == label.long(), dim=1)
    # int32 counters, as the JAX package's (its 32-bit default)
    n = pred.shape[0]
    num_correct = torch.sum(correct).to(torch.int32)
    return {"Accuracy": [num_correct.to(torch.float32) / n],
            "Correct": [num_correct],
            "Total": [torch.tensor(n, dtype=torch.int32,
                                   device=pred.device)]}


@register("argmax", family="search", no_grad=True)
def _argmax(ins, attrs, ctx):
    x = _dat(_one(ins, "X"))
    return {"Out": [torch.argmax(x, dim=int(attrs.get("axis", -1)))
                    .to(torch.int32)]}


# ---------------------------------------------------------------------------
# random / fill
# ---------------------------------------------------------------------------


@register("uniform_random", family="random", no_grad=True, uses_rng=True)
def _uniform_random(ins, attrs, ctx):
    shape = tuple(int(s) for s in attrs["shape"])
    out = draw_uniform(ctx, attrs.get("_rng_salt", 0), shape,
                       attrs.get("min", -1.0), attrs.get("max", 1.0))
    return {"Out": [out.to(_torch_dtype(attrs.get("dtype", "float32")))]}


@register("gaussian_random", family="random", no_grad=True, uses_rng=True)
def _gaussian_random(ins, attrs, ctx):
    shape = tuple(int(s) for s in attrs["shape"])
    out = (attrs.get("mean", 0.0) + attrs.get("std", 1.0)
           * draw_normal(ctx, attrs.get("_rng_salt", 1), shape))
    return {"Out": [out.to(_torch_dtype(attrs.get("dtype", "float32")))]}


@register("fill_constant", family="fill", no_grad=True)
def _fill_constant(ins, attrs, ctx):
    shape = tuple(int(s) for s in attrs["shape"])
    return {"Out": [torch.full(shape, attrs.get("value", 0.0),
                               dtype=_torch_dtype(attrs.get("dtype",
                                                           "float32")),
                               device=ctx.device)]}


@register("fill_zeros_like", family="fill", no_grad=True)
def _fill_zeros_like(ins, attrs, ctx):
    x = _one(ins, "X")
    return {"Out": [_like(x, torch.zeros_like(_dat(x)))]}


@register("increment", family="fill", no_grad=True)
def _increment(ins, attrs, ctx):
    x = _dat(_one(ins, "X"))
    return {"Out": [x + attrs.get("step", 1.0)]}


@register("dropout", family="random", uses_rng=True)
def _dropout(ins, attrs, ctx):
    x = _one(ins, "X")
    prob = attrs.get("dropout_prob", 0.5)
    if ctx.is_test or attrs.get("is_test", False) or prob == 0.0:
        return {"Out": [x], "Mask": [torch.ones_like(_dat(x))]}
    xd = _dat(x)
    mask = (draw_uniform(ctx, attrs.get("_rng_salt", 2), xd.shape)
            >= prob).to(xd.dtype)
    return {"Out": [_like(x, xd * mask / (1.0 - prob))], "Mask": [mask]}


# ---------------------------------------------------------------------------
# recurrent building blocks (lstm_unit_op / gru_unit_op): single
# elementwise or matmul steps, not the fused cells of ops/rnn.py
# ---------------------------------------------------------------------------


@register("lstm_unit", family="rnn")
def _lstm_unit(ins, attrs, ctx):
    x = _dat(_one(ins, "X"))          # [N, 4D] pre-activations i,f,c,o
    c_prev = _dat(_one(ins, "C_prev"))
    forget_bias = attrs.get("forget_bias", 0.0)
    i, f, g, o = torch.chunk(x, 4, dim=-1)
    c = torch.sigmoid(f + forget_bias) * c_prev \
        + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return {"C": [c], "H": [h]}


@register("gru_unit", family="rnn")
def _gru_unit(ins, attrs, ctx):
    x = _dat(_one(ins, "Input"))       # [N, 3D] projected input
    h_prev = _dat(_one(ins, "HiddenPrev"))
    w = _dat(_one(ins, "Weight"))      # [D, 3D]: gates [D,2D] + cand [D,D]
    d = h_prev.shape[-1]
    gates_x, cand_x = x[:, :2 * d], x[:, 2 * d:]
    wg, wc = w[:, :2 * d], w[:, 2 * d:]
    b = _opt(ins, "Bias")
    gates = gates_x + h_prev @ wg
    cand_b = 0.0
    if b is not None:
        bd = _dat(b)
        gates = gates + bd[:2 * d]
        cand_b = bd[2 * d:]
    u, r = torch.chunk(torch.sigmoid(gates), 2, dim=-1)
    c = torch.tanh(cand_x + (r * h_prev) @ wc + cand_b)
    h = u * h_prev + (1.0 - u) * c
    return {"Gate": [torch.cat([u, r], -1)], "ResetHiddenPrev":
            [r * h_prev], "Hidden": [h]}


# ---------------------------------------------------------------------------
# sequence (LoD) ops — segment-id based, padding-free capability
# ---------------------------------------------------------------------------


def _seg_matrix(la: LoDArray, device):
    """[num_seq, rows] one-hot segment matrix (built on the host)."""
    ids = la.sequence_ids()
    n = la.num_sequences
    m = np.zeros((n, len(ids)), np.float32)
    m[ids, np.arange(len(ids))] = 1.0
    return torch.as_tensor(m, device=device)


@register("sequence_pool", family="sequence")
def _sequence_pool(ins, attrs, ctx):
    x = _one(ins, "X")
    enforce_that(isinstance(x, LoDArray), "sequence_pool needs LoD input",
                 context="fluid")
    ptype = attrs.get("pooltype", "AVERAGE").upper()
    data = x.data.reshape(x.data.shape[0], -1)
    seg = _seg_matrix(x, data.device)        # [S, R]
    if ptype == "SUM":
        out = seg @ data
    elif ptype == "AVERAGE":
        # clamp: a zero-length sequence pools to 0, not 0/0 -> NaN
        cnt = torch.clamp(torch.sum(seg, dim=1, keepdim=True), min=1.0)
        out = (seg @ data) / cnt
    elif ptype == "SQRT":
        cnt = torch.clamp(torch.sum(seg, dim=1, keepdim=True), min=1.0)
        out = (seg @ data) / torch.sqrt(cnt)
    elif ptype == "MAX":
        big = torch.where(seg[:, :, None] > 0, data[None, :, :],
                          torch.full_like(data[None], float("-inf")))
        out = torch.amax(big, dim=1)
        # a zero-length sequence has every row masked: pool to 0, not -inf
        empty = torch.sum(seg, dim=1, keepdim=True) == 0
        out = torch.where(empty, torch.zeros_like(out), out)
    elif ptype in ("LAST", "FIRST"):
        lod = np.asarray(x.lod[-1])
        empty = lod[1:] == lod[:-1]   # off-by-one would grab a neighbor row
        if ptype == "LAST":
            rows = np.where(empty, 0, lod[1:] - 1)
        else:
            rows = np.minimum(lod[:-1], data.shape[0] - 1)
        out = data.index_select(0, torch.as_tensor(rows, device=data.device))
        keep = torch.as_tensor(~empty, device=data.device)[:, None]
        out = torch.where(keep, out, torch.zeros_like(out))
    else:
        raise EnforceError(f"bad pooltype {ptype}", context="fluid")
    return {"Out": [out.reshape((out.shape[0],) + tuple(x.data.shape[1:]))]}


@register("sequence_softmax", family="sequence")
def _sequence_softmax(ins, attrs, ctx):
    x = _one(ins, "X")
    enforce_that(isinstance(x, LoDArray), "sequence_softmax needs LoD",
                 context="fluid")
    data = x.data.reshape(-1)
    ids = torch.as_tensor(x.sequence_ids(), device=data.device).long()
    n = x.num_sequences
    # the shift cancels in the quotient: its gradient is zero, so it is
    # taken out of the graph
    seg_max = torch.full((n,), float("-inf"), dtype=data.dtype,
                         device=data.device).scatter_reduce(
        0, ids, data.detach(), "amax")
    e = torch.exp(data - seg_max[ids])
    seg_sum = torch.zeros(n, dtype=data.dtype,
                          device=data.device).index_add(0, ids, e)
    return {"Out": [LoDArray((e / seg_sum[ids]).reshape(x.data.shape),
                             x.lod)]}


@register("sequence_concat", family="sequence")
def _sequence_concat(ins, attrs, ctx):
    xs = ins["X"]
    enforce_that(all(isinstance(v, LoDArray) for v in xs),
                 "sequence_concat needs LoD inputs", context="fluid")
    axis = int(attrs.get("axis", 0))
    if axis == 1:
        return {"Out": [LoDArray(
            torch.cat([v.data for v in xs], dim=1), xs[0].lod)]}
    # axis 0: interleave per sequence
    lods = [np.asarray(v.lod[-1]) for v in xs]
    pieces, new_offs = [], [0]
    for s in range(len(lods[0]) - 1):
        for v, lod in zip(xs, lods):
            pieces.append(v.data[int(lod[s]):int(lod[s + 1])])
        new_offs.append(new_offs[-1]
                        + sum(int(l[s + 1] - l[s]) for l in lods))
    return {"Out": [LoDArray(torch.cat(pieces, dim=0),
                             (tuple(new_offs),))]}


@register("sequence_expand", family="sequence")
def _sequence_expand(ins, attrs, ctx):
    x, y = _one(ins, "X"), _one(ins, "Y")
    enforce_that(isinstance(y, LoDArray), "sequence_expand needs LoD Y",
                 context="fluid")
    xd = _dat(x)
    ids = torch.as_tensor(y.sequence_ids(), device=xd.device).long()
    return {"Out": [LoDArray(xd.index_select(0, ids), y.lod)]}


# ---------------------------------------------------------------------------
# recurrent op — the sub-block run once a step (recurrent_op.cc analog,
# StaticRNN python/paddle/v2/framework/layers.py:333)
# ---------------------------------------------------------------------------


@register("recurrent", family="rnn")
def _recurrent(ins, attrs, ctx):
    enforce_that(ctx.trace_block is not None,
                 "recurrent op needs executor trace hook", context="fluid")
    xs = [_dat(v) for v in ins.get("Inputs", [])]        # each [T, B, ...]
    carry = [_dat(v) for v in ins.get("InitStates", [])]
    params = list(ins.get("Parameters", []))
    step_in = list(attrs["step_inputs"])            # sub-block var names
    st_in = list(attrs["step_states_in"])
    st_out = list(attrs["step_states_out"])
    step_out = list(attrs["step_outputs"])
    param_names = list(attrs.get("param_names", []))
    sub_idx = int(attrs["sub_block"])
    steps = xs[0].shape[0] if xs else 0
    # reverse=True runs the recurrence from the last frame backwards with
    # outputs kept at their original positions (the carry flows
    # backwards; the outputs are not flipped)
    order = range(steps - 1, -1, -1) if attrs.get("reverse", False) \
        else range(steps)
    ys: List[List[Any]] = [[None] * steps for _ in step_out]
    for t in order:
        env = dict(zip(step_in, [x[t] for x in xs]))
        env.update(zip(st_in, carry))
        # parameters enter through the op's input slots so program-level
        # autodiff reaches them through every step
        env.update(zip(param_names, params))
        env = ctx.trace_block(sub_idx, env)
        carry = [env[n] for n in st_out]
        for j, n in enumerate(step_out):
            ys[j][t] = _dat(env[n])
    return {"Outputs": [torch.stack(y, dim=0) for y in ys],
            "FinalStates": [_dat(c) for c in carry]}


# ---------------------------------------------------------------------------
# control flow — cond (cond_op.h:28-46) and dynamic_recurrent
# (dynamic_recurrent_op.cc) analogs
# ---------------------------------------------------------------------------


@register("cond", family="control_flow")
def _cond(ins, attrs, ctx):
    """Dynamic if-else (reference cond_op.h:28-46: gather the true/false
    row subsets, run each subnet on its subset, scatter-merge).  As the
    JAX package: BOTH sub-blocks run on the full batch and a per-row mask
    selects each output, so each branch's gradient reaches it masked."""
    enforce_that(ctx.trace_block is not None,
                 "cond op needs executor trace hook", context="fluid")
    cond = _dat(_one(ins, "Cond"))
    names = list(attrs.get("x_names", []))
    env0 = dict(zip(names, ins.get("Xs", [])))
    env_t = ctx.trace_block(int(attrs["true_block"]), dict(env0))
    env_f = ctx.trace_block(int(attrs["false_block"]), dict(env0))
    outs = []
    for tn, fn in zip(attrs["true_outputs"], attrs["false_outputs"]):
        t, f = _dat(env_t[tn]), _dat(env_f[fn])
        enforce_that(tuple(t.shape) == tuple(f.shape),
                     f"cond branch shapes differ: {tuple(t.shape)} vs "
                     f"{tuple(f.shape)}", context="fluid")
        m = cond.reshape((-1,) + (1,) * (t.dim() - 1)).to(torch.bool)
        outs.append(torch.where(m, t, f))
    return {"Out": outs}


@register("dynamic_recurrent", family="rnn")
def _dynamic_recurrent(ins, attrs, ctx):
    """Variable-length RNN over a LoD batch (dynamic_recurrent_op.cc
    analog).  The ragged batch is packed once to time-major [T, B, ...]
    rows by a host-side index plan, the step runs T times with
    mask-gated carries (a finished sequence holds its final state), and
    the rows go back to LoD order.  ``reverse=True`` packs each sequence
    back-to-front so the same forward loop IS the backward recurrence."""
    enforce_that(ctx.trace_block is not None,
                 "dynamic_recurrent needs executor trace hook",
                 context="fluid")
    x = _one(ins, "Inputs")
    enforce_that(isinstance(x, LoDArray),
                 "dynamic_recurrent needs a LoD input", context="fluid")
    carry = [_dat(v) for v in ins.get("InitStates", [])]
    params = list(ins.get("Parameters", []))
    step_in = attrs["step_inputs"][0]
    st_in = list(attrs["step_states_in"])
    st_out = list(attrs["step_states_out"])
    step_out = list(attrs["step_outputs"])
    param_names = list(attrs.get("param_names", []))
    sub_idx = int(attrs["sub_block"])
    reverse = bool(attrs.get("reverse", False))

    lod = np.asarray(x.lod[-1])
    starts, lens = lod[:-1], lod[1:] - lod[:-1]
    n_seq, t_max = len(lens), int(lens.max()) if len(lens) else 0
    rows = x.data.reshape(x.data.shape[0], -1)
    dev = rows.device

    # host-side pack/unpack index plans
    tb_idx = np.zeros((t_max, n_seq), np.int64)
    mask = np.zeros((t_max, n_seq), np.float32)
    flat_pos = np.zeros(int(lod[-1]), np.int64)
    for b in range(n_seq):
        for t in range(int(lens[b])):
            tt = int(lens[b]) - 1 - t if reverse else t
            tb_idx[tt, b] = starts[b] + t
            mask[tt, b] = 1.0
            flat_pos[starts[b] + t] = tt * n_seq + b

    xt = rows.index_select(0, torch.as_tensor(tb_idx.reshape(-1),
                                              device=dev))
    xt = xt.reshape(t_max, n_seq, -1)
    mask_d = torch.as_tensor(mask, device=dev)
    ys: List[List[Any]] = [[] for _ in step_out]
    for t in range(t_max):
        env = {step_in: xt[t]}
        env.update(zip(st_in, carry))
        env.update(zip(param_names, params))
        env = ctx.trace_block(sub_idx, env)
        new_carry = []
        for c, n in zip(carry, st_out):
            nv = _dat(env[n])
            gate = mask_d[t].reshape((-1,) + (1,) * (nv.dim() - 1))
            new_carry.append(gate * nv + (1.0 - gate) * c)
        carry = new_carry
        for j, n in enumerate(step_out):
            ys[j].append(_dat(env[n]))
    pos = torch.as_tensor(flat_pos, device=dev)
    out_arrays = []
    for y in ys:
        y = torch.stack(y, dim=0)
        flat = y.reshape((t_max * n_seq,) + tuple(y.shape[2:]))
        out_arrays.append(LoDArray(flat.index_select(0, pos), x.lod))
    return {"Outputs": out_arrays, "FinalStates": list(carry)}


# ---------------------------------------------------------------------------
# checkpoint IO — save_restore_op.cc analog.  The Executor runs IO-only
# programs on the host by itself (see Executor.run); these computes never
# run.
# ---------------------------------------------------------------------------


def _io_never_traced(ins, attrs, ctx):
    raise EnforceError(
        "save/restore are host-side ops: the Executor must run them "
        "eagerly, never trace them", context="fluid")


register("save", family="io", no_grad=True)(_io_never_traced)
register("restore", family="io", no_grad=True)(_io_never_traced)


# ---------------------------------------------------------------------------
# optimizer ops (sgd_op / momentum_op / adam_op ...: run server-side in the
# reference's pserver (ParameterServer2.cpp:362-541); here ordinary ops of
# the train program, each writing new tensors)
# ---------------------------------------------------------------------------


def _lr(ins):
    return _dat(_one(ins, "LearningRate")).reshape(())


@register("sgd", family="optimizer", stateful=("ParamOut",), no_grad=True)
def _sgd(ins, attrs, ctx):
    p, g = _dat(_one(ins, "Param")), _dat(_one(ins, "Grad"))
    return {"ParamOut": [p - _lr(ins) * g]}


@register("momentum", family="optimizer",
          stateful=("ParamOut", "VelocityOut"), no_grad=True)
def _momentum(ins, attrs, ctx):
    p, g = _dat(_one(ins, "Param")), _dat(_one(ins, "Grad"))
    v = _dat(_one(ins, "Velocity"))
    mu = attrs.get("mu", 0.9)
    lr = _lr(ins)
    v_new = mu * v + g
    if attrs.get("use_nesterov", False):
        p_new = p - lr * (g + mu * v_new)
    else:
        p_new = p - lr * v_new
    return {"ParamOut": [p_new], "VelocityOut": [v_new]}


@register("adagrad", family="optimizer",
          stateful=("ParamOut", "MomentOut"), no_grad=True)
def _adagrad(ins, attrs, ctx):
    p, g = _dat(_one(ins, "Param")), _dat(_one(ins, "Grad"))
    m = _dat(_one(ins, "Moment"))
    eps = attrs.get("epsilon", 1e-6)
    m_new = m + torch.square(g)
    return {"ParamOut": [p - _lr(ins) * g / (torch.sqrt(m_new) + eps)],
            "MomentOut": [m_new]}


@register("adadelta", family="optimizer",
          stateful=("ParamOut", "AvgSquaredGradOut", "AvgSquaredUpdateOut"),
          no_grad=True)
def _adadelta(ins, attrs, ctx):
    p, g = _dat(_one(ins, "Param")), _dat(_one(ins, "Grad"))
    ag = _dat(_one(ins, "AvgSquaredGrad"))
    au = _dat(_one(ins, "AvgSquaredUpdate"))
    rho, eps = attrs.get("rho", 0.95), attrs.get("epsilon", 1e-6)
    ag_new = rho * ag + (1 - rho) * torch.square(g)
    upd = -torch.sqrt(au + eps) / torch.sqrt(ag_new + eps) * g
    au_new = rho * au + (1 - rho) * torch.square(upd)
    return {"ParamOut": [p + _lr(ins) * upd], "AvgSquaredGradOut": [ag_new],
            "AvgSquaredUpdateOut": [au_new]}


@register("rmsprop", family="optimizer",
          stateful=("ParamOut", "MomentOut", "MeanSquareOut"), no_grad=True)
def _rmsprop(ins, attrs, ctx):
    p, g = _dat(_one(ins, "Param")), _dat(_one(ins, "Grad"))
    ms = _dat(_one(ins, "MeanSquare"))
    mom = _dat(_one(ins, "Moment"))
    rho, eps = attrs.get("decay", 0.9), attrs.get("epsilon", 1e-6)
    momentum = attrs.get("momentum", 0.0)
    ms_new = rho * ms + (1 - rho) * torch.square(g)
    mom_new = momentum * mom + _lr(ins) * g / torch.sqrt(ms_new + eps)
    return {"ParamOut": [p - mom_new], "MomentOut": [mom_new],
            "MeanSquareOut": [ms_new]}


@register("decayed_adagrad", family="optimizer",
          stateful=("ParamOut", "MomentOut"), no_grad=True)
def _decayed_adagrad(ins, attrs, ctx):
    p, g = _dat(_one(ins, "Param")), _dat(_one(ins, "Grad"))
    m = _dat(_one(ins, "Moment"))
    decay, eps = attrs.get("decay", 0.95), attrs.get("epsilon", 1e-6)
    m_new = decay * m + (1 - decay) * torch.square(g)
    return {"ParamOut": [p - _lr(ins) * g / (torch.sqrt(m_new) + eps)],
            "MomentOut": [m_new]}


@register("adam", family="optimizer",
          stateful=("ParamOut", "Moment1Out", "Moment2Out"), no_grad=True)
def _adam(ins, attrs, ctx):
    p, g = _dat(_one(ins, "Param")), _dat(_one(ins, "Grad"))
    m1, m2 = _dat(_one(ins, "Moment1")), _dat(_one(ins, "Moment2"))
    b1p = _dat(_one(ins, "Beta1Pow")).reshape(())
    b2p = _dat(_one(ins, "Beta2Pow")).reshape(())
    b1, b2 = attrs.get("beta1", 0.9), attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    m1n = b1 * m1 + (1 - b1) * g
    m2n = b2 * m2 + (1 - b2) * torch.square(g)
    lr = _lr(ins) * torch.sqrt(1 - b2p * b2) / (1 - b1p * b1)
    return {"ParamOut": [p - lr * m1n / (torch.sqrt(m2n) + eps)],
            "Moment1Out": [m1n], "Moment2Out": [m2n]}


@register("adamax", family="optimizer",
          stateful=("ParamOut", "MomentOut", "InfNormOut"), no_grad=True)
def _adamax(ins, attrs, ctx):
    p, g = _dat(_one(ins, "Param")), _dat(_one(ins, "Grad"))
    m, inf = _dat(_one(ins, "Moment")), _dat(_one(ins, "InfNorm"))
    b1p = _dat(_one(ins, "Beta1Pow")).reshape(())
    b1, b2 = attrs.get("beta1", 0.9), attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    m_new = b1 * m + (1 - b1) * g
    inf_new = torch.maximum(b2 * inf, torch.abs(g))
    lr = _lr(ins) / (1 - b1p * b1)
    return {"ParamOut": [p - lr * m_new / (inf_new + eps)],
            "MomentOut": [m_new], "InfNormOut": [inf_new]}


@register("proximal_gd", family="optimizer", stateful=("ParamOut",),
          no_grad=True)
def _proximal_gd(ins, attrs, ctx):
    p, g = _dat(_one(ins, "Param")), _dat(_one(ins, "Grad"))
    l1 = attrs.get("l1", 0.0)
    l2 = attrs.get("l2", 0.0)
    lr = _lr(ins)
    prox = p - lr * g
    if l1 > 0:
        prox = torch.sign(prox) * torch.relu(torch.abs(prox) - lr * l1)
    return {"ParamOut": [prox / (1.0 + lr * l2)]}


@register("beta_pow_update", family="optimizer",
          stateful=("Beta1PowOut", "Beta2PowOut"), no_grad=True)
def _beta_pow_update(ins, attrs, ctx):
    """Adam/Adamax beta^t accumulators (adam_op.cc keeps them as inputs;
    we advance them explicitly once per step)."""
    b1p = _dat(_one(ins, "Beta1Pow"))
    out = {"Beta1PowOut": [b1p * attrs.get("beta1", 0.9)]}
    if "Beta2Pow" in ins:
        out["Beta2PowOut"] = [_dat(_one(ins, "Beta2Pow"))
                              * attrs.get("beta2", 0.999)]
    return out

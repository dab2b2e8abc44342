"""Carry weights into the port as numpy arrays.

Training weights: a JAX ``Parameters`` read as numpy (``as_dict()`` values,
or its tar) becomes the port's with :func:`parameters_from_numpy`; the
names are the same ``<layer>.<param>`` keys in both packages, and every
layer keeps the JAX package's layout (HWIO convolutions, DHWIO 3-D ones,
``[in, out]`` products, ``nce``/``hsigmoid``'s class rows, ``tensor``'s
``[size, a, b]``, ``mdlstmemory``'s ``wx``/``wr``/``wc``/``b``), so each
array crosses as it is.  A JAX
trainer's ``model_state`` (``{layer: {"moving_mean", "moving_var"}}``)
becomes the port's with :func:`state_from_numpy`, and a JAX optimizer
state (``{"step": int32[], "slots": {slot: {name: array}}, ...}``) the
port's with :func:`opt_state_from_numpy` (``"step"`` a Python int there);
:func:`opt_state_to_numpy` and :func:`state_to_numpy` go the other way,
into the numpy trees a checkpoint's ``state.pkl`` holds.

Serving weights: the JAX package's ``DecoderLM.init_params`` returns a
flat dict — ``emb`` [V, E], ``pos`` [P, E], per layer ``l{i}.wq``/``wk``/
``wv``/``wo``/``w1``/``w2`` in the x @ W layout, and ``out`` [E, V].  The
port's ``DecoderLM`` keeps the same layout, so conversion is a copy per
tensor.
Fluid programs: a JAX ``fluid.Scope``'s values become a port
``fluid.Scope`` with :func:`scope_from_numpy`, and
:func:`scope_to_numpy` goes back (both packages name every variable the
same when the same layer calls build the program).
Weights cross between the packages as numpy: torch cannot reproduce a JAX
PRNG stream.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from paddle_tpu_torch.parameters import Parameters
from paddle_tpu_torch.platform.device import DeviceLike, resolve_device
from paddle_tpu_torch.platform.enforce import enforce_that

_LAYER_KEYS = ("wq", "wk", "wv", "wo", "w1", "w2")


def parameters_from_numpy(arrays: Dict[str, np.ndarray],
                          device: DeviceLike = None) -> Parameters:
    """A port ``Parameters`` holding copies of ``arrays`` (name -> array)
    on ``device`` (``cuda`` unless asked)."""
    dev = resolve_device(device)
    params = Parameters()
    for name, arr in arrays.items():
        # a copy: JAX arrays read as numpy are not writable
        params[name] = torch.from_numpy(np.array(arr, copy=True)).to(dev)
    return params


def state_from_numpy(state: Dict[str, Dict[str, np.ndarray]],
                     device: DeviceLike = None
                     ) -> Dict[str, Dict[str, torch.Tensor]]:
    """A port model state (``{layer: {slot: tensor}}``) holding copies of
    ``state``'s arrays on ``device`` (``cuda`` unless asked)."""
    dev = resolve_device(device)
    return {layer: {k: torch.from_numpy(np.array(v, copy=True)).to(dev)
                    for k, v in slots.items()}
            for layer, slots in state.items()}


def decoder_lm_state(model) -> Dict[str, torch.Tensor]:
    """A ``DecoderLM``'s parameters under the JAX package's keys."""
    out = {"emb": model.emb, "pos": model.pos, "out": model.out}
    for i, blk in enumerate(model.layers):
        for key in _LAYER_KEYS:
            out[f"l{i}.{key}"] = getattr(blk, key)
    return out


@torch.no_grad()
def decoder_lm_from_numpy(params: Dict[str, np.ndarray], model):
    """Copy a JAX-layout ``DecoderLM`` param dict into ``model`` (on the
    model's device and dtype); every key must be present with its exact
    whole shape.  A tensor-parallel shard (``DecoderLM(tp_mesh=)``) takes
    its own part of each whole weight, as its ``shard_plan`` places it,
    so only the shard reaches its device.  Returns ``model``."""
    from paddle_tpu_torch.serving.engine import tp_slice

    targets = decoder_lm_state(model)
    enforce_that(set(params) == set(targets),
                 f"param keys differ: missing {sorted(set(targets) - set(params))}, "
                 f"unexpected {sorted(set(params) - set(targets))}",
                 context="convert")
    plan = model.shard_plan(model._tp_axis) if model.tp > 1 else {}
    for name, dst in targets.items():
        src = params[name]
        if plan:
            src = tp_slice(src, plan[name], model._tp_axis, model.tp,
                           model.tp_rank)
        src = np.ascontiguousarray(src)
        enforce_that(tuple(src.shape) == tuple(dst.shape),
                     f"{name}: shape {tuple(src.shape)} != "
                     f"{tuple(dst.shape)}", context="convert")
        if not src.flags.writeable:   # e.g. a view of a JAX array
            src = src.copy()
        dst.copy_(torch.from_numpy(src))
    return model


def init_numpy_params(model, seed: int) -> Dict[str, np.ndarray]:
    """Random ``DecoderLM`` weights drawn with numpy at the scales of the
    JAX ``init_params`` (embeddings 0.02, projections fan-in ** -0.5), in
    its key layout — random weights for runs that need no trained model."""
    rng = np.random.default_rng(seed)
    e, f, v = model.embed_dim, model.ffn_dim, model.vocab_size
    kv = model.kv_dim

    def mat(shape, scale):
        return rng.standard_normal(shape, np.float32) * np.float32(scale)

    p = {"emb": mat((v, e), 0.02), "pos": mat((model.max_positions, e),
                                              0.02)}
    for i in range(model.num_layers):
        p[f"l{i}.wq"] = mat((e, e), e ** -0.5)
        p[f"l{i}.wk"] = mat((e, kv), e ** -0.5)
        p[f"l{i}.wv"] = mat((e, kv), e ** -0.5)
        p[f"l{i}.wo"] = mat((e, e), e ** -0.5)
        p[f"l{i}.w1"] = mat((e, f), e ** -0.5)
        p[f"l{i}.w2"] = mat((f, e), f ** -0.5)
    p["out"] = mat((e, v), e ** -0.5)
    return p


def map_tree(fn, tree, path=()):
    """``fn(leaf, path)`` over the leaves of a tree of dicts, lists and
    tuples (``path``: the keys from the root)."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(tree, path)


def check_saveable(t: torch.Tensor, what: str) -> None:
    """Refuse a tensor the JAX package's checkpoint format cannot hold."""
    enforce_that(t.dtype != torch.bfloat16,
                 f"{what}: a bfloat16 tensor cannot be saved — the "
                 "checkpoint holds numpy arrays and numpy has no bfloat16; "
                 "the port saves float32 weights, slots and state only",
                 context="convert")


def _leaf_to_numpy(leaf, path):
    if isinstance(leaf, torch.Tensor):
        check_saveable(leaf, "/".join(map(str, path)))
        return leaf.detach().to("cpu", copy=True).numpy()
    if path == ("step",):
        return np.asarray(leaf, np.int32)
    return leaf if leaf is None else np.asarray(leaf)


def opt_state_to_numpy(state):
    """The port's optimizer state (``{"step": int, "slots": {slot: {name:
    tensor}}, ...}``) as the JAX package's numpy tree: the same keys,
    ``"step"`` an int32 0-d array, every tensor a host copy."""
    return None if state is None else map_tree(_leaf_to_numpy, state)


def opt_state_from_numpy(state, device: DeviceLike = None):
    """The JAX package's optimizer state tree (numpy or JAX arrays) as the
    port's: ``"step"`` a Python int, every other array a tensor (a copy) on
    ``device`` (``cuda`` unless asked)."""
    if state is None:
        return None
    dev = resolve_device(device)

    def leaf(v, path):
        if path == ("step",):
            return int(np.asarray(v))
        if v is None:
            return None
        return torch.from_numpy(np.array(v, copy=True)).to(dev)

    return map_tree(leaf, state)


def state_to_numpy(state):
    """A port model state (``{layer: {slot: tensor}}``) as host copies."""
    return None if state is None else map_tree(_leaf_to_numpy, state)


def scope_from_numpy(values: Dict[str, object], device: DeviceLike = None):
    """A JAX ``fluid.Scope``'s values (``scope.values``: numpy or JAX
    arrays, here as numpy) as a port ``fluid.Scope`` on ``device``
    (``cuda`` unless asked): each a tensor copy, float64 narrowed to
    float32 as the JAX package computes with x64 off."""
    from paddle_tpu_torch.fluid import Scope
    from paddle_tpu_torch.fluid.executor import to_tensor

    dev = resolve_device(device)
    scope = Scope()
    for name, v in values.items():
        scope.set_var(name, to_tensor(np.array(v, copy=True), dev))
    return scope


def scope_to_numpy(scope) -> Dict[str, np.ndarray]:
    """A port ``fluid.Scope``'s values as host numpy copies, the form a
    JAX ``fluid.Scope`` takes into its ``values``."""
    return {name: (v.detach().cpu().numpy().copy()
                   if isinstance(v, torch.Tensor) else np.array(v))
            for name, v in scope.values.items()}

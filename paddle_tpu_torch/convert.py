"""Carry weights into the port as numpy arrays.

Training weights: a JAX ``Parameters`` read as numpy (``as_dict()`` values,
or its tar) becomes the port's with :func:`parameters_from_numpy`; the
names are the same ``<layer>.<param>`` keys in both packages, and every
layer keeps the JAX package's layout (HWIO convolutions, DHWIO 3-D ones,
``[in, out]`` products, ``nce``/``hsigmoid``'s class rows, ``tensor``'s
``[size, a, b]``, ``mdlstmemory``'s ``wx``/``wr``/``wc``/``b``), so each
array crosses as it is.  A JAX
trainer's ``model_state`` (``{layer: {"moving_mean", "moving_var"}}``)
becomes the port's with :func:`state_from_numpy`.

Serving weights: the JAX package's ``DecoderLM.init_params`` returns a
flat dict — ``emb`` [V, E], ``pos`` [P, E], per layer ``l{i}.wq``/``wk``/
``wv``/``wo``/``w1``/``w2`` in the x @ W layout, and ``out`` [E, V].  The
port's ``DecoderLM`` keeps the same layout, so conversion is a copy per
tensor.
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


def _targets(model) -> Dict[str, torch.Tensor]:
    out = {"emb": model.emb, "pos": model.pos, "out": model.out}
    for i, blk in enumerate(model.layers):
        for key in _LAYER_KEYS:
            out[f"l{i}.{key}"] = getattr(blk, key)
    return out


@torch.no_grad()
def decoder_lm_from_numpy(params: Dict[str, np.ndarray], model):
    """Copy a JAX-layout ``DecoderLM`` param dict into ``model`` (on the
    model's device and dtype); every key must be present with its exact
    shape.  Returns ``model``."""
    targets = _targets(model)
    enforce_that(set(params) == set(targets),
                 f"param keys differ: missing {sorted(set(targets) - set(params))}, "
                 f"unexpected {sorted(set(params) - set(targets))}",
                 context="convert")
    for name, dst in targets.items():
        src = np.ascontiguousarray(params[name])
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

"""Both packages computing in float64, for parity tests whose f32 runs
part at rounding-decided ties (a ReLU input at 0, a batch statistic's
one-pass sum): runtime patches of each package's f32 casts, no file of
either package changed."""

import contextlib

import jax
import pytest
import torch

from paddle_tpu.ops import math as jmath

from paddle_tpu_torch.ops import math as tmath


@contextlib.contextmanager
def port_in_float64():
    """The port computes in float64: its f32 storage policy for maps and
    dense outputs, the f32 result of its matmul and its widening to f32
    (``Tensor.float``) keep float64 as float64, so parameters, feeds and
    statistics handed over in float64 stay float64 through the forward,
    the backward and the update."""
    from paddle_tpu_torch.ops import conv as tconv

    widen, matmul = torch.Tensor.float, tmath.matmul
    mp = pytest.MonkeyPatch()
    mp.setattr(torch.Tensor, "float", lambda self, *a, **k: self
               if self.dtype == torch.float64 else widen(self, *a, **k))
    mp.setattr(tconv, "activation_dtype", lambda: torch.float64)
    mp.setattr(tmath, "dense_activation_dtype", lambda: torch.float64)
    mp.setattr(tmath, "matmul", lambda *a, out_dtype=None, **k: matmul(
        *a, out_dtype=torch.float64, **k))
    try:
        yield
    finally:
        mp.undo()


class _Float32IsFloat64:
    """``jax.numpy`` as a module of the JAX package sees it in
    :func:`jax_in_float64`: its ``float32`` is ``float64``."""

    def __init__(self, jnp):
        self._jnp = jnp

    def __getattr__(self, name):
        return getattr(self._jnp, "float64" if name == "float32" else name)


@contextlib.contextmanager
def jax_in_float64():
    """The JAX package computes in float64, a runtime patch of its f32
    casts (no file changes): 64-bit JAX, and the ``jnp.float32`` that its
    norm, pool, loss, conv, math and optimizer modules cast to, its
    storage policy and its matmul's f32 result all read float64.  The
    step's jaxpr then holds no f32 value."""
    import jax.numpy as jnp
    from paddle_tpu import optimizer as joptimizer
    from paddle_tpu.ops import conv as jconv
    from paddle_tpu.ops import losses as jlosses
    from paddle_tpu.ops import norm as jnorm
    from paddle_tpu.ops import pool as jpool

    matmul = jmath.matmul
    mp = pytest.MonkeyPatch()
    for mod in (joptimizer, jconv, jlosses, jnorm, jpool, jmath):
        mp.setattr(mod, "jnp", _Float32IsFloat64(jnp))
    mp.setattr(jconv, "activation_dtype", lambda: jnp.dtype(jnp.float64))
    mp.setattr(jmath, "dense_activation_dtype",
               lambda: jnp.dtype(jnp.float64))
    mp.setattr(jmath, "matmul", lambda *a, out_dtype=None, **k: matmul(
        *a, out_dtype=jnp.float64, **k))
    try:
        with jax.enable_x64(True):
            yield
    finally:
        mp.undo()

"""Recurrent cells and time scans (the port of ``paddle_tpu/ops/rnn.py``).

Gate layouts are the JAX package's: i, f, g (candidate), o for the LSTM,
update z, reset r, candidate c for the GRU; ``W_h`` is [H, 4H] or [H, 3H]
and the bias [4H] or [3H], never torch's ``nn.LSTM`` layout.  Masked steps
carry the state through unchanged (``m * new + (1 - m) * old``), which
keeps the padded slots of ragged sequences exact.

Two routes for a step, decided exactly as JAX decides them:

- the plain cells :func:`lstm_cell` and :func:`gru_cell`, with the recurrent
  product through ``ops/math.matmul`` (bf16 inputs under ``use_bf16``) and
  any activations;
- the fused steps, taken where JAX takes its Pallas kernels
  (:func:`_use_fused`, ``_gru_fused_plan``): the recurrent product in f32
  and the default sigmoid/tanh gates.  On the card they are the
  hand-written CUDA kernels of ``csrc/rnn_cells.cu``:

  ====  =========================  ======================================
  B5    :func:`lstm_step_kernel`   ``_lstm_fused_kernel_tiled`` (rnn.py:80)
  B6    :func:`gru_step_kernel`    ``_gru_fused_kernel`` (rnn.py:212)
  B7    :func:`gru_zr_kernel`      ``_gru_zr_kernel_tiled`` (rnn.py:234)
  B8    :func:`gru_cand_kernel`    ``_gru_cand_kernel_tiled`` (rnn.py:244)
  ====  =========================  ======================================

  each with its plain PyTorch version beside it (``*_reference``, f32
  products, the same outputs).  A CPU tensor takes the plain version; a
  CUDA tensor launches the kernel or raises.  Every kernel wrapper counts
  its launches in ``.launches``.

Among the fused GRU shapes the port has its own gate (:func:`gru_route`),
sized by the card: B6 is one cooperative launch whose grid must be
co-resident, so it runs where JAX's plan is its one block and the card
holds the whole grid at once, and B7 + B8 (two ordinary launches)
everywhere else.  Both compute the same f32 function.

The backward of a fused step is the JAX closed form over the saved
activations (``_fused_lstm_bwd``, ``_fused_gru_bwd``) in plain torch, its
products through ``ops/math.matmul`` as JAX's are through its ``matmul``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from paddle_tpu_torch.kernels import build
from paddle_tpu_torch.ops.math import matmul
from paddle_tpu_torch.platform.enforce import enforce_that
from paddle_tpu_torch.platform.flags import FLAGS


class LSTMState(NamedTuple):
    h: torch.Tensor
    c: torch.Tensor


def lstm_cell(x_proj, state: LSTMState, w_h, bias=None,
              gate_act=torch.sigmoid, cell_act=torch.tanh,
              out_act=torch.tanh) -> Tuple[torch.Tensor, LSTMState]:
    """One LSTM step. x_proj: [B, 4H] (input already projected), w_h:
    [H, 4H] or None when the h-recurrence is pre-projected into x_proj."""
    h, c = state
    gates = x_proj if w_h is None else x_proj + matmul(h, w_h)
    if bias is not None:
        gates = gates + bias
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    i, f, o = gate_act(i), gate_act(f), gate_act(o)
    g = cell_act(g)
    new_c = f * c + i * g
    new_h = o * out_act(new_c)
    return new_h, LSTMState(new_h, new_c)


def gru_cell(x_proj, h, w_h, bias=None, gate_act=torch.sigmoid,
             cand_act=torch.tanh) -> torch.Tensor:
    """One GRU step (gate order: update z, reset r, candidate).
    x_proj: [B, 3H], w_h: [H, 3H] split as [H, 2H] (z, r) + [H, H]."""
    H = h.shape[-1]
    zr_x, c_x = x_proj[..., :2 * H], x_proj[..., 2 * H:]
    w_zr, w_c = w_h[:, :2 * H], w_h[:, 2 * H:]
    zr = zr_x + matmul(h, w_zr)
    if bias is not None:
        zr = zr + bias[:2 * H]
    z, r = torch.chunk(gate_act(zr), 2, dim=-1)
    c = c_x + matmul(r * h, w_c)
    if bias is not None:
        c = c + bias[2 * H:]
    c = cand_act(c)
    return (1.0 - z) * h + z * c


# ---------------------------------------------------------------------------
# JAX's fused-or-plain rule, copied verbatim.  These numbers are the
# reference's route rule (a TPU VMEM budget), not a limit of this card: the
# fused kernels compute h W_h in f32 and the plain cells round it through
# the bf16 policy, so the port fuses exactly where JAX fuses or the two
# packages part under ``use_bf16``.
# ---------------------------------------------------------------------------

_FUSED_VMEM_BUDGET = 10 * 1024 * 1024


def _hidden_tile(H: int, B: int, gate_cols: int, io_rows: int):
    """JAX's largest hidden tile for a fused kernel: H itself or a
    multiple-of-128 divisor of H; None = no tile -> the plain cell."""
    cands = [H] + [d for d in range(128, H, 128) if H % d == 0]
    for t in sorted(cands, reverse=True):
        if (H * gate_cols * t + B * H + B * io_rows * t) * 4 \
                <= _FUSED_VMEM_BUDGET:
            return t
    return None


def _lstm_tile(H: int, B: int):
    return _hidden_tile(H, B, 4, 16)


def _gru_tile(H: int, B: int):
    return _hidden_tile(H, B, 2, 10)


def _fused_vmem_ok(w_numel: int, H: int, batch: int,
                   rows_per_item: int) -> bool:
    """JAX's ``_fused_vmem_ok(w_h, batch, rows_per_item)`` for a ``w_h``
    of ``w_numel`` elements and H rows."""
    return (w_numel + batch * rows_per_item * H) * 4 <= _FUSED_VMEM_BUDGET


def _gru_fused_plan(H: int, B: int, w_h):
    """JAX's plan: "block", a tile size, or None (the plain cell).  Only
    ``is not None`` matters here: which CUDA route runs is
    :func:`gru_route`'s choice."""
    if _fused_vmem_ok(w_h.numel(), H, B, 11):
        return "block"
    return _gru_tile(H, B)


def _use_fused(batch: int, w_h, gate_act, cell_act, out_act) -> bool:
    return (FLAGS.use_pallas and w_h is not None
            and gate_act is torch.sigmoid and cell_act is torch.tanh
            and out_act is torch.tanh
            and _lstm_tile(w_h.shape[0], batch) is not None)


# ---------------------------------------------------------------------------
# The port's own gate between B6 and B7 + B8, sized by the card
# ---------------------------------------------------------------------------

# geometry of B6 and B7 (csrc/rnn_cells.cu, the GRU's main loop): a block
# of 256 threads owns 8 hidden units x 32 batch rows and streams K in
# chunks of 64 through a 4-stage cp.async ring: each stage 32 rows of f32
# (the chunk plus a 16-byte pad) and the chunk's W_h columns of 2 gates x
# 8 units, 51,200 bytes in all, the same at every H (no row stays
# resident); B6 is compiled with __launch_bounds__(256, 2), so registers
# allow at least 2 of its blocks an SM.  B8 keeps its own block.
BLOCK_UNITS, BLOCK_ROWS, BLOCK_THREADS, K_CHUNK = 8, 32, 256, 64
RING_STAGES = 4
GRU_BLOCK_MIN_BLOCKS = 2
GRU_BLOCK_SMEM = RING_STAGES * 4 * (BLOCK_ROWS * (K_CHUNK + 4)
                                    + K_CHUNK * 2 * BLOCK_UNITS)
# an H100 SXM: 132 SMs, 228 KB of shared memory an SM, 1 KB of it reserved
# by the runtime for each block
H100_SMS = 132
H100_SMEM_PER_SM = 233472
SMEM_RESERVED_PER_BLOCK = 1024
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _grid_blocks(B: int, H: int) -> int:
    return -(-H // BLOCK_UNITS) * -(-B // BLOCK_ROWS)


def gru_block_capacity_h100() -> int:
    """B6 blocks an H100 holds at once, reckoned from its shared memory
    (4 rings of 51,200 bytes an SM), its 2048 threads an SM (8 blocks) and
    the 2 blocks the launch bounds guarantee by registers: 2 x 132 SMs, a
    lower bound of what ``rnn_gru_block_capacity`` asks the card, the same
    at every H."""
    per_sm = min(H100_SMEM_PER_SM // (GRU_BLOCK_SMEM
                                      + SMEM_RESERVED_PER_BLOCK),
                 2048 // BLOCK_THREADS, GRU_BLOCK_MIN_BLOCKS)
    return per_sm * H100_SMS


_CAPACITY = {}   # (card, dtype) -> the card's B6 capacity, asked once


def gru_block_capacity(dtype=torch.float32, device=None) -> int:
    """B6's co-resident block limit: the card's own answer for a CUDA
    ``device``, the H100 reckoning otherwise."""
    device = None if device is None else torch.device(device)
    if device is None or device.type != "cuda":
        return gru_block_capacity_h100()
    key = (device.index if device.index is not None
           else torch.cuda.current_device(), dtype)
    if key not in _CAPACITY:
        lib = build.load("rnn_cells", _SIGNATURES)
        cap = ctypes.c_int(0)
        _raise_on(lib, lib.rnn_gru_block_capacity(_DTYPE_CODE[dtype],
                                                  ctypes.byref(cap)),
                  "rnn_gru_block_capacity")
        _CAPACITY[key] = cap.value
    return _CAPACITY[key]


def gru_block_refusal(B: int, H: int, dtype=torch.float32,
                      device=None) -> Optional[str]:
    """None when B6 takes a [B, H] step, else why not, with the limit."""
    grid, cap = _grid_blocks(B, H), gru_block_capacity(dtype, device)
    if grid > cap:
        return (f"B6 is one cooperative launch of {grid} blocks at B={B}, "
                f"H={H}; the card holds {cap} such blocks at once "
                f"({BLOCK_THREADS} threads and {GRU_BLOCK_SMEM} bytes of "
                "shared memory each)")
    return None


def gru_route(B: int, H: int, dtype=torch.float32, device=None) -> str:
    """``"block"`` (B6) where JAX's plan is its one block and B6's grid is
    co-resident on the card, else ``"tiled"`` (B7 then B8).  At B 64,
    H 1280 both say tiled: JAX's plan tiles H 1280, and B6's 320 blocks
    are more than the 264 an H100 holds.  B6's ring does not grow with H,
    so the card alone would let B6 take some shapes that JAX tiles (B 32,
    H 1280: 160 blocks); the plan keeps the two packages' routes alike
    there."""
    if not _fused_vmem_ok(3 * H * H, H, B, 11):
        return "tiled"
    return "block" if gru_block_refusal(B, H, dtype, device) is None \
        else "tiled"


# ---------------------------------------------------------------------------
# Plain versions of the four kernels (CPU path, parity oracle on the card)
# ---------------------------------------------------------------------------

def lstm_step_reference(xp, h, c, w_h, bias, *, save_acts: bool = False):
    """Plain B5: (h' in xp's type, c' f32, acts [B, 5H] f32 or None)."""
    H = h.shape[1]
    gates = xp.float() + torch.matmul(h.float(), w_h.float())
    gates = gates + bias.float()
    i = torch.sigmoid(gates[:, :H])
    f = torch.sigmoid(gates[:, H:2 * H])
    g = torch.tanh(gates[:, 2 * H:3 * H])
    o = torch.sigmoid(gates[:, 3 * H:])
    new_c = f * c.float() + i * g
    tanh_nc = torch.tanh(new_c)
    new_h = (o * tanh_nc).to(xp.dtype)
    acts = torch.cat([i, f, g, o, tanh_nc], dim=1) if save_acts else None
    return new_h, new_c, acts


def gru_step_reference(xp, h, w_h, bias, *, save_acts: bool = False):
    """Plain B6: (h' in xp's type, acts [B, 3H] = (z, r, c) f32 or None)."""
    H = h.shape[1]
    x, hf, w, b = xp.float(), h.float(), w_h.float(), bias.float()
    zr = x[:, :2 * H] + torch.matmul(hf, w[:, :2 * H]) + b[:2 * H]
    z = torch.sigmoid(zr[:, :H])
    r = torch.sigmoid(zr[:, H:])
    c = torch.tanh(x[:, 2 * H:] + torch.matmul(r * hf, w[:, 2 * H:])
                   + b[2 * H:])
    new_h = ((1.0 - z) * hf + z * c).to(xp.dtype)
    return new_h, (torch.cat([z, r, c], dim=1) if save_acts else None)


def gru_zr_reference(xp, h, w_h, bias):
    """Plain B7: (zrc [B, 3H] f32 with z and r in its first 2H columns,
    r h [B, H] f32).  The last H columns are B8's to fill."""
    H = h.shape[1]
    hf = h.float()
    zr = xp[:, :2 * H].float() + torch.matmul(hf, w_h[:, :2 * H].float()) \
        + bias[:2 * H].float()
    zrc = torch.zeros((h.shape[0], 3 * H), dtype=torch.float32,
                      device=h.device)
    zrc[:, :2 * H] = torch.sigmoid(zr)
    return zrc, zrc[:, H:2 * H] * hf


def gru_cand_reference(rh, xp, w_h, bias, zrc, h, *, save_c: bool = False):
    """Plain B8: h' in xp's type from the complete r h; with ``save_c`` it
    writes c into ``zrc[:, 2H:]`` in place (the acts layout)."""
    H = h.shape[1]
    c = torch.tanh(xp[:, 2 * H:].float() + torch.matmul(
        rh, w_h[:, 2 * H:].float()) + bias[2 * H:].float())
    z = zrc[:, :H]
    new_h = ((1.0 - z) * h.float() + z * c).to(xp.dtype)
    if save_c:
        zrc[:, 2 * H:] = c
    return new_h


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

_VOIDP = ctypes.c_void_p
_INT = ctypes.c_int
_SIGNATURES = {
    # xp h c w b new_h new_c acts | B H dtype stream
    "rnn_lstm_step": ([_VOIDP] * 8 + [_INT] * 3 + [_VOIDP], _INT),
    # xp h w b rh new_h acts | B H dtype stream
    "rnn_gru_step": ([_VOIDP] * 7 + [_INT] * 3 + [_VOIDP], _INT),
    # xp h w b zrc rh | B H dtype stream
    "rnn_gru_zr": ([_VOIDP] * 6 + [_INT] * 3 + [_VOIDP], _INT),
    # rh xp w b zrc h new_h | save_c B H dtype stream
    "rnn_gru_cand": ([_VOIDP] * 7 + [_INT] * 4 + [_VOIDP], _INT),
    "rnn_gru_block_capacity": ([_INT, ctypes.POINTER(_INT)], _INT),
    "rnn_error_string": ([_INT], ctypes.c_char_p),
}


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.rnn_error_string(rc).decode())


def _check(what: str, xp, h, gates: int, w_h, bias, f32=()) -> None:
    """Device, types, shapes and contiguity the kernels take."""
    dev = xp.device
    enforce_that(dev.type == "cuda", f"the RNN kernels run on CUDA tensors, "
                 f"got {dev}", context=what)
    enforce_that(xp.dtype in _DTYPE_CODE and h.dtype == xp.dtype,
                 "the RNN kernels take xp and h in one type, float32 or "
                 f"bfloat16; got {xp.dtype} and {h.dtype}", context=what)
    B, H = h.shape
    enforce_that(tuple(xp.shape) == (B, gates * H) and
                 tuple(w_h.shape) == (H, gates * H) and
                 tuple(bias.shape) == (gates * H,),
                 f"shapes must be xp [B, {gates}H], h [B, H], w_h [H, "
                 f"{gates}H], bias [{gates}H]; got {tuple(xp.shape)}, "
                 f"{tuple(h.shape)}, {tuple(w_h.shape)}, "
                 f"{tuple(bias.shape)}", context=what)
    for name, x in (("xp", xp), ("h", h), ("w_h", w_h), ("bias", bias),
                    *f32):
        enforce_that(x.device == dev and x.is_contiguous(),
                     f"{name} must be contiguous on {dev}", context=what)
    for name, x in (("w_h", w_h), ("bias", bias), *f32):
        enforce_that(x.dtype == torch.float32, f"{name} must be float32, "
                     f"got {x.dtype}", context=what)


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _ptr(x) -> Optional[int]:
    return None if x is None else x.data_ptr()


def lstm_step_kernel(xp, h, c, w_h, bias, *, save_acts: bool = False):
    """Launch B5 on CUDA tensors; same arguments and results as
    :func:`lstm_step_reference`.  Adds one to ``.launches`` a launch."""
    _check("lstm_step", xp, h, 4, w_h, bias, f32=(("c", c),))
    enforce_that(c.shape == h.shape, "c must be [B, H] like h",
                 context="lstm_step")
    lib = build.load("rnn_cells", _SIGNATURES)
    B, H = h.shape
    new_h = torch.empty_like(h)
    new_c = torch.empty_like(c)
    acts = (torch.empty((B, 5 * H), dtype=torch.float32, device=h.device)
            if save_acts else None)
    rc = lib.rnn_lstm_step(xp.data_ptr(), h.data_ptr(), c.data_ptr(),
                           w_h.data_ptr(), bias.data_ptr(), new_h.data_ptr(),
                           new_c.data_ptr(), _ptr(acts), B, H,
                           _DTYPE_CODE[xp.dtype], _stream(h.device))
    _raise_on(lib, rc, "rnn_lstm_step")
    lstm_step_kernel.launches += 1
    return new_h, new_c, acts


def gru_step_kernel(xp, h, w_h, bias, *, save_acts: bool = False):
    """Launch B6 (one cooperative launch) on CUDA tensors; same arguments
    and results as :func:`gru_step_reference`.  Raises, with the limit,
    where the card cannot hold its grid at once (:func:`gru_route` then
    takes B7 + B8)."""
    _check("gru_step", xp, h, 3, w_h, bias)
    B, H = h.shape
    why = gru_block_refusal(B, H, xp.dtype, h.device)
    enforce_that(why is None, str(why), context="gru_step")
    lib = build.load("rnn_cells", _SIGNATURES)
    new_h = torch.empty_like(h)
    rh = torch.empty((B, H), dtype=torch.float32, device=h.device)
    acts = (torch.empty((B, 3 * H), dtype=torch.float32, device=h.device)
            if save_acts else None)
    rc = lib.rnn_gru_step(xp.data_ptr(), h.data_ptr(), w_h.data_ptr(),
                          bias.data_ptr(), rh.data_ptr(), new_h.data_ptr(),
                          _ptr(acts), B, H, _DTYPE_CODE[xp.dtype],
                          _stream(h.device))
    _raise_on(lib, rc, "rnn_gru_step")
    gru_step_kernel.launches += 1
    return new_h, acts


def gru_zr_kernel(xp, h, w_h, bias):
    """Launch B7 on CUDA tensors; same arguments and results as
    :func:`gru_zr_reference` (the last H columns of zrc unwritten)."""
    _check("gru_zr", xp, h, 3, w_h, bias)
    lib = build.load("rnn_cells", _SIGNATURES)
    B, H = h.shape
    zrc = torch.empty((B, 3 * H), dtype=torch.float32, device=h.device)
    rh = torch.empty((B, H), dtype=torch.float32, device=h.device)
    rc = lib.rnn_gru_zr(xp.data_ptr(), h.data_ptr(), w_h.data_ptr(),
                        bias.data_ptr(), zrc.data_ptr(), rh.data_ptr(), B, H,
                        _DTYPE_CODE[xp.dtype], _stream(h.device))
    _raise_on(lib, rc, "rnn_gru_zr")
    gru_zr_kernel.launches += 1
    return zrc, rh


def gru_cand_kernel(rh, xp, w_h, bias, zrc, h, *, save_c: bool = False):
    """Launch B8 on CUDA tensors; same arguments and results as
    :func:`gru_cand_reference` (c into ``zrc[:, 2H:]`` with ``save_c``)."""
    _check("gru_cand", xp, h, 3, w_h, bias, f32=(("rh", rh), ("zrc", zrc)))
    B, H = h.shape
    enforce_that(tuple(rh.shape) == (B, H) and
                 tuple(zrc.shape) == (B, 3 * H),
                 "rh must be [B, H] and zrc [B, 3H]", context="gru_cand")
    lib = build.load("rnn_cells", _SIGNATURES)
    new_h = torch.empty_like(h)
    rc = lib.rnn_gru_cand(rh.data_ptr(), xp.data_ptr(), w_h.data_ptr(),
                          bias.data_ptr(), zrc.data_ptr(), h.data_ptr(),
                          new_h.data_ptr(), int(save_c), B, H,
                          _DTYPE_CODE[xp.dtype], _stream(h.device))
    _raise_on(lib, rc, "rnn_gru_cand")
    gru_cand_kernel.launches += 1
    return new_h


lstm_step_kernel.launches = 0
gru_step_kernel.launches = 0
gru_zr_kernel.launches = 0
gru_cand_kernel.launches = 0


# ---------------------------------------------------------------------------
# Dispatch by device, and the fused steps with their closed-form backward
# ---------------------------------------------------------------------------

def lstm_step(xp, h, c, w_h, bias, *, save_acts: bool = False):
    """B5: the kernel on CUDA tensors, the plain version on CPU ones."""
    fn = lstm_step_kernel if xp.is_cuda else lstm_step_reference
    return fn(xp, h, c, w_h, bias, save_acts=save_acts)


def gru_fused_step(xp, h, w_h, bias, *, save_acts: bool = False):
    """One fused GRU step: (h' in xp's type, acts [B, 3H] f32 or None), by
    :func:`gru_route`'s choice: B6, or B7 then B8.  Kernels on CUDA
    tensors, their plain versions on CPU ones."""
    B, H = h.shape
    cuda = xp.is_cuda
    if gru_route(B, H, xp.dtype, h.device) == "block":
        fn = gru_step_kernel if cuda else gru_step_reference
        return fn(xp, h, w_h, bias, save_acts=save_acts)
    zrc, rh = (gru_zr_kernel if cuda else gru_zr_reference)(xp, h, w_h, bias)
    new_h = (gru_cand_kernel if cuda else gru_cand_reference)(
        rh, xp, w_h, bias, zrc, h, save_c=save_acts)
    return new_h, (zrc if save_acts else None)


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class _FusedLSTMCell(torch.autograd.Function):
    """JAX's ``_fused_lstm_cell`` custom_vjp: the forward saves the acts;
    the backward is ``_fused_lstm_bwd``."""

    @staticmethod
    def forward(ctx, xp, h, c, w_h, bias):
        new_h, new_c, acts = lstm_step(xp, h, c, w_h, bias, save_acts=True)
        ctx.save_for_backward(h, c, w_h, acts)
        ctx.dtypes = (xp.dtype, bias.dtype)
        return new_h, new_c

    @staticmethod
    def backward(ctx, d_newh, d_newc):
        h, c, w_h, acts = ctx.saved_tensors
        xp_dtype, bias_dtype = ctx.dtypes
        i, f, g, o, tanh_nc = torch.chunk(acts, 5, dim=1)
        d_newh = d_newh.float()
        d_newc = d_newc.float()
        do_ = d_newh * tanh_nc
        dct = d_newc + d_newh * o * (1.0 - tanh_nc * tanh_nc)
        dgates = torch.cat([
            dct * g * i * (1.0 - i),
            dct * c.float() * f * (1.0 - f),
            dct * i * (1.0 - g * g),
            do_ * o * (1.0 - o),
        ], dim=1)
        need = ctx.needs_input_grad
        dxp = dgates.to(xp_dtype) if need[0] else None
        dh = matmul(dgates, w_h, trans_b=True).to(h.dtype) if need[1] \
            else None
        dc = (dct * f).to(c.dtype) if need[2] else None
        dwh = matmul(h.float(), dgates, trans_a=True).to(w_h.dtype) \
            if need[3] else None
        db = dgates.sum(0).to(bias_dtype) if need[4] else None
        return dxp, dh, dc, dwh, db


def _fused_lstm_cell(xp, h, c, w_h, bias):
    """(h', c' f32); the forward-only call skips the acts write, as JAX's
    primal-only variant does."""
    if _wants_grad(xp, h, c, w_h, bias):
        return _FusedLSTMCell.apply(xp, h, c, w_h, bias)
    new_h, new_c, _ = lstm_step(xp, h, c, w_h, bias)
    return new_h, new_c


class _FusedGRUCell(torch.autograd.Function):
    """JAX's ``_fused_gru_cell`` custom_vjp: the forward saves the acts
    (z, r, c); the backward is ``_fused_gru_bwd``."""

    @staticmethod
    def forward(ctx, xp, h, w_h, bias):
        new_h, acts = gru_fused_step(xp, h, w_h, bias, save_acts=True)
        ctx.save_for_backward(h, w_h, acts)
        ctx.dtypes = (xp.dtype, bias.dtype)
        return new_h

    @staticmethod
    def backward(ctx, d_newh):
        h, w_h, acts = ctx.saved_tensors
        xp_dtype, bias_dtype = ctx.dtypes
        H = h.shape[1]
        z, r, c = torch.chunk(acts, 3, dim=1)
        hf = h.float()
        d_newh = d_newh.float()
        dz = d_newh * (c - hf)
        dc = d_newh * z
        dh = d_newh * (1.0 - z)
        dgc = dc * (1.0 - c * c)
        d_rh = matmul(dgc, w_h[:, 2 * H:], trans_b=True)
        dr = d_rh * hf
        dh = dh + d_rh * r
        dgz = dz * z * (1.0 - z)
        dgr = dr * r * (1.0 - r)
        dgzr = torch.cat([dgz, dgr], dim=1)
        dh = dh + matmul(dgzr, w_h[:, :2 * H], trans_b=True)
        dgates = torch.cat([dgzr, dgc], dim=1)
        need = ctx.needs_input_grad
        dwh = torch.cat([matmul(hf, dgzr, trans_a=True),
                         matmul(r * hf, dgc, trans_a=True)],
                        dim=1).to(w_h.dtype) if need[2] else None
        dxp = dgates.to(xp_dtype) if need[0] else None
        db = dgates.sum(0).to(bias_dtype) if need[3] else None
        return dxp, dh.to(h.dtype), dwh, db


def _fused_gru_cell(xp, h, w_h, bias):
    if _wants_grad(xp, h, w_h, bias):
        return _FusedGRUCell.apply(xp, h, w_h, bias)
    return gru_fused_step(xp, h, w_h, bias)[0]


# ---------------------------------------------------------------------------
# Time scans
# ---------------------------------------------------------------------------

def _steps(T: int, reverse: bool):
    return range(T - 1, -1, -1) if reverse else range(T)


def _time_steps(x):
    """[B, T, ...] -> T contiguous [B, ...] views, as the kernels take
    them.  ``unbind``'s backward is one ``stack``; indexing step t of the
    [T, B, ...] tensor would instead make autograd build and sum a
    full-size zero tensor for every step."""
    return x.transpose(0, 1).contiguous().unbind(0)


def lstm_scan(x, mask, w_x, w_h, bias, *, reverse: bool = False,
              init: Optional[LSTMState] = None, gate_act=torch.sigmoid,
              cell_act=torch.tanh, out_act=torch.tanh
              ) -> Tuple[torch.Tensor, LSTMState]:
    """Full-sequence LSTM: x [B, T, D], mask [B, T] -> (h_all [B, T, H],
    final state).  ``w_x=None`` means x is already projected to [B, T, 4H]
    (the ``lstmemory`` contract).  ``reverse`` scans from the last step to
    the first, output t aligned with input t (``lax.scan(reverse=True)``)."""
    B, T, _ = x.shape
    H = w_h.shape[0]
    xp = matmul(x, w_x) if w_x is not None else x
    if init is None:
        init = LSTMState(torch.zeros((B, H), dtype=xp.dtype, device=xp.device),
                         torch.zeros((B, H), dtype=xp.dtype, device=xp.device))
    fused = _use_fused(B, w_h, gate_act, cell_act, out_act)
    bias_arr = (bias if bias is not None else torch.zeros(
        (4 * H,), dtype=torch.float32, device=xp.device)) if fused else bias
    xs = _time_steps(xp)
    mt = mask.transpose(0, 1)
    state, hs = init, [None] * T
    for t in _steps(T, reverse):
        if fused:
            new_h, new_c = _fused_lstm_cell(xs[t], state.h, state.c.float(),
                                            w_h, bias_arr)
            new_state = LSTMState(new_h, new_c.to(state.c.dtype))
            h = new_h
        else:
            h, new_state = lstm_cell(xs[t], state, w_h, bias, gate_act,
                                     cell_act, out_act)
        m = mt[t][:, None].to(h.dtype)
        state = LSTMState(m * new_state.h + (1 - m) * state.h,
                          m * new_state.c + (1 - m) * state.c)
        hs[t] = state.h
    return torch.stack(hs, dim=1), state


def gru_scan(x, mask, w_x, w_h, bias, *, reverse: bool = False,
             init=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence GRU: x [B, T, D] -> (h_all [B, T, H], final h).
    ``w_x=None`` means x is already [B, T, 3H] (the ``grumemory``
    contract)."""
    B, T, _ = x.shape
    H = w_h.shape[0]
    xp = matmul(x, w_x) if w_x is not None else x
    h = init if init is not None else torch.zeros(
        (B, H), dtype=xp.dtype, device=xp.device)
    fused = FLAGS.use_pallas and _gru_fused_plan(H, B, w_h) is not None
    bias_arr = (bias if bias is not None else torch.zeros(
        (3 * H,), dtype=torch.float32, device=xp.device)) if fused else bias
    xs = _time_steps(xp)
    mt = mask.transpose(0, 1)
    hs = [None] * T
    for t in _steps(T, reverse):
        if fused:
            new_h = _fused_gru_cell(xs[t], h, w_h, bias_arr)
        else:
            new_h = gru_cell(xs[t], h, w_h, bias)
        m = mt[t][:, None].to(new_h.dtype)
        h = m * new_h + (1 - m) * h
        hs[t] = h
    return torch.stack(hs, dim=1), h

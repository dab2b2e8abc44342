"""The ragged paged-attention kernel's cases at the serving shapes, their
tolerances and their roofline bounds, in one place so ``chip_smoke.py``
and ``python -m paddle_tpu_torch.tools.compare_ragged`` run the same
inputs.

The main path's shapes are the serve workload's (``serve_workload``): 16
heads of head_dim 128, page 128, 8 pages a sequence, a 129-page pool.
``decode_f32`` is 8 decode rows over cached lengths 0-1024; ``mixed_f32``
is the unified step's shape: one 256-row prefill chunk at offset 512 plus
7 decode rows.  The other cases take the same sequences at the other head
dims, groups, query and page types the kernel serves.

Usage::

    for name, case in kernel_cases(torch.device("cuda")):
        got = ragged_paged_attention_kernel(*args(case), **scales(case))
        assert check(case, got)["within_tolerance"]
"""

from __future__ import annotations

import numpy as np
import torch

SEED = 0
H, D, PAGE, PM = 16, 128, 128, 8
NUM_PAGES = 129

# published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet,
# dense)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12
BF16_FLOPS_PER_S = 989e12
# the kernel's wide items: runs of more score rows than this (NARROW_ROWS)
NARROW_ROWS = 16

# (abs, rel) against the plain version.  f32 outputs on f32 or int8 pages:
# 1e-4 (sums in another order).  f32 queries on bf16 pages: 1e-3 against
# the plain version that rounds P as the kernel does (at its tiles and
# spans), 2e-2 against the one that does not.  bf16 outputs: 1e-3 plus one
# bf16 step of the value (2**-7 of it): both sides round one f32 result,
# which the order of the sums can move across a rounding boundary.  bf16
# queries on bf16 pages (the tensor cores): every element within 2e-2 of
# the plain version that does not round P, and all but FLIP_SHARE of them
# within TOL_BF16_OUT of the one that does — the tensor cores sum the
# scores in another order, which moves a few P across a bf16 rounding
# step, each moving its row's output by up to 2**-8 of its V.
TOL = {"float32": (1e-4, 1e-4), "int8": (1e-4, 1e-4),
       "bfloat16": (1e-3, 1e-3)}
TOL_BF16_UNROUNDED = (2e-2, 2e-2)
TOL_BF16_OUT = (1e-3, 2.0 ** -7)
FLIP_SHARE = 1e-3

ARGS = ("q", "k_pages", "v_pages", "page_table", "kv_lens", "row_seq",
        "qpos")

# decode-only: 8 sequences, one row each; mixed: one 256-row prefill chunk
# at offset 512 plus 7 decode rows — the unified step's shape
DECODE_SEQS = [(n, 1, 0) for n in (0, 1, 127, 128, 129, 500, 777, 1024)]
MIXED_SEQS = [(768, 256, 512)] + [(n, 1, 0) for n in
                                  (1, 128, 129, 300, 640, 900, 1024)]


def build_case(rng, seqs, kvh, dev, h: int = H, d: int = D):
    """A sequence-packed batch in the kernel's block packing.  ``seqs``
    is a list of (kv_len, q_rows, q_start): one decode row at kv_len-1
    when q_rows == 1, else a prefill chunk at q_start..q_start+q_rows-1.
    Live pages hold random K/V, the rest random garbage; page rows are
    ``padded_head_dim(d)`` wide, as the pool allocates them, the columns
    past d zero."""
    from paddle_tpu_torch.ops.attention import padded_head_dim

    dp = padded_head_dim(d)
    kp = rng.standard_normal((NUM_PAGES, PAGE, kvh, dp), np.float32)
    vp = rng.standard_normal((NUM_PAGES, PAGE, kvh, dp), np.float32)
    kp[..., d:] = 0.0
    vp[..., d:] = 0.0
    table = np.zeros((len(seqs), PM), np.int32)
    free = list(range(1, NUM_PAGES))
    rng.shuffle(free)
    row_seq, qpos = [], []
    for i, (n, qr, qs) in enumerate(seqs):
        for j in range(-(-n // PAGE)):
            table[i, j] = free.pop()
        blocks = -(-qr // 8)
        pos = list(range(qs, qs + qr)) if qr > 1 else [n - 1]
        qpos += pos + [-1] * (blocks * 8 - qr)
        row_seq += [i] * blocks * 8
    q = rng.standard_normal((len(qpos), h, d), np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return dict(q=t(q), k_pages=t(kp), v_pages=t(vp), page_table=t(table),
                kv_lens=t(np.asarray([s[0] for s in seqs], np.int32)),
                row_seq=t(np.asarray(row_seq, np.int32)),
                qpos=t(np.asarray(qpos, np.int32)))


def with_types(case, pages: str = "float32", q: str = "float32"):
    """The same case with its pages stored as ``pages`` (int8 through the
    pool's own quantize-on-write rule) and its queries as ``q``."""
    from paddle_tpu_torch.serving.kv_cache import quantize_kv

    out = dict(case)
    if pages == "int8":
        out["k_pages"], out["k_scale"] = quantize_kv(case["k_pages"])
        out["v_pages"], out["v_scale"] = quantize_kv(case["v_pages"])
    elif pages == "bfloat16":
        out["k_pages"] = case["k_pages"].to(torch.bfloat16)
        out["v_pages"] = case["v_pages"].to(torch.bfloat16)
    out["q"] = case["q"].to(getattr(torch, q))
    return out


def args(case) -> list:
    return [case[k] for k in ARGS]


def scales(case) -> dict:
    return {k: case[k] for k in ("k_scale", "v_scale") if k in case}


def kernel_rounding(case) -> dict:
    """The plain version's options that round P on bf16 pages as the
    kernel does: at its tiles, the running maximum restarting at each
    span of its split token axis."""
    from paddle_tpu_torch.serving import decode_attention as da

    tokens = case["page_table"].shape[1] * case["k_pages"].shape[1]
    return dict(round_p_tile=da.KERNEL_TILE_TOKENS,
                round_p_span=da.kernel_split_tokens(tokens))


# name: (sequences, KV heads, heads, head dim, q type, page type) — the
# main path's decode and mixed steps, then the same sequences over the
# other page and query types, head dims and groups (G 1, 3 with 12 heads
# over 4 KV heads, 4, and 16 over one KV head): the compiled widths, and
# head dims between them (96 on f32 pages, 80 on int8 pages), which the
# kernels at widths 128 run with their columns past the head dim zero
CASES = {
    "decode_f32": ("decode", 16, 16, 128, "float32", "float32"),
    "mixed_f32": ("mixed", 16, 16, 128, "float32", "float32"),
    "mixed_gqa4_f32": ("mixed", 4, 16, 128, "float32", "float32"),
    "mixed_int8": ("mixed", 16, 16, 128, "float32", "int8"),
    "mixed_bf16": ("mixed", 16, 16, 128, "float32", "bfloat16"),
    "decode_bf16q_bf16": ("decode", 16, 16, 128, "bfloat16", "bfloat16"),
    "mixed_bf16q_bf16": ("mixed", 16, 16, 128, "bfloat16", "bfloat16"),
    "mixed_bf16q_f32": ("mixed", 16, 16, 128, "bfloat16", "float32"),
    "mixed_gqa3_f32": ("mixed", 4, 12, 128, "float32", "float32"),
    "mixed_mqa16_f32": ("mixed", 1, 16, 128, "float32", "float32"),
    "mixed_f32_d16": ("mixed", 16, 16, 16, "float32", "float32"),
    "mixed_f32_d32": ("mixed", 16, 16, 32, "float32", "float32"),
    "mixed_f32_d64": ("mixed", 16, 16, 64, "float32", "float32"),
    "mixed_f32_d256": ("mixed", 16, 16, 256, "float32", "float32"),
    "mixed_f32_d96": ("mixed", 16, 16, 96, "float32", "float32"),
    "mixed_int8_d80": ("mixed", 16, 16, 80, "float32", "int8"),
}
SEQS = {"decode": DECODE_SEQS, "mixed": MIXED_SEQS}

# head dims served from pools padded to the next multiple of 8 (12 and 100,
# rows of 16 and 104) and by the wide kernel above 256 (320): decode and
# mixed steps on f32, bf16 and int8 pages, and bf16 queries on bf16 pages,
# over 4 heads
C4_CASES = {
    f"c4_{seqs}_{name}_d{d}": (seqs, 4, 4, d, q, pages)
    for d in (12, 100, 320) for seqs in ("decode", "mixed")
    for name, q, pages in (("f32", "float32", "float32"),
                           ("bf16", "float32", "bfloat16"),
                           ("int8", "float32", "int8"),
                           ("bf16q_bf16", "bfloat16", "bfloat16"))}
# head dims above 512, on the wide kernel in chunks of 512 columns: decode
# and mixed steps on f32 and bf16 pages, and bf16 queries on bf16 pages
C4_WIDE_CASES = {
    f"c4_{seqs}_{name}_d{d}": (seqs, 4, 4, d, q, pages)
    for d in (640, 1024) for seqs in ("decode", "mixed")
    for name, q, pages in (("f32", "float32", "float32"),
                           ("bf16", "float32", "bfloat16"),
                           ("bf16q_bf16", "bfloat16", "bfloat16"))}


def kernel_cases(dev, cases=None):
    """[(name, case)] of ``cases`` (default :data:`CASES`), in order;
    cases of the same sequences and shapes share their f32 data."""
    cases = CASES if cases is None else cases
    rng = np.random.default_rng(SEED if cases is CASES else SEED + 1)
    base = {}
    # the main path's two first, as every earlier run drew them
    for key in ((("mixed", 16, 16, 128), ("decode", 16, 16, 128))
                if cases is CASES else ()):
        base[key] = build_case(rng, SEQS[key[0]], key[1], dev, h=key[2],
                               d=key[3])
    out = []
    for name, (seqs, kvh, h, d, q, pages) in cases.items():
        key = (seqs, kvh, h, d)
        if key not in base:
            base[key] = build_case(rng, SEQS[seqs], kvh, dev, h=h, d=d)
        out.append((name, with_types(base[key], pages, q)))
    return out


def check(case, got) -> dict:
    """The kernel's output against the plain version on the case's real
    rows (padded rows are arbitrary by contract), at the tolerances
    above: max abs error, the tolerance, and whether every element is
    within it (all but :data:`FLIP_SHARE` of them on the tensor-core
    path) and finite."""
    from paddle_tpu_torch.serving.decode_attention import \
        ragged_paged_attention_reference as plain

    real = case["qpos"] >= 0
    bf16_pages = case["k_pages"].dtype == torch.bfloat16
    bf16_q = case["q"].dtype == torch.bfloat16

    def compare(want, tol):
        g, w = got[real].float(), want[real].float()
        err = (g - w).abs()
        outside = float((err > tol[0] + tol[1] * w.abs()).float().mean())
        return float(err.max()), outside

    want = plain(*args(case), **scales(case),
                 **(kernel_rounding(case) if bf16_pages else {}))
    tol = TOL_BF16_OUT if bf16_q else \
        TOL[str(case["k_pages"].dtype).replace("torch.", "")]
    err, outside = compare(want, tol)
    allowed = FLIP_SHARE if bf16_q and bf16_pages else 0.0
    ok = outside <= allowed
    res = {"max_abs_err": err, "atol": tol[0], "rtol": tol[1],
           "share_outside": outside, "share_allowed": allowed}
    if bf16_pages:
        err2, outside2 = compare(plain(*args(case), **scales(case)),
                                 TOL_BF16_UNROUNDED)
        res.update(max_abs_err_unrounded=err2,
                   tol_unrounded=TOL_BF16_UNROUNDED,
                   within_tolerance_unrounded=outside2 == 0.0)
        ok = ok and outside2 == 0.0
    res["within_tolerance"] = ok and bool(torch.isfinite(got[real]).all())
    return res


def wide_rows(case) -> np.ndarray:
    """[T] bool: the real rows the kernel computes as wide items — runs
    (up to 8 consecutive 8-row blocks of one sequence inside a 64-row
    aligned group) of more than :data:`NARROW_ROWS` score rows (real rows
    times the group) — as its plan forms them."""
    rs = case["row_seq"].cpu().numpy()
    real = case["qpos"].cpu().numpy() >= 0
    g = case["q"].shape[1] // case["k_pages"].shape[2]
    out = np.zeros(len(rs), bool)
    nb = len(rs) // 8
    b = 0
    while b < nb:
        e = b + 1
        while e < nb and e % 8 and rs[e * 8] == rs[b * 8]:
            e += 1
        rows = slice(8 * b, 8 * e)
        out[rows] = real[rows] & (real[rows].sum() * g > NARROW_ROWS)
        b = e
    return out


def product_rates(case) -> dict:
    """The rate each product runs at, in f32-equivalent flops per second:
    bf16 queries on bf16 pages on the bf16 tensor cores; otherwise the
    wide rows' QK and PV as 3xTF32 tensor-core products, one TF32 product
    for each term the kernel issues (operands exact in TF32 — bf16 and
    int8 pages, P rounded on bf16 pages — drop their lo terms), and the
    narrow rows' on the CUDA cores in f32."""
    q, kp = case["q"], case["k_pages"]
    if q.dtype == torch.bfloat16 and kp.dtype == torch.bfloat16:
        return {k: BF16_FLOPS_PER_S for k in
                ("wide_qk", "wide_pv", "narrow_qk", "narrow_pv")}
    f32_pages = kp.dtype == torch.float32
    qk_terms = 3 if f32_pages else 2
    pv_terms = 3 if f32_pages else (1 if kp.dtype == torch.bfloat16 else 2)
    return {"wide_qk": TF32_FLOPS_PER_S / qk_terms,
            "wide_pv": TF32_FLOPS_PER_S / pv_terms,
            "narrow_qk": F32_FLOPS_PER_S, "narrow_pv": F32_FLOPS_PER_S}


def roofline(case) -> dict:
    """Least time for this case's work: each input byte the function
    needs read once, each output byte written once (live K/V, and q and
    out of real rows only — padded rows' output is arbitrary by
    contract — in q's type), and the operations of the live (row, head,
    token) triples, 2 flops per multiply-add, QK and PV each at the rate
    it runs (:func:`product_rates`)."""
    q, kp = case["q"], case["k_pages"]
    _, h, d = q.shape
    kvh = kp.shape[2]
    lens = case["kv_lens"].cpu().numpy()
    qpos = case["qpos"].cpu().numpy()
    rs = case["row_seq"].cpu().numpy()
    wide = wide_rows(case)
    tok_bytes = kvh * d * kp.element_size()
    if "k_scale" in case:
        tok_bytes += kvh * 4
    seq_tokens = {}
    live = {True: 0, False: 0}
    real = [r for r in range(len(qpos)) if qpos[r] >= 0]
    for r in real:
        s = int(rs[r])
        n = min(int(lens[s]), int(qpos[r]) + 1)
        seq_tokens[s] = max(seq_tokens.get(s, 0), n)
        live[bool(wide[r])] += n
    nbytes = (2 * sum(seq_tokens.values()) * tok_bytes
              + 2 * len(real) * h * d * q.element_size()
              + sum(case[k].numel() * 4 for k in
                    ("page_table", "kv_lens", "row_seq", "qpos")))
    rate = product_rates(case)
    half_w = 2.0 * live[True] * h * d       # QK, and again PV
    half_n = 2.0 * live[False] * h * d
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = (half_w / rate["wide_qk"] + half_w / rate["wide_pv"] +
              half_n / rate["narrow_qk"] + half_n / rate["narrow_pv"]) * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "flops": 2 * (half_w + half_n),
            "bytes_ms": bytes_ms, "ops_ms": ops_ms}

"""The tenth slice's layers at small widths: one case a layer (two
where a layer has two modes worth holding apart), each a build function
taking a package's ``layer`` and ``data_type`` modules, the data slots and
seeded samples.  The CPU tests build every case in both the JAX package
and the port; ``chip_smoke.py``'s ``layers_v2`` phase runs the port's on
the card against its CPU path.  This module imports neither package."""

from __future__ import annotations

import numpy as np

B, D = 4, 6


def _rs(seed):
    return np.random.RandomState(seed)


def dense(*cols, n=B, seed=1):
    """n samples of the given columns: ("d", dim, lo, hi) a float row,
    ("i", range) an int, ("s", dim, lo, hi) a float sequence of 1-5
    tokens, ("si", range) an int sequence."""
    rs = _rs(seed)
    lens = [int(x) for x in rs.randint(1, 6, n)]
    out = []
    for i in range(n):
        row = []
        for c in cols:
            if c[0] == "d":
                row.append(rs.uniform(c[2], c[3], c[1]).astype(np.float32))
            elif c[0] == "i":
                row.append(int(rs.randint(0, c[1])))
            elif c[0] == "s":
                row.append(list(rs.uniform(c[2], c[3], (lens[i], c[1]))
                                .astype(np.float32)))
            else:
                row.append(rs.randint(0, c[1], lens[i]).tolist())
        out.append(tuple(row))
    return out


def _x(L, dt, dim=D, name="x"):
    return L.data(name=name, type=dt.dense_vector(dim))


def _img(L, dt, h, w, c, name="img"):
    return L.data(name=name, type=dt.dense_vector(h * w * c), height=h,
                  width=w)


IMG = (5, 6, 4)          # H, W, C
IMG_SLOTS = [("img", "dense_vector", IMG[0] * IMG[1] * IMG[2])]
IMG_BATCH = dense(("d", IMG[0] * IMG[1] * IMG[2], -1, 1))
VOL = (3, 4, 5, 2)       # D, H, W, C
VOL_SLOTS = [("vol", "dense_vector", int(np.prod(VOL)))]
VOL_BATCH = dense(("d", int(np.prod(VOL)), -1, 1), n=2)


def _vol(L, dt):
    return L.data(name="vol", type=dt.dense_vector(int(np.prod(VOL))))


def _conv3d(L, dt, trans=False):
    d, h, w, c = VOL
    return L.img_conv3d(_vol(L, dt), filter_size=3, num_filters=3,
                        num_channels=c, stride=2 if trans else 1,
                        padding=1, act="tanh", trans=trans, depth=d,
                        height=h, width=w, name="c3")


def _seq(L, dt, dim=D, name="s"):
    return L.data(name=name, type=dt.dense_vector_sequence(dim))


# a single-map SSD head: the layer API, like the reference's, takes one
# ``priorbox``, so a case holds one feature map (SSD300's six maps are
# ``tools/detection_workload.py``'s, on ``ops/detection`` directly)
SSD_MAP = (3, 3, 4)      # H, W, C
SSD_IMG, SSD_CLASSES, SSD_GTS = 30, 3, 3
SSD_SLOTS = [("fmap", "dense_vector", int(np.prod(SSD_MAP))),
             ("gt", "dense_vector", SSD_GTS * 5)]


def _ssd_head(L, dt):
    """(loc, conf, priorbox) over a data feature map: 3 x 3 convolutions
    and 4 priors a cell (min 8, max 16, aspect ratio 2 and 1/2)."""
    h, w, c = SSD_MAP
    fmap = _img(L, dt, h, w, c, name="fmap")
    loc = L.img_conv(fmap, filter_size=3, num_filters=4 * 4,
                     num_channels=c, padding=1, name="loc")
    conf = L.img_conv(fmap, filter_size=3, num_filters=4 * SSD_CLASSES,
                      num_channels=c, padding=1, name="conf")
    prior = L.priorbox(fmap, image_size=SSD_IMG, min_size=[8.0],
                       max_size=[16.0], aspect_ratio=[2.0], name="prior")
    return loc, conf, prior


def _ssd_batch(seed=9):
    """(feature map, gt rows) samples: classes 1..C-1, the last one or two
    rows of each example padded (class -1)."""
    rs = _rs(seed)
    out = []
    for b in range(B):
        lo = rs.rand(SSD_GTS, 2) * 0.6
        gt = np.concatenate([rs.randint(1, SSD_CLASSES, (SSD_GTS, 1)), lo,
                             lo + 0.2 + 0.2 * rs.rand(SSD_GTS, 2)], 1)
        gt[SSD_GTS - 1 - b % 2:, 0] = -1.0
        out.append((rs.uniform(-1, 1, SSD_SLOTS[0][2]).astype(np.float32),
                    gt.astype(np.float32).reshape(-1)))
    return out


# name -> (build(L, dt), slots, batch[, tolerance])
CASES = {
    "interpolation": (
        lambda L, dt: L.interpolation([_x(L, dt), _x(L, dt, name="y")],
                                      _x(L, dt, 1, "w")),
        [("x", "dense_vector", D), ("y", "dense_vector", D),
         ("w", "dense_vector", 1)],
        dense(("d", D, -1, 1), ("d", D, -1, 1), ("d", 1, 0, 1))),
    "scaling": (
        lambda L, dt: L.scaling(_x(L, dt), _x(L, dt, 1, "w")),
        [("x", "dense_vector", D), ("w", "dense_vector", 1)],
        dense(("d", D, -1, 1), ("d", 1, -2, 2))),
    "power": (
        lambda L, dt: L.power(_x(L, dt), _x(L, dt, 1, "w")),
        [("x", "dense_vector", D), ("w", "dense_vector", 1)],
        dense(("d", D, 0.5, 2), ("d", 1, 0.5, 2))),
    "sum_to_one_norm": (
        lambda L, dt: L.sum_to_one_norm(_x(L, dt)),
        [("x", "dense_vector", D)], dense(("d", D, 0.1, 1))),
    "row_l2_norm": (
        lambda L, dt: L.row_l2_norm(_x(L, dt)),
        [("x", "dense_vector", D)], dense(("d", D, -1, 1))),
    "cos_sim": (
        lambda L, dt: L.cos_sim(_x(L, dt), _x(L, dt, name="y"), scale=2.0),
        [("x", "dense_vector", D), ("y", "dense_vector", D)],
        dense(("d", D, -1, 1), ("d", D, -1, 1))),
    "clip": (
        lambda L, dt: L.clip(_x(L, dt), min=-0.5, max=0.5),
        [("x", "dense_vector", D)], dense(("d", D, -1, 1))),
    "resize": (
        lambda L, dt: L.resize(_x(L, dt), size=3),
        [("x", "dense_vector", D)], dense(("d", D, -1, 1))),
    "spp": (
        lambda L, dt: L.spp(_img(L, dt, *IMG), pyramid_height=2),
        IMG_SLOTS, IMG_BATCH),
    # 7 x 7 leaves no bin of the 4 x 4 level empty (an empty bin's mean
    # is 0 / 0 in both packages)
    "spp_avg": (
        lambda L, dt: L.spp(_img(L, dt, 7, 7, 2), pyramid_height=3,
                            pool_type="avg"),
        [("img", "dense_vector", 98)], dense(("d", 98, -1, 1))),
    "maxout": (
        lambda L, dt: L.maxout(_img(L, dt, *IMG), groups=2),
        IMG_SLOTS, IMG_BATCH),
    "bilinear_interp_up": (
        lambda L, dt: L.bilinear_interp(_img(L, dt, *IMG), out_size_x=11,
                                        out_size_y=8),
        IMG_SLOTS, IMG_BATCH),
    "bilinear_interp_down": (
        lambda L, dt: L.bilinear_interp(_img(L, dt, *IMG), out_size_x=4,
                                        out_size_y=2),
        IMG_SLOTS, IMG_BATCH),
    "pad": (
        lambda L, dt: L.pad(_img(L, dt, *IMG), pad_c=(1, 0), pad_h=(0, 2),
                            pad_w=(1, 1)),
        IMG_SLOTS, IMG_BATCH),
    "crop": (
        lambda L, dt: L.crop(_img(L, dt, *IMG), offset_h=1, offset_w=2,
                             crop_h=3),
        IMG_SLOTS, IMG_BATCH),
    "rotate": (
        lambda L, dt: L.rotate(_img(L, dt, *IMG)), IMG_SLOTS, IMG_BATCH),
    "block_expand": (
        lambda L, dt: L.block_expand(_img(L, dt, *IMG), block_x=3,
                                     block_y=2, stride_x=2, stride_y=1,
                                     padding_x=1, padding_y=0),
        IMG_SLOTS, IMG_BATCH),
    "selective_fc": (
        lambda L, dt: L.selective_fc(
            _x(L, dt), size=5, act="tanh",
            select=L.data(name="sel", type=dt.sparse_binary_vector(5))),
        [("x", "dense_vector", D), ("sel", "sparse_binary_vector", 5)],
        [(r[0], [j for j in range(5) if (i + j) % 3]) for i, r in
         enumerate(dense(("d", D, -1, 1)))]),
    "hsigmoid": (
        lambda L, dt: L.hsigmoid(_x(L, dt), L.data(
            name="y", type=dt.integer_value(7)), num_classes=7),
        [("x", "dense_vector", D), ("y", "integer_value", 7)],
        dense(("d", D, -1, 1), ("i", 7))),
    "cross_entropy_with_selfnorm_cost": (
        lambda L, dt: L.cross_entropy_with_selfnorm_cost(
            _x(L, dt), L.data(name="y", type=dt.integer_value(D)),
            softmax_selfnorm_alpha=0.3),
        [("x", "dense_vector", D), ("y", "integer_value", D)],
        dense(("d", D, -2, 2), ("i", D))),
    "square_error_cost": (
        lambda L, dt: L.square_error_cost(_x(L, dt), _x(L, dt, name="y")),
        [("x", "dense_vector", D), ("y", "dense_vector", D)],
        dense(("d", D, -1, 1), ("d", D, -1, 1))),
    "regression_cost": (
        lambda L, dt: L.regression_cost(_x(L, dt), _x(L, dt, name="y")),
        [("x", "dense_vector", D), ("y", "dense_vector", D)],
        dense(("d", D, -1, 1), ("d", D, -1, 1), seed=2)),
    "soft_binary_class_cross_entropy_cost": (
        lambda L, dt: L.soft_binary_class_cross_entropy_cost(
            _x(L, dt), _x(L, dt, name="y")),
        [("x", "dense_vector", D), ("y", "dense_vector", D)],
        dense(("d", D, 0.05, 0.95), ("d", D, 0, 1))),
    "rank_cost": (
        lambda L, dt: L.rank_cost(_x(L, dt, 1, "l"), _x(L, dt, 1, "r"),
                                  _x(L, dt, 1, "t"),
                                  weight=_x(L, dt, 1, "w")),
        [("l", "dense_vector", 1), ("r", "dense_vector", 1),
         ("t", "dense_vector", 1), ("w", "dense_vector", 1)],
        dense(("d", 1, -2, 2), ("d", 1, -2, 2), ("d", 1, 0, 1),
              ("d", 1, 0.5, 1.5))),
    "lambda_cost": (
        lambda L, dt: L.lambda_cost(_seq(L, dt, 1), _seq(L, dt, 1, "rel"),
                                    NDCG_num=3),
        [("s", "dense_vector_sequence", 1),
         ("rel", "dense_vector_sequence", 1)],
        [(s, [np.float32([int(v[0] * 3)]) for v in r]) for s, r in
         dense(("s", 1, -2, 2), ("s", 1, 0, 1), n=5)]),
    "huber_regression_cost": (
        lambda L, dt: L.huber_regression_cost(_x(L, dt), _x(L, dt, name="y"),
                                              delta=0.7),
        [("x", "dense_vector", D), ("y", "dense_vector", D)],
        dense(("d", D, -2, 2), ("d", D, -2, 2))),
    "huber_classification_cost": (
        lambda L, dt: L.huber_classification_cost(
            _x(L, dt, 1), L.data(name="y", type=dt.integer_value(2))),
        [("x", "dense_vector", 1), ("y", "integer_value", 2)],
        dense(("d", 1, -3, 3), ("i", 2), n=8)),
    "smooth_l1_cost": (
        lambda L, dt: L.smooth_l1_cost(_x(L, dt), _x(L, dt, name="y")),
        [("x", "dense_vector", D), ("y", "dense_vector", D)],
        dense(("d", D, -2, 2), ("d", D, -2, 2))),
    "sum_cost": (
        lambda L, dt: L.sum_cost(_x(L, dt)),
        [("x", "dense_vector", D)], dense(("d", D, -1, 1))),
    "sum_cost_sequence": (
        lambda L, dt: L.sum_cost(_seq(L, dt)),
        [("s", "dense_vector_sequence", D)], dense(("s", D, -1, 1))),
    "eos": (
        lambda L, dt: L.eos(L.data(name="ids", type=dt.integer_value_sequence(
            5)), eos_id=2),
        [("ids", "integer_value_sequence", 5)], dense(("si", 5), n=6)),
    "prelu": (
        lambda L, dt: L.prelu(_x(L, dt), partial_sum=2),
        [("x", "dense_vector", D)], dense(("d", D, -1, 1))),
    "scale_shift": (
        lambda L, dt: L.scale_shift(_x(L, dt)),
        [("x", "dense_vector", D)], dense(("d", D, -1, 1))),
    "data_norm": (
        lambda L, dt: L.data_norm(_x(L, dt), mean=[0.5] * D,
                                  std=list(np.linspace(0.5, 2, D))),
        [("x", "dense_vector", D)], dense(("d", D, -1, 1))),
    "data_norm_decimal": (
        lambda L, dt: L.data_norm(_x(L, dt), std=250.0,
                                  mode="decimal-scaling"),
        [("x", "dense_vector", D)], dense(("d", D, -100, 100))),
    "trans": (
        lambda L, dt: L.trans(_x(L, dt)),
        [("x", "dense_vector", D)], dense(("d", D, -1, 1))),
    "switch_order": (
        lambda L, dt: L.switch_order(_img(L, dt, *IMG)),
        IMG_SLOTS, IMG_BATCH),
    "tensor": (
        lambda L, dt: L.tensor(_x(L, dt, 3), _x(L, dt, 4, "y"), size=2,
                               act="tanh"),
        [("x", "dense_vector", 3), ("y", "dense_vector", 4)],
        dense(("d", 3, -1, 1), ("d", 4, -1, 1))),
    "out_prod": (
        lambda L, dt: L.out_prod(_x(L, dt, 3), _x(L, dt, 4, "y")),
        [("x", "dense_vector", 3), ("y", "dense_vector", 4)],
        dense(("d", 3, -1, 1), ("d", 4, -1, 1))),
    "multiplex": (
        lambda L, dt: L.multiplex(
            L.data(name="k", type=dt.integer_value(3)),
            [_x(L, dt, name=n) for n in ("a", "b", "c")]),
        [("k", "integer_value", 3), ("a", "dense_vector", D),
         ("b", "dense_vector", D), ("c", "dense_vector", D)],
        dense(("i", 3), ("d", D, -1, 1), ("d", D, -1, 1), ("d", D, -1, 1),
              n=6)),
    "conv_shift": (
        lambda L, dt: L.conv_shift(_x(L, dt), _x(L, dt, 3, "k")),
        [("x", "dense_vector", D), ("k", "dense_vector", 3)],
        dense(("d", D, -1, 1), ("d", 3, -1, 1))),
    "linear_comb": (
        lambda L, dt: L.linear_comb(_x(L, dt, 3, "w"), _x(L, dt, 12),
                                    size=4),
        [("w", "dense_vector", 3), ("x", "dense_vector", 12)],
        dense(("d", 3, -1, 1), ("d", 12, -1, 1))),
    "convex_comb": (
        lambda L, dt: L.convex_comb(_x(L, dt, 3, "w"), _x(L, dt, 12),
                                    size=4),
        [("w", "dense_vector", 3), ("x", "dense_vector", 12)],
        dense(("d", 3, 0, 1), ("d", 12, -1, 1), seed=3)),
    "cos_vm": (
        lambda L, dt: L.cos_vm(_x(L, dt, 4), _x(L, dt, 12, "y"), size=3,
                               scale=1.5),
        [("x", "dense_vector", 4), ("y", "dense_vector", 12)],
        dense(("d", 4, -1, 1), ("d", 12, -1, 1))),
    "row_conv": (
        lambda L, dt: L.row_conv(_seq(L, dt, 4), context_len=3, act="tanh"),
        [("s", "dense_vector_sequence", 4)], dense(("s", 4, -1, 1))),
    "subseq": (
        lambda L, dt: L.subseq(_seq(L, dt, 3),
                               L.data(name="o", type=dt.integer_value(2)),
                               L.data(name="n", type=dt.integer_value(3))),
        [("s", "dense_vector_sequence", 3), ("o", "integer_value", 2),
         ("n", "integer_value", 3)],
        dense(("s", 3, -1, 1), ("i", 2), ("i", 3))),
    "featmap_expand": (
        lambda L, dt: L.featmap_expand(_x(L, dt, 3), num_filters=4),
        [("x", "dense_vector", 3)], dense(("d", 3, -1, 1))),
    "featmap_expand_columns": (
        lambda L, dt: L.featmap_expand(_x(L, dt, 3), num_filters=4,
                                       as_row_vector=False),
        [("x", "dense_vector", 3)], dense(("d", 3, -1, 1))),
    "img_conv3d": (
        lambda L, dt: _conv3d(L, dt), VOL_SLOTS, VOL_BATCH),
    "img_conv3d_trans": (
        lambda L, dt: _conv3d(L, dt, trans=True), VOL_SLOTS, VOL_BATCH),
    "img_pool3d": (
        lambda L, dt: L.img_pool3d(_conv3d(L, dt), pool_size=2, stride=1,
                                   padding=1),
        VOL_SLOTS, VOL_BATCH),
    # a padding above half the window, which torch's pools refuse (no
    # window lies wholly in the padding: that one's max would be -inf)
    "img_pool3d_wide_pad": (
        lambda L, dt: L.img_pool3d(_conv3d(L, dt), pool_size=3, stride=1,
                                   padding=2),
        VOL_SLOTS, VOL_BATCH),
    "img_pool3d_avg": (
        lambda L, dt: L.img_pool3d(
            _conv3d(L, dt), pool_size=2, stride=2, padding=1,
            pool_type="avg"),
        VOL_SLOTS, VOL_BATCH),
    "mdlstmemory": (
        lambda L, dt: L.mdlstmemory(_x(L, dt, 3 * 4 * 2), size=3, height=3,
                                    width=4),
        [("x", "dense_vector", 24)], dense(("d", 24, -1, 1), n=3)),
    "gated_recurrent": (
        lambda L, dt: L.gated_recurrent(_seq(L, dt, 9), size=3),
        [("s", "dense_vector_sequence", 9)], dense(("s", 9, -1, 1))),
    "ctc": (
        lambda L, dt: L.ctc(_seq(L, dt, 5), L.data(
            name="lab", type=dt.integer_value_sequence(5)), blank=0),
        [("s", "dense_vector_sequence", 5),
         ("lab", "integer_value_sequence", 5)],
        [(list(_rs(4).randn(n, 5).astype(np.float32)), lab) for n, lab in
         ((5, [1, 2]), (4, [3, 3]), (3, [1, 2, 1]), (6, [4]))]),
    "warp_ctc": (
        lambda L, dt: L.warp_ctc(_seq(L, dt, 5), L.data(
            name="lab", type=dt.integer_value_sequence(5)), blank=4,
            norm_by_times=True),
        [("s", "dense_vector_sequence", 5),
         ("lab", "integer_value_sequence", 5)],
        [(list(_rs(5).randn(n, 5).astype(np.float32)), lab) for n, lab in
         ((3, [0, 1]), (6, [2, 2, 0]), (1, [3]))]),
    "ssd_multibox_loss": (
        lambda L, dt: L.multibox_loss(
            *_ssd_head(L, dt), L.data(name="gt", type=dt.dense_vector(
                SSD_GTS * 5)), num_classes=SSD_CLASSES, max_boxes=SSD_GTS),
        SSD_SLOTS, _ssd_batch()),
    "ssd_detection_output": (
        lambda L, dt: L.detection_output(
            *_ssd_head(L, dt), num_classes=SSD_CLASSES, keep_top_k=8,
            confidence_threshold=0.2),
        SSD_SLOTS[:1], [s[:1] for s in _ssd_batch()]),
}


# ---------------------------------------------------------------------------
# the port alone: forward and gradients on a device (the card phase)
# ---------------------------------------------------------------------------

NCE = (lambda L, dt: L.nce(_x(L, dt), L.data(
    name="y", type=dt.integer_value(7)), num_classes=7, num_neg_samples=3),
    [("x", "dense_vector", D), ("y", "integer_value", 7)],
    dense(("d", D, -1, 1), ("i", 7)))


class fixed_draws:
    """Within the block, ``layer``'s random draws (``_draw_ids``,
    ``_nce_negatives``) come from a CPU generator seeded afresh each call
    and move to the input's device, so a card run and a CPU run draw the
    same ids."""

    def __init__(self, seed: int = 0):
        self.seed = seed

    def __enter__(self):
        import torch

        from paddle_tpu_torch import layer

        self._saved = (layer._draw_ids, layer._nce_negatives)
        draw_ids, negatives = self._saved
        seed = self.seed

        def ids(gen, probs):
            g = torch.Generator().manual_seed(seed)
            return draw_ids(g, probs.detach().cpu()).to(probs.device)

        def neg(gen, batch, k, n, dist, device):
            g = torch.Generator().manual_seed(seed)
            return negatives(g, batch, k, n, dist, "cpu").to(device)

        layer._draw_ids, layer._nce_negatives = ids, neg
        return self

    def __exit__(self, *exc):
        from paddle_tpu_torch import layer

        layer._draw_ids, layer._nce_negatives = self._saved


def max_err(got: np.ndarray, want: np.ndarray) -> float:
    """max |got - want| / (1 + |want|), equal entries (infinities
    included) 0 and a NaN on one side only an infinite error."""
    same = (got == want) | (np.isnan(got) & np.isnan(want))
    with np.errstate(invalid="ignore"):
        err = np.abs(got.astype(np.float64) - want) / (1 + np.abs(want))
    err = np.where(same, 0.0, np.nan_to_num(err, nan=np.inf))
    return float(err.max()) if err.size else 0.0


def run_port(build, slots, batch, device, seed: int = 0):
    """The port's output and the gradients of ``sum(out * w)`` (w seeded,
    zero on padding) with respect to every parameter and float input, on
    ``device``, from weights drawn on the CPU from ``seed``.  Returns
    (output as numpy, valid rows only; {name: gradient as numpy})."""
    import torch

    import paddle_tpu_torch as pkg
    from paddle_tpu_torch.data_feeder import DataFeeder
    from paddle_tpu_torch.parameters import Parameters
    from paddle_tpu_torch.sequence import SequenceBatch

    pkg.topology.reset_name_scope()
    topo = pkg.topology.Topology([build(pkg.layer, pkg.data_type)])
    params = Parameters.from_topology(topo, seed=seed, device="cpu")
    tp = {k: params[k].detach().clone().to(device).requires_grad_(True)
          for k in topo.param_specs()}
    feeds = DataFeeder([(n, getattr(pkg.data_type, f)(d))
                        for n, f, d in slots], device=device)(batch)
    diff = {}
    for k, v in list(feeds.items()):
        d = v.data if isinstance(v, SequenceBatch) else v
        if d.dtype == torch.float32:
            diff[k] = d.clone().requires_grad_(True)
            feeds[k] = v.with_data(diff[k]) if isinstance(
                v, SequenceBatch) else diff[k]
    out = topo.forward(tp, feeds)[0]
    data = out.data if isinstance(out, SequenceBatch) else out
    mask = out.valid_mask if isinstance(out, SequenceBatch) else None
    grads = {}
    if data.dtype == torch.float32:
        w = torch.from_numpy(_rs(7).randn(*data.shape).astype(np.float32))
        w = w.to(device)
        if mask is not None:
            w = torch.where(mask.reshape((-1,) + (1,) * (w.dim() - 1)), w,
                            torch.zeros_like(w))
        loss = (data * w).sum()
        wrt = {**tp, **{f"feed:{k}": t for k, t in diff.items()}}
        if loss.requires_grad:
            got = torch.autograd.grad(loss, list(wrt.values()),
                                      allow_unused=True)
            grads = {k: (g if g is not None else torch.zeros_like(t))
                     .detach().cpu().numpy()
                     for (k, t), g in zip(wrt.items(), got)}
    if mask is not None:
        data = data[mask]
    return data.detach().cpu().numpy(), grads

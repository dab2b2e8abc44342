"""The SSD detection suite, the port (``ops/detection.py``, the
``priorbox``, ``multibox_loss`` and ``detection_output`` layers,
``evaluator.detection_map``) against the JAX package on the CPU.

A small prior set (feature maps 4 x 4 and 2 x 2 of a 64-pixel image: 120
priors), batches of 3 examples of up to 5 gt boxes.  The gts include
padded rows (class -1), a box that overlaps no prior (IoU 0 with each:
it claims none) and two gts with the same best prior.  Confidences are
quantized to a few levels, so many priors carry equal scores: the
hard-negative ranks, every NMS pick and the final cut to ``keep_top_k``
meet ties, which the port breaks as JAX does (first index of equal
maxima, stable sorts).  f32; values within 1e-5 (absolute and relative),
kept indices and labels exact; the JAX functions run one example at a
time under ``vmap`` as the JAX layers do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import data_type as jdt
from paddle_tpu import evaluator as jevaluator
from paddle_tpu import layer as jlayer
from paddle_tpu import topology as jtopo
from paddle_tpu.ops import detection as jdet
from paddle_tpu.platform.flags import FLAGS as JFLAGS

from paddle_tpu_torch import data_type as tdt
from paddle_tpu_torch import evaluator as tevaluator
from paddle_tpu_torch import layer as tlayer
from paddle_tpu_torch import topology as ttopo
from paddle_tpu_torch.data_feeder import DataFeeder
from paddle_tpu_torch.ops import detection as tdet
from paddle_tpu_torch.platform.flags import FLAGS as TFLAGS

TOL = 1e-5
B, G, C = 3, 5, 4
MAPS = [dict(fh=4, fw=4, min_sizes=[12.0], max_sizes=[30.0],
             aspect_ratios=[2.0]),
        dict(fh=2, fw=2, min_sizes=[30.0], max_sizes=[50.0],
             aspect_ratios=[2.0, 3.0])]
IMG = 64


@pytest.fixture(autouse=True)
def f32_policy():
    old = (JFLAGS.use_bf16, TFLAGS.use_bf16)
    JFLAGS.use_bf16 = TFLAGS.use_bf16 = False
    yield
    JFLAGS.use_bf16, TFLAGS.use_bf16 = old


def _priors():
    parts = [tdet.prior_boxes(m["fh"], m["fw"], IMG, IMG, m["min_sizes"],
                              m["max_sizes"], m["aspect_ratios"])
             for m in MAPS]
    return (np.concatenate([b for b, _ in parts]),
            np.concatenate([v for _, v in parts]))


def _gts(seed=0):
    """[B, G, 5] (class, box) rows: random boxes of classes 1..C-1; in
    example 0 a padded row, a box that overlaps no prior (zero area) and
    a duplicate of a box; in example 2 all but one row padded."""
    rs = np.random.RandomState(seed)
    lo = rs.rand(B, G, 2) * 0.6
    boxes = np.concatenate([lo, lo + 0.15 + 0.25 * rs.rand(B, G, 2)], -1)
    cls = rs.randint(1, C, (B, G)).astype(np.float32)
    cls[0, 1] = -1.0
    boxes[0, 2] = [0.3, 0.3, 0.3, 0.3]            # zero area: IoU 0
    boxes[0, 3] = boxes[0, 0]                     # two gts, one best prior
    cls[2, 1:] = -1.0
    return np.concatenate([cls[..., None], boxes], -1).astype(np.float32)


def _preds(P, seed=1):
    rs = np.random.RandomState(seed)
    loc = (0.5 * rs.randn(B, P, 4)).astype(np.float32)
    conf = (rs.randint(0, 3, (B, P, C)) * 0.75).astype(np.float32)
    return loc, conf


def test_prior_boxes_and_counts_match_jax():
    for m in MAPS + [dict(fh=3, fw=5, min_sizes=[10.0, 20.0],
                          max_sizes=[15.0], aspect_ratios=[2.0, 0.5, 3.0])]:
        args = (m["fh"], m["fw"], IMG, IMG + 16, m["min_sizes"],
                m["max_sizes"], m["aspect_ratios"])
        tb, tv = tdet.prior_boxes(*args)
        jb, jv = jdet.prior_boxes(*args)
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_array_equal(tv, jv)
        assert tdet.num_priors_per_cell(*args[4:]) == \
            jdet.num_priors_per_cell(*args[4:])


def test_iou_and_box_coding_match_jax():
    priors, var = _priors()
    gt = _gts()[0, :, 1:]
    loc, _ = _preds(len(priors))
    np.testing.assert_allclose(
        tdet.iou_matrix(torch.from_numpy(priors), torch.from_numpy(gt)),
        jdet.iou_matrix(priors, gt), rtol=TOL, atol=TOL)
    matched = gt[np.arange(len(priors)) % G]
    np.testing.assert_allclose(
        tdet.encode_boxes(torch.from_numpy(matched), torch.from_numpy(priors),
                          torch.from_numpy(var)),
        jdet.encode_boxes(matched, priors, var), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        tdet.decode_boxes(torch.from_numpy(loc[0]), torch.from_numpy(priors),
                          torch.from_numpy(var)),
        jdet.decode_boxes(loc[0], priors, var), rtol=TOL, atol=TOL)


def test_match_priors_matches_jax():
    priors, _ = _priors()
    gts = _gts()
    valid = gts[..., 0] >= 0
    match, best = tdet.match_priors(torch.from_numpy(priors),
                                    torch.from_numpy(gts[..., 1:]),
                                    torch.from_numpy(valid), 0.5)
    jm, jb = jax.vmap(lambda g, v: jdet.match_priors(priors, g, v, 0.5))(
        gts[..., 1:], valid)
    np.testing.assert_array_equal(match.numpy(), np.asarray(jm))
    np.testing.assert_allclose(best.numpy(), np.asarray(jb), rtol=TOL,
                               atol=TOL)
    m0 = match.numpy()[0]
    assert 2 not in m0 and 1 not in m0      # zero-area and padded gts
    assert 3 in m0                          # the later of two gts holds


def _jax_multibox(loc, conf, priors, var, gts):
    def one(l, c, g):
        return jdet.multibox_loss(l, c, priors, var, g[:, 1:5],
                                  jnp.maximum(g[:, 0], 0).astype(jnp.int32),
                                  g[:, 0] >= 0, C, 0.5, 3.0, 0)
    return jnp.sum(jax.vmap(one)(loc, conf, gts) *
                   jnp.arange(1.0, B + 1)), jax.vmap(one)(loc, conf, gts)


def test_multibox_loss_and_gradients_match_jax():
    priors, var = _priors()
    gts = _gts()
    loc, conf = _preds(len(priors))
    (_, want), (gl, gc) = jax.value_and_grad(
        lambda l, c: _jax_multibox(l, c, priors, var, gts), argnums=(0, 1),
        has_aux=True)(loc, conf)
    tl = torch.tensor(loc, requires_grad=True)
    tc = torch.tensor(conf, requires_grad=True)
    g = torch.from_numpy(gts)
    got = tdet.multibox_loss(tl, tc, torch.from_numpy(priors),
                             torch.from_numpy(var), g[..., 1:5],
                             torch.clamp(g[..., 0], min=0).to(torch.int32),
                             g[..., 0] >= 0, C, 0.5, 3.0, 0)
    (got * torch.arange(1.0, B + 1)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(gl), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(gc), rtol=TOL,
                               atol=TOL)


def test_nms_matches_jax_with_tied_scores():
    priors, var = _priors()
    loc, conf = _preds(len(priors))
    boxes = np.asarray(jax.vmap(lambda l: jdet.decode_boxes(
        l, priors, var))(loc))
    probs = np.asarray(jax.nn.softmax(conf, -1))
    scores = np.where(probs >= 0.2, probs, -np.inf).transpose(0, 2, 1)
    assert len(np.unique(scores[0, 1])) < scores.shape[2] // 4   # ties
    idx, ok = tdet.nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                       0.45, 20)
    for b in range(B):
        for c in range(C):
            ji, jo = jdet.nms(boxes[b], scores[b, c], 0.45, 20)
            np.testing.assert_array_equal(idx[b, c].numpy(), np.asarray(ji))
            np.testing.assert_array_equal(ok[b, c].numpy(), np.asarray(jo))


@pytest.mark.parametrize("keep_top_k,threshold", [(30, 0.01), (200, 0.3)])
def test_detection_output_matches_jax_with_tied_scores(keep_top_k,
                                                       threshold):
    """keep_top_k 30 cuts between equal scores; 200 keeps every class's
    survivors and leaves empty rows."""
    priors, var = _priors()
    loc, conf = _preds(len(priors))
    want = jax.vmap(lambda l, c: jdet.detection_output(
        l, c, priors, var, C, 0.45, threshold, keep_top_k, 0))(loc, conf)
    got = tdet.detection_output(torch.from_numpy(loc),
                                torch.from_numpy(conf),
                                torch.from_numpy(priors),
                                torch.from_numpy(var), C, 0.45, threshold,
                                keep_top_k, 0)
    want = np.asarray(want)
    np.testing.assert_array_equal(got.numpy()[..., 0], want[..., 0])
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    if keep_top_k == 200:
        assert (want[..., 0] == -1).any()


def _build(L, dt, ev):
    """An SSD head on the first feature map: loc and conf convolutions
    over a data map, its priors, the loss, the detections and their
    mAP."""
    m = MAPS[0]
    fmap = L.data(name="f0", type=dt.dense_vector(m["fh"] * m["fw"] * 3),
                  height=m["fh"], width=m["fw"])
    n = jdet.num_priors_per_cell(m["min_sizes"], m["max_sizes"],
                                 m["aspect_ratios"])
    loc = L.img_conv(fmap, filter_size=3, num_filters=n * 4, padding=1,
                     name="loc0")
    conf = L.img_conv(fmap, filter_size=3, num_filters=n * C, padding=1,
                      name="conf0")
    prior = L.priorbox(fmap, image_size=IMG, min_size=m["min_sizes"],
                       max_size=m["max_sizes"],
                       aspect_ratio=m["aspect_ratios"], name="prior0")
    label = L.data(name="gt", type=dt.dense_vector(G * 5))
    loss = L.multibox_loss([loc], [conf], prior, label, num_classes=C,
                           max_boxes=G, name="mbox")
    det = L.detection_output([loc], [conf], prior, num_classes=C,
                             keep_top_k=10, confidence_threshold=0.2,
                             name="det")
    mapn = ev.detection_map(det, label, num_classes=C, keep_top_k=10,
                            max_boxes=G, overlap_threshold=0.3, name="map")
    return prior, loss, det, mapn


def test_ssd_layers_and_detection_map_match_jax():
    rs = np.random.RandomState(5)
    gts = _gts(3)
    m = MAPS[0]
    samples = [(rs.randn(m["fh"] * m["fw"] * 3).astype(np.float32),
                gts[b].reshape(-1)) for b in range(B)]
    slots = [("f0", m["fh"] * m["fw"] * 3)]
    jtopo.reset_name_scope()
    jnodes = _build(jlayer, jdt, jevaluator)
    ttopo.reset_name_scope()
    tnodes = _build(tlayer, tdt, tevaluator)
    jt, tt = jtopo.Topology(list(jnodes)), ttopo.Topology(list(tnodes))
    arrays = {k: np.asarray(v) * 4 for k, v in
              jpaddle.Parameters.from_topology(jt, seed=2).as_dict().items()}
    jtypes = [(n, jdt.dense_vector(d)) for n, d in slots] + \
        [("gt", jdt.dense_vector(G * 5))]
    ttypes = [(n, tdt.dense_vector(d)) for n, d in slots] + \
        [("gt", tdt.dense_vector(G * 5))]
    jfeeds = jpaddle.DataFeeder(jtypes)(samples)
    tfeeds = DataFeeder(ttypes, device="cpu")(samples)

    def jloss(p):
        outs = jt.forward(p, {}, jfeeds)[0]
        return jnp.sum(outs[1]), outs

    (_, jouts), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        {k: jnp.asarray(v) for k, v in arrays.items()})
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in arrays.items()}
    touts = tt.forward(tp, tfeeds)
    touts[1].sum().backward()
    for want, got in zip(jouts, touts):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=TOL, atol=TOL)
    dets = np.asarray(jouts[2]).reshape(B, 10, 6)
    assert (dets[..., 0] >= 0).any() and np.isfinite(float(touts[3][0]))
    for k, g in jgrads.items():
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(g),
                                   rtol=TOL, atol=TOL, err_msg=k)

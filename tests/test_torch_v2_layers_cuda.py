"""The tenth slice on the card: ``detection_output`` at SSD300's 8732
priors, the wavefront ``mdlstmemory``, ``ctc`` and a VGG-16 step, each
card against the CPU path; and, on the CPU, the shared workloads' shapes.

The card tests need a CUDA device and skip without one.  The file imports
neither ``jax`` nor ``paddle_tpu``; on a machine without JAX run it
without the repository's ``conftest.py``::

    python -m pytest tests/test_torch_v2_layers_cuda.py -q --noconftest

Tolerances, f32 with TF32 off: outputs and gradients within 1e-4 of the
CPU path's relative to 1 + |value| (``chip_smoke.py``'s
``LAYERS_V2_TOL``); detections, rows listed by label and box, within
1e-5; the wavefront against a row-by-row scan of the same cells (the JAX
package's order) within 1e-5; the VGG-16 step at 32 px, batch 2, dropout
masks made equal and cuDNN held to its deterministic algorithms, its cost
within 1e-5 and each parameter's update within 1e-4 in norm (the worst
read 1.5e-5 on an H100; at 224 px the early convolutions' gradients move
by ~3e-3 between any two runs that round apart, two float64 runs
included, so ``chip_smoke.py``'s ``VGG_UPDATE_RTOL`` there is 1e-2:
``tools/vgg_grad_spread.py``).
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import numpy as np
import pytest
import torch

from paddle_tpu_torch.tools import detection_workload as dw
from paddle_tpu_torch.tools import layer_cases as lc
from paddle_tpu_torch.tools import vgg_workload as vw

TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_ssd300_priors_and_vgg16_counts():
    boxes, var = dw.priors()
    assert boxes.shape == var.shape == (8732, 4)
    assert vw.parameter_count() == 134_678_438
    assert abs(vw.step_flops() / 1e12 - 5.939) < 1e-3


@pytest.mark.cuda
def test_detection_output_at_ssd300_card_matches_cpu(cuda):
    boxes, var = dw.priors()
    loc, conf, _ = dw.inputs(batch=4)
    pb, pv = torch.from_numpy(boxes), torch.from_numpy(var)
    want = dw.detections(torch.from_numpy(loc), torch.from_numpy(conf), pb,
                         pv).numpy()
    got = dw.detections(torch.from_numpy(loc).to(cuda),
                        torch.from_numpy(conf).to(cuda), pb.to(cuda),
                        pv.to(cuda)).cpu().numpy()
    for g, w in zip(got, want):
        g, w = dw.sorted_rows(g), dw.sorted_rows(w)
        assert g.shape == w.shape and len(w) > 0
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def _mdlstm_rowscan(x, p, size, height, width):
    """The 2-D LSTM cell by cell, rows then columns (the JAX package's
    scan order)."""
    b = x.shape[0]
    grid = x.reshape(b, height, width, -1)
    zero = x.new_zeros((b, size))
    h = [[None] * width for _ in range(height)]
    c = [[None] * width for _ in range(height)]
    for i in range(height):
        for j in range(width):
            h_up, c_up = (h[i - 1][j], c[i - 1][j]) if i else (zero, zero)
            h_l, c_l = (h[i][j - 1], c[i][j - 1]) if j else (zero, zero)
            z = grid[:, i, j] @ p["wx"] + p["b"] + h_up @ p["wr"] + \
                h_l @ p["wc"]
            ig, fr, fc, og, g = torch.chunk(z, 5, dim=-1)
            c[i][j] = torch.sigmoid(fr) * c_up + torch.sigmoid(fc) * c_l + \
                torch.sigmoid(ig) * torch.tanh(g)
            h[i][j] = torch.sigmoid(og) * torch.tanh(c[i][j])
    return torch.stack([h[i][j] for i in range(height)
                        for j in range(width)], 1).reshape(b, -1)


@pytest.mark.cuda
def test_wavefront_mdlstm_card_matches_cpu_and_the_row_scan(cuda):
    from paddle_tpu_torch import data_type, layer, topology
    from paddle_tpu_torch.parameters import Parameters

    height, width, cin, size, b = 9, 13, 4, 16, 3
    topology.reset_name_scope()
    x = layer.data(name="x", type=data_type.dense_vector(height * width
                                                         * cin))
    topo = topology.Topology([layer.mdlstmemory(x, size=size, height=height,
                                                width=width, name="md")])
    params = Parameters.from_topology(topo, seed=1, device="cpu")
    p = {k.split(".")[1]: params[k].detach() for k in topo.param_specs()}
    feed = torch.from_numpy(np.random.RandomState(2).randn(
        b, height * width * cin).astype(np.float32))
    plain = _mdlstm_rowscan(feed, p, size, height, width).numpy()
    cpu = topo.forward({k: params[k] for k in topo.param_specs()},
                       {"x": feed})[0].detach().numpy()
    card = topo.forward({k: params[k].to(cuda) for k in topo.param_specs()},
                        {"x": feed.to(cuda)})[0].detach().cpu().numpy()
    np.testing.assert_allclose(cpu, plain, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(card, plain, rtol=1e-5, atol=1e-5)
    want, wg = lc.run_port(*lc.CASES["mdlstmemory"], "cpu")
    got, gg = lc.run_port(*lc.CASES["mdlstmemory"], cuda)
    assert lc.max_err(got, want) <= TOL
    assert max(lc.max_err(gg[k], wg[k]) for k in wg) <= TOL


@pytest.mark.cuda
def test_draws_on_the_card_are_in_range_and_seeded(cuda):
    """``sampling_id`` and ``nce`` draw from the step's CUDA generator:
    ids in range, finite costs, the same seed the same draws."""
    from paddle_tpu_torch import data_type, layer, topology
    from paddle_tpu_torch.parameters import Parameters

    topology.reset_name_scope()
    x = layer.data(name="x", type=data_type.dense_vector(6))
    y = layer.data(name="y", type=data_type.integer_value(7))
    probs = layer.fc(x, size=5, act="softmax", name="p")
    ids = layer.sampling_id(probs, name="ids")
    cost = layer.nce(x, y, num_classes=7, num_neg_samples=4, name="nce",
                     neg_distribution=[0.4] + [0.1] * 6)
    topo = topology.Topology([ids, cost])
    params = Parameters.from_topology(topo, seed=0, device=cuda)
    p = {k: params[k] for k in topo.param_specs()}
    rng = np.random.RandomState(1)
    feeds = {"x": torch.from_numpy(rng.randn(64, 6).astype(np.float32))
             .to(cuda),
             "y": torch.from_numpy(rng.randint(0, 7, 64).astype(np.int32))
             .to(cuda)}
    runs = [topo.forward(p, feeds, train=True, seed=s) for s in (3, 3, 4)]
    got, c = runs[0]
    assert got.dtype == torch.int32 and int(got.min()) >= 0 and \
        int(got.max()) < 5
    assert torch.isfinite(c).all() and c.shape == (64,)
    assert torch.equal(runs[1][0], got) and torch.equal(runs[1][1], c)
    assert not torch.equal(runs[2][0], got)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ctc", "warp_ctc"])
def test_ctc_card_matches_cpu(cuda, case):
    want, wg = lc.run_port(*lc.CASES[case], "cpu")
    got, gg = lc.run_port(*lc.CASES[case], cuda)
    assert lc.max_err(got, want) <= TOL
    assert max(lc.max_err(gg[k], wg[k]) for k in wg) <= TOL


@pytest.mark.cuda
def test_vgg16_step_card_matches_cpu(cuda):
    from paddle_tpu_torch.ops import math as pmath
    from paddle_tpu_torch.platform.flags import FLAGS

    masks = vw.SharedMasks()
    cudnn = torch.backends.cudnn
    old = FLAGS.use_bf16, pmath.dropout, cudnn.benchmark, cudnn.deterministic
    FLAGS.use_bf16, pmath.dropout = False, masks
    cudnn.benchmark, cudnn.deterministic = False, True
    try:
        batch = [vw.mapper(3, crop=32)(s) for s in
                 vw.raw_images(2, 4, edge=40)]
        runs, p0 = {}, None
        for dev in (torch.device("cpu"), cuda):
            sgd = vw.trainer(dev, img=32)
            with torch.no_grad():
                if p0 is None:
                    p0 = {k: sgd.parameters[k].detach().clone()
                          for k in sgd._names}
                for k in sgd._names:
                    sgd.parameters[k].copy_(p0[k])
            masks.reset()
            cost = float(sgd.step(vw.device_feeds(batch, dev)))
            runs[dev.type] = cost, {k: sgd.parameters[k].detach().cpu()
                                    for k in sgd._names}
    finally:
        (FLAGS.use_bf16, pmath.dropout, cudnn.benchmark,
         cudnn.deterministic) = old
    (c_cpu, p_cpu), (c_card, p_card) = runs["cpu"], runs["cuda"]
    assert abs(c_card - c_cpu) <= 1e-5 * abs(c_cpu)
    for k in p0:
        du, dc = p_card[k] - p0[k], p_cpu[k] - p0[k]
        assert float((du - dc).norm()) <= 1e-4 * float(dc.norm()) + 1e-12, k

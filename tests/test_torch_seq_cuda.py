"""The seventh slice on the card: the fused LSTM step (B5) at the CRF
taggers' and quick_start's shapes against its plain version; an SRL step
and a quick_start ``lstm`` step on the card against the CPU path; the CRF
decode on the card against the CPU decode; the flash kernels (B1-B3) and
the ragged kernel (B4) at head dims 640 and 1024 (the wide kernels, C4)
against their plain versions.  Widths are cut where ``chip_smoke.py``
runs the full ones.

The card tests need a CUDA device and skip without one.  The file imports
neither ``jax`` nor ``paddle_tpu``; on a machine without JAX run it
without the repository's ``conftest.py``::

    python -m pytest tests/test_torch_seq_cuda.py -q --noconftest

Tolerances: the kernels' as in ``tools/rnn_workload.rnn_error``,
``tools/train_workload.flash_error`` and ``tools/ragged_cases.check``;
card against CPU in f32 with TF32 off over 3 steps: costs within 1e-4
relative, every parameter within 1e-4 relative in norm; decoded paths
equal.
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import numpy as np
import pytest
import torch

from paddle_tpu_torch.tools import nmt_workload as nw
from paddle_tpu_torch.tools import quick_start_workload as qw
from paddle_tpu_torch.tools import ragged_cases as rc
from paddle_tpu_torch.tools import rnn_workload as rw
from paddle_tpu_torch.tools import srl_workload as sw
from paddle_tpu_torch.tools import train_workload as tw

SMALL_QS = dict(dict_size=2000, emb_size=128)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["lstm_f32_h128_b10_acts",
                                  "lstm_f32_h128_b128_acts"])
def test_lstm_step_at_the_h128_shapes(cuda, name):
    from paddle_tpu_torch.ops import rnn as R

    case = rw.rnn_case(name, cuda)
    args = (case["xp"], case["h"], case["c"], case["w_h"], case["bias"])
    got = R.lstm_step_kernel(*args, save_acts=True)
    want = R.lstm_step_reference(*args, save_acts=True)
    for g, w in zip(got, want):
        assert rw.rnn_error(g, w)["within_tolerance"]


def _steps(sgd, batch, steps=3):
    from paddle_tpu_torch.data_feeder import DataFeeder

    feeds = DataFeeder([(n.name, n.input_type)
                        for n in sgd.topology.data_nodes],
                       device=sgd.device).feed(batch)
    return [float(sgd.step(feeds)) for _ in range(steps)]


def _rel(a, b) -> float:
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _card_and_cpu(build, batch, cuda):
    out = []
    with nw.f32_policy():
        for dev in (cuda, torch.device("cpu")):
            sgd, node = build(dev)
            out.append((sgd, node, _steps(sgd, batch)))
    (cs, _, cc), (ps, _, pc) = out
    np.testing.assert_allclose(cc, pc, rtol=1e-4)
    for k, v in ps.parameters.as_dict().items():
        assert _rel(cs.parameters[k], v) <= 1e-4, k
    return out


@pytest.mark.cuda
def test_srl_steps_and_decode_match_the_cpu_path(cuda):
    batch = sw.srl_batch(sw.PARITY)
    out = _card_and_cpu(lambda d: sw.build_srl(d, sw.PARITY), batch, cuda)
    paths = []
    for sgd, dec, _ in out:
        names = [n.name for n in sgd.topology.data_nodes]
        paths.append(sw.decode(dec, sgd.parameters, batch, names,
                               sgd.device))
    np.testing.assert_array_equal(paths[0], paths[1])


@pytest.mark.cuda
def test_quick_start_lstm_step_matches_the_cpu_path(cuda, monkeypatch):
    # the masks the two devices draw differ: dropout off for the parity
    from paddle_tpu_torch.ops import math as pmath

    monkeypatch.setattr(pmath, "dropout", lambda x, rate, gen, train: x)
    batch = qw.batch("lstm", dims=SMALL_QS, bs=32)
    before = rw.launches()["lstm_step"]
    _card_and_cpu(lambda d: qw.build_trainer("lstm", d, dims=SMALL_QS),
                  batch, cuda)
    assert rw.launches()["lstm_step"] - before == 3 * sw.frames(batch)


@pytest.mark.cuda
def test_chunker_decode_matches_the_cpu_decode(cuda):
    batch = sw.chunk_batch(16)
    paths = []
    for dev in (cuda, torch.device("cpu")):
        sgd, dec = sw.build_chunker(dev)
        names = [n.name for n in sgd.topology.data_nodes]
        paths.append(sw.decode(dec, sgd.parameters, batch, names, dev))
    np.testing.assert_array_equal(paths[0], paths[1])


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(tw.C4_WIDE_FLASH_CASES))
def test_flash_kernels_above_512(cuda, name):
    from paddle_tpu_torch.ops import attention as A

    case = tw.flash_case(name, cuda)
    cfg = dict(causal=case.causal, sm_scale=case.sm_scale)
    fwd = (case.q, case.k, case.v, case.q_seg, case.kv_seg)
    o_ref, lse_ref = A.flash_fwd_reference(*fwd, **cfg)
    o, lse = A.flash_fwd_kernel(*fwd, **cfg)
    bwd = fwd + (case.dout, lse_ref, A.attention_delta(o_ref, case.dout))
    dk_ref, dv_ref = A.flash_bwd_kv_reference(*bwd, **cfg)
    dk, dv = A.flash_bwd_kv_kernel(*bwd, **cfg)
    dq = A.flash_bwd_dq_kernel(*bwd, **cfg)
    dq_ref = A.flash_bwd_dq_reference(*bwd, **cfg)
    for got, want in ((o, o_ref), (lse, lse_ref), (dk, dk_ref),
                      (dv, dv_ref), (dq, dq_ref)):
        assert got.shape == want.shape
        assert tw.flash_error(got, want)["within_tolerance"]


@pytest.mark.cuda
def test_ragged_kernel_above_512(cuda):
    from paddle_tpu_torch.serving.decode_attention import \
        ragged_paged_attention_kernel

    for name, case in rc.kernel_cases(cuda, rc.C4_WIDE_CASES):
        got = ragged_paged_attention_kernel(*rc.args(case),
                                            **rc.scales(case))
        assert got.shape == case["q"].shape
        assert rc.check(case, got)["within_tolerance"], name


def test_wide_cases_cover_640_and_1024():
    """Host-side: the wide cases the card tests and ``chip_smoke.py`` run
    (no card needed)."""
    assert {c[4] for c in tw.C4_WIDE_FLASH_CASES.values()} == {640, 1024}
    assert {c[3] for c in rc.C4_WIDE_CASES.values()} == {640, 1024}
    assert 640 in tw.HEAD_DIM_MODELS
    for name in ("lstm_f32_h128_b10_acts", "lstm_f32_h128_b128_acts"):
        kind, b, h, _, acts = rw.RNN_CASES[name]
        assert kind == "lstm_step" and h == 128 and acts

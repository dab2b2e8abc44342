"""The sixth slice and its repairs on the card: the flash kernels (B1-B3)
and the ragged kernel (B4) at head dims 12, 100 and 320 against their
plain versions (C4); equal bits from two NMT steps, two DeepFM steps and
two generations from one state (C5); DeepFM's card steps against its CPU
path; the GAN's task masking on the card; the sparse row updates on the
card.  Widths are cut where ``chip_smoke.py`` runs the full ones.

The card tests need a CUDA device and skip without one; the others hold
the workloads these tests and ``chip_smoke.py`` share on the CPU.  The
file imports neither ``jax`` nor ``paddle_tpu``; on a machine without JAX
run it without the repository's ``conftest.py``::

    python -m pytest tests/test_torch_ctr_cuda.py -q --noconftest

Tolerances: the kernels' as in ``tools/train_workload.flash_error`` and
``tools/ragged_cases.check``; DeepFM f32 with TF32 off, card against CPU
over 3 Adam steps: costs within 1e-5 relative, every parameter within
1e-4 relative in norm; the row updates within 1e-5 of the dense step
(the dense gradient sums duplicate ids with atomics), untouched rows
bit-identical.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.parallel import sparse as sp
from paddle_tpu_torch.tools import ctr_workload as cw
from paddle_tpu_torch.tools import gan_vae_workload as gw
from paddle_tpu_torch.tools import nmt_workload as nw
from paddle_tpu_torch.tools import ragged_cases as rc
from paddle_tpu_torch.tools import repro
from paddle_tpu_torch.tools import train_workload as tw

SMALL_NMT = dict(src_dict_size=2000, trg_dict_size=2000, embed_size=128,
                 hidden=128)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(tw.C4_FLASH_CASES))
def test_flash_kernels_at_repaired_head_dims(cuda, name):
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
def test_ragged_kernel_at_repaired_head_dims(cuda):
    from paddle_tpu_torch.serving.decode_attention import \
        ragged_paged_attention_kernel

    for name, case in rc.kernel_cases(cuda, rc.C4_CASES):
        got = ragged_paged_attention_kernel(*rc.args(case),
                                            **rc.scales(case))
        assert got.shape == case["q"].shape
        assert rc.check(case, got)["within_tolerance"], name


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", sorted(tw.HEAD_DIM_MODELS))
def test_training_at_repaired_head_dims_matches_the_cpu_path(cuda,
                                                             head_dim):
    samples = tw.lm_samples(7, bs=tw.HEAD_DIM_BATCH, seq=tw.HEAD_DIM_SEQ,
                            vocab=tw.HEAD_DIM_VOCAB)
    costs = []
    with nw.f32_policy():
        for dev in (cuda, torch.device("cpu")):
            costs.append(_three_steps(tw.head_dim_trainer(dev, head_dim),
                                      samples))
    np.testing.assert_allclose(costs[0], costs[1], rtol=1e-4)


def _three_steps(sgd, samples):
    from paddle_tpu_torch.data_feeder import DataFeeder

    feeds = DataFeeder([(n.name, n.input_type)
                        for n in sgd.topology.data_nodes], tw.FEEDING,
                       device=sgd.device).feed(samples)
    return [float(sgd.step(feeds)) for _ in range(3)]


@pytest.mark.cuda
def test_two_nmt_steps_from_one_state_are_the_same_bits(cuda):
    sgd = nw.build_trainer(cuda, **SMALL_NMT)
    batch = nw.samples(5, bs=8, min_len=10, max_len=20, dict_size=2000)
    cost_equal, differ = repro.step_twice(sgd, nw.feeds(sgd, batch))
    assert cost_equal and differ == []


@pytest.mark.cuda
def test_two_deepfm_steps_from_one_state_are_the_same_bits(cuda):
    sgd = cw.build_trainer(cuda, vocab=1 << 20)
    data = cw.CtrData(cuda, 1, vocab=1 << 20)
    cost_equal, differ = repro.step_twice(sgd, data.feeds(0))
    assert cost_equal and differ == []


@pytest.mark.cuda
def test_two_generations_are_the_same_bits(cuda):
    sgd = nw.build_trainer(cuda, **SMALL_NMT)
    srcs = nw.sources(9, n=4, dict_size=2000)
    until = nw.eos_until("target_lengths", 9, n=4, dict_size=2000)
    ban = nw.EosBan(until)
    _, inf = nw.generator(sgd.parameters, sgd.model_state, cuda,
                          hooks={"candidate_adjust": ban}, **SMALL_NMT)
    runs = []
    for _ in range(2):
        ban.clear()
        runs.append(ban.run(nw.generate(inf, srcs)))
    assert nw.runs_equal(*runs)


@pytest.mark.cuda
def test_deepfm_card_steps_match_the_cpu_path(cuda):
    vocab, batch = 65536, 512
    data = cw.CtrData(torch.device("cpu"), 3, batch=batch, vocab=vocab)
    costs, params = [], []
    with nw.f32_policy():
        for dev in (cuda, torch.device("cpu")):
            sgd = cw.build_trainer(dev, vocab=vocab)
            costs.append([float(sgd.step({k: v.to(dev) for k, v in
                                          data.feeds(i).items()}))
                          for i in range(3)])
            params.append({k: v.detach().cpu()
                           for k, v in sgd.parameters.items()})
    np.testing.assert_allclose(costs[0], costs[1], rtol=1e-5)
    for k, v in params[0].items():
        assert nw.rel_norm(v, params[1][k]) <= 1e-4, k


@pytest.mark.cuda
@pytest.mark.parametrize("task,other", [("d", "gen_"), ("g", "dis_")])
def test_gan_step_leaves_the_other_side_bit_identical_on_the_card(
        cuda, task, other):
    t, params = gw.build_gan("mnist", cuda)
    data = gw.gan_data("mnist", 1, cuda)
    before = {k: v.detach().clone() for k, v in params.items()}
    assert np.isfinite(t.step(task, gw.gan_feeds(data, 0, task)))
    for k, v in before.items():
        same = torch.equal(params[k].detach(), v)
        assert same if k.startswith(other) else not same, k


@pytest.mark.cuda
def test_sparse_row_updates_on_the_card(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    vocab = 1 << 20
    table = torch.randn((vocab, cw.FACTOR), generator=gen, device=cuda)
    ids = cw.CtrData(cuda, 1, vocab=vocab).ids[0].reshape(-1).long()
    rows = torch.randn((ids.numel(), cw.FACTOR), generator=gen, device=cuda)
    dense = torch.zeros_like(table).index_put_((ids,), rows, accumulate=True)
    touched = torch.zeros(vocab, dtype=torch.bool, device=cuda)
    touched[ids] = True
    grad = sp.SelectedRows(ids, rows, vocab)
    got = sp.sgd_update_rows(table.clone(), grad, 0.05)
    want = table - 0.05 * dense
    assert float((got - want)[touched].abs().max()) <= 1e-5
    assert torch.equal(got[~touched], table[~touched])
    combined = grad.to_dense()
    got, acc = sp.adagrad_update_rows(table.clone(), torch.zeros_like(table),
                                      grad, 0.05)
    torch.testing.assert_close(acc, combined.square(), rtol=0, atol=0)
    assert torch.equal(got[~touched], table[~touched])
    upd = sp.SparseEmbeddingUpdater(sparse_params=("v",))
    got = upd.apply({"v": table.clone()}, {"v": dense}, 0.05,
                    ids={"v": ids})["v"]
    assert torch.equal(got[touched], want[touched])
    assert torch.equal(got[~touched], table[~touched])


# ---------------------------------------------------------------------------
# the shared workloads on the CPU
# ---------------------------------------------------------------------------

def test_ctr_workload_is_criteo_width_with_skewed_ids_in_field_ranges():
    assert cw.VOCAB == 33_763_409 and cw.FIELDS == 39
    assert sum(cw.CATEGORICAL_IDS) == 33_762_577
    data = cw.CtrData(torch.device("cpu"), 2, batch=2048, vocab=39 * 1000)
    ids = data.ids.numpy()
    sizes = np.asarray(cw.field_ids(39 * 1000))
    rel = ids - data.offsets[None, None, :]
    assert (rel >= 0).all() and (rel < sizes).all()
    # power law: half of each field's draws fall below sqrt of its size
    assert (rel < np.sqrt(sizes)).mean() == pytest.approx(0.5, abs=0.03)
    labels = data.labels.numpy()
    assert set(np.unique(labels)) == {0, 1}
    feeds = data.feeds(1)
    assert len(feeds) == 40 and feeds["label"].shape == (2048,)
    samples = data.samples(0)
    assert len(samples) == 2048 and samples[0][-1] == labels[0, 0]


def test_numpy_params_follow_the_default_rules():
    from paddle_tpu_torch import topology

    specs = topology.Topology([cw.build(vocab=390)[3]]).param_specs()
    p = cw.numpy_params(specs)
    assert set(p) == set(specs)
    assert (p["fc_0.w0"] == 0.5).all()            # the FM projection
    assert not p["addto_0.b"].any()
    limit = np.sqrt(6 / (390 + 10))
    assert np.abs(p["deepfm.v"]).max() <= limit
    again = cw.numpy_params(specs)
    assert all(np.array_equal(p[k], again[k]) for k in p)


def test_gan_vae_traffic_workloads_build_and_step_on_the_cpu():
    cpu = torch.device("cpu")
    t, params = gw.build_gan("uniform", cpu)
    data = gw.gan_data("uniform", 2, cpu)
    assert data["real"].shape == (2, gw.BATCH, 2)
    assert np.isfinite(t.step("d", gw.gan_feeds(data, 0, "d")))
    assert np.isfinite(t.step("g", gw.gan_feeds(data, 0, "g")))
    sgd = gw.build_traffic(cpu)
    feeds = gw.traffic_feeds(1, cpu)[0]
    assert len(feeds) == 25
    assert all(int(v.max()) <= 3 for k, v in feeds.items()
               if k.startswith("label_"))
    assert np.isfinite(float(sgd.step(feeds)))
    x = gw.vae_feeds(1, cpu)[0]["pixel"]
    assert x.shape == (gw.BATCH, 784) and set(x.unique().tolist()) <= {0, 1}

"""The eighth slice on the card: the flash kernels (B1-B3) at the
translation model's three shapes against their plain versions; the
translation model, the decoders, the fused LM head and remat on the card
against the CPU path.  Widths are cut where ``chip_smoke.py`` runs the
full ones.

The card tests need a CUDA device and skip without one.  The file imports
neither ``jax`` nor ``paddle_tpu``; on a machine without JAX run it
without the repository's ``conftest.py``::

    python -m pytest tests/test_torch_transformer_cuda.py -q --noconftest

Tolerances: the kernels' as in ``tools/train_workload.flash_error``; card
against CPU in f32 with TF32 off: training costs within 1e-4 relative
and every parameter within 1e-4 relative in norm after 3 Adam steps;
decoded tokens equal (a greedy token may differ only at a near tie,
``train_workload.NEAR_TIE_RTOL``), beam scores within 1e-5 relative;
``lm_head_xent``'s loss and gradients within 1e-5 relative (1e-6
absolute) in f32, the gradients within ``flash_error``'s bf16 bound under
the bf16 policy.
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import numpy as np
import pytest
import torch

from paddle_tpu_torch.tools import nmt_workload as nw
from paddle_tpu_torch.tools import train_workload as tw
from paddle_tpu_torch.tools import transformer_nmt_workload as tnw

LM = dict(vocab_size=512, d_model=128, n_layers=2, n_heads=4, max_len=64)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel_norm(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float(torch.linalg.norm((a - b).flatten()) /
                 max(float(torch.linalg.norm(b.flatten())), 1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("name", tw.NMT_FLASH_CASES)
def test_translation_flash_cases_match_plain(cuda, name):
    from paddle_tpu_torch.ops import attention as A

    case = tw.flash_case(name, cuda)
    cfg = dict(causal=case.causal, sm_scale=case.sm_scale)
    fwd = (case.q, case.k, case.v, case.q_seg, case.kv_seg)
    o_ref, lse_ref = A.flash_fwd_reference(*fwd, **cfg)
    bwd = fwd + (case.dout, lse_ref, A.attention_delta(o_ref, case.dout))
    got = list(A.flash_fwd_kernel(*fwd, **cfg)) + \
        list(A.flash_bwd_kv_kernel(*bwd, **cfg)) + \
        [A.flash_bwd_dq_kernel(*bwd, **cfg)]
    want = [o_ref, lse_ref, *A.flash_bwd_kv_reference(*bwd, **cfg),
            A.flash_bwd_dq_reference(*bwd, **cfg)]
    torch.cuda.synchronize()
    assert A.kernel_route(tuple(case.q.shape), tuple(case.k.shape),
                          case.q.dtype, False) == "flash_attention_sm90"
    for label, g, w in zip(("o", "lse", "dk", "dv", "dq"), got, want):
        res = tw.flash_error(g, w)
        assert res["within_tolerance"], (label, res)


@pytest.mark.cuda
def test_translation_steps_on_the_card_match_the_cpu(cuda):
    cfg = dict(tnw.PARITY, n_layers=1)
    batch = tnw.samples(tnw.SEED + 3, bs=8, dict_size=cfg["trg_vocab"])
    runs = {}
    with nw.f32_policy():
        for where in (cuda, torch.device("cpu")):
            sgd = tnw.build_trainer(where, config=cfg)
            costs = [float(sgd.step(tnw.feeds(sgd, batch)))
                     for _ in range(3)]
            runs[where.type] = (costs, sgd.parameters)
    (ccosts, cparams), (pcosts, pparams) = runs["cuda"], runs["cpu"]
    np.testing.assert_allclose(ccosts, pcosts, rtol=1e-4)
    for k in pparams.keys():
        assert _rel_norm(cparams[k].detach().cpu(), pparams[k]) < 1e-4, k


def _lm_params(device):
    from paddle_tpu_torch import topology
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.parameters import Parameters

    topology.reset_name_scope()
    *_, cost = transformer.build(**LM)
    return Parameters.from_topology(topology.Topology([cost]), seed=1,
                                    device=device).as_dict()


@pytest.mark.cuda
def test_decoders_on_the_card_match_the_cpu(cuda):
    from paddle_tpu_torch.models import transformer as T

    kw = dict(n_layers=LM["n_layers"], n_heads=LM["n_heads"],
              max_len=LM["max_len"])
    card, cpu = _lm_params(cuda), _lm_params("cpu")
    prompts = np.random.RandomState(2).randint(0, LM["vocab_size"],
                                               (3, 12)).tolist()
    greedy = T.generate(card, prompts[0], 20, **kw)
    replay = tw.replay_greedy(cpu, prompts[0], greedy.tolist(), **kw)
    assert replay["ok"], replay
    beam_kw = dict(kw, beam_size=4, eos_id=0, length_penalty=1.0)
    for pr in prompts:
        rec = tw.BanAndStop(int(greedy[0]), stop_at=12, record=True)
        want = T.beam_generate(cpu, pr, 16, **beam_kw, **rec.hooks(),
                               device="cpu")
        got = T.beam_generate(card, pr, 16, **beam_kw,
                              **tw.BanAndStop(int(greedy[0]),
                                              stop_at=12).hooks())
        agree = tw.beams_agree(got, want, rec.gaps)
        assert agree["ok"], agree
    batch = T.beam_generate_batch(card, prompts, 16, **beam_kw)
    for i, pr in enumerate(prompts):
        rec = tw.BanAndStop(None, record=True)
        single = T.beam_generate(card, pr, 16, **beam_kw,
                                 candidate_adjust=rec.adjust)
        agree = tw.beams_agree((batch[0][i], batch[1][i]), single, rec.gaps)
        assert agree["ok"], agree


@pytest.mark.cuda
@pytest.mark.parametrize("use_bf16", [False, True])
def test_lm_head_xent_on_the_card_matches_the_cpu(cuda, use_bf16):
    from paddle_tpu_torch.ops import losses as L
    from paddle_tpu_torch.platform.flags import FLAGS

    rng = np.random.RandomState(4)
    arrays = [rng.standard_normal((256, 128)).astype(np.float32),
              (rng.standard_normal((128, 5000)) * 0.1).astype(np.float32),
              (rng.standard_normal(5000) * 0.1).astype(np.float32)]
    labels = rng.randint(0, 5000, 256)
    g = rng.standard_normal(256).astype(np.float32)
    out = {}
    old = FLAGS.use_bf16
    FLAGS.use_bf16 = use_bf16
    try:
        for where in (cuda, torch.device("cpu")):
            ts = [torch.tensor(a, device=where, requires_grad=True)
                  for a in arrays]
            loss = L.lm_head_xent(*ts, torch.tensor(labels, device=where),
                                  1024)
            (loss * torch.tensor(g, device=where)).sum().backward()
            out[where.type] = [loss.detach().cpu()] + \
                [t.grad.cpu() for t in ts]
    finally:
        FLAGS.use_bf16 = old
    for name, got, want in zip(("loss", "dx", "dw", "db"), out["cuda"],
                               out["cpu"]):
        if use_bf16 and name != "loss":
            res = tw.flash_error(got.bfloat16(), want)
            assert res["within_tolerance"], (name, res)
        else:
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.cuda
def test_fused_head_and_remat_on_the_card_match_the_cpu(cuda):
    """The levers at a small width, f32: 3 Momentum steps on the card
    against the CPU path, and remat (with dropout) against no remat on
    the card."""
    cfg = dict(LM, n_layers=2)
    samples = tw.lm_samples(5, bs=2, seq=64, vocab=cfg["vocab_size"])

    def costs(where, **levers):
        from paddle_tpu_torch import optimizer, topology, trainer
        from paddle_tpu_torch.models import transformer
        from paddle_tpu_torch.parameters import Parameters

        topology.reset_name_scope()
        *_, cost = transformer.build(**cfg, **levers)
        params = Parameters.from_topology(topology.Topology([cost]), seed=0,
                                          device=where)
        sgd = trainer.SGD(cost, params, optimizer.Momentum(
            momentum=0.9, learning_rate=1e-3), device=where)
        feeds = sgd._make_feeder(tw.FEEDING).feed(samples)
        return [float(sgd.step(feeds)) for _ in range(3)]

    with nw.f32_policy():
        card = costs(cuda, fused_head=True)
        cpu = costs(torch.device("cpu"), fused_head=True)
        remat = costs(cuda, remat=True, dropout=0.1)
        plain = costs(cuda, dropout=0.1)
    np.testing.assert_allclose(card, cpu, rtol=1e-4)
    np.testing.assert_allclose(remat, plain, rtol=1e-6)

"""The port's transformer decoders (``_step_token``, ``generate``,
``beam_generate``, ``beam_generate_batch``) and the functional block
(``block_apply``, ``stage_params``) against the JAX package, on the CPU.

One model, ``transformer.build(vocab 64, d 32, 2 layers, 2 heads,
max_len 32)`` with the JAX ``Parameters.from_topology(seed=3)`` weights
handed to both packages as numpy arrays, and one prompt length (5) and
decode length (6), so that JAX compiles each of its scans once.  Neither
package's decode step takes the bf16 policy: products in f32, attention
in f32.

Tolerances: the step's hidden state and the beam scores within 1e-5
relative (the same f32 products summed in another order); tokens equal.
The forced ties (every logit equal: a zero head) are broken the same way
in both, by the lower index.  A temperature draw cannot replay
``jax.random.categorical``'s stream: it is held to the vocabulary and to
its own replay from one seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import topology as jtopo
from paddle_tpu.models import transformer as jt
from paddle_tpu.parameters import Parameters as JParameters

from paddle_tpu_torch import topology as ttopo
from paddle_tpu_torch.data_feeder import DataFeeder
from paddle_tpu_torch.models import transformer as tt
from paddle_tpu_torch.platform.enforce import EnforceError

from torch_transformer_util import LM_FEEDING, policy

VOCAB, D, LAYERS, HEADS, MAX_LEN = 64, 32, 2, 2, 32
ARCH = dict(n_layers=LAYERS, n_heads=HEADS, max_len=MAX_LEN)
PROMPT = [3, 17, 42, 5, 9]
NEW = 6
PROMPTS = [PROMPT, [1, 2, 3, 4, 5], [60, 0, 33, 33, 8]]


@pytest.fixture(scope="module")
def params():
    jtopo.reset_name_scope()
    *_, cost = jt.build(vocab_size=VOCAB, d_model=D, n_layers=LAYERS,
                        n_heads=HEADS, max_len=MAX_LEN)
    p = JParameters.from_topology(jtopo.Topology([cost]), seed=3)
    return {k: np.asarray(v) for k, v in p.as_dict().items()}


def _tie(params):
    """The same weights with a zero head: every logit equal."""
    out = dict(params)
    out["lm_head.w0"] = np.zeros_like(params["lm_head.w0"])
    out["lm_head.b"] = np.zeros_like(params["lm_head.b"])
    return out


def test_step_token_matches_jax(params):
    rng = np.random.RandomState(0)
    t = 5
    x = rng.standard_normal(D).astype(np.float32)
    shape = (MAX_LEN, HEADS, D // HEADS)
    caches = [(rng.standard_normal(shape).astype(np.float32),
               rng.standard_normal(shape).astype(np.float32))
              for _ in range(LAYERS)]
    jh, jc = jax.jit(lambda p, x, c: jt._step_token(
        p, x, c, t, n_layers=LAYERS, n_heads=HEADS, max_len=MAX_LEN))(
            params, x, caches)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    tc = [(torch.tensor(k), torch.tensor(v)) for k, v in caches]
    th, tc = tt._step_token(tp, torch.tensor(x), tc, t, n_layers=LAYERS,
                            n_heads=HEADS, max_len=MAX_LEN)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-6)
    for (jk, jv), (tk, tv) in zip(jc, tc):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                                   atol=1e-6)


def test_greedy_generate_matches_jax_and_a_full_forward(params):
    got = tt.generate(params, PROMPT, NEW, **ARCH, device="cpu")
    want = jt.generate(params, PROMPT, NEW, **ARCH)
    assert got.dtype == np.int32 and got.tolist() == want.tolist()
    # the layer graph's argmax over the sequence so far, token by token
    ttopo.reset_name_scope()
    _, _, _, logits, _ = tt.build(vocab_size=VOCAB, d_model=D,
                                  n_layers=LAYERS, n_heads=HEADS,
                                  max_len=MAX_LEN)
    topo = ttopo.Topology([logits])
    tp = {k: torch.tensor(params[k]) for k in topo.param_specs()}
    feeder = DataFeeder([(n.name, n.input_type) for n in topo.data_nodes],
                        {"tokens": 0, "pos": 1}, device="cpu")
    seq = list(PROMPT)
    with policy(False), torch.no_grad():
        for _ in range(NEW):
            feeds = feeder.feed([(seq, list(range(len(seq))))])
            lg = topo.forward(tp, feeds)[0].data.numpy()[len(seq) - 1]
            seq.append(int(np.argmax(lg)))
    assert got.tolist() == seq[len(PROMPT):]


def test_generate_pads_with_eos_as_jax(params):
    first = int(tt.generate(params, PROMPT, NEW, **ARCH, device="cpu")[0])
    got = tt.generate(params, PROMPT, NEW, **ARCH, eos_id=first,
                      device="cpu")
    want = jt.generate(params, PROMPT, NEW, **ARCH, eos_id=first)
    assert got.tolist() == want.tolist() == [first] * NEW


@pytest.mark.parametrize("length_penalty", [0.0, 1.0])
def test_beam_generate_matches_jax(params, length_penalty):
    kw = dict(ARCH, beam_size=3, eos_id=0, length_penalty=length_penalty)
    got, gs = tt.beam_generate(params, PROMPT, NEW, **kw, device="cpu")
    want, ws = jt.beam_generate(params, PROMPT, NEW, **kw)
    assert got.tolist() == want.tolist()
    np.testing.assert_allclose(gs, ws, rtol=1e-5)


def test_beam_of_one_is_greedy(params):
    greedy = tt.generate(params, PROMPT, NEW, **ARCH, device="cpu")
    beam, score = tt.beam_generate(params, PROMPT, NEW, **ARCH, beam_size=1,
                                   device="cpu")
    assert beam.tolist() == greedy.tolist() and np.isfinite(score)


def _hook_runs(pkg, params, banned):
    """JAX's control-hook cases, the hooks written for ``pkg``'s arrays:
    none, identity hooks, a banned token, a stop after step 1."""
    kw = dict(ARCH, beam_size=3, eos_id=0)
    extra = {} if pkg is jt else {"device": "cpu"}
    if pkg is jt:
        ones = lambda beam: jnp.ones_like(beam.finished)   # noqa: E731
        ban = lambda lp, beam: lp.at[:, banned].set(-1e30)  # noqa: E731
    else:
        ones = lambda beam: torch.ones_like(beam.finished)  # noqa: E731

        def ban(lp, beam):
            lp = lp.clone()
            lp[:, banned] = -1e30
            return lp
    runs = {
        "base": {},
        "identity": dict(candidate_adjust=lambda lp, beam: lp,
                         path_filter=ones),
        "ban": dict(candidate_adjust=ban),
        "stop": dict(stop_condition=lambda beam: beam.t >= 1),
    }
    return {name: pkg.beam_generate(params, PROMPT, NEW, **kw, **hooks,
                                    **extra)
            for name, hooks in runs.items()}


def test_beam_hooks_match_jax(params):
    base, _ = tt.beam_generate(params, PROMPT, NEW, **ARCH, beam_size=3,
                               eos_id=0, device="cpu")
    banned = int(base[0])
    got = _hook_runs(tt, params, banned)
    want = _hook_runs(jt, params, banned)
    for name in got:
        assert got[name][0].tolist() == want[name][0].tolist(), name
        np.testing.assert_allclose(got[name][1], want[name][1], rtol=1e-5,
                                   err_msg=name)
    assert got["identity"][0].tolist() == got["base"][0].tolist()
    assert banned not in got["ban"][0].tolist()
    assert (got["stop"][0][2:] == 0).all()
    assert got["stop"][0][:2].tolist() == got["base"][0][:2].tolist()


def test_eos_minus_one_wraps_to_the_last_entry_as_in_jax(params):
    """With the default ``eos_id=-1`` a done beam extends with the last
    vocabulary entry (``eos_row[-1]``), and no token ever ends a beam."""
    kw = dict(ARCH, beam_size=3, stop_condition=lambda beam: beam.t >= 1)
    got, gs = tt.beam_generate(params, PROMPT, NEW, **kw, device="cpu")
    want, ws = jt.beam_generate(params, PROMPT, NEW, **kw)
    assert got.tolist() == want.tolist()
    assert (got[2:] == VOCAB - 1).all()
    np.testing.assert_allclose(gs, ws, rtol=1e-5)


def test_forced_ties_break_as_in_jax(params):
    """A zero head makes every continuation equal: the lower index wins,
    every step, in both packages."""
    tied = _tie(params)
    kw = dict(ARCH, beam_size=3, eos_id=0)
    got, gs = tt.beam_generate(tied, PROMPT, NEW, **kw, device="cpu")
    want, ws = jt.beam_generate(tied, PROMPT, NEW, **kw)
    assert got.tolist() == want.tolist()
    np.testing.assert_allclose(gs, ws, rtol=1e-5)
    greedy = tt.generate(tied, PROMPT, NEW, **ARCH, device="cpu")
    assert greedy.tolist() == jt.generate(tied, PROMPT, NEW, **ARCH).tolist()


def test_beam_batch_matches_single_prompts_and_jax(params):
    kw = dict(ARCH, beam_size=3, eos_id=0)
    bt, bs = tt.beam_generate_batch(params, PROMPTS, NEW, **kw,
                                    device="cpu")
    assert bt.shape == (3, NEW) and bs.shape == (3,)
    jtoks, jscores = jt.beam_generate_batch(params, PROMPTS, NEW, **kw)
    assert bt.tolist() == np.asarray(jtoks).tolist()
    np.testing.assert_allclose(bs, jscores, rtol=1e-5)
    for i, pr in enumerate(PROMPTS):
        ti, si = tt.beam_generate(params, pr, NEW, **kw, device="cpu")
        assert bt[i].tolist() == ti.tolist()
        assert abs(float(bs[i]) - si) < 1e-5


def test_beam_batch_calls_the_hooks_prompt_by_prompt(params):
    """A hook written for ``beam_generate`` works unchanged: it is shown
    one prompt's [K] beams."""
    shapes = []

    def adjust(lp, beam):
        shapes.append((tuple(lp.shape), tuple(beam.scores.shape)))
        return lp

    tt.beam_generate_batch(params, PROMPTS, 2, **ARCH, beam_size=3,
                           candidate_adjust=adjust, device="cpu")
    assert shapes == [((3, VOCAB), (3,))] * (2 * len(PROMPTS))


def test_decode_errors_match_jax(params):
    kw = dict(ARCH, beam_size=3, eos_id=0)
    cases = [
        lambda pkg, ex: pkg.beam_generate_batch(params, [[1, 2], [1, 2, 3]],
                                                4, **kw, **ex),
        lambda pkg, ex: pkg.generate(params, [], 4, **ARCH, **ex),
        lambda pkg, ex: pkg.beam_generate(params, [], 4, **kw, **ex),
        lambda pkg, ex: pkg.generate(params, PROMPT, MAX_LEN, **ARCH, **ex),
        lambda pkg, ex: pkg.beam_generate(params, PROMPT, MAX_LEN, **kw,
                                          **ex),
    ]
    for case in cases:
        with pytest.raises(ValueError) as want:
            case(jt, {})
        with pytest.raises(ValueError) as got:
            case(tt, {"device": "cpu"})
        assert str(got.value) == str(want.value)


def test_zero_new_tokens(params):
    toks, score = tt.beam_generate(params, PROMPT, 0, **ARCH, device="cpu")
    assert toks.shape == (0,) and toks.dtype == np.int32 and score == 0.0
    bt, bs = tt.beam_generate_batch(params, PROMPTS, 0, **ARCH,
                                    device="cpu")
    assert bt.shape == (3, 0) and bs.shape == (3,)
    assert tt.generate(params, PROMPT, 0, **ARCH, device="cpu").shape == (0,)


def test_block_apply_matches_jax_and_the_layer_graph(params):
    s = 9
    toks = np.array(PROMPT + [1, 2, 3, 4])
    stages_j = jt.stage_params(params, LAYERS)
    stages_t = tt.stage_params(params, LAYERS)
    assert [sorted(st) for st in stages_t] == [sorted(st) for st in stages_j]
    assert sorted(stages_t[0]) == sorted(
        k[len("blk0_"):] for k in params if k.startswith("blk0_"))
    x = params["tok_embed.w"][toks] + params["pos_embed.w"][np.arange(s)]
    xj, xt = jnp.asarray(x), torch.tensor(x)
    for sj, st in zip(stages_j, stages_t):
        xj = jax.jit(lambda p, v: jt.block_apply(p, v, n_heads=HEADS))(sj, xj)
        xt = tt.block_apply({k: torch.tensor(v) for k, v in st.items()}, xt,
                            n_heads=HEADS)
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-5,
                                   atol=1e-5)
    # the stack, the final norm and the head are the layer graph's logits
    ttopo.reset_name_scope()
    _, _, _, logits, _ = tt.build(vocab_size=VOCAB, d_model=D,
                                  n_layers=LAYERS, n_heads=HEADS,
                                  max_len=MAX_LEN)
    topo = ttopo.Topology([logits])
    tp = {k: torch.tensor(params[k]) for k in topo.param_specs()}
    feeds = DataFeeder([(n.name, n.input_type) for n in topo.data_nodes],
                       {"tokens": 0, "pos": 1}, device="cpu").feed(
                           [(toks.tolist(), list(range(s)))])
    with policy(False), torch.no_grad():
        want = topo.forward(tp, feeds)[0].data[:s]
    got = tt._logits(tp, xt)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_temperature_draws_replay_from_one_seed(params):
    a = tt.generate(params, PROMPT, NEW, **ARCH, temperature=1.0, rng=11,
                    device="cpu")
    b = tt.generate(params, PROMPT, NEW, **ARCH, temperature=1.0,
                    rng=torch.Generator().manual_seed(11), device="cpu")
    c = tt.generate(params, PROMPT, NEW, **ARCH, temperature=1.0, rng=12,
                    device="cpu")
    assert a.tolist() == b.tolist()
    assert ((a >= 0) & (a < VOCAB)).all() and ((c >= 0) & (c < VOCAB)).all()
    # a draw at a tiny temperature is the greedy token
    cold = tt.generate(params, PROMPT, NEW, **ARCH, temperature=1e-6,
                       rng=3, device="cpu")
    assert cold.tolist() == tt.generate(params, PROMPT, NEW, **ARCH,
                                        device="cpu").tolist()


def test_decoders_run_on_the_card_unless_asked(params):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    for fn in (lambda: tt.generate(params, PROMPT, 2, **ARCH),
               lambda: tt.beam_generate(params, PROMPT, 2, **ARCH),
               lambda: tt.beam_generate_batch(params, PROMPTS, 2, **ARCH)):
        with pytest.raises(EnforceError, match="CUDA is not available"):
            fn()

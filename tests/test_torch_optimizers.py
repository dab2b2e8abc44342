"""The port's optimizer suite against the JAX package's, on the CPU.

Both packages get the same numpy parameters and, step by step, the same
numpy gradients; the port updates its tensors in place, the JAX
``apply`` returns new arrays.  Tolerances: every parameter, slot and
average within 1e-6 relative (and 1e-7 absolute where an entry is near
zero) after 5 f32 steps; the two frameworks evaluate the same f32
expressions, and differ only where a fused or reordered operation rounds
once instead of twice, a few ulps a step.  Adam alone is held to 1e-5
absolute on parameters of unit scale (measured: 1.73e-6 after 5 steps of
lr 0.05, 5.57e-6 on a tensor with a 3x rate multiplier): its bias
corrections are the port's f64 ``1 - b ** t``, kept so
that its bits stay what they were, where JAX takes ``1 - b ** t`` in f32
(``1 - f32(0.999)`` is 1.3e-5 off 0.001), which moves each step's update
by a few parts in 1e5.  The global-norm clip sums the per-tensor sums in
the same order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu import attr as jattr
from paddle_tpu import optimizer as jopt
from paddle_tpu import topology as jtopo

from paddle_tpu_torch import attr as tattr
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import topology as ttopo

SHAPES = {"a.w": (8, 6), "a.b": (6,), "c.w": (6, 3)}
STEPS = 5
RTOL, ATOL = 1e-6, 1e-7
ADAM_ATOL = 1e-5

RULES = {
    "Sgd": {},
    "Momentum": {"momentum": 0.9},
    "SparseMomentum": {"momentum": 0.9, "decay_rate": 0.01},
    "Adagrad": {"epsilon": 1e-6},
    "AdaDelta": {"rho": 0.9, "epsilon": 1e-6},
    "RMSProp": {"rho": 0.9, "epsilon": 1e-6},
    "DecayedAdagrad": {"rho": 0.9, "epsilon": 1e-6},
    "Adam": {"beta1": 0.9, "beta2": 0.999},
    "Adamax": {"beta1": 0.9, "beta2": 0.999},
}


def _params(seed=0, shapes=SHAPES):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}


def _grads(seed, shapes=SHAPES, scale=1.0):
    rng = np.random.RandomState(100 + seed)
    return {k: (scale * rng.randn(*s)).astype(np.float32)
            for k, s in shapes.items()}


def _specs(attrs, shapes=SHAPES):
    """(JAX specs, port specs) from {name: ParamAttr kwargs}."""
    jspecs, tspecs = {}, {}
    for k, s in shapes.items():
        kw = dict(attrs.get(k, {}))
        hooks = kw.pop("update_hooks", None)
        jspecs[k] = jtopo.ParamSpec(s, jattr.ParamAttr(
            update_hooks=None if hooks is None else jattr.HookAttr(**hooks),
            **kw))
        tspecs[k] = ttopo.ParamSpec(s, tattr.ParamAttr(
            update_hooks=None if hooks is None else tattr.HookAttr(**hooks),
            **kw))
    return jspecs, tspecs


def _run_both(rule, kw, attrs=None, steps=STEPS, grad_scale=1.0,
              shapes=SHAPES):
    """``steps`` updates in both packages: (JAX params, JAX state, port
    params, port state)."""
    jo = getattr(jopt, rule)(**kw)
    to = getattr(topt, rule)(**kw)
    jspecs, tspecs = _specs(attrs or {}, shapes)
    jo.set_param_specs(jspecs)
    to.set_param_specs(tspecs)
    p0 = _params(shapes=shapes)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    js = jo.init_state(jp)
    ts = to.init_state(tp)
    for i in range(steps):
        g = _grads(i, shapes, grad_scale)
        jp, js = jo.apply(jp, {k: jnp.asarray(v) for k, v in g.items()}, js)
        to.apply(tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts)
    return jp, js, tp, ts


def _close(got, want, what, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=atol, err_msg=what)


def _assert_same(jp, js, tp, ts, atol=ATOL):
    for k in jp:
        _close(tp[k], jp[k], f"param {k}", atol)
    for s, d in js["slots"].items():
        for k in d:
            _close(ts["slots"][s][k], d[k], f"slot {s}/{k}", atol)
    assert ts["step"] == int(js["step"])
    for key in ("avg", "prune_masks"):
        assert (key in ts) == (key in js)
        for k in js.get(key, {}):
            _close(ts[key][k], js[key][k], f"{key} {k}", atol)
    if "avg_count" in js:
        _close(ts["avg_count"], js["avg_count"], "avg_count")
    for k in js.get("sm", {}):
        _close(ts["sm"][k], js["sm"][k], f"sm {k}")


@pytest.mark.parametrize("rule", sorted(RULES))
def test_each_rule_matches_jax_over_five_steps(rule):
    jp, js, tp, ts = _run_both(rule, dict(RULES[rule], learning_rate=0.05))
    _assert_same(jp, js, tp, ts, ADAM_ATOL if rule == "Adam" else ATOL)


SCHEDULES = {
    "constant": {},
    "poly": {"learning_rate_decay_a": 0.1, "learning_rate_decay_b": 0.75},
    "caffe_poly": {"learning_rate_decay_a": 40.0,
                   "learning_rate_decay_b": 2.0},
    "exp": {"learning_rate_decay_a": 0.5, "learning_rate_decay_b": 700.0},
    "discexp": {"learning_rate_decay_a": 0.1,
                "learning_rate_decay_b": 300274.0},
    "linear": {"learning_rate_decay_a": 0.01,
               "learning_rate_decay_b": 0.2},
    "manual": {"learning_rate_args": "3:1.0,10:0.5,30:0.1"},
    "pass_manual": {"learning_rate_args": "2:0.9,5:0.3"},
}
# steps on both sides of every break: caffe_poly's end at 40, linear's
# floor from 80, manual's 3/10/30, discexp's 300274 and its doubles;
# exp decays slowly enough that no step lands on an f32 denormal (XLA on
# the CPU flushes them to 0, torch keeps them)
SWEEP = [0, 1, 2, 3, 4, 5, 6, 9, 10, 11, 29, 30, 31, 39, 40, 41, 79, 80,
         81, 1000, 300273, 300274, 300275, 600547, 600548, 600549, 10 ** 7]


@pytest.mark.parametrize("kind", sorted(SCHEDULES))
def test_each_schedule_matches_jax_across_its_breaks(kind):
    args = dict(SCHEDULES[kind], learning_rate_schedule=kind)
    jf = jopt.make_lr_schedule(args)
    tf = topt.make_lr_schedule(args)
    for s in SWEEP:
        want = np.asarray(jf(jnp.asarray(s, jnp.float32)))
        got = tf(torch.full((), float(s), dtype=torch.float32))
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0,
                                   err_msg=f"{kind} at step {s}")


# every lever, each alone on Momentum and Adam, then all together
LEVERS = {
    "l2": ({"regularization": topt.L2Regularization(1e-2)}, {}),
    "l1": ({"regularization": topt.L1Regularization(1e-2)}, {}),
    "l1l2": ({"regularization": topt.L1L2Regularization(1e-2, 3e-2)}, {}),
    "attr_decay": ({"regularization": topt.L2Regularization(1e-2)},
                   {"a.w": {"l1_decay": 2e-2, "l2_decay": 5e-2}}),
    "global_clip": ({"gradient_clipping_threshold": 1.5}, {}),
    "param_clip": ({}, {"a.w": {"gradient_clipping_threshold": 0.3}}),
    "static": ({}, {"a.b": {"is_static": True}}),
    "lr_mult": ({}, {"c.w": {"learning_rate": 3.0}}),
    "pruning": ({}, {"a.w": {"update_hooks": {"type": "pruning",
                                              "sparsity_ratio": 0.6}}}),
    "schedule": ({"learning_rate_schedule": "manual",
                  "learning_rate_args": "2:1.0,4:0.25"}, {}),
    "model_average": ({"model_average": topt.ModelAverage(0.003)}, {}),
}


def _jax_kw(kw):
    """The same optimizer keywords with the JAX package's config objects."""
    out = dict(kw)
    reg = kw.get("regularization")
    if reg is not None:
        out["regularization"] = jopt.L1L2Regularization(reg.l1, reg.l2)
    if kw.get("model_average") is not None:
        out["model_average"] = jopt.ModelAverage(
            kw["model_average"].average_window)
    return out


def _run_levers(rule, kw, attrs):
    base = dict(RULES[rule], learning_rate=0.05)
    jo = getattr(jopt, rule)(**base, **_jax_kw(kw))
    to = getattr(topt, rule)(**base, **kw)
    jspecs, tspecs = _specs(attrs)
    jo.set_param_specs(jspecs)
    to.set_param_specs(tspecs)
    p0 = _params()
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    js, ts = jo.init_state(jp), to.init_state(tp)
    for i in range(STEPS):
        g = _grads(i)
        jp, js = jo.apply(jp, {k: jnp.asarray(v) for k, v in g.items()}, js)
        to.apply(tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts)
    return p0, jp, js, tp, ts


@pytest.mark.parametrize("rule", ["Momentum", "Adam"])
@pytest.mark.parametrize("lever", sorted(LEVERS))
def test_each_lever_alone_matches_jax(rule, lever):
    kw, attrs = LEVERS[lever]
    p0, jp, js, tp, ts = _run_levers(rule, kw, attrs)
    _assert_same(jp, js, tp, ts, ADAM_ATOL if rule == "Adam" else ATOL)
    if lever == "static":
        assert torch.equal(tp["a.b"], torch.from_numpy(p0["a.b"]))
    if lever == "pruning":
        mask = ts["prune_masks"]["a.w"]
        assert 0.3 < float(mask.mean()) < 0.5
        assert bool((tp["a.w"][mask == 0] == 0).all())


@pytest.mark.parametrize("rule", sorted(RULES))
def test_all_levers_together_match_jax(rule):
    kw = {"regularization": topt.L1L2Regularization(1e-3, 1e-2),
          "gradient_clipping_threshold": 2.0,
          "learning_rate_schedule": "manual",
          "learning_rate_args": "2:1.0,4:0.5",
          "model_average": topt.ModelAverage(0.002)}
    attrs = {"a.w": {"gradient_clipping_threshold": 0.4,
                     "update_hooks": {"type": "pruning",
                                      "sparsity_ratio": 0.5},
                     "l2_decay": 3e-2},
             "a.b": {"is_static": True},
             "c.w": {"learning_rate": 2.0}}
    _, jp, js, tp, ts = _run_levers(rule, kw, attrs)
    _assert_same(jp, js, tp, ts, ADAM_ATOL if rule == "Adam" else ATOL)


def test_sparse_momentum_equals_momentum_at_decay_0():
    rng = np.random.RandomState(42)
    p0 = rng.randn(8, 4).astype(np.float32)
    pm = {"w": torch.from_numpy(p0.copy())}
    ps = {"w": torch.from_numpy(p0.copy())}
    om = topt.Momentum(momentum=0.9, learning_rate=0.05)
    osm = topt.SparseMomentum(momentum=0.9, learning_rate=0.05)
    sm_, ss = om.init_state(pm), osm.init_state(ps)
    for _ in range(6):
        g = {"w": torch.from_numpy(rng.randn(8, 4).astype(np.float32))}
        om.apply(pm, g, sm_)
        osm.apply(ps, g, ss)
        np.testing.assert_allclose(ps["w"].numpy(), pm["w"].numpy(),
                                   rtol=2e-5, atol=2e-6)


def test_sparse_momentum_restarts_seamlessly_and_as_jax_does():
    """momentum 0.5 doubles alpha a step; threshold 8 restarts every few
    steps: the port stays on plain momentum's path (the restart drops a
    bounded u / alpha residue) and on the JAX package's, scalars
    included."""
    shapes = {"w": (10,)}
    kw = {"momentum": 0.5, "learning_rate": 0.1, "threshold": 8.0}
    jp, js, tp, ts = _run_both("SparseMomentum", kw, steps=12,
                               shapes=shapes)
    _assert_same(jp, js, tp, ts)
    assert float(ts["sm"]["alpha"]) < 8.0
    om = topt.Momentum(momentum=0.5, learning_rate=0.1)
    pm = {"w": torch.from_numpy(_params(shapes=shapes)["w"])}
    st = om.init_state(pm)
    for i in range(12):
        om.apply(pm, {k: torch.from_numpy(v) for k, v in
                      _grads(i, shapes).items()}, st)
    np.testing.assert_allclose(tp["w"].numpy(), pm["w"].numpy(), rtol=0.05,
                               atol=0.05)


def test_model_average_follows_its_decay():
    """``avg`` after 4 updates equals the running average the decay
    formula gives, from the parameters' own trajectory."""
    w = 0.003                       # 1 - 1/3: the cap binds from c = 2
    o = topt.Sgd(learning_rate=0.1, model_average=topt.ModelAverage(w))
    p = {"w": torch.from_numpy(_params()["a.w"])}
    st = o.init_state(p)
    avg = p["w"].double().clone()
    for i in range(4):
        o.apply(p, {"w": torch.from_numpy(_grads(i)["a.w"])}, st)
        decay = min(i / (i + 1.0), 1.0 - 1.0 / max(1.0, w * 1000))
        avg = decay * avg + (1 - decay) * p["w"].double()
    np.testing.assert_allclose(st["avg"]["w"].numpy(), avg.numpy(),
                               rtol=1e-6, atol=1e-7)
    assert float(st["avg_count"]) == 4.0


def test_prune_mask_above_two_to_the_24_matches_jnp_quantile():
    """A tensor of 4097 x 4096 > 2^24 elements: ``torch.quantile``
    refuses it; the port's sort-based quantile gives jnp.quantile's f32
    threshold bit for bit, and the same mask."""
    rng = np.random.RandomState(3)
    w = rng.randn(4097, 4096).astype(np.float32)
    assert w.size > 2 ** 24
    want = np.asarray(jnp.quantile(jnp.abs(jnp.asarray(w)).ravel(), 0.7))
    got = topt.quantile_f32(torch.from_numpy(np.abs(w)), 0.7)
    assert got.numpy().tobytes() == want.tobytes()
    jo = jopt.Sgd(learning_rate=0.1)
    to = topt.Sgd(learning_rate=0.1)
    hook = {"type": "pruning", "sparsity_ratio": 0.7}
    jspecs, tspecs = _specs({"big": {"update_hooks": hook}},
                            {"big": w.shape})
    jo.set_param_specs(jspecs)
    to.set_param_specs(tspecs)
    jm = np.asarray(jo._make_prune_masks({"big": jnp.asarray(w)})["big"])
    tm = to._make_prune_masks({"big": torch.from_numpy(w)})["big"].numpy()
    assert np.array_equal(tm, jm)


def test_quantile_on_small_tensors_matches_jnp():
    rng = np.random.RandomState(5)
    for n in (1, 2, 7, 100, 1001):
        x = rng.randn(n).astype(np.float32)
        for q in (0.0, 0.25, 0.5, 0.6, 0.75, 1.0):
            want = np.asarray(jnp.quantile(jnp.asarray(x), q))
            got = topt.quantile_f32(torch.from_numpy(x), q).numpy()
            assert got.tobytes() == want.tobytes(), (n, q)


def _old_update(rule, p, g, slots, lr, step):
    """Sgd, Momentum and Adam as the port ran them before the levers."""
    if rule == "Sgd":
        p.sub_(lr * g)
    elif rule == "Momentum":
        m = slots["momentum"]
        m.mul_(0.9).sub_(g, alpha=lr)
        p.add_(m)
    else:
        t = step + 1
        m, v = slots["m"], slots["v"]
        m.mul_(0.9).add_(g, alpha=1 - 0.9)
        v.mul_(0.999).addcmul_(g, g, value=1 - 0.999)
        denom = (v / (1 - 0.999 ** t)).sqrt_().add_(1e-8)
        p.sub_(lr * (m / (1 - 0.9 ** t)) / denom)


@pytest.mark.parametrize("rule", ["Sgd", "Momentum", "Adam"])
def test_no_lever_keeps_the_earlier_bits(rule):
    o = getattr(topt, rule)(learning_rate=0.05)
    slots_of = {"Sgd": (), "Momentum": ("momentum",), "Adam": ("m", "v")}
    p = {k: torch.from_numpy(v) for k, v in _params().items()}
    ref = {k: v.clone() for k, v in p.items()}
    ref_slots = {s: {k: torch.zeros_like(v) for k, v in p.items()}
                 for s in slots_of[rule]}
    st = o.init_state(p)
    for i in range(STEPS):
        g = {k: torch.from_numpy(v) for k, v in _grads(i).items()}
        o.apply(p, g, st)
        for k in ref:
            _old_update(rule, ref[k], g[k],
                        {s: ref_slots[s][k] for s in ref_slots}, 0.05, i)
    for k in p:
        assert torch.equal(p[k], ref[k]), k


def test_zero_plan_names_the_parallel_slice():
    with pytest.raises(Exception, match="A12"):
        topt.Momentum().set_zero_plan(object())

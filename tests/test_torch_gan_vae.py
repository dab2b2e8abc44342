"""The port's multi-task trainer, GAN and VAE against the JAX package, on
the CPU.

``trainer.TaskSpec``/``MultiTaskTrainer`` with ``models/gan`` and
``optimizer.Sgd``/``Adam``, and ``models/vae`` through ``trainer.SGD``.
Weights are the JAX initializer's, crossed by name as numpy; feeds are
the same numpy batches.  The VAE's reparameterisation noise cannot come
from the same generator in both packages, so the test draws the JAX
package's ``eps`` itself, from the key the JAX trainer hands its forward
(the trainer's split key, folded with the md5 of the node's name as
``Context.rng_for`` does), and hands those numbers to the port's draw by
monkeypatching ``models.vae._normal``.

Tolerances (f32, ``use_bf16`` off in both): costs within 1e-5 relative,
parameters within 1e-4 relative in norm; a task's step leaves every
parameter outside its ``trainable`` set bit-identical.
"""

import contextlib
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import event as jevent
from paddle_tpu import optimizer as jopt
from paddle_tpu import topology as jtopo
from paddle_tpu import trainer as jtrainer
from paddle_tpu.models import gan as jgan
from paddle_tpu.models import vae as jvae
from paddle_tpu.parameters import Parameters as JParameters
from paddle_tpu.platform.flags import FLAGS as JFLAGS

from paddle_tpu_torch import convert
from paddle_tpu_torch import event as tevent
from paddle_tpu_torch import minibatch as tminibatch
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import topology as ttopo
from paddle_tpu_torch import trainer as ttrainer
from paddle_tpu_torch.models import gan as tgan
from paddle_tpu_torch.models import vae as tvae
from paddle_tpu_torch.platform.enforce import EnforceError
from paddle_tpu_torch.platform.flags import FLAGS as TFLAGS

COST_RTOL = 1e-5
PARAM_RTOL = 1e-4
GAN = dict(noise_dim=4, data_dim=2, gen_dims=(8,), dis_dims=(8,))
BS = 8


@contextlib.contextmanager
def f32_policy():
    old = (JFLAGS.use_bf16, TFLAGS.use_bf16)
    JFLAGS.use_bf16 = TFLAGS.use_bf16 = False
    try:
        yield
    finally:
        JFLAGS.use_bf16, TFLAGS.use_bf16 = old


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _numpy(params) -> dict:
    return {k: v.detach().numpy().copy() if isinstance(v, torch.Tensor)
            else np.array(v) for k, v in params.items()}


NAMES = ["gen_h0.w", "gen_h0.b", "gen_out.w", "dis_h0.w", "dis_out.b"]


@pytest.mark.parametrize("trainable", [
    None, "dis_", ("gen_h0.w", "dis_out.b"), {"gen_out.w"},
    lambda name: name.endswith(".b"),
], ids=["all", "prefix", "tuple", "set", "callable"])
def test_task_spec_trainable_forms_match_jax(trainable):
    j = jtrainer.TaskSpec("t", None, jopt.Sgd(), trainable=trainable)
    t = ttrainer.TaskSpec("t", None, topt.Sgd(), trainable=trainable)
    assert [t.trainable(n) for n in NAMES] == [j.trainable(n) for n in NAMES]


def _gan_both(optim, seed=1):
    """Both packages' GAN (``GAN`` sizes) over one parameter store each,
    from the JAX initializer's weights; (jax trainer, jax params, port
    trainer, port params)."""
    jtopo.reset_name_scope()
    _, _, _, jd, jg = jgan.build(**GAN)
    jparams = JParameters.from_topology(jtopo.Topology([jd, jg]), seed=seed)
    arrays = _numpy(jparams.as_dict())
    jt = jtrainer.MultiTaskTrainer(
        [jtrainer.TaskSpec("d", jd, optim(jopt), trainable="dis_"),
         jtrainer.TaskSpec("g", jg, optim(jopt), trainable="gen_")], jparams)
    ttopo.reset_name_scope()
    _, _, _, td, tg = tgan.build(**GAN)
    tparams = convert.parameters_from_numpy(arrays, device="cpu")
    tt = ttrainer.MultiTaskTrainer(
        [ttrainer.TaskSpec("d", td, optim(topt), trainable="dis_"),
         ttrainer.TaskSpec("g", tg, optim(topt), trainable="gen_")],
        tparams, device="cpu")
    return jt, jparams, tt, tparams


def _feeds(task, rs):
    ones = np.ones((BS, 1), np.float32)
    f = {"noise": rs.randn(BS, GAN["noise_dim"]).astype(np.float32),
         "label_one": ones}
    if task == "d":
        f["pixel"] = rs.randn(BS, GAN["data_dim"]).astype(np.float32)
        f["label_zero"] = np.zeros((BS, 1), np.float32)
    return f


@pytest.mark.parametrize("task,other", [("d", "gen_"), ("g", "dis_")])
def test_one_sgd_step_leaves_the_other_side_bit_identical(task, other):
    with f32_policy():
        jt, jparams, tt, tparams = _gan_both(
            lambda m: m.Sgd(learning_rate=0.1))
        before = _numpy(tparams.as_dict())
        feeds = _feeds(task, np.random.RandomState(0))
        jcost = jt.step(task, feeds)
        tcost = tt.step(task, feeds)
    np.testing.assert_allclose(tcost, jcost, rtol=COST_RTOL)
    after = _numpy(tparams.as_dict())
    jafter = _numpy(jparams.as_dict())
    for k in before:
        if k.startswith(other):
            np.testing.assert_array_equal(after[k], before[k], err_msg=k)
        else:
            assert not np.array_equal(after[k], before[k]), k
            assert _rel(after[k], jafter[k]) <= PARAM_RTOL, k
    assert tt.steps_run(task) == 1


def test_five_alternating_adam_steps_match_jax():
    rs = np.random.RandomState(2)
    with f32_policy():
        jt, jparams, tt, tparams = _gan_both(
            lambda m: m.Adam(learning_rate=2e-3, beta1=0.5), seed=0)
        for _ in range(5):
            for task in ("d", "g"):
                feeds = _feeds(task, rs)
                np.testing.assert_allclose(tt.step(task, feeds),
                                           jt.step(task, feeds),
                                           rtol=COST_RTOL)
    assert tt.steps_run("d") == tt.steps_run("g") == 5
    jp = _numpy(jparams.as_dict())
    for k, v in _numpy(tparams.as_dict()).items():
        assert _rel(v, jp[k]) <= PARAM_RTOL, (k, _rel(v, jp[k]))


def test_a_task_that_trains_no_parameter_raises():
    ttopo.reset_name_scope()
    _, _, _, td, _ = tgan.build(**GAN)
    tparams = convert.parameters_from_numpy(
        {k: np.zeros(s.shape, np.float32)
         for k, s in ttopo.Topology([td]).param_specs().items()},
        device="cpu")
    with pytest.raises(EnforceError, match="trains no parameters"):
        ttrainer.MultiTaskTrainer(
            [ttrainer.TaskSpec("d", td, topt.Sgd(), trainable="nothing_")],
            tparams, device="cpu")


def _jax_eps(steps, name, shape):
    """The ``eps`` the JAX trainer's forward draws at node ``name`` in each
    of ``steps`` steps: its key split per step from ``PRNGKey(seed)``,
    folded with the md5 of the name (``paddle_tpu/topology.py``
    ``Context.rng_for``)."""
    rng = jax.random.PRNGKey(JFLAGS.seed or 0)
    h = int.from_bytes(hashlib.md5(name.encode()).digest()[:4], "little")
    out = []
    for _ in range(steps):
        rng, key = jax.random.split(rng)
        out.append(np.asarray(jax.random.normal(jax.random.fold_in(key, h),
                                                shape, jnp.float32)))
    return out


def test_vae_matches_jax_with_its_eps(monkeypatch):
    D, hidden, latent, bs, steps = 16, (32,), 4, 32, 3
    rs = np.random.RandomState(0)
    protos = (rs.rand(2, D) > 0.5).astype(np.float32)
    data = []
    for _ in range(bs * steps):
        p = protos[rs.randint(0, 2)]
        data.append((np.abs(p - (rs.rand(D) < 0.05).astype(np.float32)),))

    def costs_of(sgd, event_mod, batch):
        out = []
        sgd.train(batch(lambda: iter(data), bs), num_passes=1,
                  event_handler=lambda ev: out.append(float(ev.cost))
                  if isinstance(ev, event_mod.EndIteration) else None)
        return np.asarray(out)

    with f32_policy():
        jtopo.reset_name_scope()
        _, _, jcost = jvae.build(data_dim=D, hidden=hidden,
                                 latent_dim=latent)
        jparams = JParameters.from_topology(jtopo.Topology([jcost]), seed=0)
        arrays = _numpy(jparams.as_dict())
        jsgd = jtrainer.SGD(cost=jcost, parameters=jparams,
                            update_equation=jopt.Adam(learning_rate=1e-2))
        jcosts = costs_of(jsgd, jevent, jpaddle.batch)

        ttopo.reset_name_scope()
        _, _, tcost = tvae.build(data_dim=D, hidden=hidden,
                                 latent_dim=latent)
        sample = next(n for n in ttopo.Topology([tcost]).nodes
                      if n.layer_type == "gaussian_sample")
        eps = iter(_jax_eps(steps, sample.name, (bs, latent)))
        monkeypatch.setattr(tvae, "_normal",
                            lambda gen, like: torch.tensor(next(eps)))
        tparams = convert.parameters_from_numpy(arrays, device="cpu")
        tsgd = ttrainer.SGD(tcost, tparams, topt.Adam(learning_rate=1e-2),
                            device="cpu")
        tcosts = costs_of(tsgd, tevent, tminibatch.batch)

    assert len(tcosts) == steps and np.isfinite(tcosts).all()
    np.testing.assert_allclose(tcosts, jcosts, rtol=COST_RTOL)
    jp = _numpy(jsgd.parameters.as_dict())
    for k, v in _numpy(tparams.as_dict()).items():
        assert _rel(v, jp[k]) <= PARAM_RTOL, (k, _rel(v, jp[k]))


def test_vae_draws_from_the_step_generator():
    """Without the patch the port's draw is a function of the step's
    seed: one seed gives one cost, another seed another."""
    ttopo.reset_name_scope()
    x, _, cost = tvae.build(data_dim=8, hidden=(8,), latent_dim=2)
    topo = ttopo.Topology([cost])
    rs = np.random.RandomState(0)
    params = {k: torch.from_numpy(rs.randn(*s.shape).astype(np.float32))
              for k, s in topo.param_specs().items()}
    feeds = {"pixel": torch.from_numpy(rs.rand(4, 8).astype(np.float32))}

    def run(seed):
        return topo.forward(params, feeds, train=True, seed=seed)[0]

    torch.testing.assert_close(run(3), run(3), rtol=0, atol=0)
    assert not torch.equal(run(3), run(4))

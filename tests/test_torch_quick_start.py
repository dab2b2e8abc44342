"""The port's quick_start classifiers against the JAX package, on the CPU.

All seven architectures of ``models/quick_start`` at dict 200 and
embedding 16 train 3 Adam steps in both packages from the JAX
initializer's weights (f32 policy), on the same reviews
(``tools/quick_start_workload``; ``lr`` on their bags of words): costs
within 1e-5 relative and every parameter within 1e-4 relative in norm.
``lstm``'s dropout and ``db_lstm``'s ``drop_rate`` draw masks the two
packages cannot share, so both packages' ``dropout`` is patched to the
identity for these runs (the JAX package's at run time, no file of it
changed).  Every batch packs to capacity 64 and ``max_len`` bucket 16, so
the JAX step compiles once.
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import contextlib

import numpy as np
import pytest

from paddle_tpu import event as jevent
from paddle_tpu import optimizer as jopt
from paddle_tpu import topology as jtopo
from paddle_tpu import trainer as jtrainer
from paddle_tpu.models import quick_start as jqs
from paddle_tpu.ops import math as jmath
from paddle_tpu.parameters import Parameters as JParameters
from paddle_tpu.platform.flags import FLAGS as JFLAGS

from paddle_tpu_torch import convert
from paddle_tpu_torch import event as tevent
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import topology as ttopo
from paddle_tpu_torch import trainer as ttrainer
from paddle_tpu_torch.models import quick_start as tqs
from paddle_tpu_torch.ops import math as tmath
from paddle_tpu_torch.platform.flags import FLAGS as TFLAGS
from paddle_tpu_torch.tools import quick_start_workload as qw

DIMS = dict(dict_size=200, emb_size=16)
RTOL, PARAM_RTOL = 1e-5, 1e-4


@contextlib.contextmanager
def f32_policy():
    old = (JFLAGS.use_bf16, TFLAGS.use_bf16)
    JFLAGS.use_bf16 = TFLAGS.use_bf16 = False
    try:
        yield
    finally:
        JFLAGS.use_bf16, TFLAGS.use_bf16 = old


def _batches(arch, steps=3, n=4):
    """4 reviews of 10-15 tokens a batch: capacity 64, max_len 16."""
    rs = np.random.RandomState(len(arch))
    out = [qw.reviews(rs, n, DIMS["dict_size"], lo=10, hi=16)
           for _ in range(steps)]
    if arch == "lr":
        out = [qw.bag_of_words(b, DIMS["dict_size"]) for b in out]
    return out


def _costs(sgd, event_mod, batches):
    costs = []
    sgd.train(lambda: iter(batches), event_handler=lambda ev:
              costs.append(float(ev.cost))
              if isinstance(ev, event_mod.EndIteration) else None)
    return np.asarray(costs)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("arch", tqs.ARCHS)
def test_arch_three_adam_steps_match_jax(arch, monkeypatch):
    assert tqs.ARCHS == jqs.ARCHS
    no_dropout = (lambda x, rate, key, train: x)
    monkeypatch.setattr(jmath, "dropout", no_dropout)
    monkeypatch.setattr(tmath, "dropout", no_dropout)
    batches = _batches(arch)
    with f32_policy():
        jtopo.reset_name_scope()
        jcost = jqs.build(arch, **DIMS)[3]
        jparams = JParameters.from_topology(jtopo.Topology([jcost]), seed=0)
        arrays = {k: np.array(v) for k, v in jparams.as_dict().items()}
        jsgd = jtrainer.SGD(cost=jcost, parameters=jparams,
                            update_equation=jopt.Adam(learning_rate=2e-3))
        jc = _costs(jsgd, jevent, batches)
        ttopo.reset_name_scope()
        tcost = tqs.build(arch, **DIMS)[3]
        tparams = convert.parameters_from_numpy(arrays, device="cpu")
        tsgd = ttrainer.SGD(tcost, tparams, topt.Adam(learning_rate=2e-3),
                            device="cpu")
        tc = _costs(tsgd, tevent, batches)
    assert len(tc) == 3 and np.isfinite(tc).all()
    np.testing.assert_allclose(tc, jc, rtol=RTOL)
    jd = jsgd.parameters.as_dict()
    assert set(jd) == set(tparams.keys())
    for k, v in jd.items():
        err = _rel(tparams[k].detach().numpy(), np.asarray(v))
        assert err <= PARAM_RTOL, (k, err)


def test_dropout_draws_masks_from_the_step_generator():
    """Unpatched, ``lstm``'s dropout and ``db_lstm``'s drop rate change
    the cost and the same step seed repeats it."""
    from paddle_tpu_torch import topology

    for arch in ("lstm", "db_lstm"):
        rows = _batches(arch, steps=1)[0]
        sgd, _ = qw.build_trainer(arch, "cpu", dims=DIMS)
        feeds = sgd._make_feeder(None).feed(rows)
        params = sgd.parameters.as_dict()
        topo = topology.Topology([sgd.topology.outputs[0]])
        train = [float(topo.forward(params, feeds, train=True,
                                    seed=s)[0].mean()) for s in (1, 1, 2)]
        test = float(topo.forward(params, feeds)[0].mean())
        assert train[0] == train[1] != train[2]
        assert test not in train

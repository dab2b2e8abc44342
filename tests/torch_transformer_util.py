"""Shared by the transformer family's parity tests: the bf16 policy in
both packages, training one topology in both from the JAX package's
weights (crossed through the tar format), and LM batches."""

import contextlib
import io

import numpy as np

from paddle_tpu import event as jevent
from paddle_tpu import minibatch as jminibatch
from paddle_tpu import topology as jtopo
from paddle_tpu import trainer as jtrainer
from paddle_tpu.parameters import Parameters as JParameters
from paddle_tpu.platform.flags import FLAGS as JFLAGS

from paddle_tpu_torch import event as tevent
from paddle_tpu_torch import minibatch as tminibatch
from paddle_tpu_torch import topology as ttopo
from paddle_tpu_torch import trainer as ttrainer
from paddle_tpu_torch.parameters import Parameters as TParameters
from paddle_tpu_torch.platform.flags import FLAGS as TFLAGS

LM_FEEDING = {"tokens": 0, "pos": 1, "target": 2}
S2S_FEEDING = {"src": 0, "src_pos": 1, "trg": 2, "trg_pos": 3, "label": 4}


@contextlib.contextmanager
def policy(use_bf16: bool):
    old = (JFLAGS.use_bf16, TFLAGS.use_bf16)
    JFLAGS.use_bf16 = TFLAGS.use_bf16 = use_bf16
    try:
        yield
    finally:
        JFLAGS.use_bf16, TFLAGS.use_bf16 = old


def lm_batch(rng, vocab, lens):
    """(tokens, positions, next-token targets) samples of ``lens``."""
    out = []
    for n in lens:
        toks = rng.randint(0, vocab, size=n)
        out.append((toks.tolist(), list(range(n)), np.roll(toks, -1).tolist()))
    return out


def costs_of(sgd, event_mod, minibatch_mod, batches, feeding):
    """One pass of ``SGD.train`` over ``batches`` (all one size): the
    per-step costs."""
    costs = []
    samples = [s for b in batches for s in b]
    sgd.train(minibatch_mod.batch(lambda: iter(samples), len(batches[0])),
              num_passes=1, feeding=feeding, event_handler=lambda ev:
              costs.append(float(ev.cost))
              if isinstance(ev, event_mod.EndIteration) else None)
    return np.asarray(costs)


def jax_tar(jcost, seed) -> bytes:
    buf = io.BytesIO()
    JParameters.from_topology(jtopo.Topology([jcost]), seed=seed).to_tar(buf)
    return buf.getvalue()


def train_both(build_j, build_t, batches, make_j_opt, make_t_opt, feeding,
               seed=0):
    """``build_j()``/``build_t()`` return each package's cost node (after
    resetting its name scope here); both train on ``batches`` from the JAX
    package's ``seed`` weights.  Returns (JAX costs, port costs, JAX
    parameters, port parameters), parameters as numpy dicts."""
    jtopo.reset_name_scope()
    jcost = build_j()
    tar = jax_tar(jcost, seed)
    jsgd = jtrainer.SGD(cost=jcost,
                        parameters=JParameters.from_tar(io.BytesIO(tar)),
                        update_equation=make_j_opt())
    jcosts = costs_of(jsgd, jevent, jminibatch, batches, feeding)
    ttopo.reset_name_scope()
    tcost = build_t()
    tsgd = ttrainer.SGD(tcost, TParameters.from_tar(io.BytesIO(tar),
                                                    device="cpu"),
                        make_t_opt(), device="cpu")
    tcosts = costs_of(tsgd, tevent, tminibatch, batches, feeding)
    jp = {k: np.asarray(v) for k, v in jsgd.parameters.as_dict().items()}
    tp = {k: tsgd.parameters.get(k) for k in tsgd.parameters.keys()}
    return jcosts, tcosts, jp, tp


def assert_norm_close(got, want, rtol):
    """Each tensor within ``rtol`` of the JAX one in norm."""
    assert set(got) == set(want)
    for k in want:
        err = np.linalg.norm(got[k] - want[k])
        assert err <= rtol * np.linalg.norm(want[k]), (k, err)

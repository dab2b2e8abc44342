"""The port's attention seq2seq NMT against the JAX package, on the CPU.

Both packages build ``models/seq2seq`` at the sizes of
``tests/test_seq2seq.py`` (vocabularies of 20, embedding and hidden 16);
the JAX ``Parameters.from_topology(seed=4)`` weights cross into the port
through the tar format, and the same numpy batches (copy-task pairs,
``(source, <s> + target, target + <e>)``, every batch at feeder capacity
64 and ``max_len`` bucket 16, so the JAX step compiles once) go through
both ``trainer.SGD.train`` loops with ``Adam(lr 1e-2)`` for 3 steps.  The
JAX encoder runs its fused GRU steps as Pallas kernels in interpret mode;
the port's the kernels' plain versions.

Tolerances:
- f32 (``use_bf16`` off in both): the first cost, the forward of one
  batch at the same weights, within 1e-5 relative; the 3 steps' costs
  within 1e-4 relative (Adam's first steps move each weight by about the
  learning rate whatever its gradient's size, so f32 rounding in a small
  gradient shows in the next cost).
- the bf16 policy (the default): every cost within 1e-4 relative.  The
  products take bf16-rounded inputs in both packages and sum in f32; an
  f32 sum taken in another order can cross a bf16 rounding step (2**-8
  of a value) where a product's output feeds the next product's input.
  The fused GRU steps compute h W_h in f32 in both.  Measured: f32 costs
  apart by at most 7.5e-8, bf16 ones by 1.3e-5 (step 2), relative.
- generation: ``Inference`` over the port's trained weights gives the JAX
  generator's tokens and lengths, scores within 1e-4.
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import contextlib
import io

import numpy as np
import pytest

import paddle_tpu as jpaddle
from paddle_tpu import event as jevent
from paddle_tpu import optimizer as jopt
from paddle_tpu import topology as jtopo
from paddle_tpu import trainer as jtrainer
from paddle_tpu.models import seq2seq as js2s
from paddle_tpu.parameters import Parameters as JParameters
from paddle_tpu.platform.flags import FLAGS as JFLAGS

from paddle_tpu_torch import event as tevent
from paddle_tpu_torch import minibatch as tminibatch
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import topology as ttopo
from paddle_tpu_torch import trainer as ttrainer
from paddle_tpu_torch.inference import Inference, infer
from paddle_tpu_torch.models import seq2seq as ts2s
from paddle_tpu_torch.parameters import Parameters as TParameters
from paddle_tpu_torch.platform.flags import FLAGS as TFLAGS

V = 20
BOS, EOS = 0, 1
SIZES = dict(src_dict_size=V, trg_dict_size=V, embed_size=16, hidden=16)
BATCH, STEPS = 4, 3
GEN = dict(bos_id=BOS, eos_id=EOS, beam_size=3, max_length=8)


@contextlib.contextmanager
def policy(use_bf16: bool):
    old = (JFLAGS.use_bf16, TFLAGS.use_bf16)
    JFLAGS.use_bf16 = TFLAGS.use_bf16 = use_bf16
    try:
        yield
    finally:
        JFLAGS.use_bf16, TFLAGS.use_bf16 = old


def _copy_task(n, seed):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        src = [int(t) for t in rng.randint(2, V, int(rng.randint(2, 6)))]
        out.append((src, [BOS] + src, src + [EOS]))
    return out


def _costs(sgd, event_mod, reader):
    costs = []
    sgd.train(reader, num_passes=1, event_handler=lambda ev:
              costs.append(float(ev.cost))
              if isinstance(ev, event_mod.EndIteration) else None)
    return np.asarray(costs)


def _train_both(use_bf16):
    data = _copy_task(BATCH * STEPS, seed=0)
    with policy(use_bf16):
        jtopo.reset_name_scope()
        jcost, _ = js2s.build_train(**SIZES)
        buf = io.BytesIO()
        JParameters.from_topology(jtopo.Topology([jcost]), seed=4).to_tar(buf)
        jparams = JParameters.from_tar(io.BytesIO(buf.getvalue()))
        jsgd = jtrainer.SGD(cost=jcost, parameters=jparams,
                            update_equation=jopt.Adam(learning_rate=1e-2))
        jcosts = _costs(jsgd, jevent,
                        jpaddle.batch(lambda: iter(data), BATCH))
        ttopo.reset_name_scope()
        tcost, _ = ts2s.build_train(**SIZES)
        tparams = TParameters.from_tar(io.BytesIO(buf.getvalue()),
                                       device="cpu")
        tsgd = ttrainer.SGD(tcost, tparams, topt.Adam(learning_rate=1e-2),
                            device="cpu")
        tcosts = _costs(tsgd, tevent,
                        tminibatch.batch(lambda: iter(data), BATCH))
    return jcosts, tcosts, jsgd, tsgd


@pytest.mark.parametrize("use_bf16", [False, True])
def test_three_adam_steps_match_jax(use_bf16):
    jcosts, tcosts, _, _ = _train_both(use_bf16)
    assert len(tcosts) == STEPS and np.isfinite(tcosts).all()
    if not use_bf16:
        np.testing.assert_allclose(tcosts[0], jcosts[0], rtol=1e-5)
    np.testing.assert_allclose(tcosts, jcosts, rtol=1e-4)


def test_generator_keys_are_trainer_keys_and_inference_matches_jax():
    jcosts, tcosts, jsgd, tsgd = _train_both(False)
    jtopo.reset_name_scope()
    jbeam = js2s.build_generator(**SIZES, **GEN)
    ttopo.reset_name_scope()
    tbeam = ts2s.build_generator(**SIZES, **GEN)
    gen_keys = set(ttopo.Topology([tbeam]).param_specs())
    assert gen_keys == set(jtopo.Topology([jbeam]).param_specs())
    assert gen_keys <= set(tsgd.topology.param_specs())

    srcs = [([3, 4, 5],), ([7, 8],), ([9, 2, 11, 5, 6],)]
    with policy(False):
        jout = list(jpaddle.Inference(output_layer=jbeam,
                                      parameters=jsgd.parameters)
                    .iter_infer([srcs]))[0][0]
        inf = Inference(tbeam, tsgd.parameters, device="cpu")
        (tout,) = next(inf.iter_infer([srcs]))
    jt, jl, js = (np.asarray(a) for a in jout)
    tt, tl, ts = (a.numpy() for a in tout)
    assert tt.shape == (3, 3, 8)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_allclose(ts, js, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("batch_size", [2, 8])
def test_infer_pads_the_tail_as_jax_does_and_matches(batch_size):
    """``infer`` of a dense node (the decoder's boot state) over 5 sources:
    batches of 2 pad the tail to 2, one batch of 8 pads to the next power
    of two; the padded rows are cut off and the values match JAX's."""
    srcs = [(s,) for s, _, _ in _copy_task(5, seed=3)]
    with policy(False):
        jtopo.reset_name_scope()
        jcost, _ = js2s.build_train(**SIZES)
        jtopo_ = jtopo.Topology([jcost])
        buf = io.BytesIO()
        JParameters.from_topology(jtopo_, seed=4).to_tar(buf)
        jparams = JParameters.from_tar(io.BytesIO(buf.getvalue()))
        want = jpaddle.infer(jtopo_.by_name["decoder_boot"], jparams, srcs,
                             batch_size=batch_size)
        ttopo.reset_name_scope()
        tcost, _ = ts2s.build_train(**SIZES)
        tparams = TParameters.from_tar(io.BytesIO(buf.getvalue()),
                                       device="cpu")
        got = infer(ttopo.Topology([tcost]).by_name["decoder_boot"], tparams,
                    srcs, batch_size=batch_size, device="cpu")
    assert got.shape == np.asarray(want).shape == (5, SIZES["hidden"])
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)

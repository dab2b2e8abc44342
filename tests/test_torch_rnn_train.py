"""The port's recurrent training slice against the JAX package, on the CPU.

Both packages build bench.py's text classifier (``models/text_lstm``:
embedding -> 2 x ``simple_lstm`` -> max pooling -> fc(2) ->
``classification_cost``) and its GRU variant (``simple_gru`` layers) at a
small size (dict 1000, embedding 16, hidden 32); the JAX
``Parameters.from_topology(seed=0)`` weights cross into the port through
the tar format; the same numpy batches go through both ``DataFeeder``s and
both ``trainer.SGD.train`` loops with ``Momentum(0.9, 0.01)`` (bench.py's
optimizer) for 5 steps.  The JAX scans run the fused Pallas kernels in
interpret mode; the port's run the kernels' plain versions.  Every batch
packs to capacity 64 with max_len bucket 16, so the JAX step compiles once.

Tolerances (costs per step; parameters after the five steps):
- f32 (``use_bf16=False`` in both): costs within 1e-4 relative, every
  parameter within 1e-4 relative (1e-6 absolute near zero): the two
  frameworks only sum in other orders.
- bf16 policy (the default): costs within 1e-4 relative and each
  parameter tensor within 1e-4 relative in norm.  The fused forward
  computes h W_h in f32 in both, but the input projections and the
  closed-form backward's products take bf16 inputs, and an f32 sum taken
  in another order can cross a bf16 rounding step (2**-8 of the value);
  at this size none did enough to show: measured, the costs differ by at
  most 1.7e-7 relative and the parameters by 2.7e-7 in norm under either
  policy.
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import contextlib
import io

import numpy as np
import pytest

from paddle_tpu import data_type as jdt
from paddle_tpu import event as jevent
from paddle_tpu import layer as jlayer
from paddle_tpu import minibatch as jminibatch
from paddle_tpu import networks as jnetworks
from paddle_tpu import optimizer as jopt
from paddle_tpu import pooling as jpooling
from paddle_tpu import topology as jtopo
from paddle_tpu import trainer as jtrainer
from paddle_tpu.models import text_lstm as jtext_lstm
from paddle_tpu.parameters import Parameters as JParameters
from paddle_tpu.platform.flags import FLAGS as JFLAGS

from paddle_tpu_torch import event as tevent
from paddle_tpu_torch import minibatch as tminibatch
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import topology as ttopo
from paddle_tpu_torch import trainer as ttrainer
from paddle_tpu_torch.ops import rnn as trnn
from paddle_tpu_torch.parameters import Parameters as TParameters
from paddle_tpu_torch.platform.flags import FLAGS as TFLAGS
from paddle_tpu_torch.tools import rnn_workload as rw

CFG = dict(dict_size=1000, embed_size=16, hidden=32, num_classes=2,
           num_layers=2)
FEEDING = {"words": 0, "label": 1}
# per step: the sequence lengths of one batch of 4 (total 36..64 tokens,
# longest 9..16: capacity 64 and max_len bucket 16 throughout)
BATCH_LENS = [(16, 9, 12, 10), (9, 9, 9, 9), (11, 16, 3, 14),
              (16, 16, 16, 16), (5, 7, 13, 12)]


@contextlib.contextmanager
def bf16_policy(on: bool):
    old = (JFLAGS.use_bf16, TFLAGS.use_bf16)
    JFLAGS.use_bf16 = TFLAGS.use_bf16 = on
    try:
        yield
    finally:
        JFLAGS.use_bf16, TFLAGS.use_bf16 = old


def _batches(seed=0):
    rng = np.random.RandomState(seed)
    return [[(rng.randint(0, CFG["dict_size"], size=n).tolist(),
              int(rng.randint(2))) for n in lens] for lens in BATCH_LENS]


def _jax_classifier(cell):
    """The JAX graph: ``text_lstm.build`` or its ``simple_gru`` variant."""
    jtopo.reset_name_scope()
    if cell == "lstm":
        return jtext_lstm.build(**CFG)[-1]
    words = jlayer.data(name="words", type=jdt.integer_value_sequence(
        CFG["dict_size"]))
    label = jlayer.data(name="label",
                        type=jdt.integer_value(CFG["num_classes"]))
    net = jlayer.embedding(input=words, size=CFG["embed_size"])
    for i in range(CFG["num_layers"]):
        net = jnetworks.simple_gru(input=net, size=CFG["hidden"],
                                   name=f"gru{i}")
    pooled = jlayer.pooling(input=net, pooling_type=jpooling.MaxPooling())
    logits = jlayer.fc(input=pooled, size=CFG["num_classes"])
    return jlayer.classification_cost(input=logits, label=label)


def _port_classifier(cell):
    ttopo.reset_name_scope()
    return rw.build_classifier(cell, **CFG)


def _train(sgd, event_mod, minibatch_mod, batches):
    costs = []

    def handler(ev):
        if isinstance(ev, event_mod.EndIteration):
            costs.append(ev.cost)

    samples = [s for b in batches for s in b]
    sgd.train(minibatch_mod.batch(lambda: iter(samples), len(batches[0])),
              num_passes=1, event_handler=handler, feeding=FEEDING)
    return np.asarray(costs)


def _train_both(cell, use_bf16):
    batches = _batches()
    with bf16_policy(use_bf16):
        jcost = _jax_classifier(cell)
        buf = io.BytesIO()
        JParameters.from_topology(jtopo.Topology([jcost]), seed=0).to_tar(buf)
        tar = buf.getvalue()
        jsgd = jtrainer.SGD(cost=jcost,
                            parameters=JParameters.from_tar(io.BytesIO(tar)),
                            update_equation=jopt.Momentum(
                                momentum=0.9, learning_rate=0.01))
        jcosts = _train(jsgd, jevent, jminibatch, batches)
        tcost = _port_classifier(cell)
        tparams = TParameters.from_tar(io.BytesIO(tar), device="cpu")
        tsgd = ttrainer.SGD(tcost, tparams, topt.Momentum(
            momentum=0.9, learning_rate=0.01), device="cpu")
        tcosts = _train(tsgd, tevent, tminibatch, batches)
    final_j = {k: np.asarray(v) for k, v in jsgd.parameters.as_dict().items()}
    final_t = {k: tsgd.parameters.get(k) for k in tsgd.parameters.keys()}
    return jcosts, tcosts, final_j, final_t


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_training_matches_jax_f32(cell):
    jcosts, tcosts, final_j, final_t = _train_both(cell, False)
    assert len(jcosts) == len(tcosts) == len(BATCH_LENS)
    np.testing.assert_allclose(tcosts, jcosts, rtol=1e-4)
    assert set(final_t) == set(final_j)
    for k in final_j:
        np.testing.assert_allclose(final_t[k], final_j[k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_training_matches_jax_bf16_policy(cell):
    jcosts, tcosts, final_j, final_t = _train_both(cell, True)
    np.testing.assert_allclose(tcosts, jcosts, rtol=1e-4)
    for k in final_j:
        err = np.linalg.norm(final_t[k] - final_j[k])
        assert err <= 1e-4 * np.linalg.norm(final_j[k]), (k, err)


def test_text_lstm_names_match_jax_and_fused_route_taken():
    """The port's text_lstm declares the JAX package's parameters (names
    and shapes), and its LSTM layers take the fused step: B5's plain
    version runs 2 layers x 16 steps a forward."""
    jspecs = jtopo.Topology([_jax_classifier("lstm")]).param_specs()
    tcost = _port_classifier("lstm")
    tspecs = ttopo.Topology([tcost]).param_specs()
    assert {k: tuple(s.shape) for k, s in jspecs.items()} == \
        {k: tuple(s.shape) for k, s in tspecs.items()}
    assert sorted(tspecs) == sorted([
        "embedding_0.w", "lstm0_input_proj.w0", "lstm0_input_proj.b",
        "lstm0.w", "lstm0.b", "lstm1_input_proj.w0", "lstm1_input_proj.b",
        "lstm1.w", "lstm1.b", "fc_0.w0", "fc_0.b"])
    calls = []
    old = trnn.lstm_step_reference

    def counted(*a, **k):
        calls.append(k.get("save_acts"))
        return old(*a, **k)

    trnn.lstm_step_reference = counted
    try:
        params = TParameters.from_topology(ttopo.Topology([tcost]), seed=0,
                                           device="cpu")
        sgd = ttrainer.SGD(tcost, params, topt.Momentum(
            momentum=0.9, learning_rate=0.01), device="cpu")
        costs = _train(sgd, tevent, tminibatch, [_batches()[0]] * 4)
    finally:
        trnn.lstm_step_reference = old
    assert len(calls) == 2 * 16 * 4 and all(calls)
    assert np.all(np.isfinite(costs)) and costs[-1] < costs[0]

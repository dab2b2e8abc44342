"""The v2 training loop's workloads that ``chip_smoke.py`` drives, and the
evaluator cases the card and the CPU tests share.

* ``v2_sentiment``: IMDB sentiment, bench.py's ``text_lstm`` at its width
  (embedding 128, 2 x LSTM of 512, max pooling, fc(2)) over
  ``dataset.imdb.word_dict()`` (5147 words offline), fed by
  ``batch(reader.shuffle(imdb.train(word_dict), 2048), 64)`` with
  ``imdb.test`` as the test reader, trained with the PaddlePaddle book's
  sentiment optimizer, ``Adam(2e-3, L2Regularization(8e-4),
  ModelAverage(0.5))``, with ``classification_error`` and ``auc``
  (over the softmax of the logits) as extra layers.
* ``v2_resnet50``: ResNet-50 at 224 px, batch 128, the bf16 policy, fed
  flat CHW samples through a reader (4 training batches, 2 test batches),
  bench.py's ``Momentum(0.9)`` at 0.01 with He et al. (2016)'s weight
  decay ``L2Regularization(1e-4)`` and a ``discexp`` schedule of 0.1 every
  300274 steps (30 ImageNet epochs of 1,281,167 images at batch 128),
  top-1 and top-5 ``classification_error``.
* ``v2_mnist``: BASELINE #1, ``models/lenet``, fed by
  ``batch(reader.shuffle(dataset.mnist.train(), 8192), 128)``, the book's
  digits optimizer ``Momentum(0.1 / 128, 0.9, L2Regularization(0.0005 *
  128))``, one pass, then ``test`` on ``mnist.test()`` and ``infer``.
* ``optimizers``: LeNet in f32 under each of the nine rules with every
  lever (:data:`LEVERS`), card against the CPU path.
* ``evaluators``: :data:`EVALUATOR_CASES`, each a function taking a
  package (the port, or in the CPU tests the JAX package) and giving the
  metric node and its samples.

The datasets' downloads are refused inside :func:`offline`: every run
takes the seeded synthetic fallbacks, and none reaches the network.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import math
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

SEED = 0


@contextlib.contextmanager
def offline():
    """The port's datasets fall back to their synthetic samples: their
    ``common.download`` refuses for the block."""
    from paddle_tpu_torch.dataset import common

    def refuse(url, module_name, md5sum):
        raise IOError(f"offline: {url} is not fetched")

    saved = common.download
    common.download = refuse
    try:
        yield
    finally:
        common.download = saved


def frames(batch, minimum: int = 16) -> int:
    """The recurrent frames one scan runs on ``batch``: the feeder's
    ``max_len`` bucket (the least power of two, at least 16, over the
    longest sequence)."""
    longest = max(len(s[0]) for s in batch)
    cap = minimum
    while cap < longest:
        cap *= 2
    return cap


class FrameLog:
    """Records the frames of every batch a wrapped reader yields."""

    def __init__(self):
        self.frames: List[int] = []

    def wrap(self, reader):
        def logged():
            for b in reader():
                self.frames.append(frames(b))
                yield b
        return logged


# ---------------------------------------------------------------------------
# v2_sentiment
# ---------------------------------------------------------------------------

SENTIMENT = dict(embed_size=128, hidden=512, num_layers=2, num_classes=2)
SENTIMENT_BATCH, SENTIMENT_BUF, SENTIMENT_PASSES = 64, 2048, 2
ADAM_LR, SENTIMENT_L2, AVERAGE_WINDOW = 2e-3, 8e-4, 0.5
SENTIMENT_FEEDING = {"words": 0, "label": 1}


def sentiment_graph(dict_size: int, **cfg):
    """(cost, [error, auc]) of the classifier over ``dict_size`` words."""
    from paddle_tpu_torch import activation, evaluator, layer
    from paddle_tpu_torch.models import text_lstm

    _, label, logits, cost = text_lstm.build(dict_size=dict_size,
                                             **dict(SENTIMENT, **cfg))
    probs = layer.mixed(input=[layer.identity_projection(logits)],
                        act=activation.SoftmaxActivation(), name="probs")
    return cost, [evaluator.classification_error(input=logits, label=label,
                                                 name="error"),
                  evaluator.auc(input=probs, label=label, name="auc")]


def sentiment_optimizer(levers: bool = True):
    """The book's Adam with L2 and model averaging (``levers``), or the
    same Adam alone."""
    from paddle_tpu_torch import optimizer

    if not levers:
        return optimizer.Adam(learning_rate=ADAM_LR)
    return optimizer.Adam(
        learning_rate=ADAM_LR,
        regularization=optimizer.L2Regularization(SENTIMENT_L2),
        model_average=optimizer.ModelAverage(average_window=AVERAGE_WINDOW))


def sentiment_trainer(device, dict_size: int, levers: bool = True,
                      seed: int = SEED, **cfg):
    from paddle_tpu_torch import topology, trainer
    from paddle_tpu_torch.parameters import Parameters

    topology.reset_name_scope()
    cost, extra = sentiment_graph(dict_size, **cfg)
    params = Parameters.from_topology(topology.Topology([cost]), seed=seed,
                                      device=device)
    return trainer.SGD(cost, params, sentiment_optimizer(levers),
                       extra_layers=extra, device=device)


def sentiment_readers(word_dict, batch: int = SENTIMENT_BATCH):
    """(training reader, test reader) over IMDB's samples."""
    from paddle_tpu_torch import minibatch, reader
    from paddle_tpu_torch.dataset import imdb

    train = minibatch.batch(reader.shuffle(imdb.train(word_dict),
                                           buf_size=SENTIMENT_BUF), batch)
    return train, minibatch.batch(imdb.test(word_dict), batch)


# ---------------------------------------------------------------------------
# v2_resnet50
# ---------------------------------------------------------------------------

RESNET = "resnet50"
RESNET_TRAIN_BATCHES, RESNET_TEST_BATCHES = 4, 2
RESNET_MOMENTUM, RESNET_LR, RESNET_L2 = 0.9, 0.01, 1e-4
# 0.1 every 30 ImageNet epochs: 30 x 1,281,167 images / 128 a step
DISCEXP_A, DISCEXP_B = 0.1, float(math.ceil(30 * 1281167 / 128))


def resnet_optimizer(l2: bool = True):
    from paddle_tpu_torch import optimizer

    return optimizer.Momentum(
        momentum=RESNET_MOMENTUM, learning_rate=RESNET_LR,
        regularization=optimizer.L2Regularization(RESNET_L2) if l2
        else None,
        learning_rate_schedule="discexp", learning_rate_decay_a=DISCEXP_A,
        learning_rate_decay_b=DISCEXP_B)


def resnet_trainer(device, l2: bool = True, seed: int = SEED):
    """ResNet-50 with top-1 and top-5 errors as extra layers."""
    from paddle_tpu_torch import evaluator, topology, trainer
    from paddle_tpu_torch.models import resnet
    from paddle_tpu_torch.parameters import Parameters
    from paddle_tpu_torch.tools import image_workload as iw

    topology.reset_name_scope()
    _, label, logits, cost = resnet.build(
        **iw.MODELS[RESNET]["kw"], img_size=iw.MODELS[RESNET]["img"])
    extra = [evaluator.classification_error(input=logits, label=label,
                                            top_k=1, name="top1_error"),
             evaluator.classification_error(input=logits, label=label,
                                            top_k=5, name="top5_error")]
    params = Parameters.from_topology(topology.Topology([cost]), seed=seed,
                                      device=device)
    return trainer.SGD(cost, params, resnet_optimizer(l2),
                       extra_layers=extra, device=device)


def resnet_batches(first_seed: int, n: int) -> list:
    """``n`` batches of flat CHW samples (``image_workload.flat_samples``)."""
    from paddle_tpu_torch.tools import image_workload as iw

    return [iw.flat_samples(RESNET, first_seed + i) for i in range(n)]


# ---------------------------------------------------------------------------
# v2_mnist
# ---------------------------------------------------------------------------

MNIST_BATCH, MNIST_BUF = 128, 8192
MNIST_LR, MNIST_MOMENTUM, MNIST_L2 = 0.1 / 128, 0.9, 0.0005 * 128
MNIST_INFER = 16


def mnist_trainer(device, seed: int = SEED):
    """(LeNet's SGD with its error as an extra layer, the logits node)."""
    from paddle_tpu_torch import evaluator, optimizer, topology, trainer
    from paddle_tpu_torch.models import lenet
    from paddle_tpu_torch.parameters import Parameters

    topology.reset_name_scope()
    _, label, logits, cost = lenet.build()
    params = Parameters.from_topology(topology.Topology([cost]), seed=seed,
                                      device=device)
    opt = optimizer.Momentum(
        learning_rate=MNIST_LR, momentum=MNIST_MOMENTUM,
        regularization=optimizer.L2Regularization(MNIST_L2))
    err = evaluator.classification_error(input=logits, label=label,
                                         name="error")
    return trainer.SGD(cost, params, opt, extra_layers=[err],
                       device=device), logits


def mnist_readers(batch: int = MNIST_BATCH):
    from paddle_tpu_torch import minibatch, reader
    from paddle_tpu_torch.dataset import mnist

    return (minibatch.batch(reader.shuffle(mnist.train(),
                                           buf_size=MNIST_BUF), batch),
            minibatch.batch(mnist.test(), batch))


# ---------------------------------------------------------------------------
# optimizers: every rule and lever on LeNet, card against the CPU path
# ---------------------------------------------------------------------------

RULES = {
    "Sgd": {},
    "Momentum": {"momentum": 0.9},
    "SparseMomentum": {"momentum": 0.9, "decay_rate": 0.01},
    "Adagrad": {},
    "AdaDelta": {},
    "RMSProp": {},
    "DecayedAdagrad": {},
    "Adam": {},
    "Adamax": {},
}
OPT_LR, OPT_STEPS, OPT_BATCH = 0.01, 3, 64
# every lever at once: L1 and L2 decay, a global clip far below LeNet's
# gradient norm, a manual schedule with a break inside the 3 steps, model
# averaging; per parameter a clip and a pruning hook (the first fc), an
# L2 override (the first conv), a static tensor and a rate multiplier
LEVERS = dict(learning_rate_schedule="manual",
              learning_rate_args="1:1.0,10:0.5",
              gradient_clipping_threshold=0.1)
PARAM_LEVERS = {
    "fc": dict(gradient_clipping_threshold=1e-3, update_hooks=dict(
        type="pruning", sparsity_ratio=0.5)),
    "conv0.w": dict(l2_decay=1e-2),
    "conv1.b": dict(is_static=True),
    "logits": dict(learning_rate=2.0),
}


def _lever_attrs(topo) -> None:
    """Put :data:`PARAM_LEVERS` on LeNet's parameter specs (a key is a
    parameter name's prefix or the name itself)."""
    from paddle_tpu_torch.attr import HookAttr

    conv = [n for n in topo.nodes if n.layer_type == "conv"]
    fcs = [n for n in topo.nodes if n.layer_type == "fc"]
    where = {"conv0": conv[0], "conv1": conv[1], "fc": fcs[0],
             "logits": fcs[1]}
    for key, kw in PARAM_LEVERS.items():
        node = where[key.split(".")[0]]
        pnames = [key.split(".")[1]] if "." in key else \
            [p for p in node.params if p.startswith("w")]
        for pn in pnames:
            spec = node.params[pn]
            kw = dict(kw)
            hooks = kw.pop("update_hooks", None)
            spec.attr = dataclasses.replace(
                spec.attr, update_hooks=None if hooks is None
                else HookAttr(**hooks), **kw)


def lever_trainer(rule: str, device, arrays=None):
    """(LeNet's SGD in f32 under ``rule`` with every lever, its feeds) on
    ``device``; ``arrays`` (name -> numpy) gives the weights, else seed
    :data:`SEED`'s."""
    from paddle_tpu_torch import optimizer, topology, trainer
    from paddle_tpu_torch.convert import parameters_from_numpy
    from paddle_tpu_torch.models import lenet
    from paddle_tpu_torch.parameters import Parameters
    from paddle_tpu_torch.tools import image_workload as iw

    topology.reset_name_scope()
    *_, cost = lenet.build()
    topo = topology.Topology([cost])
    _lever_attrs(topo)
    if arrays is None:
        params = Parameters.from_topology(topo, seed=SEED, device=device)
    else:
        params = parameters_from_numpy(arrays, device=device)
    opt = getattr(optimizer, rule)(
        learning_rate=OPT_LR, **RULES[rule], **LEVERS,
        regularization=optimizer.L1L2Regularization(1e-4, 5e-4),
        model_average=optimizer.ModelAverage(average_window=0.01))
    sgd = trainer.SGD(cost, params, opt, device=device)
    feeds = iw.device_feeds("lenet", device, seed=SEED + 1, batch=OPT_BATCH)
    return sgd, feeds


def on_both(rule: str, device):
    """(the card trainer, the CPU trainer) after :data:`OPT_STEPS` steps
    in which the CPU trainer's optimizer applies the card's own
    gradients to its copy of the weights: what differs is the update's
    arithmetic alone."""
    cpu, _ = lever_trainer(rule, "cpu")
    arrays = {k: v.detach().numpy().copy()
              for k, v in cpu.parameters.as_dict().items()}
    card, feeds = lever_trainer(rule, device, arrays)
    apply = card.optimizer.apply
    cpu_params = {k: cpu.parameters[k] for k in cpu._names}

    def both(params, grads, state):
        cpu.optimizer.apply(cpu_params, {
            k: None if g is None else g.detach().cpu()
            for k, g in grads.items()}, cpu.opt_state)
        apply(params, grads, state)

    card.optimizer.apply = both
    for _ in range(OPT_STEPS):
        card.step(feeds)
    card.optimizer.apply = apply
    return card, cpu


def independent(rule: str, device):
    """(the card trainer, the CPU trainer) after :data:`OPT_STEPS` steps
    from the same weights, each on its own gradients."""
    cpu, cpu_feeds = lever_trainer(rule, "cpu")
    arrays = {k: v.detach().numpy().copy()
              for k, v in cpu.parameters.as_dict().items()}
    card, feeds = lever_trainer(rule, device, arrays)
    for _ in range(OPT_STEPS):
        cpu.step(cpu_feeds)
        card.step(feeds)
    return card, cpu


def state_errors(card, cpu) -> Dict[str, float]:
    """Each optimizer tensor's error (card against CPU) in norm relative
    to its norm; the prune masks compare exactly (0 or 1)."""
    got, want = optimizer_state_tensors(card), optimizer_state_tensors(cpu)
    out = {}
    for k, w in want.items():
        g = got[k].detach().cpu()
        w = w.detach()
        if k.startswith("prune_masks"):
            out[k] = 0.0 if torch.equal(g, w) else 1.0
        else:
            out[k] = float((g.double() - w.double()).norm() /
                           w.double().norm().clamp_min(1e-30))
    return out


def grad_norm(sgd, feeds) -> float:
    """The global norm of the cost's gradient at the trainer's weights
    (no update): the clip binds below it."""
    from paddle_tpu_torch import trainer

    params = {k: sgd.parameters[k].detach().requires_grad_(True)
              for k in sgd._names}
    outs, _ = sgd.topology.forward_with_state(params, sgd.model_state, feeds,
                                              train=True)
    grads = torch.autograd.grad(trainer._reduce_cost(outs[0]),
                                list(params.values()), allow_unused=True)
    return float(torch.sqrt(sum(torch.sum(torch.square(g))
                                for g in grads if g is not None)))


def optimizer_state_tensors(sgd) -> Dict[str, torch.Tensor]:
    """Every parameter, slot, average and mask of a trainer, by a flat
    name."""
    st = sgd.opt_state
    out = {f"param/{k}": v for k, v in sgd.parameters.as_dict().items()}
    for s, d in st["slots"].items():
        out.update({f"slot/{s}/{k}": v for k, v in d.items()})
    for key in ("avg", "prune_masks"):
        out.update({f"{key}/{k}": v for k, v in st.get(key, {}).items()})
    out.update({f"sm/{k}": v for k, v in st.get("sm", {}).items()})
    return out


BIG_PRUNE_SHAPE = (4097, 4096)        # 16,781,312 > 2^24 elements


# ---------------------------------------------------------------------------
# evaluators: cases for the card and the CPU tests
# ---------------------------------------------------------------------------

def _rng(name: str) -> np.random.RandomState:
    return np.random.RandomState(sorted(EVALUATOR_CASES).index(name) + 7)


def _tied(rng, shape, levels=3):
    """Scores on a few levels: many exact ties."""
    return (rng.randint(0, levels, size=shape) / float(levels)).astype(
        np.float32)


def _seqs(rng, n, lo, hi):
    return [int(rng.randint(lo, hi + 1)) for _ in range(n)]


def _case_error(pkg, name, top_k=1, weighted=False):
    rng = _rng(name)
    L, dt, ev = pkg.layer, pkg.data_type, pkg.evaluator
    classes = 10 if top_k > 1 else 5
    x = L.data(name="x", type=dt.dense_vector(classes))
    y = L.data(name="y", type=dt.integer_value(classes))
    ins = [x, y]
    w = None
    if weighted:
        w = L.data(name="w", type=dt.dense_vector(1))
        ins.append(w)
    node = ev.classification_error(input=x, label=y, top_k=top_k, weight=w,
                                   name=name)
    xs = _tied(rng, (24, classes))
    ys = rng.randint(0, classes, 24)
    ws = rng.rand(24, 1).astype(np.float32)
    samples = [tuple([xs[i], int(ys[i])] + ([ws[i]] if weighted else []))
               for i in range(24)]
    return node, samples


def _case_seq_error(pkg, name, per_sequence=False):
    rng = _rng(name)
    L, dt, ev = pkg.layer, pkg.data_type, pkg.evaluator
    x = L.data(name="x", type=dt.dense_vector_sequence(4))
    y = L.data(name="y", type=dt.integer_value_sequence(4))
    fn = ev.seq_classification_error if per_sequence else \
        ev.classification_error
    node = fn(input=x, label=y, name=name)
    samples = []
    for n in _seqs(rng, 7, 1, 6):
        samples.append((list(_tied(rng, (n, 4))),
                        rng.randint(0, 4, n).tolist()))
    return node, samples


def _case_sum(pkg, name, seq=False):
    rng = _rng(name)
    L, dt, ev = pkg.layer, pkg.data_type, pkg.evaluator
    x = L.data(name="x", type=dt.dense_vector_sequence(3) if seq
               else dt.dense_vector(3))
    node = ev.sum(input=x, name=name)
    if seq:
        return node, [(list(rng.randn(n, 3).astype(np.float32)),)
                      for n in _seqs(rng, 5, 1, 5)]
    return node, [(rng.randn(3).astype(np.float32),) for _ in range(9)]


def _case_column_sum(pkg, name):
    rng = _rng(name)
    x = pkg.layer.data(name="x", type=pkg.data_type.dense_vector(6))
    node = pkg.evaluator.column_sum(input=x, name=name)
    return node, [(rng.randn(6).astype(np.float32),) for _ in range(9)]


def _case_auc(pkg, name):
    rng = _rng(name)
    L, dt = pkg.layer, pkg.data_type
    x = L.data(name="x", type=dt.dense_vector(2))
    y = L.data(name="y", type=dt.integer_value(2))
    node = pkg.evaluator.auc(input=x, label=y, name=name)
    s = _tied(rng, (40,), levels=4)
    ys = rng.randint(0, 2, 40)
    return node, [(np.array([1 - s[i], s[i]], np.float32), int(ys[i]))
                  for i in range(40)]


def _case_rankauc(pkg, name):
    rng = _rng(name)
    L, dt = pkg.layer, pkg.data_type
    x = L.data(name="x", type=dt.dense_vector(1))
    y = L.data(name="y", type=dt.integer_value(2))
    w = L.data(name="w", type=dt.dense_vector(1))
    node = pkg.evaluator.rankauc(input=x, label=y, weight=w, name=name)
    s = _tied(rng, (40, 1), levels=5)
    ys = rng.randint(0, 2, 40)
    ws = (0.5 + rng.rand(40, 1)).astype(np.float32)
    return node, [(s[i], int(ys[i]), ws[i]) for i in range(40)]


def _case_pnpair(pkg, name):
    rng = _rng(name)
    L, dt = pkg.layer, pkg.data_type
    x = L.data(name="x", type=dt.dense_vector(1))
    y = L.data(name="y", type=dt.integer_value(3))
    q = L.data(name="q", type=dt.integer_value(4))
    node = pkg.evaluator.pnpair(input=x, label=y, query_id=q, name=name)
    s = _tied(rng, (32, 1), levels=4)
    return node, [(s[i], int(rng.randint(3)), int(rng.randint(4)))
                  for i in range(32)]


def _case_precision_recall(pkg, name):
    rng = _rng(name)
    L, dt = pkg.layer, pkg.data_type
    x = L.data(name="x", type=dt.dense_vector(2))
    y = L.data(name="y", type=dt.integer_value(2))
    node = pkg.evaluator.precision_recall(input=x, label=y, name=name)
    xs = rng.randn(30, 2).astype(np.float32)
    return node, [(xs[i], int(rng.randint(2))) for i in range(30)]


CHUNK_TYPES = 3


def _case_chunk(pkg, name, scheme="IOB", dense=False):
    rng = _rng(name)
    L, dt = pkg.layer, pkg.data_type
    tags = 2 * CHUNK_TYPES + 1 if scheme == "IOB" else CHUNK_TYPES + 1
    x = L.data(name="x", type=dt.dense_vector_sequence(tags) if dense
               else dt.integer_value_sequence(tags))
    y = L.data(name="y", type=dt.integer_value_sequence(tags))
    node = pkg.evaluator.chunk(input=x, label=y,
                               num_chunk_types=CHUNK_TYPES,
                               chunk_scheme=scheme, name=name)
    samples = []
    for n in _seqs(rng, 6, 1, 9):
        lab = rng.randint(0, tags, n)
        # the prediction agrees with the label on about half the tokens
        pred = np.where(rng.rand(n) < 0.5, lab, rng.randint(0, tags, n))
        if dense:
            pred = list(np.eye(tags, dtype=np.float32)[pred] +
                        0.1 * rng.rand(n, tags).astype(np.float32))
        else:
            pred = pred.tolist()
        samples.append((pred, lab.tolist()))
    return node, samples


def _case_ctc(pkg, name):
    rng = _rng(name)
    L, dt = pkg.layer, pkg.data_type
    classes = 5                                   # blank = 4
    x = L.data(name="x", type=dt.dense_vector_sequence(classes))
    y = L.data(name="y", type=dt.integer_value_sequence(classes - 1))
    node = pkg.evaluator.ctc_edit_distance(input=x, label=y, name=name)
    samples = []
    for n, m in zip(_seqs(rng, 6, 1, 12), _seqs(rng, 6, 1, 7)):
        samples.append((list(rng.rand(n, classes).astype(np.float32)),
                        rng.randint(0, classes - 1, m).tolist()))
    return node, samples


def _case_printer(pkg, name, kind):
    rng = _rng(name)
    L, dt, ev = pkg.layer, pkg.data_type, pkg.evaluator
    if kind == "max_frame_printer":
        x = L.data(name="x", type=dt.dense_vector_sequence(3))
        return ev.max_frame_printer(input=x, name=name), [
            (list(rng.randn(n, 3).astype(np.float32)),)
            for n in _seqs(rng, 3, 1, 4)]
    if kind == "seq_text_printer":
        x = L.data(name="x", type=dt.integer_value_sequence(10))
        return ev.seq_text_printer(input=x, name=name), [
            (rng.randint(0, 10, n).tolist(),) for n in _seqs(rng, 3, 1, 4)]
    x = L.data(name="x", type=dt.dense_vector(4))
    xs = _tied(rng, (5, 4))
    if kind == "classification_error_printer":
        y = L.data(name="y", type=dt.integer_value(4))
        return ev.classification_error_printer(input=x, label=y, name=name), \
            [(xs[i], int(rng.randint(4))) for i in range(5)]
    return getattr(ev, kind)(input=x, name=name), [(xs[i],)
                                                    for i in range(5)]


def _case_detection_map(pkg, name):
    """Six examples of up to 4 gt boxes of 3 classes (padded rows class
    -1) and 12 detections: jittered copies of the gts (some of the wrong
    class, some twice), random boxes and empty rows, scores on 4 levels
    (many ties)."""
    rng = _rng(name)
    L, dt = pkg.layer, pkg.data_type
    K, G, classes = 12, 4, 4
    det = L.data(name="det", type=dt.dense_vector(K * 6))
    gt = L.data(name="gt", type=dt.dense_vector(G * 5))
    node = pkg.evaluator.detection_map(detections=det, label=gt,
                                       num_classes=classes, keep_top_k=K,
                                       max_boxes=G, name=name)
    samples = []
    for _ in range(6):
        lo = rng.rand(G, 2) * 0.6
        boxes = np.concatenate([lo, lo + 0.1 + 0.3 * rng.rand(G, 2)], 1)
        cls = rng.randint(1, classes, G).astype(np.float32)
        cls[rng.rand(G) < 0.25] = -1.0
        gts = np.concatenate([cls[:, None], boxes], 1).astype(np.float32)
        rows = []
        for k in range(K):
            kind = rng.randint(4)
            g = rng.randint(G)
            if kind == 3:
                rows.append([-1.0] * 6)
                continue
            box = boxes[g] + 0.03 * rng.randn(4) if kind < 2 else \
                np.sort(rng.rand(2, 2), axis=0).reshape(-1)[[0, 2, 1, 3]]
            label = cls[g] if kind == 0 and cls[g] >= 0 else \
                float(rng.randint(1, classes))
            rows.append([label, rng.randint(1, 5) / 4.0] + list(box))
        samples.append((np.asarray(rows, np.float32).reshape(-1),
                        gts.reshape(-1)))
    return node, samples


EVALUATOR_CASES: Dict[str, Callable] = {
    "error_top1": lambda pkg, n: _case_error(pkg, n),
    "error_top5": lambda pkg, n: _case_error(pkg, n, top_k=5),
    "error_weighted": lambda pkg, n: _case_error(pkg, n, weighted=True),
    "error_packed": lambda pkg, n: _case_seq_error(pkg, n),
    "seq_error": lambda pkg, n: _case_seq_error(pkg, n, per_sequence=True),
    "sum_dense": lambda pkg, n: _case_sum(pkg, n),
    "sum_packed": lambda pkg, n: _case_sum(pkg, n, seq=True),
    "column_sum": _case_column_sum,
    "auc": _case_auc,
    "rankauc": _case_rankauc,
    "pnpair": _case_pnpair,
    "precision_recall": _case_precision_recall,
    "chunk_iob": lambda pkg, n: _case_chunk(pkg, n),
    "chunk_plain": lambda pkg, n: _case_chunk(pkg, n, scheme="plain"),
    "chunk_iob_dense": lambda pkg, n: _case_chunk(pkg, n, dense=True),
    "ctc_edit_distance": _case_ctc,
    "value_printer": lambda pkg, n: _case_printer(pkg, n, "value_printer"),
    "maxid_printer": lambda pkg, n: _case_printer(pkg, n, "maxid_printer"),
    "max_frame_printer":
        lambda pkg, n: _case_printer(pkg, n, "max_frame_printer"),
    "seq_text_printer":
        lambda pkg, n: _case_printer(pkg, n, "seq_text_printer"),
    "classification_error_printer":
        lambda pkg, n: _case_printer(pkg, n, "classification_error_printer"),
    "voc_detection_map": _case_detection_map,
}
# the evaluator each case exercises (the CPU tests' breadth gate)
CASE_EVALUATOR = {
    "error_top1": "classification_error", "error_top5":
    "classification_error", "error_weighted": "classification_error",
    "error_packed": "classification_error",
    "seq_error": "seq_classification_error", "sum_dense": "sum",
    "sum_packed": "sum", "column_sum": "column_sum", "auc": "auc",
    "rankauc": "rankauc", "pnpair": "pnpair",
    "precision_recall": "precision_recall", "chunk_iob": "chunk",
    "chunk_plain": "chunk", "chunk_iob_dense": "chunk",
    "ctc_edit_distance": "ctc_edit_distance",
    "value_printer": "value_printer", "maxid_printer": "maxid_printer",
    "max_frame_printer": "max_frame_printer",
    "seq_text_printer": "seq_text_printer",
    "classification_error_printer": "classification_error_printer",
    "voc_detection_map": "detection_map",
}


def evaluate(name: str, device) -> Tuple[np.ndarray, float, str]:
    """The port's value of case ``name`` on ``device``: (the node's output
    as numpy, valid tokens only for a packed output; the metric the
    trainer reports; what the node printed)."""
    from paddle_tpu_torch import topology
    from paddle_tpu_torch import trainer
    import paddle_tpu_torch as pkg
    from paddle_tpu_torch.data_feeder import DataFeeder
    from paddle_tpu_torch.sequence import SequenceBatch

    topology.reset_name_scope()
    node, samples = EVALUATOR_CASES[name](pkg, name)
    topo = topology.Topology([node])
    feeder = DataFeeder([(n.name, n.input_type) for n in topo.data_nodes],
                        device=device)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), torch.no_grad():
        value = topo.forward({}, feeder.feed(samples))[0]
        metric = float(trainer._metric_scalar(value))
    if isinstance(value, SequenceBatch):
        value = value.data[value.valid_mask]
    return value.detach().cpu().numpy(), metric, out.getvalue()

"""The attention seq2seq NMT workload that ``chip_smoke.py`` drives, in one
place so the script, ``tools/profile_nmt.py`` and
``tests/test_torch_nmt_cuda.py`` run the same configuration.

The model is ``models/seq2seq`` at the width of PaddlePaddle's
demo/seqToseq (``seqToseq_net.py``: word vectors, encoder and decoder
512; beam 3, max_length 250; ``translation/train.conf``: batch 50, Adam at
lr 5e-4) over the WMT-14 dictionaries (30000 words a side, ``<s>`` 0,
``<e>`` 1: ``dataset/wmt14.py``).  The corpus is not in the repository, so
the pairs are synthetic, seeded with numpy and shaped as that dataset
keeps them: source and target lengths uniform in 10-80 (it drops longer
pairs), token ids uniform in [3, 30000), each sample ``(source, <s> +
target, target + <e>)``.  The flags are at their defaults (the bf16
policy: bf16 product inputs, f32 sums).

The encoder's two ``simple_gru`` layers take the one-launch GRU step (B6)
at this width: JAX's plan is its one block and 64 x 2 blocks (B 50) or
64 x 1 (B 16) are co-resident on an H100.  Each scans the padded source
layout, T = the feeder's ``max_len`` bucket (128 for a longest source of
65-80), so a training step launches B6 2 x T times (the backward is the
closed form in plain torch) and so does a generated batch.

Generation bans ``<e>`` (:class:`EosBan`) until each source's drawn target
length, so outputs are as long as the data's, or until ``max_length`` as
the worst case.  The hook keeps each step's beams, from which
:meth:`EosBan.run` finds each beam's parent; :func:`replay` makes the CPU
path follow such a run and checks every step of it.

Usage::

    sgd = build_trainer(torch.device("cuda"))
    cost = sgd.step(feeds(sgd, samples(SEED + 1)))
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from paddle_tpu_torch import data_type, optimizer, topology, trainer
from paddle_tpu_torch.data_feeder import DataFeeder
from paddle_tpu_torch.generation import NEG
from paddle_tpu_torch.inference import Inference
from paddle_tpu_torch.models import seq2seq
from paddle_tpu_torch.parameters import Parameters
from paddle_tpu_torch.platform.enforce import enforce_that
from paddle_tpu_torch.platform.flags import FLAGS
from paddle_tpu_torch.tools import rnn_workload as rw

MODEL = dict(src_dict_size=30000, trg_dict_size=30000, embed_size=512,
             hidden=512)
BOS, EOS = 0, 1                      # wmt14.py START_IDX, END_IDX
FIRST_WORD = 3                       # ids 0-2 are <s>, <e>, <unk>
BATCH, MIN_LEN, MAX_LEN = 50, 10, 80
LEARNING_RATE = 5e-4
BEAM, MAX_LENGTH, GEN_BATCH = 3, 250, 16
SEED = 0                             # weights; batches use SEED + 1 and up
FEEDING = {"source_words": 0, "target_words": 1, "target_next": 2}


def samples(seed: int, bs: int = BATCH, min_len: int = MIN_LEN,
            max_len: int = MAX_LEN, dict_size: int = MODEL["trg_dict_size"]):
    """``bs`` (source, <s> + target, target + <e>) samples, lengths
    uniform in [min_len, max_len], ids uniform in [3, dict_size)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(bs):
        src = rng.randint(FIRST_WORD, dict_size,
                          rng.randint(min_len, max_len + 1)).tolist()
        trg = rng.randint(FIRST_WORD, dict_size,
                          rng.randint(min_len, max_len + 1)).tolist()
        out.append((src, [BOS] + trg, trg + [EOS]))
    return out


def sources(seed: int, n: int = GEN_BATCH, **kw):
    """``n`` one-field (source,) samples for the generator."""
    return [(s,) for s, _, _ in samples(seed, bs=n, **kw)]


def build_trainer(device, seed: int = SEED, update_equation=None, **cfg):
    """``trainer.SGD`` over ``seq2seq.build_train`` with weights from
    ``seed`` (drawn on the host, the same on every device) on ``device``,
    Adam at lr 5e-4 unless ``update_equation`` is given."""
    topology.reset_name_scope()
    cost, _ = seq2seq.build_train(**dict(MODEL, **cfg))
    params = Parameters.from_topology(topology.Topology([cost]), seed=seed,
                                      device=device)
    return trainer.SGD(cost, params, update_equation or
                       optimizer.Adam(learning_rate=LEARNING_RATE),
                       device=device)


def build_generator(beam_size: int = BEAM, max_length: int = MAX_LENGTH,
                    hooks=None, **cfg):
    """The beam-search node of ``seq2seq.build_generator`` (``hooks``: its
    beam-search hooks)."""
    topology.reset_name_scope()
    return seq2seq.build_generator(**dict(MODEL, **cfg), bos_id=BOS,
                                   eos_id=EOS, beam_size=beam_size,
                                   max_length=max_length, **(hooks or {}))


def eos_until(variant: str, seed: int, n: int = GEN_BATCH,
              max_length: int = MAX_LENGTH, **kw) -> np.ndarray:
    """Per source of ``sources(seed, n, **kw)``, the step before which a
    generation ``variant`` bans ``<e>``: "target_lengths", the length of
    the target drawn with it (outputs as long as the data's: 10-80 words
    and ``<e>``), or "eos_banned", ``max_length`` (every beam runs every
    step: the worst case).  A few steps of training make ``<e>`` the
    likeliest word, so with no ban each beam would stop at step 2."""
    if variant == "eos_banned":
        return np.full(n, max_length, np.int64)
    enforce_that(variant == "target_lengths",
                 f"unknown generation variant {variant!r}",
                 context="nmt_workload")
    return np.array([len(t) for _, _, t in samples(seed, bs=n, **kw)],
                    np.int64) - 1


GENERATIONS = ("target_lengths", "eos_banned")


class EosBan:
    """A ``candidate_adjust`` that bans ``<e>`` from row b's beams before
    step ``until[b]``, and keeps what each step starts from (the
    :class:`BeamState` it is shown) and the log-probabilities it hands
    back, for :meth:`run` (:meth:`clear` empties them)."""

    def __init__(self, until):
        self.until = torch.as_tensor(np.asarray(until, np.int64))
        self.clear()

    def clear(self) -> None:
        self.states, self.logps = [], []

    def ban(self, logp, t: int):
        if self.until.device != logp.device:
            self.until = self.until.to(logp.device)
        logp = logp.clone()
        logp[:, :, EOS] = torch.where((t < self.until)[:, None], NEG,
                                      logp[:, :, EOS])
        return logp

    def __call__(self, logp, beam):
        logp = self.ban(logp, beam.t)
        self.states.append(beam)
        self.logps.append(logp)
        return logp

    def run(self, outputs):
        """The run this hook has just seen, for :func:`replay`:
        (``outputs``, each step's beams (tokens, scores, finished,
        lengths) and each step's parents [B, K], the beam of the step each
        new beam continues, all numpy).  A parent is found where the
        step's own total of the new beam's token equals its score, bit for
        bit: ``_totals`` is the beam loop's own arithmetic."""
        tokens, _, scores = outputs
        steps = len(self.states)
        dev = self.states[0].scores.device
        news = [(s.tokens, s.scores) for s in self.states[1:]] + [(
            torch.as_tensor(tokens[:, :, steps - 1], dtype=torch.long,
                            device=dev), torch.as_tensor(scores, device=dev))]
        hits = []
        for state, logp, (tok, score) in zip(self.states, self.logps, news):
            total = _totals(state.scores, state.finished, logp)
            hits.append(total.gather(2, tok[:, None, :].expand(
                -1, total.shape[1], -1)) == score[:, None, :])
        hits = torch.stack(hits).cpu().numpy()      # [steps, B, K, K]
        toks = np.stack([x[0].cpu().numpy() for x in news])
        parents = np.empty(toks.shape, np.int64)
        for t, b in np.ndindex(toks.shape[:2]):
            # equal totals of one token from two beams: the sort put the
            # lower beam first
            used = set()
            for j, tok in enumerate(toks[t, b]):
                cand = [p for p in np.flatnonzero(hits[t, b, :, j])
                        if (p, tok) not in used]
                enforce_that(bool(cand), f"step {t}: a beam's score is no "
                             "total of the step before",
                             context="nmt_workload")
                parents[t, b, j] = cand[0]
                used.add((cand[0], tok))
        states = [tuple(x.cpu().numpy() for x in s[1:]) for s in self.states]
        return outputs, states, parents


def _totals(scores, finished, logp):
    """Each candidate's total, as ``beam_search`` sums it: a finished
    beam continues only by ``<e>`` at cost 0."""
    V = logp.shape[-1]
    if isinstance(logp, np.ndarray):
        eos_only = np.where(np.arange(V) == EOS, 0.0, NEG).astype(logp.dtype)
        return scores[..., None] + np.where(finished[..., None], eos_only,
                                            logp)
    eos_only = torch.where(torch.arange(V, device=logp.device) == EOS,
                           0.0, NEG)
    return scores[..., None] + torch.where(finished[..., None], eos_only,
                                           logp)


def generator(params, model_state, device, **kw):
    """(beam node, ``Inference`` over ``params`` and ``model_state`` on
    ``device``): a trainer's weights and state, shared by name."""
    beam = build_generator(**kw)
    return beam, Inference(beam, params, model_state=model_state,
                           device=device)


def repeat_reader(batch, steps: int):
    """A reader that yields the same batch ``steps`` times."""
    return lambda: iter([batch] * steps)


def feeds(sgd, batch):
    """``batch`` through a ``DataFeeder`` of the trainer's data layers."""
    return DataFeeder([(n.name, n.input_type)
                       for n in sgd.topology.data_nodes], FEEDING,
                      device=sgd.device).feed(batch)


def source_frames(batch) -> int:
    """T, the frames each encoder GRU scans for ``batch``: the feeder's
    ``max_len`` bucket of its longest source."""
    feeder = DataFeeder([("source_words", data_type.integer_value_sequence(
        MODEL["src_dict_size"]))], device="cpu")
    return feeder.feed([(s[0],) for s in batch])["source_words"].max_len


def target_tokens(batch) -> int:
    """Target tokens a batch trains on (its ``target_next`` tokens)."""
    return sum(len(s[2]) for s in batch)


@torch.no_grad()
def generate(inference, srcs):
    """(tokens [B, K, L], lengths [B, K], scores [B, K]) as numpy."""
    (out,) = next(inference.iter_infer([srcs]))
    return tuple(t.cpu().numpy() for t in out)


# ---------------------------------------------------------------------------
# the card against the CPU path
# ---------------------------------------------------------------------------

def rel_norm(a: torch.Tensor, b: torch.Tensor) -> float:
    """|a - b| / |b| in float64."""
    return float((a.double() - b.double()).norm() /
                 b.double().norm().clamp_min(1e-30))


def step_parity(dev, batch, seed: int = SEED, lr: float = 0.01,
                **cfg) -> dict:
    """One f32 training step on ``dev`` against the same step on the CPU
    path: the same weights (drawn from ``seed``) and batch.  The update
    is momentum SGD's first, -lr g, so each parameter's update is its
    gradient's image (Adam's first update, lr g / (|g| + eps), is a sign
    for most elements, flipped by the rounding of any gradient near 0)."""
    with f32_policy():
        sgds = [build_trainer(d, seed, optimizer.Momentum(
            momentum=0.9, learning_rate=lr), **cfg)
            for d in (dev, torch.device("cpu"))]
        start = {k: v.detach().cpu().clone()
                 for k, v in sgds[1].parameters.items()}
        before = rw.launches()["gru_step"]
        card_cost = float(sgds[0].step(feeds(sgds[0], batch)))
        b6 = rw.launches()["gru_step"] - before
        cpu_cost = float(sgds[1].step(feeds(sgds[1], batch)))
    updates = {k: rel_norm(sgds[0].parameters[k].detach().cpu() - v,
                           sgds[1].parameters[k].detach() - v)
               for k, v in start.items()}
    worst = max(updates, key=updates.get)
    return {"card_cost": card_cost, "cpu_cost": cpu_cost,
            "cost_rel_diff": abs(card_cost - cpu_cost) / abs(cpu_cost),
            "update_max_rel_diff": updates[worst], "update_worst": worst,
            "update_median_rel_diff": float(np.median(list(
                updates.values()))),
            "b6_launches": b6, "source_frames": source_frames(batch)}


def runs_equal(a, b) -> bool:
    """Whether two recorded runs (:meth:`EosBan.run`) are the same bits."""
    def arrays(run):
        return list(run[0]) + [x for s in run[1] for x in s] + [run[2]]

    return len(a[1]) == len(b[1]) and all(
        np.array_equal(x, y) for x, y in zip(arrays(a), arrays(b)))


@contextlib.contextmanager
def f32_policy():
    """The bf16 policy off (f32 product inputs) for the block."""
    old = FLAGS.use_bf16
    FLAGS.use_bf16 = False
    try:
        yield
    finally:
        FLAGS.use_bf16 = old


# Each step of a recorded run against the CPU path made to follow it:
# where the path's own K best differ from the run's choices, their totals
# apart (``gap``), and each chosen beam's score against the run's previous
# score plus the path's log-probability (``dev``), each within ``atol``
# plus the f32 spacing of the totals (the beam ranks f32 sums: totals
# within one spacing round alike, and then the lower index goes first).
# With the policy off, the two sides sum the same products in other
# orders, and ``TIE_ATOL`` holds every step.
TIE_ATOL = 1e-4
# Under the bf16 policy each product input is rounded to 8 significant
# bits; where the two sides' f32 values straddle a rounding point, they
# round one bf16 step (2^-8 of the value) apart, and the decoder's
# memories carry every such flip on to the later steps: up to 2.7e-4 in
# 250 steps on an NVIDIA H100 80GB HBM3 at 700 W.  A change of the
# weights by 0.1% moves them by more (``tests/test_torch_nmt_cuda.py``).
BF16_ATOL = 1e-3
# the final scores of the same paths: up to 250 f32 additions, each
# rounding both sides at 6e-8 of the sum, besides each step's difference
# (``atol`` of a log-probability of ~10)
SCORE_RTOL = 1e-5


class Replay(EosBan):
    """The ``candidate_adjust`` that makes a generation follow a recorded
    ``run`` (:meth:`EosBan.run`) of the same sources and ban, checking
    every step on the way: it ranks the candidates by the run's scores
    plus its own log-probabilities (float64), compares its K best with
    the run's choices, then leaves only those choices open.  So every
    step starts from the run's beams, and the next step finds them by
    their token and score, bit for bit."""

    def __init__(self, until, run, atol: float = TIE_ATOL):
        super().__init__(until)
        (tokens, lengths, scores), states, parents = run
        steps = len(states)
        self.run_scores = [s[1] for s in states]
        self.after = [s[:2] for s in states[1:]] + [
            (tokens[:, :, steps - 1].astype(np.int64), scores)]
        self.parents = parents
        self.final = (tokens, lengths, scores)
        self.atol = atol
        B, K = scores.shape
        self.slots = np.tile(np.arange(K), (B, 1))  # run's beam -> ours
        self.expect = None      # (tokens, scores, parents) of our next beams
        self.steps = []         # (gap, dev, worst over limit, rows apart)
        self.first_apart = None
        self.lost = None

    def _find(self, tokens, scores):
        """Our slot of each of the run's beams, by the expected token and
        score; None where one is missing.  Beams of one token and score
        stand in the order of their parents."""
        want_t, want_s, parent = self.expect
        slots = np.empty_like(self.slots)
        for b in range(tokens.shape[0]):
            free = list(range(tokens.shape[1]))
            for j in np.argsort(parent[b], kind="stable"):
                hit = [i for i in free if tokens[b, i] == want_t[b, j] and
                       scores[b, i] == want_s[b, j]]
                if not hit:
                    return None
                slots[b, j] = hit[0]
                free.remove(hit[0])
        return slots

    def __call__(self, logp, beam):
        logp = self.ban(logp, beam.t)
        t = beam.t
        if self.lost is not None:
            return logp
        if t >= len(self.after):
            self.lost = {"step": t, "why": "past the run's last step"}
            return logp
        tokens, scores, finished = (x.cpu().numpy() for x in beam[1:4])
        if t > 0:
            slots = self._find(tokens, scores)
            if slots is None:
                self.lost = {"step": t, "why": "a beam of the run is gone"}
                return logp
            self.slots = slots
        lp = logp.cpu().numpy()
        total32 = _totals(scores, finished, lp)
        B, K, V = lp.shape
        run_scores = np.empty((B, K))
        np.put_along_axis(run_scores, self.slots, self.run_scores[t], 1)
        total = run_scores[..., None] + _totals(
            np.zeros((B, K)), finished, lp.astype(np.float64))
        new_tok, new_score = self.after[t]
        par = np.take_along_axis(self.slots, self.parents[t], 1)
        bix = np.arange(B)[:, None]
        chosen = total[bix, par, new_tok]
        flat = total.reshape(B, K * V)
        own = -np.sort(np.partition(-flat, K - 1, axis=1)[:, :K], axis=1)
        gap = np.abs(own - np.sort(chosen, axis=1)[:, ::-1]).max(1)
        dev = np.abs(chosen - new_score).max(1)
        limit = self.atol + np.spacing(np.abs(own).max(1).astype(np.float32))
        over = np.maximum(gap, dev) / limit
        apart = np.flatnonzero(gap > 0)
        if apart.size and self.first_apart is None:
            b = int(apart[0])
            self.first_apart = {"step": t, "row": b, "gap": float(gap[b]),
                                "limit": float(TIE_ATOL + np.spacing(
                                    np.float32(np.abs(own[b]).max())))}
        self.steps.append((float(gap.max()), float(dev.max()),
                           float(over.max()), int(apart.size)))
        forced = np.full(lp.shape, NEG, np.float32)
        forced[bix, par, new_tok] = lp[bix, par, new_tok]
        self.expect = (new_tok, total32[bix, par, new_tok], par)
        return torch.from_numpy(forced).to(logp.device)

    def report(self, outputs) -> dict:
        """The check of the whole run, from our ``outputs``."""
        tokens, lengths, scores = outputs
        rt, rl, rs = self.final
        slots = None
        if self.lost is None and self.expect is not None:
            slots = self._find(tokens[:, :, len(self.after) - 1]
                               .astype(np.int64), scores)
        if slots is None:
            paths, rel = False, float("inf")
            self.lost = self.lost or {"step": len(self.after),
                                      "why": "a final beam of the run is "
                                             "gone"}
        else:
            bix = np.arange(tokens.shape[0])[:, None]
            paths = bool((tokens[bix, slots] == rt).all() and
                         (lengths[bix, slots] == rl).all())
            rel = float(np.max(np.abs(scores[bix, slots] - rs) /
                               np.maximum(1.0, np.abs(rs))))
        steps = np.array(self.steps or [(0.0, 0.0, 0.0, 0)])
        res = {"run_steps": len(self.after), "steps_checked": len(self.steps),
               "lost": self.lost, "atol": self.atol,
               "steps_apart": int((steps[:, 3] > 0).sum()),
               "rows_apart": int(steps[:, 3].sum()),
               "first_apart": self.first_apart,
               "max_gap": float(steps[:, 0].max()),
               "max_dev": float(steps[:, 1].max()),
               "max_over_limit": float(steps[:, 2].max()),
               "paths_equal": paths, "score_rel_diff": rel,
               "score_rtol": SCORE_RTOL}
        res["ok"] = bool(self.lost is None and paths and
                         res["max_over_limit"] <= 1.0 and
                         len(self.steps) == len(self.after) and
                         rel <= SCORE_RTOL)
        return res


def replay(params, model_state, srcs, until, run, atol: float = TIE_ATOL,
           **kw) -> dict:
    """Generate ``srcs`` on the CPU path from ``params`` and
    ``model_state``, made to follow the recorded ``run``: the check of
    every step of it (:class:`Replay`), each within ``atol``."""
    follow = Replay(until, run, atol)
    _, inf = generator(params, model_state, torch.device("cpu"),
                       hooks={"candidate_adjust": follow}, **kw)
    return follow.report(generate(inf, srcs))

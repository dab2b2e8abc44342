"""The full-width serving workload that ``chip_smoke.py`` checks and
``profile_serve`` profiles, in one place so both run the same requests.

The model is the repo's headline transformer (bench.py's d=2048, 8
layers, 16 heads, vocab 32768, seq 1024) as a ``DecoderLM`` with random
weights from a seed.  The engine runs at the flag defaults (page 128, 8
slots, prefill chunk 256, buckets 32..512) with a 129-page pool and 8
pages a sequence.  The requests: seven prompts of 96-896 tokens, one of
them a 512-token prefix plus 64 tokens, all submitted at once, so chunked
prefill shares steps with decode; then an eighth prompt on the same
prefix, submitted once the prefix request has its first token, so its
pages are in the prefix cache.  32 new tokens each, no EOS.

Usage::

    model = build_model(torch.device("cuda"))
    warm_up(model, dev)
    wl = Workload(make_engine(model, dev))
    while not wl.done:
        wl.step()
    outputs = [wl.engine.result(r) for r in wl.rids]
"""

from __future__ import annotations

from typing import List

import numpy as np

MODEL = dict(vocab_size=32768, num_layers=8, num_heads=16, head_dim=128,
             ffn_mult=4, max_positions=1024)
SEED = 0                 # weights; the prompts use SEED + 1
NUM_PAGES = 129          # 128 usable: 16 sequences of 1024 tokens
PAGES_PER_SEQ = 8
NEW_TOKENS = 32
NO_EOS = -1              # random weights: every request runs its full length
PREFIX_LEN = 512
PROMPT_LENS = (96, 200, 350, 640, 777, 896)
PREFIX_REQUEST = 3       # index of the prefix + 64 prompt among the first 7
SHARER_TAIL = 130        # tokens the sharer adds to the prefix


def build_model(dev):
    from paddle_tpu_torch.convert import decoder_lm_from_numpy, \
        init_numpy_params
    from paddle_tpu_torch.serving import DecoderLM

    model = DecoderLM(**MODEL, device=dev)
    return decoder_lm_from_numpy(init_numpy_params(model, SEED), model)


def make_engine(model, dev, **kw):
    from paddle_tpu_torch.serving import ServingEngine

    return ServingEngine(model, eos_id=NO_EOS, num_pages=NUM_PAGES,
                         max_pages_per_seq=PAGES_PER_SEQ, use_kernel=True,
                         device=dev, **kw)


def warm_up(model, dev) -> None:
    """A short serve on its own engine, so a measured serve does not carry
    CUDA/cuBLAS initialisation."""
    from paddle_tpu_torch.serving import ServingEngine

    eng = ServingEngine(model, eos_id=NO_EOS, num_pages=17,
                        max_pages_per_seq=PAGES_PER_SEQ, use_kernel=True,
                        device=dev)
    for n in (300, 20):
        eng.submit(list(range(2, 2 + n)), max_tokens=4)
    eng.run()


def prompts() -> tuple:
    """(the seven first prompts, the sharer), drawn from ``SEED + 1``."""
    rng = np.random.default_rng(SEED + 1)
    vocab = MODEL["vocab_size"]
    prefix = rng.integers(2, vocab, PREFIX_LEN).tolist()
    first = [rng.integers(2, vocab, n).tolist() for n in PROMPT_LENS]
    first.insert(PREFIX_REQUEST, prefix + rng.integers(2, vocab, 64).tolist())
    sharer = prefix + rng.integers(2, vocab, SHARER_TAIL).tolist()
    return first, sharer


class Workload:
    """The requests on one engine.  Construction submits the first seven;
    :meth:`step` ticks the engine and submits the sharer right after the
    tick in which the prefix request produced its first token."""

    MAX_TICKS_TO_SHARER = 64

    def __init__(self, engine):
        self.engine = engine
        first, self._sharer = prompts()
        self.prompts: List[List[int]] = list(first)
        self._first_token: dict = {}
        self.rids = [engine.submit(p, max_tokens=NEW_TOKENS,
                                   on_token=lambda tok, i=i:
                                   self._first_token.setdefault(i, tok))
                     for i, p in enumerate(first)]
        self.sharer_in = False
        self._ticks = 0

    def step(self) -> None:
        self.engine.step()
        self._ticks += 1
        if self.sharer_in:
            return
        if PREFIX_REQUEST in self._first_token:
            self.rids.append(self.engine.submit(self._sharer,
                                                max_tokens=NEW_TOKENS))
            self.prompts.append(self._sharer)
            self.sharer_in = True
        elif self._ticks >= self.MAX_TICKS_TO_SHARER:
            raise AssertionError("the prefix request never finished prefill")

    @property
    def prefill_done(self) -> bool:
        """Every request submitted and none still queued or prefilling."""
        sched = self.engine.scheduler
        return self.sharer_in and not sched.queue and not any(
            r.prefilling for r in sched.running_requests())

    @property
    def done(self) -> bool:
        return self.sharer_in and not self.engine.has_work

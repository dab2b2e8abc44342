"""Linear-CRF sequence tagging, the sequence_tagging demo's chunker (the
port of ``paddle_tpu/models/sequence_tagging.py``): word embeddings, a
context window (``context_projection`` in a ``mixed`` layer), a tanh fc,
emission scores, and a CRF cost with a Viterbi twin sharing the
``crf_tag.*`` parameters."""

from __future__ import annotations

from paddle_tpu_torch import data_type, layer
from paddle_tpu_torch.attr import ParamAttr


def build(vocab_size: int = 2000, num_tags: int = 9, emb_dim: int = 32,
          context_len: int = 5, hidden: int = 64):
    """Returns (word, label, crf_cost, decoded)."""
    word = layer.data(name="word",
                      type=data_type.integer_value_sequence(vocab_size))
    label = layer.data(name="label",
                       type=data_type.integer_value_sequence(num_tags))
    emb = layer.embedding(input=word, size=emb_dim)
    ctx = layer.mixed(
        size=emb_dim * context_len,
        input=[layer.context_projection(input=emb, context_len=context_len,
                                        context_start=-(context_len // 2))])
    feat = layer.fc(input=ctx, size=hidden, act="tanh")
    emission = layer.fc(input=feat, size=num_tags, name="emission")
    shared = ParamAttr(name="crf_tag")
    cost = layer.crf(input=emission, label=label, size=num_tags,
                     param_attr=shared)
    decoded = layer.crf_decoding(input=emission, size=num_tags,
                                 param_attr=shared)
    return word, label, cost, decoded

"""Semantic role labeling: db_lstm, the PaddlePaddle book's chapter 07
model (the port of ``paddle_tpu/models/srl.py``).  Layer and parameter
names are the JAX package's, so weights cross by name through
``convert.parameters_from_numpy``.

The word and its five context words share one embedding table
(``word_emb.w``); the predicate and the mark have their own.  A tanh fc
mixes the eight embeddings, then ``depth`` LSTMs of alternating direction
(layers 1, 3, 5, ... reverse) each read an fc of the previous layer's mix
and LSTM output (``srl.py:53-58``).  An emission fc feeds the CRF cost
and its Viterbi twin, which share the ``srl_crf.*`` parameters.  Every
LSTM runs ``ops/rnn.lstm_scan``, whose step is the fused LSTM kernel at
the default activations.
"""

from __future__ import annotations

from paddle_tpu_torch import data_type, layer
from paddle_tpu_torch.attr import ParamAttr


def build(word_dict_len: int = 4000, label_dict_len: int = 67,
          pred_dict_len: int = 300, word_dim: int = 32, mark_dim: int = 5,
          hidden_dim: int = 128, depth: int = 4):
    """Returns (data_layers, crf_cost, decoded); ``data_layers`` in the
    conll05 9-slot sample's order: word, ctx_n2, ctx_n1, ctx_0, ctx_p1,
    ctx_p2, verb, mark, label."""
    seq = data_type.integer_value_sequence
    word = layer.data(name="word", type=seq(word_dict_len))
    ctxs = [layer.data(name=n, type=seq(word_dict_len))
            for n in ("ctx_n2", "ctx_n1", "ctx_0", "ctx_p1", "ctx_p2")]
    predicate = layer.data(name="verb", type=seq(pred_dict_len))
    mark = layer.data(name="mark", type=seq(2))
    label = layer.data(name="label", type=seq(label_dict_len))

    shared_emb = ParamAttr(name="word_emb.w")
    embs = [layer.embedding(input=x, size=word_dim, param_attr=shared_emb)
            for x in [word] + ctxs]
    embs.append(layer.embedding(input=predicate, size=word_dim))
    embs.append(layer.embedding(input=mark, size=mark_dim))

    hidden = layer.fc(input=embs, size=hidden_dim, act="tanh",
                      name="srl_hidden0")
    lstm = layer.lstmemory(
        input=layer.fc(input=hidden, size=hidden_dim * 4, name="srl_in0"),
        size=hidden_dim, name="srl_lstm0")
    feat = [hidden, lstm]
    for i in range(1, depth):
        mix = layer.fc(input=feat, size=hidden_dim * 4, name=f"srl_in{i}")
        lstm = layer.lstmemory(input=mix, size=hidden_dim,
                               reverse=(i % 2 == 1), name=f"srl_lstm{i}")
        feat = [mix, lstm]

    emission = layer.fc(input=feat, size=label_dict_len, name="srl_emission")
    shared_crf = ParamAttr(name="srl_crf")
    cost = layer.crf(input=emission, label=label, size=label_dict_len,
                     param_attr=shared_crf)
    decoded = layer.crf_decoding(input=emission, size=label_dict_len,
                                 param_attr=shared_crf)
    return [word] + ctxs + [predicate, mark, label], cost, decoded

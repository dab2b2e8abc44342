"""The quick_start text classifiers (the port of
``paddle_tpu/models/quick_start.py``): the seven architectures of
v1_api_demo/quick_start's ``trainer_config.{lr,emb,cnn,lstm,bidi-lstm,
db-lstm,resnet-lstm}.py``, each a sentiment classifier over word ids (a
dense bag of words for ``lr``).  Layer names are the JAX package's.

``lstm``'s dropout (0.25) and ``db_lstm``'s per-layer ``drop_rate`` (0.1)
draw their masks from the step's generator: the same rate, not the JAX
package's bits.
"""

from __future__ import annotations

from paddle_tpu_torch import data_type, layer, pooling
from paddle_tpu_torch.attr import ExtraAttr
from paddle_tpu_torch.networks import (bidirectional_lstm, sequence_conv_pool,
                                       simple_lstm)

ARCHS = ("lr", "emb", "cnn", "lstm", "bidi_lstm", "db_lstm", "resnet_lstm")


def _lr(word, dict_size, emb_size):
    return word          # the bag of words is the dense input itself


def _emb_avg(word, dict_size, emb_size):
    emb = layer.embedding(input=word, size=emb_size)
    return layer.pooling(input=emb, pooling_type=pooling.AvgPooling())


def _cnn(word, dict_size, emb_size):
    emb = layer.embedding(input=word, size=emb_size)
    return sequence_conv_pool(emb, context_len=3, hidden_size=512)


def _lstm(word, dict_size, emb_size):
    emb = layer.embedding(input=word, size=emb_size)
    lstm = layer.dropout(simple_lstm(emb, size=emb_size), 0.25)
    return layer.pooling(input=lstm, pooling_type=pooling.MaxPooling())


def _bidi_lstm(word, dict_size, emb_size):
    emb = layer.embedding(input=word, size=emb_size)
    bi = bidirectional_lstm(emb, size=emb_size)
    return layer.pooling(input=bi, pooling_type=pooling.MaxPooling())


def _db_lstm(word, dict_size, emb_size, depth: int = 4):
    # each level's fc reads [previous fc, previous lstm]
    emb = layer.embedding(input=word, size=emb_size)
    hidden = layer.fc(input=emb, size=emb_size)
    lstm = layer.lstmemory(
        input=layer.fc(input=hidden, size=emb_size * 4, name="db0_proj"),
        size=emb_size, layer_attr=ExtraAttr(drop_rate=0.1))
    inputs = [hidden, lstm]
    for i in range(1, depth):
        fc = layer.fc(input=inputs, size=emb_size)
        lstm = layer.lstmemory(
            input=layer.fc(input=fc, size=emb_size * 4, name=f"db{i}_proj"),
            size=emb_size, reverse=(i % 2) == 1,
            layer_attr=ExtraAttr(drop_rate=0.1))
        inputs = [fc, lstm]
    return layer.pooling(input=lstm, pooling_type=pooling.MaxPooling())


def _resnet_lstm(word, dict_size, emb_size, depth: int = 3):
    # a level's input is the previous input plus the previous LSTM's output
    emb = layer.embedding(input=word, size=emb_size)
    prev_input, prev_hidden = emb, simple_lstm(emb, size=emb_size)
    for i in range(depth):
        cur = layer.addto(input=[prev_input, prev_hidden])
        hidden = simple_lstm(cur, size=emb_size, name=f"res_lstm{i}")
        prev_input, prev_hidden = cur, hidden
    return layer.pooling(input=prev_hidden,
                         pooling_type=pooling.MaxPooling())


_BUILDERS = {
    "lr": _lr, "emb": _emb_avg, "cnn": _cnn, "lstm": _lstm,
    "bidi_lstm": _bidi_lstm, "db_lstm": _db_lstm,
    "resnet_lstm": _resnet_lstm,
}


def build(arch: str = "cnn", dict_size: int = 30000, emb_size: int = 128,
          num_classes: int = 2, **arch_kwargs):
    """Returns (word, label, output, cost) for one of :data:`ARCHS`;
    ``arch_kwargs`` go to the architecture (``depth=`` for db_lstm and
    resnet_lstm)."""
    if arch not in _BUILDERS:
        raise KeyError(f"unknown quick_start arch {arch!r}; one of {ARCHS}")
    if arch == "lr":
        word = layer.data(name="word",
                          type=data_type.dense_vector(dict_size))
    else:
        word = layer.data(name="word",
                          type=data_type.integer_value_sequence(dict_size))
    label = layer.data(name="label",
                       type=data_type.integer_value(num_classes))
    feat = _BUILDERS[arch](word, dict_size, emb_size, **arch_kwargs)
    output = layer.fc(input=feat, size=num_classes)
    cost = layer.classification_cost(input=output, label=label)
    return word, label, output, cost

"""Stacked-LSTM text classifier (the port of
``paddle_tpu/models/text_lstm.py``; reference: benchmark/paddle/rnn/rnn.py,
the RNN benchmark config: 2xLSTM + fc, BASELINE.md RNN tables).  Layer and
parameter names are the JAX package's, so weights cross through the tar
format."""

from __future__ import annotations

from paddle_tpu_torch import data_type, layer, pooling
from paddle_tpu_torch.networks import simple_lstm


def build(dict_size: int = 30000, embed_size: int = 128, hidden: int = 512,
          num_classes: int = 2, num_layers: int = 2):
    words = layer.data(name="words",
                       type=data_type.integer_value_sequence(dict_size))
    label = layer.data(name="label",
                       type=data_type.integer_value(num_classes))
    net = layer.embedding(input=words, size=embed_size)
    for i in range(num_layers):
        net = simple_lstm(input=net, size=hidden, name=f"lstm{i}")
    pooled = layer.pooling(input=net, pooling_type=pooling.MaxPooling())
    logits = layer.fc(input=pooled, size=num_classes)
    cost = layer.classification_cost(input=logits, label=label)
    return words, label, logits, cost

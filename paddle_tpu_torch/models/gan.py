"""GAN: a generator and a discriminator trained in turn (the port of
``paddle_tpu/models/gan.py``; reference: v1_api_demo/gan).

Both cost graphs read ONE parameter store: the discriminator tower is
applied twice (the real batch, the generated batch) through pinned
parameter names (``gen_*``, ``dis_*``), and ``MultiTaskTrainer`` keeps
each task's step on its own prefix.
"""

from __future__ import annotations

from typing import Tuple

from paddle_tpu_torch import data_type, layer
from paddle_tpu_torch.attr import ParamAttr


def _shared_fc(inp, size, act, pname):
    """fc with pinned parameter names, so several applications share its
    weights."""
    return layer.fc(inp, size=size, act=act,
                    param_attr=ParamAttr(name=f"{pname}.w"),
                    bias_attr=ParamAttr(name=f"{pname}.b"),
                    name=layer.unique_name(pname))


def generator(noise, dims: Tuple[int, ...], out_dim: int):
    h = noise
    for i, d in enumerate(dims):
        h = _shared_fc(h, d, "relu", f"gen_h{i}")
    return _shared_fc(h, out_dim, "tanh", "gen_out")


def discriminator_logit(x, dims: Tuple[int, ...]):
    h = x
    for i, d in enumerate(dims):
        h = _shared_fc(h, d, "relu", f"dis_h{i}")
    return _shared_fc(h, 1, None, "dis_out")


def build(noise_dim: int = 16, data_dim: int = 2,
          gen_dims: Tuple[int, ...] = (32, 32),
          dis_dims: Tuple[int, ...] = (32,)):
    """Returns (noise, real, fake, d_cost, g_cost):
    ``d_cost = BCE(D(real), 1) + BCE(D(fake), 0)`` (trains ``dis_*``),
    ``g_cost = BCE(D(fake), 1)`` (trains ``gen_*``)."""
    noise = layer.data(name="noise", type=data_type.dense_vector(noise_dim))
    real = layer.data(name="pixel", type=data_type.dense_vector(data_dim))
    ones = layer.data(name="label_one", type=data_type.dense_vector(1))
    zeros = layer.data(name="label_zero", type=data_type.dense_vector(1))

    fake = generator(noise, gen_dims, data_dim)
    d_real = discriminator_logit(real, dis_dims)
    d_fake = discriminator_logit(fake, dis_dims)

    d_cost = layer.addto(
        [layer.multi_binary_label_cross_entropy_cost(input=d_real,
                                                     label=ones),
         layer.multi_binary_label_cross_entropy_cost(input=d_fake,
                                                     label=zeros)])
    d_cost.is_cost = True
    g_cost = layer.multi_binary_label_cross_entropy_cost(input=d_fake,
                                                         label=ones)
    return noise, real, fake, d_cost, g_cost

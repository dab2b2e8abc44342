"""Variational autoencoder (the port of ``paddle_tpu/models/vae.py``;
reference: v1_api_demo/vae): an MLP encoder to (mu, logvar), a
reparameterised gaussian latent, an MLP decoder, and BCE reconstruction
plus KL as the cost.

The reparameterisation noise is drawn from the step's per-node generator
(``Context.rng_for``) on the step's device, so a step is a function of
its seed.  It cannot give the JAX package's numbers for the same seed
(``jax.random`` and ``torch.Generator`` differ); the parity test hands
both the same draws.
"""

from __future__ import annotations

from typing import Tuple

import torch

from paddle_tpu_torch import data_type, layer
from paddle_tpu_torch.sequence import SequenceBatch
from paddle_tpu_torch.topology import LayerOutput, unique_name


def _data(v):
    return v.data if isinstance(v, SequenceBatch) else v


def _normal(gen: torch.Generator, like: torch.Tensor) -> torch.Tensor:
    """eps ~ N(0, I) shaped and typed as ``like``, from ``gen``."""
    return torch.randn(like.shape, generator=gen, dtype=like.dtype,
                       device=like.device)


def _gaussian_sample(mu, logvar):
    """z = mu + eps * exp(0.5 * logvar), eps from the step's stream of
    this node."""
    name = unique_name("vae_sample")

    def compute(ctx, p, ins):
        m, lv = _data(ins[0]), _data(ins[1])
        eps = _normal(ctx.rng_for(name), m)
        return m + eps * torch.exp(0.5 * lv)

    return LayerOutput(name=name, layer_type="gaussian_sample",
                       inputs=[mu, logvar], fn=compute, size=mu.size)


def _kl_cost(mu, logvar):
    """KL(q(z|x) || N(0, I)) per example."""
    name = unique_name("vae_kl")

    def compute(ctx, p, ins):
        m, lv = ins[0], ins[1]
        return -0.5 * torch.sum(1.0 + lv - m * m - torch.exp(lv), dim=-1)

    node = LayerOutput(name=name, layer_type="vae_kl", inputs=[mu, logvar],
                       fn=compute, size=1)
    node.is_cost = True
    return node


def build(data_dim: int = 32, hidden: Tuple[int, ...] = (64,),
          latent_dim: int = 8):
    """Returns (x, recon, cost); cost = BCE(recon, x) + KL."""
    x = layer.data(name="pixel", type=data_type.dense_vector(data_dim))
    h = x
    for i, d in enumerate(hidden):
        h = layer.fc(h, size=d, act="relu", name=f"vae_enc{i}")
    mu = layer.fc(h, size=latent_dim, name="vae_mu")
    logvar = layer.fc(h, size=latent_dim, name="vae_logvar")
    z = _gaussian_sample(mu, logvar)
    g = z
    for i, d in enumerate(reversed(hidden)):
        g = layer.fc(g, size=d, act="relu", name=f"vae_dec{i}")
    recon_logit = layer.fc(g, size=data_dim, name="vae_recon")
    recon = layer.mixed(input=layer.identity_projection(recon_logit),
                        size=data_dim, act="sigmoid")
    bce = layer.multi_binary_label_cross_entropy_cost(input=recon_logit,
                                                      label=x)
    cost = layer.addto([bce, _kl_cost(mu, logvar)])
    cost.is_cost = True
    return x, recon, cost

"""The GAN, VAE (BASELINE config #5) and traffic-forecasting
configurations that ``chip_smoke.py`` drives, in one place.

- GAN (``models/gan``, an MLP; the demo's convolutional MNIST GAN,
  v1_api_demo/gan/gan_conf_image.py, has no counterpart in the JAX
  package): at MNIST's size, noise 100, one hidden layer of 128 on both
  sides, 784-pixel samples (the VAE demo's widths below), and at the
  uniform-data demo's widths (v1_api_demo/gan/gan_conf.py: noise 10,
  hidden 10, 2-d samples).  Batch 128, Adam(beta1 0.5) at 1e-3 for both
  tasks (gan_conf.py's settings), ``d`` and ``g`` steps in turn through
  ``MultiTaskTrainer``.
- VAE (v1_api_demo/vae/vae_conf.py): 784 -> 128 -> latent 100 -> 128 ->
  784, batch 128, Adam at 1e-3.
- traffic_prediction at its demo defaults: 24 readings, 24 horizons,
  emb 16, batch 128, Adam at 1e-3.

MNIST and the traffic readings are not in the repository: the data is
seeded synthetic data of their shapes, made on the device in bulk.  MNIST
images are a few binary prototypes with 5% of the pixels flipped (as
``tests/test_gan_vae.py`` makes its VAE data), in [0, 1] for the VAE and
scaled to [-1, 1] (the generator's tanh range) for the GAN; the uniform
demo's real samples are uniform in [0, 1)^2 (its gan_trainer.py draws
``np.random.rand``); traffic readings are
uniform in [0, 1], each horizon's speed bucket that of one reading.
Weights are drawn with numpy (``ctr_workload.numpy_params``: the
package's default rules).
"""

from __future__ import annotations

from typing import Dict

import torch

from paddle_tpu_torch.tools.ctr_workload import numpy_params

GAN_WIDTHS = {
    "mnist": dict(noise_dim=100, data_dim=784, gen_dims=(128,),
                  dis_dims=(128,)),
    "uniform": dict(noise_dim=10, data_dim=2, gen_dims=(10,),
                    dis_dims=(10,)),
}
VAE = dict(data_dim=784, hidden=(128,), latent_dim=100)
TRAFFIC = dict(term_num=24, forecasting_num=24, emb_size=16)
BATCH = 128
LEARNING_RATE = 1e-3
GAN_BETA1 = 0.5
PROTOTYPES, FLIP = 10, 0.05
SEED = 0              # weights; the data uses SEED + 1


def _params(costs, device):
    from paddle_tpu_torch import topology
    from paddle_tpu_torch.convert import parameters_from_numpy

    specs = topology.Topology(list(costs)).param_specs()
    return parameters_from_numpy(numpy_params(specs, SEED), device=device)


def images(gen, n: int, batch: int, dim: int, device) -> torch.Tensor:
    """[n, batch, dim] binary prototype images with flipped pixels."""
    protos = (torch.rand((PROTOTYPES, dim), generator=gen, device=device)
              > 0.5).float()
    pick = torch.randint(0, PROTOTYPES, (n, batch), generator=gen,
                         device=device)
    flip = (torch.rand((n, batch, dim), generator=gen, device=device)
            < FLIP).float()
    return (protos[pick] - flip).abs()


def build_gan(width: str, device):
    """(MultiTaskTrainer over the two tasks, parameters)."""
    from paddle_tpu_torch import optimizer, topology, trainer
    from paddle_tpu_torch.models import gan

    topology.reset_name_scope()
    _, _, _, d_cost, g_cost = gan.build(**GAN_WIDTHS[width])
    params = _params([d_cost, g_cost], device)

    def adam():
        return optimizer.Adam(learning_rate=LEARNING_RATE, beta1=GAN_BETA1)

    return trainer.MultiTaskTrainer(
        [trainer.TaskSpec("d", d_cost, adam(), trainable="dis_"),
         trainer.TaskSpec("g", g_cost, adam(), trainable="gen_")],
        params, device=device), params


def gan_data(width: str, pairs: int, device) -> Dict[str, torch.Tensor]:
    """Per step pair: real samples, the two noise batches, the labels."""
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    w = GAN_WIDTHS[width]
    if width == "mnist":
        real = 2 * images(gen, pairs, BATCH, w["data_dim"], device) - 1
    else:
        real = torch.rand((pairs, BATCH, w["data_dim"]), generator=gen,
                          device=device)
    noise = torch.randn((pairs, 2, BATCH, w["noise_dim"]), generator=gen,
                        device=device)
    return {"real": real, "noise": noise,
            "ones": torch.ones((BATCH, 1), device=device),
            "zeros": torch.zeros((BATCH, 1), device=device)}


def gan_feeds(data, i: int, task: str) -> Dict[str, torch.Tensor]:
    if task == "d":
        return {"noise": data["noise"][i, 0], "pixel": data["real"][i],
                "label_one": data["ones"], "label_zero": data["zeros"]}
    return {"noise": data["noise"][i, 1], "label_one": data["ones"]}


def build_vae(device):
    """``trainer.SGD`` over the VAE's cost."""
    from paddle_tpu_torch import optimizer, topology, trainer
    from paddle_tpu_torch.models import vae

    topology.reset_name_scope()
    _, _, cost = vae.build(**VAE)
    return trainer.SGD(cost, _params([cost], device),
                       optimizer.Adam(learning_rate=LEARNING_RATE),
                       device=device)


def vae_feeds(steps: int, device):
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    x = images(gen, steps, BATCH, VAE["data_dim"], device)
    return [{"pixel": x[i]} for i in range(steps)]


def build_traffic(device):
    """``trainer.SGD`` over the forecaster's summed costs."""
    from paddle_tpu_torch import optimizer, topology, trainer
    from paddle_tpu_torch.models import traffic_prediction

    topology.reset_name_scope()
    costs = traffic_prediction.build(**TRAFFIC)[3]
    return trainer.SGD(costs, _params(costs, device),
                       optimizer.Adam(learning_rate=LEARNING_RATE),
                       device=device)


def traffic_feeds(steps: int, device):
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    term, horizons = TRAFFIC["term_num"], TRAFFIC["forecasting_num"]
    x = torch.rand((steps, BATCH, term), generator=gen, device=device)
    out = []
    for i in range(steps):
        f = {"link_encode": x[i]}
        for h in range(horizons):
            f[f"label_{(h + 1) * 5}min"] = torch.clamp(
                (4 * x[i, :, (term - 1 - h) % term]).long(), max=3).to(
                torch.int32)
        out.append(f)
    return out

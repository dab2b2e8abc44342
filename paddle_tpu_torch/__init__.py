"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

The port mirrors the JAX package's module layout (the counterpart of
``paddle_tpu/serving/engine.py`` is ``paddle_tpu_torch/serving/engine.py``)
and is held against it by parity tests.  It imports ``torch`` and numpy
only — never ``jax`` and never a module of ``paddle_tpu``.

Importing the package builds nothing: the hand-written CUDA kernels under
``csrc/`` are compiled by :mod:`paddle_tpu_torch.kernels.build` at their
first launch.  Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"`` (see :mod:`paddle_tpu_torch.platform.device`).
"""

__all__ = ["activation", "attr", "convert", "data_feeder", "data_type",
           "event", "generation", "inference", "initializer", "kernels",
           "layer", "minibatch", "models", "networks", "ops", "optimizer",
           "parameters", "platform", "pooling", "recurrent", "sequence",
           "serving", "topology", "trainer"]

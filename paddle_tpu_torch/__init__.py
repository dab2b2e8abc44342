"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

The port mirrors the JAX package's module layout (the counterpart of
``paddle_tpu/serving/engine.py`` is ``paddle_tpu_torch/serving/engine.py``)
and is held against it by parity tests.  It imports ``torch`` and numpy
only — never ``jax`` and never a module of ``paddle_tpu``.

Importing the package builds nothing: the hand-written CUDA kernels under
``csrc/`` are compiled by :mod:`paddle_tpu_torch.kernels.build` at their
first launch.  Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"`` (see :mod:`paddle_tpu_torch.platform.device`).  The v2
surface is exported at the root as in the JAX package::

    import paddle_tpu_torch as paddle
    paddle.init(device="cpu")
    reader = paddle.batch(paddle.reader.shuffle(
        paddle.dataset.mnist.train(), buf_size=8192), 128)
"""

from paddle_tpu_torch import activation
from paddle_tpu_torch import attr
from paddle_tpu_torch import data_type
from paddle_tpu_torch import initializer
from paddle_tpu_torch import pooling
from paddle_tpu_torch import layer
from paddle_tpu_torch import networks
from paddle_tpu_torch import optimizer
from paddle_tpu_torch import evaluator
from paddle_tpu_torch import trainer
from paddle_tpu_torch import event
from paddle_tpu_torch import parameters
from paddle_tpu_torch import topology
from paddle_tpu_torch import inference
from paddle_tpu_torch import reader
from paddle_tpu_torch import dataset
from paddle_tpu_torch import minibatch
from paddle_tpu_torch import sequence

from paddle_tpu_torch.data_feeder import DataFeeder
from paddle_tpu_torch.inference import Inference, infer
from paddle_tpu_torch.minibatch import batch
from paddle_tpu_torch.parameters import Parameters
from paddle_tpu_torch.platform.device import init
from paddle_tpu_torch.platform.flags import FLAGS
from paddle_tpu_torch.sequence import SequenceBatch

__all__ = ["init", "batch", "infer", "layer", "networks", "optimizer",
           "evaluator", "trainer", "event", "parameters", "topology",
           "reader", "dataset", "minibatch", "activation", "attr",
           "data_type", "initializer", "pooling", "sequence", "Parameters",
           "DataFeeder", "SequenceBatch", "FLAGS", "Inference"]

"""Inference (the port of ``paddle_tpu/inference.py:20-116``: ``Inference``
with ``iter_infer`` and ``infer``, and the one-shot ``infer``).

A test-mode forward of the requested layers under ``torch.no_grad()``,
on ``cuda`` unless the caller passes ``device="cpu"``; the parameters must
already be there.  A caller's ``model_state`` (a trainer's batch-norm
statistics) is merged over the topology's initial state, so namespaces
the caller has take its values and the rest start at their init values.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from paddle_tpu_torch.data_feeder import DataFeeder
from paddle_tpu_torch.parameters import Parameters
from paddle_tpu_torch.platform.device import DeviceLike, resolve_device
from paddle_tpu_torch.sequence import SequenceBatch
from paddle_tpu_torch.topology import LayerOutput, Topology


class Inference:
    def __init__(self, output_layer, parameters: Parameters,
                 model_state=None, device: DeviceLike = None):
        outputs = [output_layer] if isinstance(output_layer, LayerOutput) \
            else list(output_layer)
        self.device = resolve_device(device)
        self.topology = Topology(outputs)
        self.parameters = parameters
        state = self.topology.init_state(self.device)
        for ns in state:
            if model_state is not None and ns in model_state:
                state[ns] = {**state[ns], **{
                    k: v.to(self.device) for k, v in model_state[ns].items()}}
        self.model_state = state

    def iter_infer(self, input, feeding=None):
        """For each batch of samples in ``input``, the list of the output
        layers' values (a tuple-valued node, such as a beam search's,
        as it is)."""
        data_types = [(n.name, n.input_type)
                      for n in self.topology.data_nodes]
        feeder = DataFeeder(data_types, feeding, device=self.device)
        params = self.parameters.as_dict()
        for batch in input:
            with torch.no_grad():
                outs, _ = self.topology.forward_with_state(
                    params, self.model_state, feeder.feed(batch),
                    train=False)
            yield outs

    def infer(self, input, feeding=None, field: str = "value",
              batch_size: int = 256):
        """``input`` a list of samples, run in batches of ``batch_size``;
        one numpy array an output layer (or a list of them).  The last
        partial batch is padded as the JAX package pads it (repeating the
        last sample: up to ``batch_size`` when there are several batches,
        to the next power of two for a single short one; not at all with
        sequence outputs), and the padded rows cut off the result."""
        n = len(input)
        if n == 0:
            return None
        batches = [input[i:i + batch_size] for i in range(0, n, batch_size)]
        tail = len(batches[-1])
        if any(o.is_sequence for o in self.topology.outputs):
            target = tail
        elif len(batches) > 1:
            target = batch_size
        else:
            target = 1
            while target < tail:
                target *= 2
        pad = target - tail
        if pad:
            batches[-1] = list(batches[-1]) + [input[-1]] * pad
        results: List[List[np.ndarray]] = None
        for outs in self.iter_infer(batches, feeding):
            arrays = [_to_numpy(o) for o in outs]
            if results is None:
                results = [[a] for a in arrays]
            else:
                for acc, a in zip(results, arrays):
                    acc.append(a)
        merged = [np.concatenate(parts, axis=0) if parts[0].ndim
                  else np.stack(parts) for parts in results]
        if pad:
            merged = [a[:n] if a.ndim and a.shape[0] == n + pad else a
                      for a in merged]
        return merged[0] if len(merged) == 1 else merged


def _to_numpy(o) -> np.ndarray:
    if isinstance(o, SequenceBatch):
        o = o.data
    return o.detach().cpu().numpy()


def infer(output_layer, parameters: Parameters, input, feeding=None,
          field: str = "value", model_state=None, batch_size: int = 256,
          device: DeviceLike = None):
    """One-shot :class:`Inference`; ``model_state`` forwards a trainer's
    state (batch-norm statistics)."""
    return Inference(output_layer, parameters, model_state=model_state,
                     device=device).infer(input, feeding=feeding,
                                          field=field,
                                          batch_size=batch_size)

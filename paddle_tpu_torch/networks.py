"""Prebuilt network helpers (the port of ``paddle_tpu/networks.py:82-100``:
``simple_lstm`` and ``simple_gru`` so far)."""

from __future__ import annotations

from typing import Optional

from paddle_tpu_torch import layer as L
from paddle_tpu_torch.topology import LayerOutput, unique_name

__all__ = ["simple_lstm", "simple_gru"]


def simple_lstm(input, size: int, reverse: bool = False, act=None,
                gate_act=None, state_act=None, name: Optional[str] = None,
                mat_param_attr=None, bias_param_attr=None,
                inner_param_attr=None) -> LayerOutput:
    """fc(4H) + lstmemory."""
    name = name or unique_name("simple_lstm")
    proj = L.fc(input=input, size=size * 4, name=f"{name}_input_proj",
                param_attr=mat_param_attr, bias_attr=bias_param_attr or True)
    return L.lstmemory(input=proj, size=size, reverse=reverse, act=act,
                       gate_act=gate_act, state_act=state_act,
                       name=name, param_attr=inner_param_attr)


def simple_gru(input, size: int, reverse: bool = False, act=None,
               gate_act=None, name: Optional[str] = None, **kw) -> LayerOutput:
    """fc(3H) + grumemory."""
    name = name or unique_name("simple_gru")
    proj = L.fc(input=input, size=size * 3, name=f"{name}_input_proj")
    return L.grumemory(input=proj, size=size, reverse=reverse, act=act,
                       gate_act=gate_act, name=name)

"""Prebuilt network helpers (the port of ``paddle_tpu/networks.py:39-100``:
``simple_img_conv_pool``, ``img_conv_group``, ``simple_lstm`` and
``simple_gru`` so far)."""

from __future__ import annotations

from typing import Optional, Sequence

from paddle_tpu_torch import layer as L
from paddle_tpu_torch.topology import LayerOutput, unique_name

__all__ = ["simple_img_conv_pool", "img_conv_group", "simple_lstm",
           "simple_gru"]


def simple_img_conv_pool(input, filter_size: int, num_filters: int,
                         pool_size: int, pool_stride: int = None,
                         num_channel: int = None, act=None,
                         padding: int = None, pool_type=None,
                         name: Optional[str] = None) -> LayerOutput:
    """img_conv ("same" padding for odd filters) then img_pool."""
    padding = padding if padding is not None else (filter_size - 1) // 2
    conv = L.img_conv(input=input, filter_size=filter_size,
                      num_filters=num_filters, num_channels=num_channel,
                      padding=padding, act=act, name=name)
    return L.img_pool(input=conv, pool_size=pool_size,
                      stride=pool_stride or pool_size, pool_type=pool_type)


def img_conv_group(input, conv_num_filter: Sequence[int],
                   conv_filter_size=3, conv_act=None,
                   conv_with_batchnorm=False, pool_size: int = 2,
                   pool_stride: int = 2, pool_type=None,
                   num_channels: int = None) -> LayerOutput:
    """A stack of img_convs (each optionally followed by batch_norm), then
    one img_pool."""
    tmp = input
    for i, nf in enumerate(conv_num_filter):
        tmp = L.img_conv(input=tmp, filter_size=conv_filter_size,
                         num_filters=nf,
                         padding=(conv_filter_size - 1) // 2,
                         num_channels=num_channels if i == 0 else None,
                         act=None if conv_with_batchnorm
                         else (conv_act or "relu"))
        if conv_with_batchnorm:
            tmp = L.batch_norm(input=tmp, act=conv_act or "relu")
    return L.img_pool(input=tmp, pool_size=pool_size, stride=pool_stride,
                      pool_type=pool_type)


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

"""Prebuilt network helpers (the port of ``paddle_tpu/networks.py:21-160``:
``sequence_conv_pool``, ``simple_img_conv_pool``, ``img_conv_group``,
``vgg_16_network``, ``simple_lstm``,
``simple_gru``, ``bidirectional_lstm``, ``bidirectional_gru``,
``simple_attention`` and ``dot_product_attention``), with the JAX
package's layer names."""

from __future__ import annotations

from typing import Optional, Sequence

from paddle_tpu_torch import activation as A
from paddle_tpu_torch import layer as L
from paddle_tpu_torch import pooling as P
from paddle_tpu_torch.topology import LayerOutput, unique_name

__all__ = ["sequence_conv_pool", "simple_img_conv_pool", "img_conv_group",
           "vgg_16_network", "simple_lstm",
           "simple_gru", "bidirectional_lstm", "bidirectional_gru",
           "simple_attention", "dot_product_attention"]


def sequence_conv_pool(input, context_len: int, hidden_size: int,
                       name: Optional[str] = None, context_start: int = None,
                       pool_type=None, fc_act=None) -> LayerOutput:
    """Text convolution: a context projection, an fc (tanh) and a
    sequence pool (max): the quick_start cnn's tower."""
    name = name or unique_name("seq_conv_pool")
    ctx = L.mixed(size=input.size * context_len,
                  input=[L.context_projection(input, context_len=context_len,
                                              context_start=context_start)],
                  name=f"{name}_ctx")
    hidden = L.fc(input=ctx, size=hidden_size, act=fc_act or "tanh",
                  name=f"{name}_fc")
    return L.pooling(input=hidden, pooling_type=pool_type or P.MaxPooling(),
                     name=name)


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


def vgg_16_network(input_image, num_channels: int, num_classes: int = 1000
                   ) -> LayerOutput:
    """VGG-16: five groups of 3 x 3 convolutions (64 x 2, 128 x 2,
    256 x 3, 512 x 3, 512 x 3, ReLU), each closed by a 2 x 2 max pool;
    fc 4096, dropout 0.5, fc 4096, dropout 0.5, fc ``num_classes``
    (softmax)."""
    tmp = input_image
    for filters, n in [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]:
        tmp = img_conv_group(tmp, [filters] * n, conv_act="relu",
                             num_channels=num_channels if filters == 64
                             else None)
    tmp = L.fc(input=tmp, size=4096, act="relu")
    tmp = L.dropout(tmp, 0.5)
    tmp = L.fc(input=tmp, size=4096, act="relu")
    tmp = L.dropout(tmp, 0.5)
    return L.fc(input=tmp, size=num_classes, act="softmax")


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


def bidirectional_lstm(input, size: int, name: Optional[str] = None,
                       return_seq: bool = True, **kw) -> LayerOutput:
    """A forward and a reverse ``simple_lstm``, concatenated per token
    (``return_seq``), or the forward's last and the reverse's first
    token."""
    name = name or unique_name("bidirectional_lstm")
    fwd = simple_lstm(input, size, reverse=False, name=f"{name}_fwd")
    bwd = simple_lstm(input, size, reverse=True, name=f"{name}_bwd")
    if return_seq:
        return L.concat(input=[fwd, bwd])
    return L.concat(input=[L.last_seq(fwd), L.first_seq(bwd)])


def bidirectional_gru(input, size: int, name: Optional[str] = None,
                      return_seq: bool = True, **kw) -> LayerOutput:
    """:func:`bidirectional_lstm` with ``simple_gru``s."""
    name = name or unique_name("bidirectional_gru")
    fwd = simple_gru(input, size, reverse=False, name=f"{name}_fwd")
    bwd = simple_gru(input, size, reverse=True, name=f"{name}_bwd")
    if return_seq:
        return L.concat(input=[fwd, bwd])
    return L.concat(input=[L.last_seq(fwd), L.first_seq(bwd)])


def simple_attention(encoded_sequence, encoded_proj, decoder_state,
                     transform_param_attr=None, softmax_param_attr=None,
                     name: Optional[str] = None) -> LayerOutput:
    """Additive attention: score_t = v . tanh(enc_proj_t + W s), context =
    sum_t sequence_softmax(score)_t enc_t."""
    name = name or unique_name("attention")
    dec_proj = L.fc(input=decoder_state, size=encoded_proj.size,
                    name=f"{name}_decoder_proj",
                    param_attr=transform_param_attr, bias_attr=False)
    expanded = L.expand(input=dec_proj, expand_as=encoded_sequence,
                        name=f"{name}_expand")
    combined = L.addto(input=[encoded_proj, expanded], act="tanh",
                       name=f"{name}_combine")
    scores = L.fc(input=combined, size=1, act=None, bias_attr=False,
                  param_attr=softmax_param_attr, name=f"{name}_scores")
    weights = L.mixed(size=1, input=[L.identity_projection(scores)],
                      act=A.SequenceSoftmaxActivation(),
                      name=f"{name}_softmax")
    scaled = L.dotmul_bcast(encoded_sequence, weights, name=f"{name}_scale")
    return L.pooling(input=scaled, pooling_type=P.SumPooling(),
                     name=f"{name}_context")


def dot_product_attention(encoded_sequence, attended_sequence,
                          transformed_state,
                          name: Optional[str] = None) -> LayerOutput:
    """Dot-product attention: score_t = enc_t . s, context = sum_t
    sequence_softmax(score)_t attended_t."""
    name = name or unique_name("dot_attention")
    expanded = L.expand(input=transformed_state, expand_as=encoded_sequence,
                        name=f"{name}_expand")
    scores_tok = L.dotmul(expanded, encoded_sequence, name=f"{name}_dot")
    scores = L.fc(input=scores_tok, size=1, bias_attr=False,
                  name=f"{name}_sum")
    weights = L.mixed(size=1, input=[L.identity_projection(scores)],
                      act=A.SequenceSoftmaxActivation(),
                      name=f"{name}_softmax")
    scaled = L.dotmul_bcast(attended_sequence, weights,
                            name=f"{name}_scale")
    return L.pooling(input=scaled, pooling_type=P.SumPooling(),
                     name=f"{name}_context")

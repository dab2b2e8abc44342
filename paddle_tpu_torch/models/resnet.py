"""ResNet (the port of ``paddle_tpu/models/resnet.py``; reference:
v1_api_demo/model_zoo/resnet/resnet.py and benchmark/paddle/image).
Bottleneck-v1 ResNet-50 by default; depths 18 and 34 use basic blocks.
Layer and parameter names are the JAX package's."""

from __future__ import annotations

from paddle_tpu_torch import data_type, layer, pooling


def _conv_bn(input, num_filters, filter_size, stride=1, padding=None,
             act="relu", name=None):
    padding = padding if padding is not None else (filter_size - 1) // 2
    conv = layer.img_conv(input=input, filter_size=filter_size,
                          num_filters=num_filters, stride=stride,
                          padding=padding, act=None, bias_attr=False,
                          name=name)
    return layer.batch_norm(input=conv, act=act)


def _bottleneck(input, planes, stride=1, downsample=False, name=None):
    out = _conv_bn(input, planes, 1, stride=1)
    out = _conv_bn(out, planes, 3, stride=stride)
    out = _conv_bn(out, planes * 4, 1, act=None)
    if downsample:
        short = _conv_bn(input, planes * 4, 1, stride=stride, act=None)
    else:
        short = input
    return layer.addto(input=[out, short], act="relu")


def _basic(input, planes, stride=1, downsample=False, name=None):
    out = _conv_bn(input, planes, 3, stride=stride)
    out = _conv_bn(out, planes, 3, act=None)
    if downsample:
        short = _conv_bn(input, planes, 1, stride=stride, act=None)
    else:
        short = input
    return layer.addto(input=[out, short], act="relu")


_DEPTH_CFG = {
    18: (_basic, [2, 2, 2, 2], 1),
    34: (_basic, [3, 4, 6, 3], 1),
    50: (_bottleneck, [3, 4, 6, 3], 4),
    101: (_bottleneck, [3, 4, 23, 3], 4),
    152: (_bottleneck, [3, 8, 36, 3], 4),
}


def build(depth: int = 50, img_size: int = 224, num_classes: int = 1000):
    """Returns (images, label, logits, cost)."""
    block, layers_cfg, _ = _DEPTH_CFG[depth]
    images = layer.data(
        name="image", type=data_type.dense_vector(3 * img_size * img_size),
        height=img_size, width=img_size)
    label = layer.data(name="label",
                       type=data_type.integer_value(num_classes))

    net = _conv_bn(images, 64, 7, stride=2, padding=3)
    net = layer.img_pool(input=net, pool_size=3, stride=2, padding=1)
    planes = 64
    for stage, blocks in enumerate(layers_cfg):
        for b in range(blocks):
            stride = 2 if (stage > 0 and b == 0) else 1
            net = block(net, planes, stride=stride, downsample=(b == 0))
        planes *= 2
    # global average pool over the last maps
    h, _, _ = net.img_shape
    net = layer.img_pool(input=net, pool_size=h, stride=h,
                         pool_type=pooling.AvgPooling())
    logits = layer.fc(input=net, size=num_classes)
    cost = layer.classification_cost(input=logits, label=label)
    return images, label, logits, cost

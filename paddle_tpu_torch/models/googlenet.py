"""GoogLeNet / Inception-v1 (the port of ``paddle_tpu/models/googlenet.py``;
reference: benchmark/paddle/image/googlenet.py): four-tower inception
modules on img_conv and channel concat, the main classifier head only.
Layer and parameter names are the JAX package's."""

from __future__ import annotations

from paddle_tpu_torch import data_type, layer, pooling


def _conv(input, filters, size, stride=1, padding=None):
    padding = padding if padding is not None else (size - 1) // 2
    return layer.img_conv(input=input, filter_size=size, num_filters=filters,
                          stride=stride, padding=padding, act="relu")


def inception(input, c1, c3r, c3, c5r, c5, pp):
    """One inception module: 1x1 / 1x1->3x3 / 1x1->5x5 / pool->1x1
    towers."""
    t1 = _conv(input, c1, 1)
    t3 = _conv(_conv(input, c3r, 1), c3, 3)
    t5 = _conv(_conv(input, c5r, 1), c5, 5)
    tp = _conv(layer.img_pool(input=input, pool_size=3, stride=1, padding=1),
               pp, 1)
    return layer.concat(input=[t1, t3, t5, tp])


_CFG = [  # (c1, c3r, c3, c5r, c5, pool_proj), with 'M' = maxpool between
    (64, 96, 128, 16, 32, 32),      # 3a
    (128, 128, 192, 32, 96, 64),    # 3b
    "M",
    (192, 96, 208, 16, 48, 64),     # 4a
    (160, 112, 224, 24, 64, 64),    # 4b
    (128, 128, 256, 24, 64, 64),    # 4c
    (112, 144, 288, 32, 64, 64),    # 4d
    (256, 160, 320, 32, 128, 128),  # 4e
    "M",
    (256, 160, 320, 32, 128, 128),  # 5a
    (384, 192, 384, 48, 128, 128),  # 5b
]


def build(img_size: int = 224, num_classes: int = 1000):
    """Returns (images, label, logits, cost)."""
    images = layer.data(
        name="image", type=data_type.dense_vector(3 * img_size * img_size),
        height=img_size, width=img_size)
    label = layer.data(name="label",
                       type=data_type.integer_value(num_classes))
    net = _conv(images, 64, 7, stride=2, padding=3)
    net = layer.img_pool(input=net, pool_size=3, stride=2, padding=1)
    net = _conv(net, 64, 1)
    net = _conv(net, 192, 3)
    net = layer.img_pool(input=net, pool_size=3, stride=2, padding=1)
    for cfg in _CFG:
        if cfg == "M":
            net = layer.img_pool(input=net, pool_size=3, stride=2, padding=1)
        else:
            net = inception(net, *cfg)
    h, _, _ = net.img_shape
    net = layer.img_pool(input=net, pool_size=h, stride=h,
                         pool_type=pooling.AvgPooling())
    net = layer.dropout(net, 0.4)
    logits = layer.fc(input=net, size=num_classes)
    cost = layer.classification_cost(input=logits, label=label)
    return images, label, logits, cost

"""AlexNet (the port of ``paddle_tpu/models/alexnet.py``; reference:
benchmark/paddle/image/alexnet.py).  Layer and parameter names are the
JAX package's."""

from __future__ import annotations

from paddle_tpu_torch import data_type, layer


def build(img_size: int = 227, num_classes: int = 1000):
    """Returns (images, label, logits, cost).  Input layout: flat C*H*W
    rows or [B, H, W, C] maps."""
    images = layer.data(
        name="image", type=data_type.dense_vector(3 * img_size * img_size),
        height=img_size, width=img_size)
    label = layer.data(name="label",
                       type=data_type.integer_value(num_classes))

    # conv1: 96 kernels 11x11 stride 4 + LRN + pool
    net = layer.img_conv(input=images, filter_size=11, num_filters=96,
                         num_channels=3, stride=4, padding=1, act="relu")
    net = layer.img_cmrnorm(input=net, size=5)
    net = layer.img_pool(input=net, pool_size=3, stride=2)
    # conv2: 256 kernels 5x5
    net = layer.img_conv(input=net, filter_size=5, num_filters=256, padding=2,
                         groups=1, act="relu")
    net = layer.img_cmrnorm(input=net, size=5)
    net = layer.img_pool(input=net, pool_size=3, stride=2)
    # conv3-5
    net = layer.img_conv(input=net, filter_size=3, num_filters=384, padding=1,
                         act="relu")
    net = layer.img_conv(input=net, filter_size=3, num_filters=384, padding=1,
                         act="relu")
    net = layer.img_conv(input=net, filter_size=3, num_filters=256, padding=1,
                         act="relu")
    net = layer.img_pool(input=net, pool_size=3, stride=2)

    net = layer.fc(input=net, size=4096, act="relu")
    net = layer.dropout(net, 0.5)
    net = layer.fc(input=net, size=4096, act="relu")
    net = layer.dropout(net, 0.5)
    logits = layer.fc(input=net, size=num_classes)
    cost = layer.classification_cost(input=logits, label=label)
    return images, label, logits, cost

"""SmallNet, the cifar-quick benchmark config (the port of
``paddle_tpu/models/smallnet.py``; reference:
benchmark/paddle/image/smallnet_mnist_cifar.py): three 5x5 convs with
pooling, then fc."""

from __future__ import annotations

from paddle_tpu_torch import data_type, layer, pooling


def build(img_size: int = 32, num_classes: int = 10):
    """Returns (images, label, logits, cost)."""
    images = layer.data(
        name="image", type=data_type.dense_vector(3 * img_size * img_size),
        height=img_size, width=img_size)
    label = layer.data(name="label",
                       type=data_type.integer_value(num_classes))
    net = layer.img_conv(input=images, filter_size=5, num_filters=32,
                         padding=2, act="relu")
    net = layer.img_pool(input=net, pool_size=3, stride=2, padding=1)
    net = layer.img_conv(input=net, filter_size=5, num_filters=32, padding=2,
                         act="relu")
    net = layer.img_pool(input=net, pool_size=3, stride=2, padding=1,
                         pool_type=pooling.AvgPooling())
    net = layer.img_conv(input=net, filter_size=5, num_filters=64, padding=2,
                         act="relu")
    net = layer.img_pool(input=net, pool_size=3, stride=2, padding=1,
                         pool_type=pooling.AvgPooling())
    net = layer.fc(input=net, size=64)
    logits = layer.fc(input=net, size=num_classes)
    cost = layer.classification_cost(input=logits, label=label)
    return images, label, logits, cost

"""LeNet-5-style MNIST CNN (the port of ``paddle_tpu/models/lenet.py``;
reference: v1_api_demo/mnist).  Layer and parameter names are the JAX
package's, so weights cross through the tar format."""

from __future__ import annotations

from paddle_tpu_torch import data_type, layer
from paddle_tpu_torch.networks import simple_img_conv_pool


def build(img_size: int = 28, num_classes: int = 10):
    """Returns (images, label, logits, cost)."""
    images = layer.data(name="pixel",
                        type=data_type.dense_vector(img_size * img_size),
                        height=img_size, width=img_size)
    label = layer.data(name="label",
                       type=data_type.integer_value(num_classes))
    conv1 = simple_img_conv_pool(input=images, filter_size=5, num_filters=20,
                                 pool_size=2, num_channel=1, act="relu")
    conv2 = simple_img_conv_pool(input=conv1, filter_size=5, num_filters=50,
                                 pool_size=2, act="relu")
    fc1 = layer.fc(input=conv2, size=500, act="relu")
    logits = layer.fc(input=fc1, size=num_classes)
    cost = layer.classification_cost(input=logits, label=label)
    return images, label, logits, cost

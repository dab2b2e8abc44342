"""DeepFM CTR model (the port of ``paddle_tpu/models/deepfm.py``; Guo et
al. 2017).  Layer and parameter names are the JAX package's, so weights
cross by name through ``convert.parameters_from_numpy``.

For F categorical fields over one shared vocabulary: first-order weights
``w[id]`` from the shared ``deepfm.w1`` table [V, 1], the FM second-order
term ``0.5 * ((sum v_f)^2 - sum v_f^2)`` over k-dim factors from the
shared ``deepfm.v`` table [V, k], and a deep ReLU tower over the
concatenated factors.  Every field's lookup reads the same two tables, so
their backward sums 39 lookups (at Criteo's width) into one gradient per
table.
"""

from __future__ import annotations

from typing import Tuple

from paddle_tpu_torch import data_type, layer
from paddle_tpu_torch.attr import ParamAttr
from paddle_tpu_torch.initializer import Constant


def build(num_fields: int = 8, vocab_size: int = 1024, factor_dim: int = 8,
          deep_layers: Tuple[int, ...] = (64, 32)):
    """Returns (field_inputs, label, prob, cost).  Each field is an
    ``integer_value`` input (one id per field per example); the cost is
    the binary cross entropy on the logit."""
    fields = [layer.data(name=f"field_{i}",
                         type=data_type.integer_value(vocab_size))
              for i in range(num_fields)]
    label = layer.data(name="label", type=data_type.integer_value(2))

    w_attr = ParamAttr(name="deepfm.w1")
    v_attr = ParamAttr(name="deepfm.v")
    firsts = [layer.embedding(f, size=1, param_attr=w_attr) for f in fields]
    embeds = [layer.embedding(f, size=factor_dim, param_attr=v_attr)
              for f in fields]

    first_order = layer.addto(firsts, bias_attr=True)

    # FM second order: 0.5 * ((sum v)^2 - sum v^2), summed over k by the fc
    sum_v = layer.addto(embeds)
    sum_sq = layer.dotmul(sum_v, sum_v)
    sq_sum = layer.addto([layer.dotmul(e, e) for e in embeds])
    second = layer.mixed(
        input=layer.identity_projection(sum_sq + layer.slope_intercept(
            sq_sum, slope=-1.0)), size=factor_dim)
    second_order = layer.fc(second, size=1, bias_attr=False,
                            param_attr=ParamAttr(initializer=Constant(0.5)))

    deep = layer.concat(embeds)
    for width in deep_layers:
        deep = layer.fc(deep, size=width, act="relu")
    deep_out = layer.fc(deep, size=1, bias_attr=False)

    logit = layer.addto([first_order, second_order, deep_out])
    prob = layer.mixed(input=layer.identity_projection(logit), size=1,
                       act="sigmoid")
    cost = layer.multi_binary_label_cross_entropy_cost(input=logit,
                                                       label=label)
    return fields, label, prob, cost

"""Traffic-speed forecasting (the port of
``paddle_tpu/models/traffic_prediction.py``; reference:
v1_api_demo/traffic_prediction): one encoded history window of TERM_NUM
readings feeds FORECASTING_NUM per-horizon heads; every head's first
projection shares ONE parameter (``_link_vec.w``), then predicts a
4-class speed bucket.  The trainer sums the per-horizon costs.
"""

from __future__ import annotations

from paddle_tpu_torch import data_type, layer
from paddle_tpu_torch.attr import ParamAttr

TERM_NUM = 24
FORECASTING_NUM = 24
NUM_BUCKETS = 4


def build(term_num: int = TERM_NUM, forecasting_num: int = FORECASTING_NUM,
          emb_size: int = 16):
    """Returns (link_encode, labels, scores, costs): per-horizon score
    layers (logits over the speed buckets) and their classification
    costs."""
    link_encode = layer.data(name="link_encode",
                             type=data_type.dense_vector(term_num))
    labels, scores, costs = [], [], []
    shared = ParamAttr(name="_link_vec.w")
    for i in range(forecasting_num):
        link_vec = layer.fc(input=link_encode, size=emb_size,
                            param_attr=shared, name=f"link_vec_{i}")
        score = layer.fc(input=link_vec, size=NUM_BUCKETS,
                         name=f"score_{(i + 1) * 5}min")
        label = layer.data(name=f"label_{(i + 1) * 5}min",
                           type=data_type.integer_value(NUM_BUCKETS))
        cost = layer.classification_cost(input=score, label=label,
                                         name=f"cost_{(i + 1) * 5}min")
        labels.append(label)
        scores.append(score)
        costs.append(cost)
    return link_encode, labels, scores, costs

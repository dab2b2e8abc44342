"""Trainer events (a copy of ``paddle_tpu/event.py``).

Costs and metrics arrive as 0-d device tensors so the trainer never
waits for the card after a step; ``EndIteration.cost`` and every
event's ``metrics`` convert on first access.
"""

from __future__ import annotations

from typing import Dict, Optional


class WithMetric:
    def __init__(self, evaluator_result: Optional[Dict[str, float]] = None):
        self._metrics_raw = evaluator_result or {}
        self._metrics: Optional[Dict[str, float]] = None

    @property
    def metrics(self) -> Dict[str, float]:
        if self._metrics is None:
            self._metrics = {k: float(v) for k, v in self._metrics_raw.items()}
        return self._metrics


class BeginPass:
    def __init__(self, pass_id: int):
        self.pass_id = pass_id


class EndPass(WithMetric):
    def __init__(self, pass_id: int, evaluator_result=None, parameters=None):
        super().__init__(evaluator_result)
        self.pass_id = pass_id
        self.parameters = parameters


class BeginIteration:
    def __init__(self, pass_id: int, batch_id: int):
        self.pass_id = pass_id
        self.batch_id = batch_id


class EndIteration(WithMetric):
    def __init__(self, pass_id: int, batch_id: int, cost,
                 evaluator_result=None):
        super().__init__(evaluator_result)
        self.pass_id = pass_id
        self.batch_id = batch_id
        self._cost_raw = cost
        self._cost: Optional[float] = None

    @property
    def cost(self) -> float:
        """Plain float; waits for the card on first access."""
        if self._cost is None:
            self._cost = float(self._cost_raw)
        return self._cost


class TestResult(WithMetric):
    def __init__(self, cost: float, evaluator_result=None):
        super().__init__(evaluator_result)
        self.cost = cost

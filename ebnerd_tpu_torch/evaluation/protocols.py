"""Metric protocol + MetricEvaluator (copy of ``ebnerd_tpu/evaluation/protocols.py``),
API-compatible with the reference
(reference: src/ebrec/evaluation/metrics_protocols.py:141-217 and
protocols.py:5-17) but backed by the vectorized segment kernels in
``ranking.py`` instead of per-impression Python loops.
"""
from __future__ import annotations

import json
from typing import Iterable, Protocol, runtime_checkable

import numpy as np

from ..data.ragged import Ragged
from . import ranking

__all__ = [
    "Metric",
    "AucScore",
    "MrrScore",
    "NdcgScore",
    "LogLossScore",
    "AccuracyScore",
    "F1Score",
    "RootMeanSquaredError",
    "MetricEvaluator",
]


@runtime_checkable
class Metric(Protocol):
    name: str

    def calculate(self, y_true, y_pred) -> float:
        ...

    def __call__(self, y_true, y_pred) -> float:
        ...


def _as_ragged(rows) -> Ragged:
    if isinstance(rows, Ragged):
        return rows
    return Ragged.from_lists([np.asarray(r) for r in rows], dtype=np.float64)


class _SegmentMetric:
    """Mean over impressions of a per-impression segment metric."""

    name: str = ""

    def _per_impression(self, labels: Ragged, scores: Ragged) -> np.ndarray:
        raise NotImplementedError

    def calculate(self, y_true, y_pred) -> float:
        labels, scores = _as_ragged(y_true), _as_ragged(y_pred)
        vals = self._per_impression(labels, scores)
        return float(np.nanmean(vals))

    __call__ = calculate

    def __str__(self) -> str:
        return f"<{type(self).__name__}: {self.name}>"

    __repr__ = __str__


class AucScore(_SegmentMetric):
    name = "auc"

    def _per_impression(self, labels, scores):
        return ranking.per_impression_auc(labels, scores)


class MrrScore(_SegmentMetric):
    name = "mrr"

    def _per_impression(self, labels, scores):
        return ranking.per_impression_mrr(labels, scores)


class NdcgScore(_SegmentMetric):
    def __init__(self, k: int = 10):
        self.k = k
        self.name = f"ndcg@{k}"

    def _per_impression(self, labels, scores):
        return ranking.per_impression_ndcg(labels, scores, self.k)


class LogLossScore(_SegmentMetric):
    name = "logloss"

    def _per_impression(self, labels, scores):
        return ranking.per_impression_logloss(labels, scores)


class AccuracyScore(_SegmentMetric):
    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold
        self.name = "accuracy"

    def _per_impression(self, labels, scores):
        return ranking.per_impression_accuracy(labels, scores, self.threshold)


class F1Score(_SegmentMetric):
    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold
        self.name = "f1"

    def _per_impression(self, labels, scores):
        return ranking.per_impression_f1(labels, scores, self.threshold)


class RootMeanSquaredError(_SegmentMetric):
    name = "rmse"

    def _per_impression(self, labels, scores):
        return ranking.per_impression_rmse(labels, scores)


class MetricEvaluator:
    """Evaluate a set of metrics over ragged (labels, predictions)
    (reference: MetricEvaluator, metrics_protocols.py:141-217).

    >>> ev = MetricEvaluator(
    ...     labels=[[1, 0], [1, 1, 0]],
    ...     predictions=[[0.8, 0.1], [0.9, 0.2, 0.1]],
    ...     metric_functions=[AucScore(), MrrScore(), NdcgScore(5)],
    ... )
    >>> ev.evaluate().evaluations  # doctest: +SKIP
    {'auc': 1.0, 'mrr': 1.0, 'ndcg@5': 1.0}
    """

    def __init__(
        self,
        labels,
        predictions,
        metric_functions: Iterable[Metric],
    ):
        self.labels = _as_ragged(labels)
        self.predictions = _as_ragged(predictions)
        self.metric_functions = list(metric_functions)
        for m in self.metric_functions:
            if not (hasattr(m, "calculate") and callable(m.calculate)):
                raise AttributeError(f"{m} doesn't implement the Metric protocol")
        self.evaluations: dict[str, float] = {}

    def evaluate(self) -> "MetricEvaluator":
        self.evaluations = {
            m.name: m.calculate(self.labels, self.predictions)
            for m in self.metric_functions
        }
        return self

    def __str__(self) -> str:
        eval_str = json.dumps(self.evaluations, indent=4) if self.evaluations else (
            "{\n    <MetricEvaluator class>: 'evaluations' is empty, run evaluate() first\n}"
        )
        return f"<MetricEvaluator class>: \n {eval_str}"

    __repr__ = __str__

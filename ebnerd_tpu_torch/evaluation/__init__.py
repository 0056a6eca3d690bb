"""Ranking metrics and the metric evaluator (copies of ``ebnerd_tpu.evaluation``'s
``ranking`` and ``protocols``; beyond-accuracy metrics are ROADMAP A14)."""
from .protocols import (
    AccuracyScore,
    AucScore,
    F1Score,
    LogLossScore,
    Metric,
    MetricEvaluator,
    MrrScore,
    NdcgScore,
    RootMeanSquaredError,
)

__all__ = ["AccuracyScore", "AucScore", "F1Score", "LogLossScore", "Metric", "MetricEvaluator",
           "MrrScore", "NdcgScore", "RootMeanSquaredError"]

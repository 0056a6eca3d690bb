"""Ranking metrics, the metric evaluator and the beyond-accuracy metrics
(copies of ``ebnerd_tpu.evaluation``)."""
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
from .beyond_accuracy import (
    Coverage,
    Distribution,
    IntralistDiversity,
    Novelty,
    Sentiment,
    Serendipity,
)

__all__ = ["AccuracyScore", "AucScore", "Coverage", "Distribution", "F1Score",
           "IntralistDiversity", "LogLossScore", "Metric", "MetricEvaluator", "MrrScore",
           "NdcgScore", "Novelty", "RootMeanSquaredError", "Sentiment", "Serendipity"]

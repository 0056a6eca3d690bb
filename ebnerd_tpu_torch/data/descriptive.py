"""Descriptive dataset analysis helpers (copy of
``ebnerd_tpu/data/descriptive.py``)."""
from __future__ import annotations

import numpy as np

from ..constants import (
    DEFAULT_HISTORY_IMPRESSION_TIMESTAMP_COL,
    DEFAULT_IMPRESSION_TIMESTAMP_COL,
)
from .ragged import Ragged
from .table import Table

__all__ = [
    "min_max_impression_time_history",
    "min_max_impression_time_behaviors",
]


def min_max_impression_time_history(df: Table) -> tuple:
    """(min, max) over the ragged history timestamp column
    (reference: _descriptive_analysis.py:9-24)."""
    col: Ragged = df[DEFAULT_HISTORY_IMPRESSION_TIMESTAMP_COL]
    return col.values.min(), col.values.max()


def min_max_impression_time_behaviors(df: Table) -> tuple:
    """(min, max) over the behaviors impression timestamps
    (reference: _descriptive_analysis.py:27-36)."""
    col = np.asarray(df[DEFAULT_IMPRESSION_TIMESTAMP_COL])
    return col.min(), col.max()

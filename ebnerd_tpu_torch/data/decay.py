"""Recency decay weighting of user history (copy of
``ebnerd_tpu/data/decay.py``): the weight lists, and their application as a
dense multiply along the history axis (``apply_decay_dense``), which
works on numpy arrays and torch tensors alike.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from .ragged import Ragged
from .table import Table

__all__ = [
    "linear_decay_weights",
    "exponential_decay_weights",
    "add_decay_weights",
    "decay_weights_for_lengths",
    "apply_decay_dense",
]


def linear_decay_weights(n: int, ascending: bool = True, **kwargs) -> list[float]:
    """[1/n, 2/n, ..., 1.0] ascending (reference: _decay.py:7-26).

    >>> linear_decay_weights(5, True)
    [0.2, 0.4, 0.6, 0.8, 1.0]
    """
    weights = [(n - i) / n for i in range(n)]
    return weights[::-1] if ascending else weights


def exponential_decay_weights(
    n: int, lambda_factor: float, ascending: bool = True, **kwargs
) -> list[float]:
    """lambda^(n-1-i) (reference: _decay.py:29-51).

    >>> exponential_decay_weights(5, 0.5, True)
    [0.0625, 0.125, 0.25, 0.5, 1.0]
    """
    weights = [lambda_factor ** (n - i - 1) for i in range(n)]
    return weights if ascending else weights[::-1]


def decay_weights_for_lengths(
    lengths: np.ndarray, decay_func: Callable, ascending: bool = True, **kwargs
) -> Ragged:
    """Ragged weight column with one weight list per row length."""
    rows = [decay_func(n=int(n), ascending=ascending, **kwargs) for n in lengths]
    return Ragged.from_lists(rows, dtype=np.float64)


def add_decay_weights(
    df: Table,
    column: str,
    decay_func: Callable = linear_decay_weights,
    ascending: bool = True,
    **kwargs,
) -> Table:
    """Attach ``{column}_weights`` holding per-row decay weights
    (reference: add_decay_weights, _decay.py:54-97)."""
    col: Ragged = df[column]
    return df.with_columns(
        **{f"{column}_weights": decay_weights_for_lengths(
            col.lengths, decay_func, ascending, **kwargs
        )}
    )


def apply_decay_dense(history: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """Weight a dense history tensor [..., H, D] by per-article weights
    [..., H] — the device-side equivalent of the reference's
    ``decay_weighting_nested_lists`` (_decay.py:100-171) on the padded
    representation. Works on numpy arrays and torch tensors."""
    return history * weights[..., None]

"""Evaluation utilities (copy of ``ebnerd_tpu/evaluation/utils.py``)."""
from __future__ import annotations

import math
from collections import Counter
from typing import Iterable

import numpy as np

__all__ = [
    "convert_to_binary",
    "is_iterable_nested_dtype",
    "compute_combinations",
    "scale_range",
    "compute_item_popularity_scores",
    "compute_normalized_distribution",
    "get_keys_in_dict",
    "check_key_in_all_nested_dicts",
]


def convert_to_binary(y_pred: np.ndarray, threshold: float) -> np.ndarray:
    """Threshold scores to {0, 1} (reference: utils.py:6-10)."""
    y_pred = np.asarray(y_pred)
    return np.where(y_pred >= threshold, 1, 0)


def is_iterable_nested_dtype(iterable: Iterable, dtypes) -> bool:
    """Whether the first element is of the given dtype(s) — the reference's
    nestedness probe (reference: utils.py:13-33)."""
    return isinstance(iterable[0], dtypes)


def compute_combinations(n: int, r: int) -> int:
    """nCr (reference: utils.py:36-55)."""
    return math.comb(n, r)


def scale_range(
    m: np.ndarray,
    r_min: float | None = None,
    r_max: float | None = None,
    t_min: float = 0,
    t_max: float = 1.0,
) -> np.ndarray:
    """Min-max scale into [t_min, t_max] (reference: utils.py:58-81)."""
    m = np.asarray(m)
    if not r_min:
        r_min = np.min(m)
    if not r_max:
        r_max = np.max(m)
    return ((m - r_min) / (r_max - r_min)) * (t_max - t_min) + t_min


def compute_item_popularity_scores(R: Iterable[np.ndarray]) -> dict:
    """p_i = |{u : i ∈ R_u}| / |U| — fraction-of-users popularity
    (reference: utils.py:85-120; note the reference counts duplicate
    occurrences within one user, matched here)."""
    U = len(list(R)) if not hasattr(R, "__len__") else len(R)
    flat = np.concatenate([np.asarray(r) for r in R]) if U else np.empty(0)
    counts = Counter(flat.tolist())
    return {item: c / U for item, c in counts.items()}


def compute_normalized_distribution(
    R: np.ndarray,
    weights: np.ndarray | None = None,
    distribution: dict | None = None,
) -> dict:
    """Weighted normalized histogram of item representations
    (reference: utils.py:123-152)."""
    n = len(R)
    distr = distribution if distribution is not None else {}
    weights = weights if weights is not None else np.ones(n) / n
    for item, w in zip(R, weights):
        distr[item] = w + distr.get(item, 0.0)
    return distr


def get_keys_in_dict(id_list, dictionary: dict) -> list:
    """Subset of ids present as keys (reference: utils.py:155-169)."""
    return [i for i in id_list if i in dictionary]


def check_key_in_all_nested_dicts(dictionary: dict, key: str) -> None:
    """Raise unless ``key`` appears in every nested dict
    (reference: utils.py:172-198)."""
    for dict_key, sub in dictionary.items():
        if not isinstance(sub, dict) or key not in sub:
            raise ValueError(f"'{key}' is not present in '{dict_key}' nested dictionary.")

"""Beyond-accuracy evaluation: diversity, serendipity, novelty, coverage,
sentiment, distribution, index of dispersion (copy of
``ebnerd_tpu/evaluation/beyond_accuracy.py``, numpy).

The default cosine path uses the normalized-sum identity

  sum_{i != j} cos_dist(i, j) = k(k-1) - (|sum v^|^2 - k)

instead of k x k pairwise-distance matrices per row: O(k d) per row, which
matters at the 250-candidate beyond-accuracy lists. A custom
``pairwise_distance_function`` takes the generic path.
"""
from __future__ import annotations

from collections import Counter
from itertools import chain, combinations
from typing import Callable, Iterable, Optional

import numpy as np

from .utils import (
    check_key_in_all_nested_dicts,
    compute_combinations,
    compute_normalized_distribution,
    get_keys_in_dict,
    is_iterable_nested_dtype,
)

__all__ = [
    "cosine_distances",
    "intralist_diversity",
    "serendipity",
    "coverage_count",
    "coverage_fraction",
    "novelty",
    "index_of_dispersion",
    "IntralistDiversity",
    "Distribution",
    "Coverage",
    "Sentiment",
    "Serendipity",
    "Novelty",
]


def cosine_distances(X: np.ndarray, Y: np.ndarray) -> np.ndarray:
    """1 - cosine similarity, pairwise (sklearn-compatible semantics; zero
    vectors get similarity 0 like sklearn's epsilon-guarded norm)."""
    X = np.asarray(X, dtype=np.float64)
    Y = np.asarray(Y, dtype=np.float64)
    xn = np.linalg.norm(X, axis=1, keepdims=True)
    yn = np.linalg.norm(Y, axis=1, keepdims=True)
    xs = X / np.where(xn == 0, 1.0, xn)
    ys = Y / np.where(yn == 0, 1.0, yn)
    return 1.0 - xs @ ys.T


def _normalize_rows(V: np.ndarray) -> np.ndarray:
    V = np.asarray(V, dtype=np.float64)
    n = np.linalg.norm(V, axis=1, keepdims=True)
    return V / np.where(n == 0, 1.0, n)


# ---------------------------------------------------------------------------
# Low-level metric math (reference: metrics/_beyond_accuracy.py)
# ---------------------------------------------------------------------------


def intralist_diversity(
    R: np.ndarray, pairwise_distance_function: Optional[Callable] = None
) -> float:
    """Mean pairwise distance within one recommendation list (Smyth &
    McClave 2001; reference: _beyond_accuracy.py:8-52). NaN for lists of
    length <= 1."""
    R = np.asarray(R)
    n = R.shape[0]
    if n <= 1:
        return float("nan")
    if pairwise_distance_function is None:
        v = _normalize_rows(R)
        s = v.sum(axis=0)
        total = n * (n - 1) - (float(s @ s) - n)
        return total / (n * (n - 1))
    d = pairwise_distance_function(R, R)
    return float(np.sum(d)) / (n * (n - 1))


def serendipity(
    R: np.ndarray, H: np.ndarray, pairwise_distance_function: Optional[Callable] = None
) -> float:
    """Mean distance between recommendations and history (Lu et al. 2020;
    reference: _beyond_accuracy.py:55-94)."""
    if pairwise_distance_function is None:
        r = _normalize_rows(np.asarray(R))
        h = _normalize_rows(np.asarray(H))
        return 1.0 - float(r.sum(axis=0) @ h.sum(axis=0)) / (len(r) * len(h))
    return float(np.mean(pairwise_distance_function(np.asarray(R), np.asarray(H))))


def coverage_count(R: np.ndarray) -> int:
    """Distinct items recommended (reference: _beyond_accuracy.py:97-112)."""
    return int(np.unique(np.asarray(R)).size)


def coverage_fraction(R: np.ndarray, C: np.ndarray) -> float:
    """|unique(R)| / |unique(C)| (reference: _beyond_accuracy.py:115-134)."""
    return np.unique(np.asarray(R)).size / np.unique(np.asarray(C)).size


def novelty(R: np.ndarray) -> float:
    """Mean -log2 popularity (Zhou et al. 2010, Vargas & Castells 2011;
    reference: _beyond_accuracy.py:137-165)."""
    return float(np.mean(-np.log2(np.asarray(R, dtype=np.float64))))


def index_of_dispersion(x: Iterable) -> float:
    """Variance-to-mean ratio for nominal data
    (reference: _beyond_accuracy.py:168-225)."""
    x = list(x)
    n = len(x)
    count = Counter(x)
    k = len(count)
    if k == 1:
        return float("nan") if n == 1 else 0.0
    f_sq = sum(c * c for c in count.values())
    return k * (n * n - f_sq) / (n * n * (k - 1))


# ---------------------------------------------------------------------------
# Dict-API wrappers (reference: beyond_accuracy.py classes)
# ---------------------------------------------------------------------------


def _vectors_for(ids: list, lookup_dict: dict, lookup_key: str) -> np.ndarray:
    return np.array([lookup_dict[i].get(lookup_key) for i in ids])


class IntralistDiversity:
    """Per-impression intralist diversity over a nested attribute dict
    (reference: beyond_accuracy.py:25-154)."""

    def __init__(self) -> None:
        self.name = "intralist_diversity"

    def __call__(
        self,
        R,
        lookup_dict: dict,
        lookup_key: str,
        pairwise_distance_function: Optional[Callable] = None,
    ) -> np.ndarray:
        check_key_in_all_nested_dicts(lookup_dict, lookup_key)
        out = []
        for sample in R:
            ids = get_keys_in_dict(sample, lookup_dict)
            if len(ids) == 0:
                out.append(np.nan)
            else:
                out.append(
                    intralist_diversity(
                        _vectors_for(ids, lookup_dict, lookup_key),
                        pairwise_distance_function,
                    )
                )
        return np.asarray(out)

    def _candidate_diversity(
        self,
        R,
        n_recommendations: int,
        lookup_dict: dict,
        lookup_key: str,
        pairwise_distance_function: Optional[Callable] = None,
        max_number_combinations: int = 20000,
        seed: Optional[int] = None,
    ) -> tuple[float, float]:
        """Min/max diversity over candidate combinations — exhaustive when
        feasible, sampled beyond ``max_number_combinations``
        (reference: beyond_accuracy.py:98-154)."""
        check_key_in_all_nested_dicts(lookup_dict, lookup_key)
        R = get_keys_in_dict(R, lookup_dict)
        n_items = len(R)
        if n_recommendations > n_items:
            raise ValueError(
                "'n_recommendations' cannot exceed the number of items in R "
                f"(items in candidate list). {n_recommendations} > {n_items}"
            )
        n_comb = compute_combinations(n_items, n_recommendations)
        if n_comb > max_number_combinations:
            rng = np.random.default_rng(seed)
            iterable = chain(
                rng.choice(R, n_recommendations, replace=False)
                for _ in range(max_number_combinations)
            )
        else:
            iterable = combinations(R, n_recommendations)
        scores = self(iterable, lookup_dict, lookup_key, pairwise_distance_function)
        return float(np.nanmin(scores)), float(np.nanmax(scores))


class Distribution:
    """Normalized attribute histogram over all recommended items
    (reference: beyond_accuracy.py:158-208). Handles nested (multi-label)
    attributes by flattening."""

    def __init__(self) -> None:
        self.name = "distribution"

    def __call__(self, R, lookup_dict: dict, lookup_key: str) -> dict:
        check_key_in_all_nested_dicts(lookup_dict, lookup_key)
        flat = np.asarray(R).ravel()
        flat = get_keys_in_dict(flat, lookup_dict)
        reprs = [lookup_dict[i].get(lookup_key) for i in flat]
        if reprs and is_iterable_nested_dtype(reprs, (list, np.ndarray)):
            reprs = np.concatenate(reprs)
        return compute_normalized_distribution(reprs)


class Coverage:
    """(count, fraction) catalog coverage
    (reference: beyond_accuracy.py:212-245)."""

    def __init__(self) -> None:
        self.name = "coverage"

    def __call__(self, R, C=()) -> tuple[int, float]:
        c = coverage_count(R)
        f = coverage_fraction(R, C) if len(C) > 0 else -np.inf
        return c, f


class Sentiment:
    """Mean sentiment score per recommendation list
    (reference: beyond_accuracy.py:249-336)."""

    def __init__(self) -> None:
        self.name = "sentiment"

    def __call__(self, R, lookup_dict: dict, lookup_key: str) -> np.ndarray:
        check_key_in_all_nested_dicts(lookup_dict, lookup_key)
        out = []
        for sample in R:
            ids = get_keys_in_dict(sample, lookup_dict)
            out.append(np.mean([lookup_dict[i].get(lookup_key) for i in ids]))
        return np.asarray(out)

    def _candidate_sentiment(
        self, R, n_recommendations: int, lookup_dict: dict, lookup_key: str
    ) -> tuple[float, float]:
        """(min, max) attainable mean sentiment over the candidate list
        (reference: beyond_accuracy.py:304-336)."""
        check_key_in_all_nested_dicts(lookup_dict, lookup_key)
        R = get_keys_in_dict(R, lookup_dict)
        scores = sorted(lookup_dict[i].get(lookup_key) for i in R)
        return (
            float(np.mean(scores[-n_recommendations:])),
            float(np.mean(scores[:n_recommendations])),
        )


class Serendipity:
    """Per-user mean distance between recommendations and click history
    (reference: beyond_accuracy.py:340-427)."""

    def __init__(self) -> None:
        self.name = "serendipity"

    def __call__(
        self,
        R,
        H,
        lookup_dict: dict,
        lookup_key: str,
        pairwise_distance_function: Optional[Callable] = None,
    ) -> np.ndarray:
        if len(R) != len(H):
            raise ValueError(
                f"The lengths of 'R' and 'H' do not match ({len(R)} != {len(H)})."
            )
        check_key_in_all_nested_dicts(lookup_dict, lookup_key)
        out = []
        for r_u, h_u in zip(R, H):
            r_ids = get_keys_in_dict(np.asarray(r_u).ravel(), lookup_dict)
            h_ids = get_keys_in_dict(np.asarray(h_u).ravel(), lookup_dict)
            if len(r_ids) == 0 or len(h_ids) == 0:
                out.append(np.nan)
            else:
                out.append(
                    serendipity(
                        _vectors_for(r_ids, lookup_dict, lookup_key),
                        _vectors_for(h_ids, lookup_dict, lookup_key),
                        pairwise_distance_function,
                    )
                )
        return np.asarray(out)


class Novelty:
    """Per-list novelty from precomputed popularity scores
    (reference: beyond_accuracy.py:431-520)."""

    def __init__(self) -> None:
        self.name = "novelty"

    def __call__(self, R, lookup_dict: dict, lookup_key: str) -> np.ndarray:
        check_key_in_all_nested_dicts(lookup_dict, lookup_key)
        out = []
        for r_u in R:
            ids = get_keys_in_dict(r_u, lookup_dict)
            out.append(novelty([lookup_dict[i].get(lookup_key) for i in ids]))
        return np.asarray(out)

    def _candidate_novelty(
        self, R, n_recommendations: int, lookup_dict: dict, lookup_key: str
    ) -> tuple[float, float]:
        """(min, max) attainable novelty over the candidate list
        (reference: beyond_accuracy.py:488-520)."""
        check_key_in_all_nested_dicts(lookup_dict, lookup_key)
        R = get_keys_in_dict(R, lookup_dict)
        scores = sorted(lookup_dict[i].get(lookup_key) for i in R)
        return (
            novelty(scores[-n_recommendations:]),
            novelty(scores[:n_recommendations]),
        )

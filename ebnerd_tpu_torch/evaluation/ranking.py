"""Vectorized per-impression ranking metrics over ragged label/score columns
(copy of ``ebnerd_tpu/evaluation/ranking.py``).

Semantic counterpart of the reference evaluation layer
(reference: src/ebrec/evaluation/metrics_protocols.py:21-138 and
src/ebrec/evaluation/metrics/_ranking.py), which loops over impressions in
Python calling sklearn per row. Here every metric is one flat pass of
segment kernels (lexsort + prefix sums) over the whole ragged stream —
thousands of times faster on CPU and trivially chunkable.

All functions take two aligned Ragged columns (labels, scores) and return
a float64 array with one value per impression; the ``*_score`` wrappers
mean-reduce exactly like the reference's per-impression averaging
(metrics_protocols.py:77-86).
"""
from __future__ import annotations

import numpy as np

from ..data.ragged import Ragged

__all__ = [
    "per_impression_auc",
    "per_impression_mrr",
    "per_impression_ndcg",
    "per_impression_logloss",
    "per_impression_accuracy",
    "per_impression_f1",
    "per_impression_rmse",
]


def _check(labels: Ragged, scores: Ragged) -> None:
    if len(labels) != len(scores) or labels.total != scores.total:
        raise ValueError("labels and scores must have identical ragged structure")


def _segment_sum(values: np.ndarray, row_ids: np.ndarray, n: int) -> np.ndarray:
    return np.bincount(row_ids, weights=values, minlength=n)


def _average_ranks(scores: np.ndarray, row_ids: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """Within-row ranks (1-based, ascending) with average tie handling —
    matching sklearn's roc_auc_score rank statistic."""
    order = np.lexsort((scores, row_ids))
    s_sorted = scores[order]
    r_sorted = row_ids[order]
    pos_in_row = np.arange(len(scores), dtype=np.int64) - starts[r_sorted]
    # tie-group boundaries: new row or new score value
    new_group = np.ones(len(scores), dtype=bool)
    if len(scores) > 1:
        new_group[1:] = (r_sorted[1:] != r_sorted[:-1]) | (s_sorted[1:] != s_sorted[:-1])
    group_id = np.cumsum(new_group) - 1
    n_groups = group_id[-1] + 1 if len(scores) else 0
    group_sum = np.bincount(group_id, weights=pos_in_row + 1.0, minlength=n_groups)
    group_cnt = np.bincount(group_id, minlength=n_groups)
    avg = group_sum / np.maximum(group_cnt, 1)
    ranks = np.empty(len(scores), dtype=np.float64)
    ranks[order] = avg[group_id]
    return ranks


def per_impression_auc(labels: Ragged, scores: Ragged) -> np.ndarray:
    """ROC-AUC per impression via the Mann-Whitney rank statistic
    (numerically identical to sklearn.roc_auc_score incl. tie handling,
    which the reference calls per row, metrics_protocols.py:77-86).
    Impressions with no positive or no negative yield NaN."""
    _check(labels, scores)
    n = len(labels)
    rows = labels.row_ids()
    starts = labels.offsets[:-1]
    ranks = _average_ranks(scores.values.astype(np.float64), rows, starts)
    y = labels.values.astype(np.float64)
    npos = _segment_sum(y, rows, n)
    ntot = labels.lengths.astype(np.float64)
    nneg = ntot - npos
    pos_rank_sum = _segment_sum(ranks * y, rows, n)
    with np.errstate(invalid="ignore", divide="ignore"):
        auc = (pos_rank_sum - npos * (npos + 1) / 2.0) / (npos * nneg)
    auc[(npos == 0) | (nneg == 0)] = np.nan
    return auc


def _desc_sort(labels: Ragged, scores: Ragged):
    """Labels sorted by descending score within each row, plus 0-based
    position within row. Ties keep original order (stable): the reference's
    unstable ``np.argsort(score)[::-1]`` leaves tie order unspecified, so we
    pin the deterministic choice."""
    rows = labels.row_ids()
    order = np.lexsort((-scores.values.astype(np.float64), rows))
    y_sorted = labels.values.astype(np.float64)[order]
    pos = np.arange(labels.total, dtype=np.int64) - labels.offsets[:-1][rows[order]]
    return y_sorted, rows[order], pos


def per_impression_mrr(labels: Ragged, scores: Ragged) -> np.ndarray:
    """MRR per impression (reference: mrr_score, metrics/_ranking.py:126-155):
    sum over positives of 1/(rank) divided by the number of positives."""
    _check(labels, scores)
    n = len(labels)
    y_sorted, rows_sorted, pos = _desc_sort(labels, scores)
    rr = _segment_sum(y_sorted / (pos + 1.0), rows_sorted, n)
    npos = _segment_sum(labels.values.astype(np.float64), labels.row_ids(), n)
    with np.errstate(invalid="ignore", divide="ignore"):
        out = rr / npos
    out[npos == 0] = np.nan
    return out


def per_impression_ndcg(labels: Ragged, scores: Ragged, k: int = 10) -> np.ndarray:
    """NDCG@k per impression with 2^rel - 1 gains
    (reference: ndcg_score/dcg_score, metrics/_ranking.py:53-123)."""
    _check(labels, scores)
    n = len(labels)
    y_sorted, rows_sorted, pos = _desc_sort(labels, scores)
    gains = (np.exp2(y_sorted) - 1.0) * (pos < k)
    discounts = 1.0 / np.log2(pos + 2.0)
    dcg = _segment_sum(gains * discounts, rows_sorted, n)
    # ideal ordering: sort labels descending within row
    rows = labels.row_ids()
    iorder = np.lexsort((-labels.values.astype(np.float64), rows))
    iy = labels.values.astype(np.float64)[iorder]
    ipos = np.arange(labels.total, dtype=np.int64) - labels.offsets[:-1][rows[iorder]]
    igains = (np.exp2(iy) - 1.0) * (ipos < k)
    idcg = _segment_sum(igains / np.log2(ipos + 2.0), rows[iorder], n)
    with np.errstate(invalid="ignore", divide="ignore"):
        out = dcg / idcg
    out[idcg == 0] = np.nan
    return out


def per_impression_logloss(labels: Ragged, scores: Ragged, eps: float = 1e-15) -> np.ndarray:
    """Binary log-loss per impression with the reference's clipping
    (reference: LogLossScore, metrics_protocols.py:89-105)."""
    _check(labels, scores)
    n = len(labels)
    rows = labels.row_ids()
    p = np.clip(scores.values.astype(np.float64), eps, 1 - eps)
    y = labels.values.astype(np.float64)
    ll = -(y * np.log(p) + (1 - y) * np.log(1 - p))
    return _segment_sum(ll, rows, n) / np.maximum(labels.lengths, 1)


def per_impression_accuracy(labels: Ragged, scores: Ragged, threshold: float = 0.5) -> np.ndarray:
    """Accuracy of thresholded scores per impression
    (reference: AccuracyScore, metrics_protocols.py:21-36)."""
    _check(labels, scores)
    n = len(labels)
    rows = labels.row_ids()
    pred = (scores.values.astype(np.float64) > threshold).astype(np.float64)
    correct = (pred == labels.values.astype(np.float64)).astype(np.float64)
    return _segment_sum(correct, rows, n) / np.maximum(labels.lengths, 1)


def per_impression_f1(labels: Ragged, scores: Ragged, threshold: float = 0.5) -> np.ndarray:
    """Binary F1 of thresholded scores per impression
    (reference: F1Score, metrics_protocols.py:39-54). Rows with no
    predicted and no actual positives get 0.0 (sklearn's zero_division=0
    warning behavior)."""
    _check(labels, scores)
    n = len(labels)
    rows = labels.row_ids()
    pred = (scores.values.astype(np.float64) > threshold).astype(np.float64)
    y = labels.values.astype(np.float64)
    tp = _segment_sum(pred * y, rows, n)
    fp = _segment_sum(pred * (1 - y), rows, n)
    fn = _segment_sum((1 - pred) * y, rows, n)
    denom = 2 * tp + fp + fn
    with np.errstate(invalid="ignore", divide="ignore"):
        f1 = 2 * tp / denom
    f1[denom == 0] = 0.0
    return f1


def per_impression_rmse(labels: Ragged, scores: Ragged) -> np.ndarray:
    """RMSE per impression (reference: RootMeanSquaredError,
    metrics_protocols.py:57-70)."""
    _check(labels, scores)
    n = len(labels)
    rows = labels.row_ids()
    err = (scores.values.astype(np.float64) - labels.values.astype(np.float64)) ** 2
    return np.sqrt(_segment_sum(err, rows, n) / np.maximum(labels.lengths, 1))

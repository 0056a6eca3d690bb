"""Training and eval feeds (copy of ``ebnerd_tpu/data/dataloader.py``).

Batches carry int32 row indices ([B, H] and [B, K]) into the article
value table; the gather ``table[idx]`` happens on the device.
``NewsrecFeed`` yields fixed-shape training batches in a seeded shuffle
order. ``EvalFeed`` keeps all of an impression's candidates in one row,
padded to the width of its bucket, with a candidate mask; ``unpad``
returns one flat score stream aligned with the inview column.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from ..constants import (
    DEFAULT_HISTORY_ARTICLE_ID_COL,
    DEFAULT_INVIEW_ARTICLES_COL,
    DEFAULT_LABELS_COL,
    DEFAULT_USER_COL,
)
from .lookup import Lookup
from .ragged import Ragged
from .table import Table

__all__ = ["NewsrecFeed", "EvalFeed", "pad_to_multiple"]


def pad_to_multiple(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def _map_users(users, user_mapping: dict[int, int]) -> np.ndarray:
    """User ids -> int indices; unseen users map to ``len(user_mapping)``
    (one past the last trained user), as in the JAX package."""
    users = np.asarray(users)
    n = len(user_mapping)
    if n == 0:
        return np.full(users.shape[0], n, dtype=np.int32)
    keys = np.fromiter(user_mapping.keys(), dtype=np.int64, count=n)
    vals = np.fromiter(user_mapping.values(), dtype=np.int64, count=n)
    order = np.argsort(keys)
    keys, vals = keys[order], vals[order]
    u = users.astype(np.int64)
    pos = np.clip(np.searchsorted(keys, u), 0, n - 1)
    hit = keys[pos] == u
    return np.where(hit, vals[pos], n).astype(np.int32)


def _dense_indices(
    col: Ragged, lookup: Lookup, width: int, align: str
) -> tuple[np.ndarray, np.ndarray]:
    """Ragged id column -> ([N, width] int32 row indices, bool mask)."""
    mapped = lookup.map_ragged(col)
    dense, mask = mapped.to_padded(width, pad_value=0, align=align)
    return dense.astype(np.int32), mask


@dataclass
class NewsrecFeed:
    """Training feed: fixed-shape batches of row indices + labels.

    Expects behaviors that went through the wu2019 negative sampler and
    ``create_binary_labels_column``, so every row has exactly
    ``npratio + 1`` candidates. Each ``epoch()`` reshuffles with
    ``numpy.random.default_rng(seed + epoch)``, as the JAX feed does.

    Output batch:
      hist_idx  int32 [B, H]   rows into the article value table
      cand_idx  int32 [B, K]
      labels    float32 [B, K]
      user_idx  int32 [B]      (when ``user_mapping`` is given)
    """

    behaviors: Table
    lookup: Lookup
    history_size: int
    batch_size: int
    user_mapping: Optional[dict[int, int]] = None
    history_col: str = DEFAULT_HISTORY_ARTICLE_ID_COL
    inview_col: str = DEFAULT_INVIEW_ARTICLES_COL
    label_col: str = DEFAULT_LABELS_COL
    user_col: str = DEFAULT_USER_COL
    seed: int = 0
    drop_remainder: bool = True

    def __post_init__(self):
        df = self.behaviors
        inview: Ragged = df[self.inview_col]
        k = np.unique(inview.lengths)
        if len(k) != 1:
            raise ValueError(
                f"training feed needs a fixed candidate count; got lengths {k}. "
                "Run sampling_strategy_wu2019 first.")
        self.n_candidates = int(k[0])
        self.hist_idx, self.hist_mask = _dense_indices(
            df[self.history_col], self.lookup, self.history_size, align="right")
        self.cand_idx, _ = _dense_indices(inview, self.lookup, self.n_candidates, align="left")
        labels: Ragged = df[self.label_col]
        self.labels = labels.values.reshape(len(df), self.n_candidates).astype(np.float32)
        if self.user_mapping is not None:
            self.user_idx = _map_users(df[self.user_col], self.user_mapping)
        else:
            self.user_idx = None
        self._epoch = 0

    def __len__(self) -> int:
        n = self.hist_idx.shape[0]
        return n // self.batch_size if self.drop_remainder else -(-n // self.batch_size)

    @property
    def n_rows(self) -> int:
        return self.hist_idx.shape[0]

    def epoch(self, shuffle: bool = True,
              epoch: Optional[int] = None) -> Iterator[dict[str, np.ndarray]]:
        """One epoch of batches; each call reshuffles deterministically.
        ``epoch`` pins the order to that epoch index without advancing the
        internal counter."""
        n = self.n_rows
        if epoch is None:
            epoch = self._epoch
            self._epoch += 1
        order = np.arange(n)
        if shuffle:
            order = np.random.default_rng(self.seed + epoch).permutation(n)
        bs = self.batch_size
        stop = (n // bs) * bs if self.drop_remainder else n
        for start in range(0, stop, bs):
            idx = order[start : start + bs]
            batch = {
                "hist_idx": self.hist_idx[idx],
                "cand_idx": self.cand_idx[idx],
                "labels": self.labels[idx],
            }
            if self.user_idx is not None:
                batch["user_idx"] = self.user_idx[idx]
            yield batch


def _choose_bucket_widths(lengths: np.ndarray, n_buckets: int,
                          multiple: int = 8) -> list[int]:
    """Candidate-width buckets (each a multiple of 8, last = max width),
    cut at row-count quantiles so each bucket carries real mass."""
    widths = np.maximum(
        ((lengths + multiple - 1) // multiple) * multiple, multiple)
    uniq = np.unique(widths)
    if len(uniq) <= n_buckets:
        return [int(w) for w in uniq]
    qs = np.quantile(widths, [i / n_buckets for i in range(1, n_buckets)],
                     method="higher")
    return sorted({int(q) for q in qs} | {int(uniq[-1])})


@dataclass
class EvalFeed:
    """Scoring feed over ragged impressions: pad-to-bucket + candidate mask.

    Output batch:
      hist_idx  int32 [B, H]
      cand_idx  int32 [B, W_bucket]
      cand_mask bool  [B, W_bucket]
      user_idx  int32 [B]  (optional)
      rows      int64 [n_valid]  host-side: global row ids of this batch
      n_valid   int              host-side: real rows before padding
    """

    behaviors: Table
    lookup: Lookup
    history_size: int
    batch_size: int
    user_mapping: Optional[dict[int, int]] = None
    max_candidates: Optional[int] = None
    n_buckets: int = 4
    history_col: str = DEFAULT_HISTORY_ARTICLE_ID_COL
    inview_col: str = DEFAULT_INVIEW_ARTICLES_COL
    user_col: str = DEFAULT_USER_COL

    def __post_init__(self):
        df = self.behaviors
        inview: Ragged = df[self.inview_col]
        self.inview = inview
        kmax = int(inview.lengths.max()) if len(inview) else 1
        self.width = self.max_candidates or pad_to_multiple(max(kmax, 1), 8)
        if kmax > self.width:
            raise ValueError(f"impression with {kmax} candidates exceeds bucket {self.width}")
        if self.max_candidates or len(inview) == 0:
            self.bucket_widths = [self.width]
        else:
            self.bucket_widths = _choose_bucket_widths(
                inview.lengths, max(1, self.n_buckets))
        self.hist_idx, _ = _dense_indices(
            df[self.history_col], self.lookup, self.history_size, align="right"
        )
        # full-width candidates; batches() slices down to each bucket's width
        # (align="left" keeps real candidates in the leading columns)
        self.cand_idx, self.cand_mask = _dense_indices(
            inview, self.lookup, self.width, align="left"
        )
        lengths = inview.lengths if len(inview) else np.zeros(0, np.int64)
        self.row_bucket = np.searchsorted(self.bucket_widths, lengths)
        if self.user_mapping is not None:
            self.user_idx = _map_users(df[self.user_col], self.user_mapping)
        else:
            self.user_idx = None

    @property
    def n_rows(self) -> int:
        return self.hist_idx.shape[0]

    def __len__(self) -> int:
        return sum(-(-int((self.row_bucket == b).sum()) // self.batch_size)
                   for b in range(len(self.bucket_widths)))

    def batches(self) -> Iterator[dict[str, np.ndarray]]:
        """Per-bucket batches, each zero-padded to the full batch size, with
        their global ``rows`` so scores land in impression order."""
        bs = self.batch_size
        for b, w in enumerate(self.bucket_widths):
            rows = np.flatnonzero(self.row_bucket == b)
            for start in range(0, len(rows), bs):
                r = rows[start : start + bs]
                batch = {
                    "hist_idx": _pad_rows(self.hist_idx[r], bs),
                    "cand_idx": _pad_rows(self.cand_idx[r, :w], bs),
                    "cand_mask": _pad_rows(self.cand_mask[r, :w], bs),
                    "n_valid": len(r),
                    "rows": r,
                }
                if self.user_idx is not None:
                    batch["user_idx"] = _pad_rows(self.user_idx[r], bs)
                yield batch

    def unpad(self, scores: np.ndarray) -> Ragged:
        """[N, width] padded score matrix -> ragged scores aligned with the
        inview column (drop padded candidates)."""
        if scores.shape != (self.n_rows, self.width):
            raise ValueError(f"expected scores {(self.n_rows, self.width)}, got {scores.shape}")
        flat = scores[self.cand_mask].astype(np.float32)
        return Ragged(flat, self.inview.offsets.copy())


def _pad_rows(x: np.ndarray, n: int) -> np.ndarray:
    if x.shape[0] == n:
        return x
    pad = np.zeros((n - x.shape[0],) + x.shape[1:], dtype=x.dtype)
    return np.concatenate([x, pad], axis=0)

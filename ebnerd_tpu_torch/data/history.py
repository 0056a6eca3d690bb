"""User-history construction from raw interaction logs (copy of
``ebnerd_tpu/data/history.py``).

Null interactions are a caller-provided ``null_value`` sentinel (or NaN
for float columns); users without any qualifying history get empty lists.
Output rows are sorted by (user, timestamp).
"""
from __future__ import annotations

import numpy as np

from ..constants import (
    DEFAULT_ARTICLE_ID_COL,
    DEFAULT_IMPRESSION_TIMESTAMP_COL,
    DEFAULT_USER_COL,
)
from .ragged import Ragged, _ranges
from .table import Table

__all__ = [
    "create_dynamic_history",
    "create_fixed_history",
    "create_fixed_history_aggr_columns",
]


def _sorted_by_user_time(df: Table, user_col: str, timestamp_col: str):
    order = np.lexsort((np.asarray(df[timestamp_col]), np.asarray(df[user_col])))
    return df.take(order)


def _valid_mask(items: np.ndarray, null_value) -> np.ndarray:
    if items.dtype.kind == "f":
        mask = ~np.isnan(items)
        if null_value is not None:
            mask &= items != null_value
        return mask
    if null_value is None:
        return np.ones(len(items), dtype=bool)
    return items != null_value


def create_dynamic_history(
    df: Table,
    history_size: int,
    history_col: str = "history_dynamic",
    user_col: str = DEFAULT_USER_COL,
    item_col: str = DEFAULT_ARTICLE_ID_COL,
    timestamp_col: str = DEFAULT_IMPRESSION_TIMESTAMP_COL,
    null_value=None,
) -> Table:
    """Per row: the user's previous up-to-``history_size`` interactions
    (rolling window over ROWS, left-closed, nulls dropped afterwards —
    matching the reference's rolling + drop_nulls order,
    _behaviors.py:657-750)."""
    df = _sorted_by_user_time(df, user_col, timestamp_col)
    users = np.asarray(df[user_col])
    items = np.asarray(df[item_col])
    n = len(df)
    group_start = np.zeros(n, dtype=np.int64)
    if n:
        new_group = np.r_[True, users[1:] != users[:-1]]
        group_start = np.maximum.accumulate(np.where(new_group, np.arange(n), 0))
    pos = np.arange(n)
    win_len = np.minimum(pos - group_start, history_size)
    starts = pos - win_len
    idx = _ranges(starts, win_len, int(win_len.sum()))
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(win_len, out=offsets[1:])
    hist = Ragged(items[idx], offsets)
    keep = _valid_mask(hist.values, null_value)
    return df.with_columns(**{history_col: hist.filter_values(keep)})


def create_fixed_history(
    df: Table,
    dt_cutoff,
    history_size: int | None = None,
    history_col: str = "history_fixed",
    user_col: str = DEFAULT_USER_COL,
    item_col: str = DEFAULT_ARTICLE_ID_COL,
    timestamp_col: str = DEFAULT_IMPRESSION_TIMESTAMP_COL,
    null_value=None,
) -> Table:
    """One fixed pre-cutoff history list per user, broadcast to all the
    user's rows (reference: _behaviors.py:753-859)."""
    out = create_fixed_history_aggr_columns(
        df, dt_cutoff, history_size=history_size, columns=[], suffix="",
        user_col=user_col, item_col=item_col, timestamp_col=timestamp_col,
        null_value=null_value,
    )
    tmp = "__fixed_" + item_col
    return out.with_columns(**{history_col: out[tmp]}).drop([tmp])


def create_fixed_history_aggr_columns(
    df: Table,
    dt_cutoff,
    history_size: int | None = None,
    columns: list[str] | None = None,
    suffix: str = "_fixed",
    user_col: str = DEFAULT_USER_COL,
    item_col: str = DEFAULT_ARTICLE_ID_COL,
    timestamp_col: str = DEFAULT_IMPRESSION_TIMESTAMP_COL,
    null_value=None,
) -> Table:
    """Aggregate item + auxiliary columns of the valid pre-cutoff
    interactions per user (tail-``history_size``), broadcast to every row
    of that user (reference: _behaviors.py:862-1021). New columns are
    ``<col><suffix>`` (empty suffix uses the prefix ``__fixed_``)."""
    columns = list(columns or [])
    df = _sorted_by_user_time(df, user_col, timestamp_col)
    users = np.asarray(df[user_col])
    items = np.asarray(df[item_col])
    times = np.asarray(df[timestamp_col])
    cutoff = np.datetime64(dt_cutoff, "us") if times.dtype.kind == "M" else dt_cutoff
    valid = _valid_mask(items, null_value) & (times < cutoff)

    n = len(df)
    # per-user contiguous groups in the sorted frame
    new_group = np.r_[True, users[1:] != users[:-1]] if n else np.empty(0, bool)
    group_id = np.cumsum(new_group) - 1 if n else np.empty(0, np.int64)
    n_groups = int(group_id[-1] + 1) if n else 0

    sel = np.flatnonzero(valid)           # sorted by (user, time) already
    sel_groups = group_id[sel]
    counts = np.bincount(sel_groups, minlength=n_groups).astype(np.int64)
    g_offsets = np.zeros(n_groups + 1, dtype=np.int64)
    np.cumsum(counts, out=g_offsets[1:])
    if history_size is not None:
        keep_len = np.minimum(counts, history_size)
        starts = g_offsets[1:] - keep_len
        keep_idx = _ranges(starts, keep_len, int(keep_len.sum()))
        sel = sel[keep_idx]
        counts = keep_len
        g_offsets = np.zeros(n_groups + 1, dtype=np.int64)
        np.cumsum(counts, out=g_offsets[1:])

    # broadcast each user's aggregated list to all of that user's rows
    per_row = Ragged(sel.astype(np.int64), g_offsets).take_rows(group_id)

    aggr_cols = [item_col] + [c for c in columns if c != item_col]
    out = df
    for col in aggr_cols:
        name = (col + suffix) if suffix else ("__fixed_" + col)
        src = df[col]
        if isinstance(src, Ragged):
            raise ValueError(f"cannot aggregate list column '{col}'")
        vals = np.asarray(src)[per_row.values]
        out = out.with_columns(**{name: Ragged(vals, per_row.offsets.copy())})
    return out

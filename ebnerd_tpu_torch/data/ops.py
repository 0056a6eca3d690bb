"""Generic Table/Ragged operations (copy of ``ebnerd_tpu/data/ops.py``):
row and within-row shuffles, splits, per-row filters and de-duplication,
each a flat vectorized numpy kernel over offsets + values.
"""
from __future__ import annotations

import numpy as np

from .ragged import Ragged
from .table import Table

__all__ = [
    "shuffle_rows",
    "shuffle_list_columns",
    "split_fraction",
    "split_in_n",
    "keep_unique_values_in_list",
    "filter_list_elements",
    "remove_list_elements",
    "filter_minimum_lengths_from_list",
    "filter_maximum_lengths_from_list",
    "drop_nulls_from_list",
    "concat_list_str",
    "from_dict_to_table",
]


def shuffle_rows(df: Table, seed: int | None = None) -> Table:
    """Row shuffle (reference: shuffle_rows, _polars.py:146-199)."""
    return df.shuffle(np.random.default_rng(seed))


def shuffle_list_columns(df: Table, columns: list[str], seed: int | None = None) -> Table:
    """Shuffle several aligned list columns with ONE shared within-row
    permutation (reference shuffles inview and labels together,
    _polars.py:593-684 + _behaviors.py create_binary_labels_column)."""
    if not columns:
        return df
    rng = np.random.default_rng(seed)
    first: Ragged = df[columns[0]]
    shuffled, perm = first.shuffle_within_rows(rng)
    out = {columns[0]: shuffled}
    for name in columns[1:]:
        col: Ragged = df[name]
        if col.total != first.total or len(col) != len(first):
            raise ValueError(f"column '{name}' not aligned with '{columns[0]}'")
        out[name] = Ragged(col.values[perm], col.offsets.copy())
    return df.with_columns(**out)


def split_fraction(
    df: Table, fraction: float, seed: int | None = None, shuffle: bool = True
) -> tuple[Table, Table]:
    """(head fraction, tail remainder) split (reference: split_df_fraction,
    _polars.py:339-358)."""
    n = len(df)
    k = int(round(n * fraction))
    order = (
        np.random.default_rng(seed).permutation(n) if shuffle else np.arange(n)
    )
    return df.take(order[:k]), df.take(order[k:])


def split_in_n(df: Table, n_splits: int) -> list[Table]:
    """n near-equal contiguous splits (reference: split_df_in_n,
    _polars.py:687-736)."""
    bounds = np.linspace(0, len(df), n_splits + 1).astype(np.int64)
    return [df.slice(int(a), int(b - a)) for a, b in zip(bounds[:-1], bounds[1:])]


def keep_unique_values_in_list(col: Ragged) -> Ragged:
    """Per-row de-duplication keeping first occurrence
    (reference: keep_unique_values_in_list, _polars.py:202-231)."""
    rows = col.row_ids()
    # first occurrence of each (row, value) pair
    order = np.lexsort((np.arange(col.total), col.values, rows))
    v_sorted, r_sorted = col.values[order], rows[order]
    first = np.ones(col.total, dtype=bool)
    if col.total > 1:
        first[1:] = (r_sorted[1:] != r_sorted[:-1]) | (v_sorted[1:] != v_sorted[:-1])
    keep = np.zeros(col.total, dtype=bool)
    keep[order[first]] = True
    return col.filter_values(keep)


def filter_list_elements(col: Ragged, allowed: np.ndarray) -> Ragged:
    """Keep only values in ``allowed`` (reference: filter_list_elements /
    filter_elements, _polars.py:450-544)."""
    return col.filter_values(np.isin(col.values, np.asarray(allowed)))


def remove_list_elements(col: Ragged, banned: np.ndarray) -> Ragged:
    """Drop values in ``banned``."""
    return col.filter_values(~np.isin(col.values, np.asarray(banned)))


def filter_minimum_lengths_from_list(df: Table, column: str, n: int | None) -> Table:
    """Keep rows whose list has at least n items (reference:
    _polars.py:234-287)."""
    if n is None:
        return df
    return df.filter(df[column].lengths >= n)


def filter_maximum_lengths_from_list(df: Table, column: str, n: int | None) -> Table:
    """Keep rows whose list has at most n items (reference:
    _polars.py:290-336)."""
    if n is None:
        return df
    return df.filter(df[column].lengths <= n)


def drop_nulls_from_list(col: Ragged) -> Ragged:
    """Drop null-ish values (NaN for float values, negative sentinel for
    ints is NOT assumed — only NaN/None handling; reference:
    drop_nulls_from_list, _polars.py:409-447)."""
    v = col.values
    if v.dtype.kind == "f":
        return col.filter_values(~np.isnan(v))
    if v.dtype == object:
        return col.filter_values(np.asarray([x is not None for x in v]))
    return col


def concat_list_str(col: Ragged, separator: str = " ") -> np.ndarray:
    """Join each row's strings into one string (reference: concat_list_str,
    _polars.py:739-771)."""
    return np.asarray(
        [separator.join(map(str, col.row(i))) for i in range(len(col))], dtype=object
    )


def from_dict_to_table(d: dict) -> Table:
    """Dict of columns -> Table (reference: from_dict_to_polars,
    _polars.py:122-143)."""
    out = {}
    for k, v in d.items():
        if isinstance(v, Ragged):
            out[k] = v
        elif len(v) and isinstance(v[0], (list, tuple, np.ndarray)):
            out[k] = Ragged.from_lists(list(v))
        else:
            out[k] = np.asarray(v)
    return Table(out)

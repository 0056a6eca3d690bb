"""EB-NeRD behaviors/history transforms over Ragged columns (copy of
``ebnerd_tpu/data/behaviors.py``, numpy paths).

Labels, Wu et al.'s negative sampling, history truncation and the
behaviors-history join, as flat numpy kernels over offsets + values, so
their output feeds the batch builders as dense arrays. The samplers draw
from ``np.random.default_rng(seed)`` in the JAX module's order, so the same
seed gives the same rows. ``ebnerd_from_path`` reads parquet and needs
pyarrow when it is called.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..constants import (
    DEFAULT_CLICKED_ARTICLES_COL,
    DEFAULT_HISTORY_ARTICLE_ID_COL,
    DEFAULT_INVIEW_ARTICLES_COL,
    DEFAULT_KNOWN_USER_COL,
    DEFAULT_LABELS_COL,
    DEFAULT_USER_COL,
)
from .ragged import Ragged
from .table import Table, read_parquet

__all__ = [
    "create_binary_labels_column",
    "sampling_strategy_wu2019",
    "truncate_history",
    "ebnerd_from_path",
    "ebnerd_from_tables",
    "remove_positives_from_inview",
    "sample_article_ids",
    "filter_minimum_negative_samples",
    "add_known_user_column",
    "add_prediction_scores",
    "unique_article_ids_in_behaviors",
    "create_user_id_to_int_mapping",
    "down_sample_on_users",
    "join_history",
]


def create_binary_labels_column(
    df: Table,
    shuffle: bool = False,
    seed: int | None = None,
    clicked_col: str = DEFAULT_CLICKED_ARTICLES_COL,
    inview_col: str = DEFAULT_INVIEW_ARTICLES_COL,
    label_col: str = DEFAULT_LABELS_COL,
) -> Table:
    """labels[i][j] = 1 iff inview[i][j] ∈ clicked[i] (int8 list column).

    With shuffle=True the inview list (and therefore the labels) are
    shuffled within each row. Matches the reference doctest
    (_behaviors.py:40-107): null/empty clicked rows yield all-zero labels.
    """
    inview: Ragged = df[inview_col]
    clicked: Ragged = df[clicked_col]
    if shuffle:
        rng = np.random.default_rng(seed)
        inview, _ = inview.shuffle_within_rows(rng)
        df = df.with_columns(**{inview_col: inview})
    labels = inview.isin_per_row(clicked).astype(np.int8)
    return df.with_columns(**{label_col: Ragged(labels, inview.offsets.copy())})


def truncate_history(
    df: Table,
    column: str,
    history_size: int,
    padding_value=None,
) -> Table:
    """Keep the tail-``history_size`` of each list; with a padding value,
    left-pad every row to exactly ``history_size``
    (reference: _behaviors.py:582-654 — reverse/extend_constant/reverse).
    """
    col: Ragged = df[column]
    if padding_value is None:
        return df.with_columns(**{column: col.tail(history_size)})
    dense, _ = col.to_padded(history_size, pad_value=padding_value, align="right")
    return df.with_columns(**{column: Ragged.from_dense(dense)})


def join_history(
    behaviors: Table,
    history: Table,
    user_col: str = DEFAULT_USER_COL,
) -> Table:
    """LEFT JOIN behaviors ⋈ history on user_id
    (reference: slice_join_dataframes, _polars.py:68-86). Users missing from
    history get empty history rows."""
    hist_users = np.asarray(history[user_col])
    order = np.argsort(hist_users, kind="stable")
    sorted_users = hist_users[order]
    b_users = np.asarray(behaviors[user_col])
    pos = np.searchsorted(sorted_users, b_users)
    pos_clipped = np.minimum(pos, len(sorted_users) - 1) if len(sorted_users) else pos * 0
    found = len(sorted_users) > 0
    match = (sorted_users[pos_clipped] == b_users) if found else np.zeros(len(b_users), bool)
    out = dict((n, behaviors[n]) for n in behaviors.columns)
    hist_idx = order[pos_clipped] if found else pos_clipped
    for name in history.columns:
        if name == user_col:
            continue
        col = history[name]
        if isinstance(col, Ragged):
            joined = col.take_rows(hist_idx)
            if not match.all():
                # blank out non-matching rows
                keep = np.repeat(match, joined.lengths)
                joined = joined.filter_values(keep)
            out[name] = joined
        else:
            vals = col[hist_idx]
            if not match.all():
                vals = np.where(match, vals, np.zeros((), dtype=col.dtype))
            out[name] = vals
    return Table(out)


def ebnerd_from_path(
    path: Path | str,
    history_size: int = 30,
    padding: int = 0,
    user_col: str = DEFAULT_USER_COL,
    history_aids_col: str = DEFAULT_HISTORY_ARTICLE_ID_COL,
) -> Table:
    """Load one EB-NeRD split: history.parquet (truncated/padded) joined
    onto behaviors.parquet (reference: ebnerd_from_path, _behaviors.py:161-192)."""
    path = Path(path)
    history = read_parquet(path / "history.parquet", columns=[user_col, history_aids_col])
    behaviors = read_parquet(path / "behaviors.parquet")
    return ebnerd_from_tables(behaviors, history, history_size, padding, user_col,
                              history_aids_col)


def ebnerd_from_tables(
    behaviors: Table,
    history: Table,
    history_size: int = 30,
    padding: int = 0,
    user_col: str = DEFAULT_USER_COL,
    history_aids_col: str = DEFAULT_HISTORY_ARTICLE_ID_COL,
) -> Table:
    """``ebnerd_from_path`` on a split's tables in memory: the history's
    article ids truncated/padded to ``history_size``, joined onto the
    behaviors."""
    history = truncate_history(
        history.select([user_col, history_aids_col]), column=history_aids_col,
        history_size=history_size, padding_value=padding
    )
    return join_history(behaviors, history, user_col=user_col)


def remove_positives_from_inview(
    df: Table,
    inview_col: str = DEFAULT_INVIEW_ARTICLES_COL,
    clicked_col: str = DEFAULT_CLICKED_ARTICLES_COL,
) -> Table:
    """Per-row set difference inview \\ clicked (reference: _behaviors.py:371-420)."""
    inview: Ragged = df[inview_col]
    clicked: Ragged = df[clicked_col]
    keep = ~inview.isin_per_row(clicked)
    return df.with_columns(**{inview_col: inview.filter_values(keep)})


def sample_article_ids(
    df: Table,
    n: int,
    with_replacement: bool = False,
    seed: int | None = None,
    inview_col: str = DEFAULT_INVIEW_ARTICLES_COL,
    *,
    empty_pool_value: int = 0,
) -> Table:
    """Sample ``n`` ids from each row of ``inview_col``
    (reference: _behaviors.py:275-368).

    With replacement, rows with an empty pool are padded with
    ``empty_pool_value`` (the reference emits nulls there, which its
    dataloaders immediately map to the padding/unknown index 0 — we fold
    that into the sampler). Without replacement, a row shorter than ``n``
    raises, matching polars' ShapeError.
    """
    rng = np.random.default_rng(seed)
    col: Ragged = df[inview_col]
    lengths = col.lengths
    n_rows = len(col)
    if with_replacement:
        pool = np.maximum(lengths, 1)
        draws = rng.integers(0, pool[:, None], size=(n_rows, n))
        flat = col.offsets[:-1, None] + draws
        sampled = np.where(
            (lengths == 0)[:, None],
            np.asarray(empty_pool_value, dtype=col.values.dtype),
            col.values[np.minimum(flat, max(col.total - 1, 0))] if col.total else empty_pool_value,
        )
    else:
        if (lengths < n).any():
            raise ValueError(
                "cannot take a larger sample than the total population when "
                "`with_replacement=false`"
            )
        # vectorized per-row choice without replacement: argsort random
        # keys, chunked over rows so the key matrix stays ~64 MB however
        # large the split (e.g. 250-wide beyond-accuracy pools over
        # millions of rows would otherwise allocate a multi-GB matrix).
        # Chunking is bit-identical to one call: the generator fills
        # row-major from one sequential stream either way.
        max_len = int(lengths.max()) if n_rows else 0
        sampled = np.empty((n_rows, n), dtype=col.values.dtype)
        chunk = max(1, (8 << 20) // max(max_len, 1))
        lane = np.arange(max_len)[None, :]
        for s in range(0, n_rows, chunk):
            e = min(s + chunk, n_rows)
            keys = rng.random((e - s, max_len))
            keys[lane >= lengths[s:e, None]] = np.inf
            draws = np.argsort(keys, axis=1)[:, :n]
            sampled[s:e] = col.values[col.offsets[s:e, None] + draws]
    return df.with_columns(**{inview_col: Ragged.from_dense(sampled.astype(col.values.dtype))})


def sampling_strategy_wu2019(
    df: Table,
    npratio: int,
    shuffle: bool = False,
    with_replacement: bool = True,
    seed: int | None = None,
    inview_col: str = DEFAULT_INVIEW_ARTICLES_COL,
    clicked_col: str = DEFAULT_CLICKED_ARTICLES_COL,
) -> Table:
    """Wu et al. (KDD'19) negative sampling (reference: _behaviors.py:423-579).

    Steps (identical to the reference):
      1. remove positives from the inview pool,
      2. explode on clicked (one output row per positive),
      3. sample ``npratio`` negatives per positive (with replacement by default),
      4. inview := [neg_1..neg_npratio, positive]  (positive at the tail),
      5. clicked := [positive].
    With shuffle=True the final inview list is shuffled within each row.
    Rows whose negative pool is empty are padded with id 0 (the unknown/
    padding article row) where the reference produces nulls.
    """
    df = remove_positives_from_inview(df, inview_col=inview_col, clicked_col=clicked_col)
    clicked: Ragged = df[clicked_col]
    # step 2: explode clicked -> one row per positive
    pos_values, row_ids = clicked.explode_with_row_ids()
    exploded = df.take(row_ids)
    exploded = exploded.with_columns(**{clicked_col: pos_values.copy()})
    # step 3: sample negatives
    exploded = sample_article_ids(
        exploded,
        n=npratio,
        with_replacement=with_replacement,
        seed=seed,
        inview_col=inview_col,
    )
    # step 4: concat [negatives ++ positive]
    negs: Ragged = exploded[inview_col]
    pos_ragged = Ragged(
        pos_values.astype(negs.values.dtype),
        np.arange(len(pos_values) + 1, dtype=np.int64),
    )
    inview_new = negs.concat_values(pos_ragged)
    # step 5: clicked = [positive] (kept as list column for schema parity)
    exploded = exploded.with_columns(
        **{inview_col: inview_new, clicked_col: pos_ragged}
    )
    if shuffle:
        rng = np.random.default_rng(seed)
        shuffled, _ = exploded[inview_col].shuffle_within_rows(rng)
        exploded = exploded.with_columns(**{inview_col: shuffled})
    return exploded


def filter_minimum_negative_samples(
    df: Table,
    n: int | None,
    inview_col: str = DEFAULT_INVIEW_ARTICLES_COL,
    clicked_col: str = DEFAULT_CLICKED_ARTICLES_COL,
) -> Table:
    """Keep rows with at least ``n`` negatives (reference: _behaviors.py:120-158)."""
    if n is None or n <= 0:
        return df
    mask = (df[inview_col].lengths - df[clicked_col].lengths) >= n
    return df.filter(mask)


def add_known_user_column(
    df: Table,
    known_users,
    user_col: str = DEFAULT_USER_COL,
    known_user_col: str = DEFAULT_KNOWN_USER_COL,
) -> Table:
    """is_known_user flag (reference: _behaviors.py:243-272)."""
    known = np.asarray(list(known_users))
    return df.with_columns(**{known_user_col: np.isin(np.asarray(df[user_col]), known)})


def add_prediction_scores(
    df: Table,
    scores: np.ndarray,
    inview_col: str = DEFAULT_INVIEW_ARTICLES_COL,
    prediction_scores_col: str = "scores",
) -> Table:
    """Attach a flat per-candidate score stream back onto the ragged inview
    structure (reference: _behaviors.py:1024-1089). Accepts either a flat
    array of ``inview.total`` scores or a ``Ragged`` (what
    ``Trainer.score`` returns) whose row lengths must match the inview
    lists."""
    inview: Ragged = df[inview_col]
    if isinstance(scores, Ragged):
        if not np.array_equal(scores.offsets, inview.offsets):
            raise ValueError(
                "ragged scores row structure does not match the inview lists")
        scores = scores.values
    flat = np.asarray(scores, dtype=np.float32).reshape(-1)
    if flat.shape[0] != inview.total:
        raise ValueError(
            f"got {flat.shape[0]} scores for {inview.total} inview articles"
        )
    return df.with_columns(
        **{prediction_scores_col: Ragged(flat, inview.offsets.copy())}
    )


def unique_article_ids_in_behaviors(
    df: Table,
    item_col: str = "article_id",
    inview_col: str = DEFAULT_INVIEW_ARTICLES_COL,
    clicked_col: str = DEFAULT_CLICKED_ARTICLES_COL,
) -> np.ndarray:
    """Distinct ids across article_id/inview/clicked (reference: _behaviors.py:206-240)."""
    parts = []
    if item_col in df:
        parts.append(np.asarray(df[item_col]))
    for col in (inview_col, clicked_col):
        if col in df:
            parts.append(df[col].values)
    return np.unique(np.concatenate(parts)) if parts else np.empty(0, np.int64)


def create_user_id_to_int_mapping(df: Table, user_col: str = DEFAULT_USER_COL) -> dict:
    """user_id -> dense int index (reference: _behaviors.py:110-117)."""
    unique = np.unique(np.asarray(df[user_col]))
    return {int(u): i for i, u in enumerate(unique)}


def down_sample_on_users(
    df: Table,
    n: int,
    seed: int | None = None,
    user_col: str = DEFAULT_USER_COL,
) -> Table:
    """At most ``n`` impressions per user (reference: _behaviors.py:1092-1141)."""
    rng = np.random.default_rng(seed)
    users = np.asarray(df[user_col])
    perm = rng.permutation(len(users))
    order = perm[np.argsort(users[perm], kind="stable")]
    sorted_users = users[order]
    group_start = np.r_[True, sorted_users[1:] != sorted_users[:-1]]
    within = np.arange(len(users)) - np.maximum.accumulate(
        np.where(group_start, np.arange(len(users)), -1)
    )
    keep_idx = order[within < n]
    return df.take(np.sort(keep_idx))

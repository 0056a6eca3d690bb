"""Chunked, resumable test-set inference (copy of
``ebnerd_tpu/training/inference.py``; its parquet files need pyarrow).

Mirrors the reference's failure-recovery protocol for the huge hidden
test set (reference: examples/reproducibility_scripts/ebnerd_nrms.py:
287-315 and args_nrms.py:76-81): the behaviors frame is split into N
chunks; each chunk is scored, ranked, and persisted immediately as
parquet; a restart skips chunks whose files already exist.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from ..constants import DEFAULT_IMPRESSION_ID_COL, DEFAULT_INVIEW_ARTICLES_COL
from ..data.dataloader import EvalFeed
from ..data.lookup import Lookup
from ..data.ragged import Ragged
from ..data.table import Table, read_parquet, write_parquet
from ..utils.submission import rank_ragged_scores

__all__ = ["chunked_score", "split_chunks", "assemble_submission"]

SCORES_COL = "scores"
RANKS_COL = "ranked_scores"


def split_chunks(df: Table, n_chunks: int) -> list[Table]:
    """Split into n near-equal contiguous chunks (reference:
    split_df_chunks, _polars.py:361-406)."""
    bounds = np.linspace(0, len(df), n_chunks + 1).astype(np.int64)
    return [df.slice(int(a), int(b - a)) for a, b in zip(bounds[:-1], bounds[1:])]


def chunked_score(
    scorer,
    behaviors: Table,
    lookup: Lookup,
    history_size: int,
    batch_size: int,
    n_chunks: int,
    out_dir,
    user_mapping: Optional[dict] = None,
    max_candidates: Optional[int] = None,
    log=print,
) -> Table:
    """Score ``behaviors`` in resumable chunks with any object exposing
    ``score(feed) -> Ragged`` (Trainer or serving.TwoTowerScorer).

    Writes ``out_dir/pred_chunk_<i>.parquet`` with impression ids, ragged
    scores, and 1-based descending ranks; existing files are skipped
    (the reference's --chunks_done resume, done here by file presence).
    Returns the concatenated result.
    """
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    chunks = split_chunks(behaviors, n_chunks)
    results: list[Table] = []
    for i, chunk in enumerate(chunks):
        path = out_dir / f"pred_chunk_{i}.parquet"
        if path.exists():
            log(f"[inference] chunk {i}: exists, skipping")
            results.append(read_parquet(path))
            continue
        if len(chunk) == 0:
            continue
        feed = EvalFeed(
            chunk, lookup, history_size=history_size, batch_size=batch_size,
            user_mapping=user_mapping, max_candidates=max_candidates,
        )
        scores: Ragged = scorer.score(feed)
        ranks = rank_ragged_scores(scores)
        out = Table({
            DEFAULT_IMPRESSION_ID_COL: np.asarray(chunk[DEFAULT_IMPRESSION_ID_COL]),
            DEFAULT_INVIEW_ARTICLES_COL: chunk[DEFAULT_INVIEW_ARTICLES_COL],
            SCORES_COL: scores,
            RANKS_COL: ranks,
        })
        write_parquet(out, path)
        log(f"[inference] chunk {i}: {len(chunk)} impressions -> {path.name}")
        results.append(out)
    if not results:
        raise ValueError("no chunks produced (empty behaviors?)")
    total = results[0]
    for r in results[1:]:
        total = total.concat(r)
    return total


def assemble_submission(parts: list[Table], impression_ids: np.ndarray) -> Ragged:
    """Reassemble chunked/split scoring results into the ORIGINAL impression
    order and return the ragged rank column ready for
    ``write_submission_file`` (the reference concatenates its wo_ba + w_ba
    chunk parquets the same way before writing predictions.txt,
    ebnerd_nrms.py:352-364).

    ``parts`` are ``chunked_score`` outputs (any row order between them);
    ``impression_ids`` is the full test split's impression-id column in
    file order. Raises if the union of parts does not cover it exactly.
    """
    total = parts[0]
    for p in parts[1:]:
        total = total.concat(p)
    got_ids = np.asarray(total[DEFAULT_IMPRESSION_ID_COL], dtype=np.int64)
    want_ids = np.asarray(impression_ids, dtype=np.int64)
    if len(got_ids) != len(want_ids):
        raise ValueError(
            f"scored {len(got_ids)} impressions but the split has {len(want_ids)}")
    order = np.argsort(got_ids, kind="stable")
    pos = np.searchsorted(got_ids[order], want_ids)
    if (pos >= len(got_ids)).any() or (got_ids[order][pos] != want_ids).any():
        raise ValueError("scored impression ids do not match the split")
    ranks: Ragged = total[RANKS_COL]
    return ranks.take_rows(order[pos])

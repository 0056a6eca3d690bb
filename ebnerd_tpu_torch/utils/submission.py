"""CodaBench submission protocol: ranks, predictions.txt, zip round-trip
(copy of ``ebnerd_tpu/utils/submission.py``).

Bit-compatible with the reference submission writer
(reference: src/ebrec/utils/_python.py:41-148): each line is
``<impression_id> [r1,r2,...]`` where r_j is the 1-based rank of inview
article j by descending score, and the file ships zipped.
"""
from __future__ import annotations

import zipfile
from pathlib import Path
from typing import Iterable

import numpy as np

from ..data.ragged import Ragged

__all__ = [
    "rank_predictions_by_score",
    "rank_ragged_scores",
    "write_submission_file",
    "read_submission_file",
    "zip_submission_file",
]


def rank_predictions_by_score(scores: Iterable[float]) -> np.ndarray:
    """1-based ranks by descending score (reference: _python.py:41-59 —
    the double-argsort idiom).

    >>> rank_predictions_by_score([0.1, 0.4, 0.2]).tolist()
    [3, 1, 2]
    """
    arr = np.asarray(list(scores) if not isinstance(scores, np.ndarray) else scores)
    order = np.argsort(-arr, kind="stable")
    ranks = np.empty(len(arr), dtype=np.int64)
    ranks[order] = np.arange(1, len(arr) + 1)
    return ranks


def rank_ragged_scores(scores: Ragged) -> Ragged:
    """Per-impression 1-based descending ranks over a whole ragged score
    column in one vectorized pass (the reference maps
    ``rank_predictions_by_score`` row by row, ebnerd_nrms.py:303-311)."""
    rows = scores.row_ids()
    order = np.lexsort((-scores.values.astype(np.float64), rows))
    pos = np.arange(scores.total, dtype=np.int64) - scores.offsets[:-1][rows[order]]
    ranks = np.empty(scores.total, dtype=np.int32)
    ranks[order] = (pos + 1).astype(np.int32)
    return Ragged(ranks, scores.offsets.copy())


def write_submission_file(
    impression_ids: Iterable[int],
    prediction_scores: Ragged | Iterable[Iterable[int]],
    path: Path | str = "predictions.txt",
    rm_file: bool = True,
    filename_zip: str | None = None,
) -> None:
    """Write ``<impid> [r1,r2,...]`` lines and zip them
    (reference: _python.py:62-90). ``prediction_scores`` holds the rank
    lists (already ranked), as in the reference."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    rows = (
        (prediction_scores.row(i).tolist() for i in range(len(prediction_scores)))
        if isinstance(prediction_scores, Ragged)
        else prediction_scores
    )
    with open(path, "w") as f:
        for impr_index, preds in zip(impression_ids, rows):
            preds_formatted = str(list(preds)).replace(" ", "")
            f.write(f"{impr_index} {preds_formatted}\n")
    zip_submission_file(path=path, rm_file=rm_file, filename_zip=filename_zip)


def read_submission_file(path: Path | str) -> tuple[np.ndarray, Ragged]:
    """Parse a predictions.txt back into (impression_ids, ragged ranks)
    (reference: _python.py:93-112)."""
    ids, rows = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            impid, ranks = line.split(" ", 1)
            ids.append(int(impid))
            rows.append([int(r) for r in ranks.strip("[]").split(",") if r])
    return np.asarray(ids, dtype=np.int64), Ragged.from_lists(rows, dtype=np.int32)


def zip_submission_file(
    path: Path | str,
    filename_zip: str | None = None,
    verbose: bool = True,
    rm_file: bool = True,
) -> None:
    """Zip ``path`` next to itself (reference: _python.py:115-148)."""
    path = Path(path)
    path_zip = path.parent / (filename_zip if filename_zip else f"{path.stem}.zip")
    if path_zip.suffix != ".zip":
        raise ValueError(f"suffix must be '.zip', but is {path_zip.suffix}")
    if verbose:
        print(f"Zipping {path} to {path_zip}")
    with zipfile.ZipFile(path_zip, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.write(path, arcname=path.name)
    if rm_file:
        path.unlink(missing_ok=True)

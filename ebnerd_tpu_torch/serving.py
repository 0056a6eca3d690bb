"""Two-tower serving: a precomputed article-vector index plus a cheap
per-request user encoder (counterpart of ``ebnerd_tpu/serving.py``).

The article tower runs once over the corpus (``ArticleIndex.build``);
scoring an impression is then a gather, the user tower and a dot
(``TwoTowerScorer.score``). NRMS, NRMSDocVec, LSTUR, NAML and Fastformer
are served; NPA's article tower depends on the user, so it raises. Both
towers always run in eval mode, as the JAX functions pass
``train=False``: the model is switched for the call and its mode
restored afterwards, so an index built between training steps draws no
dropout.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Optional

import numpy as np
import torch

from . import resolve_device
from .data.dataloader import EvalFeed
from .data.ragged import Ragged
from .models.inputs import device_tables

__all__ = [
    "ArticleIndex",
    "TwoTowerScorer",
    "model_kind",
    "encode_article_rows",
    "encode_corpus",
    "article_validity",
    "two_tower_logits",
    "two_tower_scores",
    "eval_mode",
    "ScoreWindow",
    "EVAL_WINDOW",
]

_USER_INDEPENDENT = {"nrms", "nrms_docvec", "nrmsdocvec", "lstur", "naml", "fastformer"}
# eval batches in flight (scores not yet on the host), as the JAX Trainer.score
EVAL_WINDOW = 8


def model_kind(model) -> Optional[str]:
    """Two-tower dispatch key for ``model``, or None when its news encoder
    is user-dependent."""
    name = type(model).__name__.lower()
    return name if name in _USER_INDEPENDENT else None


def _require_kind(model) -> str:
    kind = model_kind(model)
    if kind is None:
        raise ValueError(
            f"{type(model).__name__} has a user-dependent news encoder "
            "(personalized attention); two-tower serving does not apply.")
    return kind


@contextmanager
def eval_mode(model: torch.nn.Module):
    """``model`` in eval mode for the block; its previous mode afterwards."""
    was_training = model.training
    model.eval()
    try:
        yield model
    finally:
        model.train(was_training)


@torch.no_grad()
def encode_article_rows(model, tables: dict, idx: torch.Tensor) -> torch.Tensor:
    """Article tower in eval mode: value-table rows ``idx`` -> article
    vectors [N, D]."""
    kind = _require_kind(model)
    with eval_mode(model):
        if kind == "nrms":
            return model.encode_news(tables["title"][idx])
        if kind == "lstur":
            return model.encode_news(tables["title"][idx], None)
        if kind in ("nrms_docvec", "nrmsdocvec"):
            return model.encode_news(tables["docvec"][idx])
        if kind == "fastformer":
            return model.encode_articles(tables["title"][idx])
        return model.encode_news(tables["title"][idx], tables["body"][idx], tables["cat"][idx],
                                 tables["subcat"][idx], None)


def encode_corpus(model, tables: dict, batch_size: int) -> torch.Tensor:
    """The [V+1, D] article vectors of every table row, encoded in chunks
    of ``batch_size`` rows; the last chunk is padded with row 0 so every
    chunk has the same shape."""
    n_rows = next(iter(tables.values())).shape[0]
    dev = next(iter(tables.values())).device
    bs = min(batch_size, n_rows)
    chunks = []
    for start in range(0, n_rows, bs):
        idx = torch.arange(start, start + bs, device=dev)
        idx[idx >= n_rows] = 0
        chunks.append(encode_article_rows(model, tables, idx))
    return torch.cat(chunks, dim=0)[:n_rows]


def article_validity(tables: dict) -> Optional[torch.Tensor]:
    """Per-article-row flag [V+1]: the token row is not all zeros (padding
    row 0 and empty titles are invalid); LSTUR's and Fastformer's history
    mask, as the full forward's ``(hist_tokens != 0).any(-1)``. None
    without a token table (NRMSDocVec); NRMS and NAML do not read it."""
    title = tables.get("title")
    if title is None:
        return None
    if not isinstance(title, torch.Tensor):  # row-sharded (parallel.mesh.ShardedTable): gather it
        title = title[torch.arange(title.shape[0], device=title.device)]
    return (title != 0).any(-1)


@torch.no_grad()
def two_tower_logits(model, art_vecs: torch.Tensor, raw: dict,
                     art_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """User tower in eval mode + scoring from precomputed article vectors.
    ``raw`` holds ``hist_idx`` [B, H], ``cand_idx`` [B, K] and, for LSTUR,
    ``user_idx`` [B], on the vectors' device. NRMS's and NRMSDocVec's user
    towers have no history mask: a padded slot gathers ``art_vecs[0]``, the
    padding article's encoding, as the full forward pass does. LSTUR and
    Fastformer mask the history by ``art_valid`` (or, without it, by
    ``hist_idx != 0``); Fastformer scores by its concat head, not a dot."""
    kind = _require_kind(model)
    hist_vecs = art_vecs[raw["hist_idx"]]
    cand_vecs = art_vecs[raw["cand_idx"]]
    if kind in ("lstur", "fastformer"):
        valid = art_valid[raw["hist_idx"]] if art_valid is not None else raw["hist_idx"] != 0
        hist_mask = valid.to(model.dtype)
    with eval_mode(model):
        if kind == "fastformer":
            return model.score(hist_vecs, hist_mask, cand_vecs)
        if kind in ("nrms", "nrms_docvec", "nrmsdocvec"):
            user = model.encode_user(hist_vecs)
        elif kind == "lstur":
            user = model.encode_user(hist_vecs, hist_mask, raw["user_idx"])
        else:
            user = model.user_pool(hist_vecs)
    return torch.einsum("bkd,bd->bk", cand_vecs, user)


class ScoreWindow:
    """Scores of up to ``EVAL_WINDOW`` eval batches in flight: each batch's
    device scores are copied into a pinned host buffer without blocking
    and an event recorded behind the copy; the oldest batch is drained
    (its event waited on, its scores written to ``out``) when the window
    is full. On the CPU the copy is immediate."""

    def __init__(self, out: np.ndarray):
        self.out = out
        self.pending: list = []

    def push(self, rows: np.ndarray, scores: torch.Tensor) -> None:
        if scores.device.type == "cuda":
            host = torch.empty(scores.shape, dtype=torch.float32, pin_memory=True)
            host.copy_(scores, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            host, done = scores.float(), None
        self.pending.append((rows, host, done))
        if len(self.pending) >= EVAL_WINDOW:
            self._drain_one()

    def _drain_one(self) -> None:
        rows, host, done = self.pending.pop(0)
        if done is not None:
            done.synchronize()
        scores = host.numpy()
        self.out[rows, : scores.shape[1]] = scores[: len(rows)]

    def drain(self) -> np.ndarray:
        while self.pending:
            self._drain_one()
        return self.out


class ArticleIndex:
    """Precomputed [V+1, D] article-vector table for one model."""

    def __init__(self, model, tables: dict, batch_size: int = 4096, device="cuda"):
        self.kind = _require_kind(model)
        self.model = model
        self.device = resolve_device(device)
        self.tables = device_tables(tables, self.device)
        self.batch_size = batch_size
        self.vectors: Optional[torch.Tensor] = None
        self.validity = article_validity(self.tables)

    def build(self) -> torch.Tensor:
        """Encode the whole corpus (``encode_corpus``)."""
        self.vectors = encode_corpus(self.model, self.tables, self.batch_size)
        return self.vectors


class TwoTowerScorer:
    """Batched scoring of ragged impressions from a prebuilt ArticleIndex."""

    def __init__(self, index: ArticleIndex):
        if index.vectors is None:
            index.build()
        self.index = index

    def score(self, feed: EvalFeed) -> Ragged:
        """Sigmoid scores aligned with the feed's inview lists."""
        return two_tower_scores(self.index.model, self.index.vectors, self.index.validity, feed)


def two_tower_scores(model, art_vecs: torch.Tensor, art_valid: Optional[torch.Tensor],
                     feed: EvalFeed) -> Ragged:
    """Sigmoid two-tower scores of every impression of ``feed``, aligned
    with its inview lists (``ScoreWindow``)."""
    dev = art_vecs.device
    keys = ("hist_idx", "cand_idx") + (("user_idx",) if model_kind(model) == "lstur" else ())
    scores = ScoreWindow(np.zeros((feed.n_rows, feed.width), np.float32))
    for raw in feed.batches():
        batch = {k: torch.as_tensor(raw[k]).to(dev, torch.long) for k in keys}
        logits = two_tower_logits(model, art_vecs, batch, art_valid=art_valid)
        scores.push(raw["rows"], torch.sigmoid(logits).float())
    return feed.unpad(scores.drain())

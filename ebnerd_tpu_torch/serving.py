"""Two-tower serving: a precomputed article-vector index plus a cheap
per-request user encoder (counterpart of ``ebnerd_tpu/serving.py``).

The article tower runs once over the corpus (``ArticleIndex.build``);
scoring an impression is then a gather, the user tower and a dot
(``TwoTowerScorer.score``). The port serves NRMS; other families raise.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import resolve_device
from .data.dataloader import EvalFeed
from .data.ragged import Ragged

__all__ = [
    "ArticleIndex",
    "TwoTowerScorer",
    "model_kind",
    "encode_article_rows",
    "article_validity",
    "two_tower_logits",
]

_USER_INDEPENDENT = {"nrms", "nrms_docvec", "nrmsdocvec", "lstur", "naml", "fastformer"}
_PORTED = {"nrms"}


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
    if kind not in _PORTED:
        raise ValueError(
            f"two-tower serving of {type(model).__name__} is not ported yet; "
            "the port serves NRMS")
    return kind


@torch.no_grad()
def encode_article_rows(model, tables: dict, idx: torch.Tensor) -> torch.Tensor:
    """Article tower: value-table rows ``idx`` -> article vectors [N, D]."""
    _require_kind(model)
    return model.encode_news(tables["title"][idx])


def article_validity(tables: dict) -> Optional[torch.Tensor]:
    """Per-article-row flag [V+1]: the token row is not all zeros (padding
    row 0 and empty titles are invalid). NRMS does not read it; the
    families that mask their history do."""
    title = tables.get("title")
    if title is None:
        return None
    return (title != 0).any(-1)


@torch.no_grad()
def two_tower_logits(model, art_vecs: torch.Tensor, raw: dict,
                     art_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """User tower + scoring from precomputed article vectors. ``raw`` holds
    ``hist_idx`` [B, H] and ``cand_idx`` [B, K] on the vectors' device.
    NRMS's user tower has no history mask: a padded slot gathers
    ``art_vecs[0]``, the padding title's encoding, as the full forward
    pass does."""
    _require_kind(model)
    hist_vecs = art_vecs[raw["hist_idx"]]
    cand_vecs = art_vecs[raw["cand_idx"]]
    user = model.encode_user(hist_vecs)
    return torch.einsum("bkd,bd->bk", cand_vecs, user)


class ArticleIndex:
    """Precomputed [V+1, D] article-vector table for one model."""

    def __init__(self, model, tables: dict, batch_size: int = 4096, device="cuda"):
        self.kind = _require_kind(model)
        self.model = model
        self.device = resolve_device(device)
        self.tables = {k: torch.as_tensor(np.asarray(v)).to(self.device, torch.long)
                       for k, v in tables.items()}
        self.batch_size = batch_size
        self.vectors: Optional[torch.Tensor] = None
        self.validity = article_validity(self.tables)

    def build(self) -> torch.Tensor:
        """Encode the whole corpus in fixed-size chunks; the last chunk is
        padded with row 0 so every chunk has the same shape."""
        n_rows = next(iter(self.tables.values())).shape[0]
        bs = min(self.batch_size, n_rows)
        chunks = []
        for start in range(0, n_rows, bs):
            idx = torch.arange(start, start + bs, device=self.device)
            idx[idx >= n_rows] = 0
            chunks.append(encode_article_rows(self.model, self.tables, idx))
        self.vectors = torch.cat(chunks, dim=0)[:n_rows]
        return self.vectors


class TwoTowerScorer:
    """Batched scoring of ragged impressions from a prebuilt ArticleIndex."""

    def __init__(self, index: ArticleIndex):
        if index.vectors is None:
            index.build()
        self.index = index

    def score(self, feed: EvalFeed) -> Ragged:
        """Sigmoid scores aligned with the feed's inview lists."""
        dev = self.index.device
        out = np.zeros((feed.n_rows, feed.width), np.float32)
        for raw in feed.batches():
            rows = raw["rows"]
            batch = {k: torch.as_tensor(raw[k]).to(dev, torch.long)
                     for k in ("hist_idx", "cand_idx")}
            logits = two_tower_logits(self.index.model, self.index.vectors, batch,
                                      art_valid=self.index.validity)
            scores = torch.sigmoid(logits).float().cpu().numpy()
            out[rows, : scores.shape[1]] = scores[: len(rows)]
        return feed.unpad(out)

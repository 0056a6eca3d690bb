"""Host-side unique-article dedup for training batches (copy of
``ebnerd_tpu/training/dedup.py``).

A batch references B*(H+K) article slots, but articles repeat heavily.
``prep_dedup_batch`` replaces ``hist_idx`` [B, H] and ``cand_idx`` [B, K]
with the batch's unique article rows ``art_uniq`` [C] (padded with row 0 to
a geometric size bucket) and the slot positions ``hist_slot`` /
``cand_slot`` into it. The model encodes each unique article once and
gathers its vector back to the slots; the backward of that gather sums
the slot cotangents. ``art_n_uniq`` is the valid count: the fused
kernels skip blocks past it.

Under dropout this draws one stochastic encode per unique article per
step, shared by its duplicate slots, as the JAX package does.
"""
from __future__ import annotations

import numpy as np

__all__ = ["dedup_bucket", "prep_dedup_batch", "pad_dedup_to", "dedup_capable"]

def dedup_capable(model) -> tuple[bool, str]:
    """(capable, reason-if-not) for one model instance. Families whose
    article tower is user-independent dedup fully; BatchNorm towers
    (NRMSDocVec, NRMS with the dense stack) through slot-count-weighted
    moments (``layers.WeightedBatchNorm``). NPA dedups partially: its
    embedding -> conv prefix runs per unique article, its personalized
    pooling per slot. Unknown families (FastformerWu among them) are
    excluded."""
    from ..serving import model_kind

    if model_kind(model) is None and type(model).__name__.lower() != "npa":
        return False, "unknown model family: no slot path implemented for article dedup"
    return True, ""


def dedup_bucket(n: int, minimum: int = 512) -> int:
    """Smallest bucket >= n from a ~1.25x geometric ladder of multiples of
    256 (waste <= max(25%, 256 rows))."""
    c = max(minimum, 256)
    c = -(-c // 256) * 256
    while c < n:
        c = -(-(c * 5 // 4) // 256) * 256
    return c


def prep_dedup_batch(raw: dict, min_bucket: int = 512, bucket: int | None = None) -> dict:
    """Dedup one index batch on the host: ``hist_idx``/``cand_idx`` become
    ``art_uniq`` (bucket-padded with row 0), ``hist_slot``/``cand_slot``,
    ``art_counts`` (slot multiplicity per unique row, pad rows 0),
    ``n_uniq`` (host int) and ``art_n_uniq`` ([1] int32). Pad entries are
    referenced by no slot. ``bucket`` forces an exact bucket size."""
    hist = np.asarray(raw["hist_idx"])
    cand = np.asarray(raw["cand_idx"])
    b, h = hist.shape
    k = cand.shape[1]
    uniq, inv = np.unique(np.concatenate([hist.reshape(-1), cand.reshape(-1)]),
                          return_inverse=True)
    c = bucket if bucket is not None else dedup_bucket(len(uniq), min_bucket)
    if len(uniq) > c:
        raise ValueError(f"bucket {c} < {len(uniq)} unique articles")
    uniq_pad = np.zeros(c, np.int32)
    uniq_pad[: len(uniq)] = uniq
    out = {key: v for key, v in raw.items() if key not in ("hist_idx", "cand_idx")}
    out["art_uniq"] = uniq_pad
    out["hist_slot"] = inv[: b * h].reshape(b, h).astype(np.int32)
    out["cand_slot"] = inv[b * h:].reshape(b, k).astype(np.int32)
    out["art_counts"] = np.bincount(inv, minlength=c).astype(np.float32)
    out["n_uniq"] = len(uniq)
    out["art_n_uniq"] = np.asarray([len(uniq)], np.int32)
    return out


def pad_dedup_to(raw: dict, bucket: int) -> dict:
    """Re-pad a prepped batch's ``art_uniq`` (and ``art_counts``) to a
    larger bucket."""
    uniq = raw["art_uniq"]
    if uniq.shape[0] == bucket:
        return raw
    if uniq.shape[0] > bucket:
        raise ValueError(f"cannot shrink bucket {uniq.shape[0]} -> {bucket}")
    out = dict(raw)
    grown = np.zeros(bucket, np.int32)
    grown[: uniq.shape[0]] = uniq
    out["art_uniq"] = grown
    if "art_counts" in raw:
        counts = np.zeros(bucket, np.float32)
        counts[: uniq.shape[0]] = raw["art_counts"]
        out["art_counts"] = counts
    return out

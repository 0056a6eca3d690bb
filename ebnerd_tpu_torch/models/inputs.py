"""Batch builders: article value tables on the device -> model batches
(counterpart of ``ebnerd_tpu/models/inputs.py``).

The feed ships int32 row indices; a builder moves them to the tables'
device and gathers the features there, so the host never touches a token
matrix. ``tables`` holds device tensors built once per run, e.g.
``"title"``: int64 [V+1, T], the token table.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["token_batch"]


def _index(v, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v).to(
        device, torch.long, non_blocking=True)


def _user(raw: dict, out: dict, device) -> dict:
    if "user_idx" in raw:
        out["user_id"] = _index(raw["user_idx"], device)
    return out


def token_batch(tables: dict, raw: dict) -> dict:
    """NRMS / LSTUR / NPA / Fastformer: title tokens (+ optional user id).

    A deduped batch (``training/dedup.py``: ``art_uniq`` + slot indices)
    gathers each unique article's tokens once and carries ``art_n_uniq``
    as a host int: the fused kernels skip the bucket-pad blocks past it."""
    title = tables["title"]
    dev = title.device
    if "art_uniq" in raw:
        out = {"uniq_tokens": title[_index(raw["art_uniq"], dev)],
               "hist_slot": _index(raw["hist_slot"], dev),
               "cand_slot": _index(raw["cand_slot"], dev)}
        if "art_n_uniq" in raw:
            out["art_n_uniq"] = int(np.asarray(raw["art_n_uniq"]).reshape(-1)[0])
        return _user(raw, out, dev)
    return _user(raw, {"hist_tokens": title[_index(raw["hist_idx"], dev)],
                       "cand_tokens": title[_index(raw["cand_idx"], dev)]}, dev)

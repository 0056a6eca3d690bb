"""Batch builders: article value tables on the device -> model batches
(counterpart of ``ebnerd_tpu/models/inputs.py``).

The feed ships int32 row indices; a builder moves them to the tables'
device and gathers the features there, so the host never touches a token
matrix. ``tables`` holds device tensors built once per run:
``"title"`` int64 [V+1, T] (the token table), for NRMSDocVec ``"docvec"``
float32 [V+1, Dv] (document vectors), and for NAML ``"body"`` [V+1, Tb],
``"cat"`` [V+1] and ``"subcat"`` [V+1]. ``device_tables`` moves a dict of
them to the device: integer tables as int64, float tables as float32.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["token_batch", "docvec_batch", "naml_batch", "builder_for", "device_tables"]


def device_tables(tables: dict, device) -> dict:
    """Value tables (numpy arrays or tensors) on ``device``: integer and
    bool tables as int64 (index and token tables), floating tables as
    float32 (NRMSDocVec's document vectors), never truncated."""
    out = {}
    for k, v in tables.items():
        t = torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
        out[k] = t.to(device, torch.float32 if t.is_floating_point() else torch.long)
    return out


def _index(v, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v).to(
        device, torch.long, non_blocking=True)


def _user(raw: dict, out: dict, device) -> dict:
    if "user_idx" in raw:
        out["user_id"] = _index(raw["user_idx"], device)
    return out


def _slots(raw: dict, out: dict, dev) -> dict:
    out["hist_slot"] = _index(raw["hist_slot"], dev)
    out["cand_slot"] = _index(raw["cand_slot"], dev)
    if "art_n_uniq" in raw:
        out["art_n_uniq"] = int(np.asarray(raw["art_n_uniq"]).reshape(-1)[0])
    if "art_counts" in raw:  # slot counts: the BN row weights of the dense stack
        c = raw["art_counts"]
        out["art_counts"] = torch.as_tensor(np.asarray(c) if not isinstance(c, torch.Tensor)
                                            else c).to(dev, torch.float32, non_blocking=True)
    return _user(raw, out, dev)


def token_batch(tables: dict, raw: dict) -> dict:
    """NRMS / LSTUR / NPA / Fastformer: title tokens (+ optional user id).

    A deduped batch (``training/dedup.py``: ``art_uniq`` + slot indices)
    gathers each unique article's tokens once and carries ``art_n_uniq``
    as a host int: the fused kernels skip the bucket-pad blocks past it."""
    title = tables["title"]
    dev = title.device
    if "art_uniq" in raw:
        return _slots(raw, {"uniq_tokens": title[_index(raw["art_uniq"], dev)]}, dev)
    return _user(raw, {"hist_tokens": title[_index(raw["hist_idx"], dev)],
                       "cand_tokens": title[_index(raw["cand_idx"], dev)]}, dev)


def docvec_batch(tables: dict, raw: dict) -> dict:
    """NRMSDocVec: the float document vectors of the ``docvec`` table."""
    dv = tables["docvec"]
    dev = dv.device
    if "art_uniq" in raw:
        return _slots(raw, {"uniq_vecs": dv[_index(raw["art_uniq"], dev)]}, dev)
    return _user(raw, {"hist_vecs": dv[_index(raw["hist_idx"], dev)],
                       "cand_vecs": dv[_index(raw["cand_idx"], dev)]}, dev)


_NAML_TABLES = (("tokens", "title"), ("body", "body"), ("cat", "cat"), ("subcat", "subcat"))


def naml_batch(tables: dict, raw: dict) -> dict:
    """NAML: title and body tokens and (sub)category ids, all gathered from
    the same row-index space."""
    dev = tables["title"].device
    if "art_uniq" in raw:
        u = _index(raw["art_uniq"], dev)
        return _slots(raw, {f"uniq_{k}": tables[t][u] for k, t in _NAML_TABLES}, dev)
    hist, cand = _index(raw["hist_idx"], dev), _index(raw["cand_idx"], dev)
    out = {}
    for k, t in _NAML_TABLES:
        out[f"hist_{k}"], out[f"cand_{k}"] = tables[t][hist], tables[t][cand]
    return _user(raw, out, dev)


def builder_for(model_name: str):
    """The batch builder of a model family, as the JAX package maps them."""
    name = model_name.lower()
    if name in ("nrms", "lstur", "npa", "fastformer"):
        return token_batch
    if name in ("nrmsdocvec", "nrms_docvec"):
        return docvec_batch
    if name == "naml":
        return naml_batch
    raise ValueError(f"no batch builder for model '{model_name}'")

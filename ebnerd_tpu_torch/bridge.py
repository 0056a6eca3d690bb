"""Carry NRMS weights from the JAX package into the port.

``load_nrms_params(model, params)`` takes the JAX NRMS ``params`` tree as
a nested dict of numpy arrays (``jax.device_get`` of ``variables["params"]``)
and copies it into a port ``NRMS``. JAX keeps kernels as [in, out];
``nn.Linear`` keeps [out, in], so every kernel is transposed. The fused
and unfused JAX models share one tree, and so do the port's, so one tree
loads into either.

  word_embedding/embedding [V, E]  -> word_embedding.embedding
  {news,user}_self_att/W{Q,K,V} [din, d] -> .W{Q,K,V}.weight [d, din]
  {news,user}_pool/W [d, a]       -> .W.weight [a, d]
  {news,user}_pool/b [a]          -> .W.bias
  {news,user}_pool/q [a, 1]       -> .q.weight [1, a]
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = ["nrms_state_dict", "load_nrms_params"]


def nrms_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """JAX NRMS params tree -> the port NRMS's ``state_dict`` (fp32, CPU)."""

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    sd = {"word_embedding.embedding": t(params["word_embedding"]["embedding"])}
    for tower in ("news", "user"):
        att = params[f"{tower}_self_att"]
        for w in ("WQ", "WK", "WV"):
            sd[f"{tower}_self_att.{w}.weight"] = t(att[w]).T.contiguous()
        pool = params[f"{tower}_pool"]
        sd[f"{tower}_pool.W.weight"] = t(pool["W"]).T.contiguous()
        sd[f"{tower}_pool.W.bias"] = t(pool["b"])
        sd[f"{tower}_pool.q.weight"] = t(pool["q"]).T.contiguous()
    return sd


def load_nrms_params(model: torch.nn.Module, params: Mapping) -> torch.nn.Module:
    """Copy a JAX NRMS params tree into ``model`` (strict: every key and
    shape must match)."""
    model.load_state_dict(nrms_state_dict(params), strict=True)
    return model

"""Carry NRMS, LSTUR and NAML weights from the JAX package into the port.

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

``load_lstur_params`` and ``load_naml_params`` do the same for LSTUR and
NAML. Beyond the pooling layout above:

  <conv>/Conv_0/kernel [w, in, out] -> <conv>.weight [out, in, w]
  <conv>/Conv_0/bias               -> <conv>.bias
  <dense>/kernel [in, out], bias   -> <dense>.weight [out, in], .bias
  gru/GRUCell_0/{ir,iz,in}/kernel, bias -> gru.{ir,iz,in_}.weight, .bias
  gru/GRUCell_0/{hr,hz}/kernel     -> gru.{hr,hz}.weight (no bias)
  gru/GRUCell_0/hn/kernel, bias    -> gru.hn.weight, .bias
  {user,vert,subvert}_embedding/embedding -> <name>.embedding
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = ["nrms_state_dict", "load_nrms_params", "lstur_state_dict", "load_lstur_params",
           "naml_state_dict", "load_naml_params"]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _pool(sd: dict, name: str, pool: Mapping) -> None:
    sd[f"{name}.W.weight"] = _t(pool["W"]).T.contiguous()
    sd[f"{name}.W.bias"] = _t(pool["b"])
    sd[f"{name}.q.weight"] = _t(pool["q"]).T.contiguous()


def _dense(sd: dict, name: str, dense: Mapping) -> None:
    sd[f"{name}.weight"] = _t(dense["kernel"]).T.contiguous()
    if "bias" in dense:
        sd[f"{name}.bias"] = _t(dense["bias"])


def _conv(sd: dict, name: str, conv: Mapping) -> None:
    sd[f"{name}.weight"] = _t(conv["Conv_0"]["kernel"]).permute(2, 1, 0).contiguous()
    sd[f"{name}.bias"] = _t(conv["Conv_0"]["bias"])


def _embed(sd: dict, name: str, params: Mapping) -> None:
    sd[f"{name}.embedding"] = _t(params[name]["embedding"])


def nrms_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """JAX NRMS params tree -> the port NRMS's ``state_dict`` (fp32, CPU)."""
    sd = {}
    _embed(sd, "word_embedding", params)
    for tower in ("news", "user"):
        att = params[f"{tower}_self_att"]
        for w in ("WQ", "WK", "WV"):
            sd[f"{tower}_self_att.{w}.weight"] = _t(att[w]).T.contiguous()
        _pool(sd, f"{tower}_pool", params[f"{tower}_pool"])
    return sd


def lstur_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """JAX LSTUR params tree (``ini`` or ``con``) -> the port LSTUR's
    ``state_dict`` (fp32, CPU)."""
    sd = {}
    for name in ("word_embedding", "user_embedding"):
        _embed(sd, name, params)
    _conv(sd, "conv", params["conv"])
    _pool(sd, "news_pool", params["news_pool"])
    cell = params["gru"]["GRUCell_0"]
    for gate in ("ir", "iz", "in", "hr", "hz", "hn"):
        _dense(sd, "gru." + ("in_" if gate == "in" else gate), cell[gate])
    if "con_dense" in params:
        _dense(sd, "con_dense", params["con_dense"])
    return sd


def naml_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """JAX NAML params tree -> the port NAML's ``state_dict`` (fp32, CPU)."""
    sd = {}
    for name in ("word_embedding", "vert_embedding", "subvert_embedding"):
        _embed(sd, name, params)
    for view in ("title", "body"):
        _conv(sd, f"{view}_conv", params[f"{view}_conv"])
        _pool(sd, f"{view}_pool", params[f"{view}_pool"])
    for name in ("vert_dense", "subvert_dense"):
        _dense(sd, name, params[name])
    for name in ("view_pool", "user_pool"):
        _pool(sd, name, params[name])
    return sd


def load_nrms_params(model: torch.nn.Module, params: Mapping) -> torch.nn.Module:
    """Copy a JAX NRMS params tree into ``model`` (strict: every key and
    shape must match)."""
    model.load_state_dict(nrms_state_dict(params), strict=True)
    return model


def load_lstur_params(model: torch.nn.Module, params: Mapping) -> torch.nn.Module:
    """Copy a JAX LSTUR params tree into ``model`` (strict)."""
    model.load_state_dict(lstur_state_dict(params), strict=True)
    return model


def load_naml_params(model: torch.nn.Module, params: Mapping) -> torch.nn.Module:
    """Copy a JAX NAML params tree into ``model`` (strict)."""
    model.load_state_dict(naml_state_dict(params), strict=True)
    return model

"""Carry the weights of every family between the JAX package and the port,
in both directions.

JAX -> port: ``load_nrms_params(model, params)`` takes the JAX NRMS
``params`` tree as a nested dict of numpy arrays (``jax.device_get`` of
``variables["params"]``) and copies it into a port ``NRMS``. A model whose
word table is row-sharded over a mesh's model axis (``Trainer(param_specs=...)``)
takes the whole JAX matrix and keeps its block (``WordEmbed``'s
``load_state_dict``). JAX keeps kernels as [in, out]; ``nn.Linear`` keeps
[out, in], so every kernel is transposed. The fused and unfused JAX models
share one tree, and so do the port's, so one tree loads into either.

port -> JAX: ``nrms_params``, ``nrms_docvec_params``, ``lstur_params``,
``npa_params``, ``naml_params`` and ``fastformer_params`` invert the
``*_state_dict`` functions. Each takes a port ``state_dict`` (the model's,
or ``Trainer.state_dict()["model"]`` read back from a checkpoint) or the
model itself, and returns the tree the JAX module's ``init`` gives (the
same nesting, names and shapes) as float32 numpy arrays that share no
memory with the model: ``apply({"params": params}, ...)`` then scores as
the port does. ``nrms_params`` and ``nrms_docvec_params`` return
``(params, batch_stats)``, the arguments their ``*_state_dict`` takes
(``batch_stats`` is None for NRMS without the dense stack). The word table
must be whole: ``Trainer.state_dict()`` gathers a row-sharded one, while a
sharded model's own ``state_dict()`` holds a block, which raises, naming
the whole shape, when the model or ``vocab_size`` says what it is. No
optimizer state is carried: JAX's checkpoint is orbax, the port's
``torch.save``.

The mapping below is read in both directions:

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

The newer families are loaded with ``model.load_state_dict(<family>_state_dict(...),
strict=True)``. ``npa_state_dict``: the conv and embeddings as above, plus
``{word,news}_query`` Denses and ``{word,news}_pool/att_proj``.

The dense stack (NRMS with ``newsencoder_units_per_layer``, NRMSDocVec)
takes ``batch_stats`` beside ``params``:

  news_dense/l2_dense_<i>/kernel, bias -> news_dense.l2_dense_<i>.weight, .bias
  news_dense/bn_<i>/scale, bias        -> news_dense.bn_<i>.scale, .bias
  batch_stats news_dense/bn_<i>/mean, var -> news_dense.bn_<i>.mean, .var (buffers)

``fastformer_state_dict`` (Fastformer or FastformerWu): every Dense
as above, LayerNorms ``scale``/``bias`` -> ``.scale``/``.bias``, and

  layer_<i>/FastSelfAttention_0/<dense> -> layers.<i>.attention.<dense>
  layer_<i>/{att_out,ffn_out}/Dense_0   -> layers.<i>.{att_out,ffn_out}.dense
  layer_<i>/{att_out,ffn_out}/LayerNorm_0 -> layers.<i>.{att_out,ffn_out}.norm
  layer_<i>/Dense_0                     -> layers.<i>.intermediate
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

__all__ = ["nrms_state_dict", "load_nrms_params", "lstur_state_dict", "load_lstur_params",
           "naml_state_dict", "load_naml_params", "npa_state_dict", "nrms_docvec_state_dict",
           "fastformer_state_dict", "nrms_params", "nrms_docvec_params", "lstur_params",
           "npa_params", "naml_params", "fastformer_params"]


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


def _self_att(sd: dict, name: str, att: Mapping) -> None:
    for w in ("WQ", "WK", "WV"):
        sd[f"{name}.{w}.weight"] = _t(att[w]).T.contiguous()


def _norm(sd: dict, name: str, norm: Mapping) -> None:
    sd[f"{name}.scale"] = _t(norm["scale"])
    sd[f"{name}.bias"] = _t(norm["bias"])


def _dense_stack(sd: dict, params: Mapping, batch_stats: Mapping) -> None:
    stack, stats = params["news_dense"], batch_stats["news_dense"]
    for name, sub in stack.items():
        if name.startswith("l2_dense_"):
            _dense(sd, f"news_dense.{name}", sub)
        else:  # bn_<i>
            _norm(sd, f"news_dense.{name}", sub)
            for buf in ("mean", "var"):
                sd[f"news_dense.{name}.{buf}"] = _t(stats[name][buf])


def nrms_state_dict(params: Mapping, batch_stats: Mapping | None = None) -> dict[str, torch.Tensor]:
    """JAX NRMS params tree (and, with the dense stack, its ``batch_stats``)
    -> the port NRMS's ``state_dict`` (fp32, CPU)."""
    sd = {}
    _embed(sd, "word_embedding", params)
    for tower in ("news", "user"):
        _self_att(sd, f"{tower}_self_att", params[f"{tower}_self_att"])
        _pool(sd, f"{tower}_pool", params[f"{tower}_pool"])
    if "news_dense" in params:
        _dense_stack(sd, params, batch_stats)
    return sd


def nrms_docvec_state_dict(params: Mapping, batch_stats: Mapping) -> dict[str, torch.Tensor]:
    """JAX NRMSDocVec ``params`` and ``batch_stats`` -> the port's
    ``state_dict`` (fp32, CPU; the BN running stats as buffers)."""
    sd = {}
    _dense_stack(sd, params, batch_stats)
    _dense(sd, "news_out", params["news_out"])
    _self_att(sd, "user_self_att", params["user_self_att"])
    _pool(sd, "user_pool", params["user_pool"])
    return sd


def npa_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """JAX NPA params tree -> the port NPA's ``state_dict`` (fp32, CPU)."""
    sd = {}
    for name in ("word_embedding", "user_embedding"):
        _embed(sd, name, params)
    _conv(sd, "conv", params["conv"])
    for name in ("word_query", "news_query"):
        _dense(sd, name, params[name])
    for name in ("word_pool", "news_pool"):
        _dense(sd, f"{name}.att_proj", params[name]["att_proj"])
    return sd


def fastformer_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """JAX Fastformer or FastformerWu params tree -> the port module's
    ``state_dict`` (fp32, CPU); the tree decides which pools there are."""
    sd = {}
    for name in ("word_embedding", "position_embedding"):
        _embed(sd, name, params)
    for name in ("embedding_transform", "output_layer"):
        _dense(sd, name, params[name])
    _norm(sd, "emb_norm", params["emb_norm"])
    for name in ("token_pool", "user_pool"):
        if name in params:
            _pool(sd, name, params[name])
    i = 0
    while f"layer_{i}" in params:
        _fastformer_layer(sd, f"layers.{i}.", params[f"layer_{i}"])
        i += 1
    return sd


def _fastformer_layer(sd: dict, prefix: str, layer: Mapping) -> None:
    for name, dense in layer["FastSelfAttention_0"].items():
        _dense(sd, f"{prefix}attention.{name}", dense)
    for name in ("att_out", "ffn_out"):
        _dense(sd, f"{prefix}{name}.dense", layer[name]["Dense_0"])
        _norm(sd, f"{prefix}{name}.norm", layer[name]["LayerNorm_0"])
    _dense(sd, f"{prefix}intermediate", layer["Dense_0"])


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


def load_nrms_params(model: torch.nn.Module, params: Mapping,
                     batch_stats: Mapping | None = None) -> torch.nn.Module:
    """Copy a JAX NRMS params tree (with the dense stack, and its
    ``batch_stats``) into ``model`` (strict: every key and shape must
    match)."""
    model.load_state_dict(nrms_state_dict(params, batch_stats), strict=True)
    return model


def load_lstur_params(model: torch.nn.Module, params: Mapping) -> torch.nn.Module:
    """Copy a JAX LSTUR params tree into ``model`` (strict)."""
    model.load_state_dict(lstur_state_dict(params), strict=True)
    return model


def load_naml_params(model: torch.nn.Module, params: Mapping) -> torch.nn.Module:
    """Copy a JAX NAML params tree into ``model`` (strict)."""
    model.load_state_dict(naml_state_dict(params), strict=True)
    return model


# -- port -> JAX --------------------------------------------------------------

def _state(state, vocab_size: Optional[int]) -> tuple[Mapping, Optional[int]]:
    """(the state_dict, the word table's whole row count if known) of a
    module or a state_dict."""
    if isinstance(state, torch.nn.Module):
        emb = getattr(state, "word_embedding", None)
        if vocab_size is None and emb is not None:
            vocab_size = emb.num_embeddings
        state = state.state_dict()
    return state, vocab_size


def _a(t) -> np.ndarray:
    """A float32 numpy copy of a tensor (any device), sharing no memory."""
    return t.detach().to("cpu", torch.float32, copy=True).numpy()


def _aT(t) -> np.ndarray:
    return np.ascontiguousarray(_a(t).T)


def _pool_p(sd: Mapping, name: str) -> dict:
    return {"W": _aT(sd[f"{name}.W.weight"]), "b": _a(sd[f"{name}.W.bias"]),
            "q": _aT(sd[f"{name}.q.weight"])}


def _dense_p(sd: Mapping, name: str) -> dict:
    out = {"kernel": _aT(sd[f"{name}.weight"])}
    if f"{name}.bias" in sd:
        out["bias"] = _a(sd[f"{name}.bias"])
    return out


def _conv_p(sd: Mapping, name: str) -> dict:
    kernel = np.ascontiguousarray(_a(sd[f"{name}.weight"]).transpose(2, 1, 0))
    return {"Conv_0": {"kernel": kernel, "bias": _a(sd[f"{name}.bias"])}}


def _embed_p(sd: Mapping, name: str) -> dict:
    return {"embedding": _a(sd[f"{name}.embedding"])}


def _word_p(sd: Mapping, vocab_size: Optional[int]) -> dict:
    """The word table, whole: a block of a row-sharded one raises."""
    table = sd["word_embedding.embedding"]
    if vocab_size is not None and table.shape[0] != vocab_size:
        raise ValueError(
            f"word_embedding.embedding is [{table.shape[0]}, {table.shape[1]}], not the whole "
            f"[{vocab_size}, {table.shape[1]}] table: a block of a row-sharded table? Export "
            "Trainer.state_dict()['model'], which gathers it")
    return _embed_p(sd, "word_embedding")


def _self_att_p(sd: Mapping, name: str) -> dict:
    return {w: _aT(sd[f"{name}.{w}.weight"]) for w in ("WQ", "WK", "WV")}


def _norm_p(sd: Mapping, name: str) -> dict:
    return {"scale": _a(sd[f"{name}.scale"]), "bias": _a(sd[f"{name}.bias"])}


def _children(sd: Mapping, prefix: str) -> list[str]:
    """The names of the direct submodules under ``prefix`` (in order)."""
    names = []
    for key in sd:
        if key.startswith(prefix):
            name = key[len(prefix):].split(".")[0]
            if name not in names:
                names.append(name)
    return names


def _dense_stack_p(sd: Mapping) -> tuple[dict, dict]:
    stack, stats = {}, {}
    for name in _children(sd, "news_dense."):
        if name.startswith("l2_dense_"):
            stack[name] = _dense_p(sd, f"news_dense.{name}")
        else:  # bn_<i>
            stack[name] = _norm_p(sd, f"news_dense.{name}")
            stats[name] = {buf: _a(sd[f"news_dense.{name}.{buf}"]) for buf in ("mean", "var")}
    return stack, stats


def nrms_params(state, vocab_size: Optional[int] = None) -> tuple[dict, Optional[dict]]:
    """Port NRMS (a state_dict or the model) -> the JAX NRMS's ``(params,
    batch_stats)``; ``batch_stats`` is None without the dense stack."""
    sd, vocab_size = _state(state, vocab_size)
    params = {"word_embedding": _word_p(sd, vocab_size)}
    for tower in ("news", "user"):
        params[f"{tower}_self_att"] = _self_att_p(sd, f"{tower}_self_att")
        params[f"{tower}_pool"] = _pool_p(sd, f"{tower}_pool")
    if not _children(sd, "news_dense."):
        return params, None
    params["news_dense"], stats = _dense_stack_p(sd)
    return params, {"news_dense": stats}


def nrms_docvec_params(state) -> tuple[dict, dict]:
    """Port NRMSDocVec -> the JAX NRMSDocVec's ``(params, batch_stats)``."""
    sd, _ = _state(state, None)
    stack, stats = _dense_stack_p(sd)
    params = {"news_dense": stack, "news_out": _dense_p(sd, "news_out"),
              "user_self_att": _self_att_p(sd, "user_self_att"),
              "user_pool": _pool_p(sd, "user_pool")}
    return params, {"news_dense": stats}


def npa_params(state, vocab_size: Optional[int] = None) -> dict:
    """Port NPA -> the JAX NPA's ``params``."""
    sd, vocab_size = _state(state, vocab_size)
    params = {"word_embedding": _word_p(sd, vocab_size),
              "user_embedding": _embed_p(sd, "user_embedding"), "conv": _conv_p(sd, "conv")}
    for name in ("word_query", "news_query"):
        params[name] = _dense_p(sd, name)
    for name in ("word_pool", "news_pool"):
        params[name] = {"att_proj": _dense_p(sd, f"{name}.att_proj")}
    return params


def fastformer_params(state, vocab_size: Optional[int] = None) -> dict:
    """Port Fastformer or FastformerWu -> the JAX module's ``params``; the
    state decides which pools there are."""
    sd, vocab_size = _state(state, vocab_size)
    params = {"word_embedding": _word_p(sd, vocab_size),
              "position_embedding": _embed_p(sd, "position_embedding"),
              "embedding_transform": _dense_p(sd, "embedding_transform"),
              "output_layer": _dense_p(sd, "output_layer"),
              "emb_norm": _norm_p(sd, "emb_norm")}
    for name in ("token_pool", "user_pool"):
        if f"{name}.W.weight" in sd:
            params[name] = _pool_p(sd, name)
    for i in _children(sd, "layers."):
        prefix = f"layers.{i}."
        params[f"layer_{i}"] = {
            "FastSelfAttention_0": {name: _dense_p(sd, f"{prefix}attention.{name}")
                                    for name in _children(sd, f"{prefix}attention.")},
            **{name: {"Dense_0": _dense_p(sd, f"{prefix}{name}.dense"),
                      "LayerNorm_0": _norm_p(sd, f"{prefix}{name}.norm")}
               for name in ("att_out", "ffn_out")},
            "Dense_0": _dense_p(sd, f"{prefix}intermediate")}
    return params


def lstur_params(state, vocab_size: Optional[int] = None) -> dict:
    """Port LSTUR (``ini`` or ``con``) -> the JAX LSTUR's ``params``."""
    sd, vocab_size = _state(state, vocab_size)
    params = {"word_embedding": _word_p(sd, vocab_size),
              "user_embedding": _embed_p(sd, "user_embedding"), "conv": _conv_p(sd, "conv"),
              "news_pool": _pool_p(sd, "news_pool"),
              "gru": {"GRUCell_0": {gate: _dense_p(sd, "gru." + ("in_" if gate == "in" else gate))
                                    for gate in ("ir", "iz", "in", "hr", "hz", "hn")}}}
    if "con_dense.weight" in sd:
        params["con_dense"] = _dense_p(sd, "con_dense")
    return params


def naml_params(state, vocab_size: Optional[int] = None) -> dict:
    """Port NAML -> the JAX NAML's ``params``."""
    sd, vocab_size = _state(state, vocab_size)
    params = {"word_embedding": _word_p(sd, vocab_size)}
    for name in ("vert_embedding", "subvert_embedding"):
        params[name] = _embed_p(sd, name)
    for view in ("title", "body"):
        params[f"{view}_conv"] = _conv_p(sd, f"{view}_conv")
        params[f"{view}_pool"] = _pool_p(sd, f"{view}_pool")
    for name in ("vert_dense", "subvert_dense"):
        params[name] = _dense_p(sd, name)
    for name in ("view_pool", "user_pool"):
        params[name] = _pool_p(sd, name)
    return params

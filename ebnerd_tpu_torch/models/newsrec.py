"""The newsrec families NRMS, NRMSDocVec, LSTUR, NPA and NAML as
``nn.Module``s; counterparts of the same classes in
``ebnerd_tpu/models/newsrec.py``. The other families' notes are in their
docstrings; this one is NRMS's.

One module scores K candidates at once and returns raw logits [B, K].
``use_fused_encoder=True`` routes both towers through the fused news
encoder (``ops/news_encoder.news_encoder``: the Hopper kernels on CUDA
tensors, forward and recompute backward); the unfused path runs
``SelfAttention`` + ``AdditiveAttention``. Both paths share one parameter
tree, so ``bridge.py`` loads the same JAX weights into either.

Training mode (``model.train()``) applies the reference's two dropouts in
the news tower, the embedding dropout and the dropout between attention
and pooling, each with keep 1 - hparams.dropout; the user tower has none.
With ``newsencoder_units_per_layer`` (unfused only) the dense stack
(``_DenseStack``: Dense, relu, ``WeightedBatchNorm``, dropout per layer)
runs between attention and pooling in place of the second dropout.
Fused, both masks come from the kernel's Philox streams under one 64-bit
seed per step; unfused, from a ``torch.Generator`` seeded with it, or,
when the seed is a tensor (the trainer's ``scan_steps`` path), from the
seed-recompute dropout kernel (``ops/dropout.py``) at streams 0
(embedding) and 1 (attention output; the dense stack's block i at 1 + i).
The seed is ``batch["dropout_seed"]`` (the trainer draws one per step), or
one drawn from torch's global generator.

Batch dict (tensors on the model's device), per slot:
  hist_tokens  int [B, H, T]
  cand_tokens  int [B, K, T]
or deduped (``training/dedup.py``, ``models/inputs.py``):
  uniq_tokens  int [C, T]    the batch's unique articles, bucket-padded
  hist_slot    int [B, H]    positions into uniq_tokens
  cand_slot    int [B, K]
  art_n_uniq   int, or an int32 device scalar: valid unique articles (the kernels skip the rest)
  art_counts   float [C]     slots per unique article (the dense stack's BN weights)
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from .. import resolve_device
from ..ops.dropout import prng_dropout
from ..ops.news_encoder import PackedWeights, news_encoder, pack_weights
from .config import HParamsLSTUR, HParamsNAML, HParamsNPA, HParamsNRMS, HParamsNRMSDocVec
from .layers import (AdditiveAttention, ConvEncoder, Dense, Embed, MaskedGRU,
                     PersonalizedAttentivePooling, PrngDropout, SelfAttention, WeightedBatchNorm,
                     WordEmbed, draw_seed, fold_seed, generator_dropout)

__all__ = ["NRMS", "NRMSDocVec", "LSTUR", "NPA", "NAML"]


def _encode_both(encode, hist: torch.Tensor, cand: torch.Tensor):
    """One encoder call over history and candidate articles concatenated
    along the article axis, then split (same math as two calls)."""
    (b, h), k = hist.shape[:2], cand.shape[1]
    both = torch.cat([hist.reshape(b * h, *hist.shape[2:]),
                      cand.reshape(b * k, *cand.shape[2:])])
    vecs = encode(both)
    return vecs[: b * h].reshape(b, h, -1), vecs[b * h:].reshape(b, k, -1)


def _dot_scores(news: torch.Tensor, user: torch.Tensor) -> torch.Tensor:
    """logits[b, k] = <news[b, k], user[b]>."""
    return torch.einsum("bkd,bd->bk", news, user)


def _maybe_remat(fn, enabled: bool):
    """``fn`` under ``torch.utils.checkpoint`` when ``enabled``: the backward
    recomputes the article encoder instead of keeping its per-token
    activations (flax ``nn.remat``). Exact: its dropout masks are
    regenerated from the same seed, so no global RNG state is stashed (which
    also lets a CUDA graph capture it)."""
    if not enabled:
        return fn
    return lambda *args: torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                                           preserve_rng_state=False)


def _dedup_gather(art: torch.Tensor, batch: dict):
    """[C, ...] unique-article rows -> ([B, H, ...], [B, K, ...]) by slot
    gathers of a [C, prod(...)] view; their backward sums the slot
    cotangents into [C, ...] (by ``F.embedding``'s sort and segment
    reduction, in fp32: popular articles fill thousands of slots).
    ``batch["art_cotangent"]``, set by the trainer under a mesh, wraps the
    rows of each gather (``parallel.mesh.average_cotangent``): the article
    tower's backward then sees every process's slot cotangents. The rows
    are then gathered in fp32, so each gather's slot sums from every
    process meet in fp32 and round to ``art``'s dtype once, as one
    process's do."""
    hook = batch.get("art_cotangent")
    out = []
    for key in ("hist_slot", "cand_slot"):
        src = art if hook is None else hook(art.float())
        flat, tail = src.reshape(src.shape[0], -1), src.shape[1:]
        out.append(F.embedding(batch[key], flat).reshape(*batch[key].shape, *tail).to(art.dtype))
    return tuple(out)


def _seed_of(model: nn.Module, batch: dict):
    """The step's dropout seed: ``batch["dropout_seed"]`` (an int, or a
    one-element int64 tensor), else one drawn when the model is training
    with dropout."""
    seed = batch.get("dropout_seed")
    if seed is None and model.training and model.hparams.dropout > 0:
        seed = draw_seed()
    return seed


class _DenseStack(nn.Module):
    """Blocks of relu Dense, ``WeightedBatchNorm`` and dropout (the JAX
    ``_DenseStack``). The Linear modules are ``l2_dense_{i}``, so
    ``losses.l2_penalty`` finds them; BN ``i`` is ``bn_{i}`` (epsilon
    1e-3, Keras's). BN's output stays fp32 and the next Dense casts it to
    ``dtype``. The dropout of block i takes stream 1 + i of the step's
    seed from a ``torch.Generator`` (the JAX stack uses flax's dropout, not
    the kernel). ``weights`` are the dedup path's slot counts
    (``WeightedBatchNorm``)."""

    def __init__(self, din: int, units: tuple, rate: float, dtype: torch.dtype,
                 device: torch.device, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.units = tuple(units)
        self.drop = PrngDropout(rate, use_kernel=False)
        for i, u in enumerate(self.units):
            setattr(self, f"l2_dense_{i}", Dense(din, u, dtype, device, generator))
            setattr(self, f"bn_{i}", WeightedBatchNorm(u, device))
            din = u

    def forward(self, x: torch.Tensor, seed,
                weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        for i in range(len(self.units)):
            x = F.relu(getattr(self, f"l2_dense_{i}")(x))
            x = getattr(self, f"bn_{i}")(x, weights)
            x = self.drop(x, seed, 1 + i)
        return x


class NRMS(nn.Module):
    """NRMS, eval and training mode (see the module docstring).

    ``dtype`` is the compute dtype (``torch.bfloat16`` or ``torch.float32``);
    parameters are fp32 on ``device``, initialised from ``seed`` with a
    ``torch.Generator`` on that device. ``word_emb_init``, a pretrained
    [V, E] matrix (numpy or a tensor), then replaces the word table's values,
    as the JAX modules' ``word_emb_init`` does; the other parameters are the
    same as without it. LSTUR, NPA, NAML and both Fastformers take it too."""

    def __init__(self, hparams: HParamsNRMS, vocab_size: int = 32000,
                 word_emb_dim: int = 300, dtype: torch.dtype = torch.float32,
                 use_fused_encoder: bool = False, transposed_self_att: bool = False,
                 device="cuda", seed: int = 0, word_emb_init=None):
        super().__init__()
        hp = hparams
        if use_fused_encoder and hp.newsencoder_units_per_layer:
            raise ValueError("fused encoder does not support the dense stack")
        if use_fused_encoder and transposed_self_att:
            raise ValueError("transposed_self_att is not implemented by the fused kernel")
        self.device = resolve_device(device)
        self.hparams = hp
        self.dtype = dtype
        self.use_fused_encoder = use_fused_encoder
        d = hp.head_num * hp.head_dim
        gen = torch.Generator(device=self.device).manual_seed(seed)
        kw = dict(dtype=dtype, device=self.device, generator=gen)
        self.word_embedding = WordEmbed(vocab_size, word_emb_dim, **kw)
        if word_emb_init is not None:
            self.word_embedding.load_(word_emb_init)
        self.news_self_att = SelfAttention(word_emb_dim, hp.head_num, hp.head_dim,
                                           transposed=transposed_self_att, **kw)
        units = tuple(hp.newsencoder_units_per_layer or ())
        if units:
            self.news_dense = _DenseStack(d, units, hp.dropout, **kw)
        news_dim = units[-1] if units else d
        self.news_pool = AdditiveAttention(news_dim, hp.attention_hidden_dim, **kw)
        self.user_self_att = SelfAttention(news_dim, hp.head_num, hp.head_dim,
                                           transposed=transposed_self_att, **kw)
        self.user_pool = AdditiveAttention(d, hp.attention_hidden_dim, **kw)
        self._packed: dict = {}  # tower -> (parameter versions, PackedWeights)
        self.eval()

    def _tower_weights(self, tower: str) -> tuple:
        """The fused encoder's weights of ``tower`` ("news" or "user") in the
        JAX layout: Wq, Wk, Wv [Din, D], W [D, A], b [A], q [A, 1]."""
        att, pool = getattr(self, f"{tower}_self_att"), getattr(self, f"{tower}_pool")
        return (att.WQ.weight.T, att.WK.weight.T, att.WV.weight.T,
                pool.W.weight.T, pool.W.bias, pool.q.weight.T)

    def packed_weights(self, tower: str, compute: torch.dtype) -> PackedWeights:
        """``tower``'s weights packed for the kernel, kept across calls and
        packed again once a parameter is replaced or changed in place."""
        weights = self._tower_weights(tower)
        key = (compute,) + tuple((w.data_ptr(), w._version) for w in weights)
        hit = self._packed.get(tower)
        if hit is None or hit[0] != key:
            hit = (key, pack_weights(*weights, num_heads=self.hparams.head_num,
                                     compute_dtype=compute))
            self._packed[tower] = hit
        return hit[1]

    def _keep(self) -> float:
        """Keep probability of the news tower's dropouts (1 in eval mode)."""
        return 1.0 - self.hparams.dropout if self.training and self.hparams.dropout > 0 else 1.0

    def _fused(self, x: torch.Tensor, tower: str, n_valid=None, seed=None) -> torch.Tensor:
        # bf16 models keep x in bf16 and run the kernel at bf16 with fp32
        # accumulation; fp32 models keep full fp32 numerics
        compute = torch.bfloat16 if self.dtype == torch.bfloat16 else torch.float32
        packed = self.packed_weights(tower, compute) if x.device.type == "cuda" else None
        keep = self._keep() if seed is not None else 1.0
        out = news_encoder(
            x.to(compute), *self._tower_weights(tower), num_heads=self.hparams.head_num,
            compute_dtype=compute, n_valid=n_valid, keep_prob=keep, emb_keep_prob=keep,
            rng_seed=seed if keep < 1.0 else None, packed=packed)
        return out.to(self.dtype)

    def encode_news(self, tokens: torch.Tensor, n_valid=None, seed=None,
                    weights: Optional[torch.Tensor] = None,
                    rows: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens [N, T] -> news vectors [N, head_num*head_dim]. In training
        mode with dropout, ``seed`` (64-bit: an int, or a one-element int64
        tensor) fixes every mask; ``n_valid`` (an int or an int32 device
        scalar) bounds the fused kernels' work; ``weights`` (dedup path) are
        the dense stack's BN row weights; ``rows`` the row-sparse mode's
        compact word rows (``WordEmbed``)."""
        x = self.word_embedding(tokens, rows)
        keep = self._keep()
        if keep < 1.0 and seed is None:
            seed = draw_seed()
        if self.use_fused_encoder:
            return self._fused(x, "news", n_valid, seed)
        if keep == 1.0:
            drop = lambda v, stream: v
        elif isinstance(seed, torch.Tensor):  # the scan path: the kernel's streams 0 and 1
            drop = lambda v, stream: prng_dropout(v, seed, stream, keep)
        else:  # one generator draws both masks, in order
            gen = torch.Generator(device=x.device).manual_seed(fold_seed(seed))
            drop = lambda v, stream: generator_dropout(v, keep, gen)
        x = drop(x, 0)
        y = self.news_self_att(x, x, x)
        y = self.news_dense(y, seed, weights) if hasattr(self, "news_dense") else drop(y, 1)
        return self.news_pool(y)

    def encode_user(self, hist_vecs: torch.Tensor) -> torch.Tensor:
        """hist_vecs [B, H, D] -> user vector [B, D]. No history mask: a
        padded slot carries the padding article's vector, as in the JAX
        model."""
        if self.use_fused_encoder:
            return self._fused(hist_vecs, "user")
        return self.user_pool(self.user_self_att(hist_vecs, hist_vecs, hist_vecs))

    def forward(self, batch: dict) -> torch.Tensor:
        seed, rows = batch.get("dropout_seed"), batch.get("emb_rows")
        if "uniq_tokens" in batch:
            art = self.encode_news(batch["uniq_tokens"], batch.get("art_n_uniq"), seed,
                                   batch.get("art_counts"), rows)
            hist_vecs, cand_vecs = _dedup_gather(art, batch)
        else:
            hist_vecs, cand_vecs = _encode_both(
                lambda x: self.encode_news(x, seed=seed, rows=rows), batch["hist_tokens"],
                batch["cand_tokens"])
        user = self.encode_user(hist_vecs)
        return _dot_scores(cand_vecs, user)


class NRMSDocVec(nn.Module):
    """NRMS on frozen document vectors instead of tokens (counterpart of
    ``NRMSDocVec`` in ``ebnerd_tpu/models/newsrec.py``). Article tower: the
    dense stack (``_DenseStack``) over the [.., title_size] document
    vector, then relu(``news_out``) to head_num * head_dim; user tower:
    ``SelfAttention`` and ``AdditiveAttention``, no mask. No dropout kernel:
    the stack's dropouts are generator-seeded.

    Batch: per slot ``hist_vecs`` [B, H, Dv], ``cand_vecs`` [B, K, Dv], or
    deduped ``uniq_vecs`` [C, Dv] with ``hist_slot``/``cand_slot`` and
    ``art_counts`` [C], the BN row weights that keep the moments equal to
    the per-slot path's (``models/inputs.docvec_batch``)."""

    def __init__(self, hparams: HParamsNRMSDocVec, dtype: torch.dtype = torch.float32,
                 device="cuda", seed: int = 0):
        super().__init__()
        hp = hparams
        self.device = resolve_device(device)
        self.hparams, self.dtype = hp, dtype
        d = hp.head_num * hp.head_dim
        gen = torch.Generator(device=self.device).manual_seed(seed)
        kw = dict(dtype=dtype, device=self.device, generator=gen)
        units = tuple(hp.newsencoder_units_per_layer)
        self.news_dense = _DenseStack(hp.title_size, units, hp.dropout, **kw)
        self.news_out = Dense(units[-1], d, **kw)
        self.user_self_att = SelfAttention(d, hp.head_num, hp.head_dim, **kw)
        self.user_pool = AdditiveAttention(d, hp.attention_hidden_dim, **kw)
        self.eval()

    def encode_news(self, vecs: torch.Tensor, seed=None,
                    weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Document vectors [N, Dv] -> article vectors [N, D]."""
        return F.relu(self.news_out(self.news_dense(vecs, seed, weights)))

    def encode_user(self, hist_vecs: torch.Tensor) -> torch.Tensor:
        return self.user_pool(self.user_self_att(hist_vecs, hist_vecs, hist_vecs))

    def forward(self, batch: dict) -> torch.Tensor:
        seed = _seed_of(self, batch)
        if "uniq_vecs" in batch:
            art = self.encode_news(batch["uniq_vecs"], seed, batch.get("art_counts"))
            hist_vecs, cand_vecs = _dedup_gather(art, batch)
        else:
            hist_vecs, cand_vecs = _encode_both(lambda x: self.encode_news(x, seed),
                                                batch["hist_vecs"], batch["cand_vecs"])
        return _dot_scores(cand_vecs, self.encode_user(hist_vecs))


class LSTUR(nn.Module):
    """Long- and Short-term User Representations (An et al., ACL 2019);
    counterpart of ``LSTUR`` in ``ebnerd_tpu/models/newsrec.py``.

    Article tower: word embedding, dropout (stream 0), ``ConvEncoder``,
    dropout (stream 1), the token mask, masked additive pooling; an article
    whose tokens are all padding encodes to zeros. User tower: a masked GRU
    over the clicked articles' vectors, seeded with the long-term user
    embedding (``type="ini"``) or concatenated with it and projected
    (``"con"``). ``prng_dropout=True`` takes the seed-recompute dropout
    kernel (``ops/dropout.py``), else generator-seeded masks;
    ``remat_encoder`` recomputes the article tower in the backward.

    Batch: per slot ``hist_tokens`` [B, H, T], ``cand_tokens`` [B, K, T], or
    deduped ``uniq_tokens`` [C, T], ``hist_slot`` [B, H], ``cand_slot``
    [B, K]; and ``user_id`` [B]. ``dropout_seed`` as in ``NRMS``."""

    def __init__(self, hparams: HParamsLSTUR, vocab_size: int = 32000, word_emb_dim: int = 300,
                 dtype: torch.dtype = torch.float32, remat_encoder: bool = False,
                 prng_dropout: bool = False, device="cuda", seed: int = 0,
                 word_emb_init=None):
        super().__init__()
        hp = hparams
        if hp.type not in ("ini", "con"):
            raise ValueError(f"unknown LSTUR type: {hp.type}")
        self.device = resolve_device(device)
        self.hparams, self.dtype, self.remat_encoder = hp, dtype, remat_encoder
        gen = torch.Generator(device=self.device).manual_seed(seed)
        kw = dict(device=self.device, generator=gen)
        self.drop = PrngDropout(hp.dropout, use_kernel=prng_dropout)
        self.word_embedding = WordEmbed(vocab_size, word_emb_dim, dtype=dtype, **kw)
        if word_emb_init is not None:
            self.word_embedding.load_(word_emb_init)
        self.user_embedding = Embed(hp.n_users + 1, hp.gru_unit, zero=True, **kw)
        self.conv = ConvEncoder(word_emb_dim, hp.filter_num, hp.window_size, dtype, **kw)
        self.news_pool = AdditiveAttention(hp.filter_num, hp.attention_hidden_dim, dtype=dtype, **kw)
        self.gru = MaskedGRU(hp.filter_num, hp.gru_unit, **kw)
        if hp.type == "con":
            self.con_dense = Dense(2 * hp.gru_unit, hp.gru_unit, dtype, **kw)
        self.eval()

    def encode_news(self, tokens: torch.Tensor, seed: int,
                    rows: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens [N, T] -> article vectors [N, filter_num] (``rows``: as NRMS's)."""
        token_mask = (tokens != 0).to(self.dtype)
        x = self.drop(self.word_embedding(tokens, rows), seed, 0)
        x = self.drop(self.conv(x), seed, 1)
        x = x * token_mask[..., None]
        return self.news_pool(x, mask=token_mask)

    def encode_user(self, hist_vecs: torch.Tensor, hist_mask: torch.Tensor,
                    user_id: torch.Tensor) -> torch.Tensor:
        long_u = self.user_embedding(user_id)
        if self.hparams.type == "ini":
            return self.gru(hist_vecs, hist_mask, initial_state=long_u.to(hist_vecs.dtype))
        short_u = self.gru(hist_vecs, hist_mask)
        return self.con_dense(torch.cat([short_u, long_u.to(short_u.dtype)], -1))

    def forward(self, batch: dict) -> torch.Tensor:
        seed, rows = _seed_of(self, batch), batch.get("emb_rows")
        encode = _maybe_remat(self.encode_news, self.remat_encoder)
        if "uniq_tokens" in batch:
            art = encode(batch["uniq_tokens"], seed, rows)
            hist_vecs, cand_vecs = _dedup_gather(art, batch)
            art_mask = (batch["uniq_tokens"] != 0).any(-1)
            hist_mask = art_mask[batch["hist_slot"]].to(self.dtype)
        else:
            hist_vecs, cand_vecs = _encode_both(lambda x: encode(x, seed, rows),
                                                batch["hist_tokens"], batch["cand_tokens"])
            hist_mask = (batch["hist_tokens"] != 0).any(-1).to(self.dtype)
        user = self.encode_user(hist_vecs, hist_mask, batch["user_id"])
        return _dot_scores(cand_vecs, user)


class NPA(nn.Module):
    """Neural News Recommendation with Personalized Attention (Wu et al.,
    KDD 2019); counterpart of ``NPA`` in ``ebnerd_tpu/models/newsrec.py``.

    Article tower: word embedding, dropout (stream 0), ``ConvEncoder``,
    dropout (stream 1), then a ``PersonalizedAttentivePooling`` over the
    tokens (value dropout stream 2) whose query is ``word_query`` of the
    user's embedding; user tower: the same pooling over the clicked
    articles' vectors (value dropout stream 3) with ``news_query``'s query.
    The user embedding starts at zeros. The article tower depends on the
    user, so NPA has no two-tower serving.

    The dedup path is partial: the embedding -> conv prefix, the value
    dropout and the tanh projection run once per unique article, gathered
    to the slots ([C, T, F] and [C, T, A] -> [B, H + K, T, .]); the query
    dot, softmax and weighted sum run per slot. Each user's query is
    computed once and broadcast over its slots. ``remat_encoder``
    recomputes the prefix in the backward; ``prng_dropout=True`` puts all
    four dropout sites on the seed-recompute kernel.

    Batch: per slot ``hist_tokens`` [B, H, T], ``cand_tokens`` [B, K, T], or
    deduped ``uniq_tokens`` [C, T], ``hist_slot``, ``cand_slot``; and
    ``user_id`` [B]."""

    def __init__(self, hparams: HParamsNPA, vocab_size: int = 32000, word_emb_dim: int = 300,
                 dtype: torch.dtype = torch.float32, remat_encoder: bool = False,
                 prng_dropout: bool = False, device="cuda", seed: int = 0,
                 word_emb_init=None):
        super().__init__()
        hp = hparams
        self.device = resolve_device(device)
        self.hparams, self.dtype, self.remat_encoder = hp, dtype, remat_encoder
        gen = torch.Generator(device=self.device).manual_seed(seed)
        kw = dict(device=self.device, generator=gen)
        f, a, u = hp.filter_num, hp.attention_hidden_dim, hp.user_emb_dim
        self.drop = PrngDropout(hp.dropout, use_kernel=prng_dropout)
        self.word_embedding = WordEmbed(vocab_size, word_emb_dim, dtype=dtype, **kw)
        if word_emb_init is not None:
            self.word_embedding.load_(word_emb_init)
        self.user_embedding = Embed(hp.n_users + 1, u, zero=True, **kw)
        self.conv = ConvEncoder(word_emb_dim, f, hp.window_size, dtype, **kw)
        self.word_query = Dense(u, a, dtype, **kw)
        self.news_query = Dense(u, a, dtype, **kw)
        self.word_pool = PersonalizedAttentivePooling(f, a, hp.dropout, dtype,
                                                      use_kernel=prng_dropout, **kw)
        self.news_pool = PersonalizedAttentivePooling(f, a, hp.dropout, dtype,
                                                      use_kernel=prng_dropout, **kw)
        self.eval()

    def conv_prefix(self, tokens: torch.Tensor, seed: int,
                    rows: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The user-independent prefix: tokens [N, T] -> [N, T, filter_num]
        (``rows``: as NRMS's)."""
        x = self.drop(self.word_embedding(tokens, rows), seed, 0)
        return self.drop(self.conv(x), seed, 1)

    def forward(self, batch: dict) -> torch.Tensor:
        seed, rows = _seed_of(self, batch), batch.get("emb_rows")
        u_emb = self.user_embedding(batch["user_id"]).to(self.dtype)   # [B, U]
        word_q = self.word_query(u_emb)[:, None]                         # [B, 1, A]
        prefix = _maybe_remat(self.conv_prefix, self.remat_encoder)
        pool = self.word_pool
        if "uniq_tokens" in batch:
            xd = pool.drop_values(prefix(batch["uniq_tokens"], seed, rows), seed, 2)  # [C, T, F]
            (hist_y, cand_y), (hist_p, cand_p) = (_dedup_gather(xd, batch),
                                                  _dedup_gather(pool.project(xd), batch))
        else:
            hist, cand = batch["hist_tokens"], batch["cand_tokens"]
            (b, h), k = hist.shape[:2], cand.shape[1]
            both = torch.cat([hist.reshape(b * h, -1), cand.reshape(b * k, -1)])
            xd = pool.drop_values(prefix(both, seed, rows), seed, 2)             # [N, T, F]
            proj = pool.project(xd)
            hist_y, cand_y = xd[:b * h].unflatten(0, (b, h)), xd[b * h:].unflatten(0, (b, k))
            hist_p, cand_p = proj[:b * h].unflatten(0, (b, h)), proj[b * h:].unflatten(0, (b, k))
        hist_vecs = pool.pool(hist_y, hist_p, word_q)                          # [B, H, F]
        cand_vecs = pool.pool(cand_y, cand_p, word_q)                          # [B, K, F]
        user = self.news_pool(hist_vecs, self.news_query(u_emb), seed, 3)
        return _dot_scores(cand_vecs, user)


class NAML(nn.Module):
    """Neural News Recommendation with Attentive Multi-View Learning (Wu et
    al., IJCAI 2019); counterpart of ``NAML`` in ``ebnerd_tpu/models/newsrec.py``.

    Four views per article: title and body (embedding, dropout, conv,
    dropout, additive pooling; dropout streams 0-1 for the title, 2-3 for
    the body), category and subcategory (embedding, relu Dense); an
    additive pooling over the views, and one over the history for the user.
    ``encode_chunks`` (dedup path only) encodes the unique-article axis in
    that many chunks of rows, each under ``remat_encoder``'s checkpoint when
    on, with the element offsets that keep every dropout mask equal to the
    unchunked encode's; on the per-slot path it raises.

    Batch: per slot ``{hist,cand}_{tokens,body,cat,subcat}``, or deduped
    ``uniq_{tokens,body,cat,subcat}`` with ``hist_slot``/``cand_slot``
    (``models/inputs.naml_batch``)."""

    def __init__(self, hparams: HParamsNAML, vocab_size: int = 32000, word_emb_dim: int = 300,
                 dtype: torch.dtype = torch.float32, remat_encoder: bool = False,
                 encode_chunks: int = 1, prng_dropout: bool = False, device="cuda",
                 seed: int = 0, word_emb_init=None):
        super().__init__()
        hp = hparams
        if encode_chunks < 1:
            raise ValueError(f"encode_chunks must be >= 1, got {encode_chunks}")
        self.device = resolve_device(device)
        self.hparams, self.dtype = hp, dtype
        self.remat_encoder, self.encode_chunks = remat_encoder, encode_chunks
        gen = torch.Generator(device=self.device).manual_seed(seed)
        kw = dict(device=self.device, generator=gen)
        f, a = hp.filter_num, hp.attention_hidden_dim
        self.drop = PrngDropout(hp.dropout, use_kernel=prng_dropout)
        self.word_embedding = WordEmbed(vocab_size, word_emb_dim, dtype=dtype, **kw)
        if word_emb_init is not None:
            self.word_embedding.load_(word_emb_init)
        self.title_conv = ConvEncoder(word_emb_dim, f, hp.window_size, dtype, **kw)
        self.title_pool = AdditiveAttention(f, a, dtype=dtype, **kw)
        self.body_conv = ConvEncoder(word_emb_dim, f, hp.window_size, dtype, **kw)
        self.body_pool = AdditiveAttention(f, a, dtype=dtype, **kw)
        self.vert_embedding = Embed(hp.vert_num, hp.vert_emb_dim, **kw)
        self.vert_dense = Dense(hp.vert_emb_dim, f, dtype, **kw)
        self.subvert_embedding = Embed(hp.subvert_num, hp.subvert_emb_dim, **kw)
        self.subvert_dense = Dense(hp.subvert_emb_dim, f, dtype, **kw)
        self.view_pool = AdditiveAttention(f, a, dtype=dtype, **kw)
        self.user_pool = AdditiveAttention(f, a, dtype=dtype, **kw)
        self.eval()

    def _text_view(self, tokens, conv, pool, seed, stream, row0, rows):
        x = self.drop(self.word_embedding(tokens, rows), seed, stream, row0)
        return pool(self.drop(conv(x), seed, stream + 1, row0))

    def encode_news(self, title, body, vert, subvert, seed: int, row0: int = 0,
                    rows: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Four views -> [N, filter_num]; ``row0`` is the global row of the
        first article (chunked encodes); ``rows``: as NRMS's."""
        title_r = self._text_view(title, self.title_conv, self.title_pool, seed, 0, row0, rows)
        body_r = self._text_view(body, self.body_conv, self.body_pool, seed, 2, row0, rows)
        vert_r = F.relu(self.vert_dense(self.vert_embedding(vert).to(self.dtype)))
        subvert_r = F.relu(self.subvert_dense(self.subvert_embedding(subvert).to(self.dtype)))
        return self.view_pool(torch.stack([title_r, body_r, vert_r, subvert_r], dim=-2))

    def _encode_chunked(self, title, body, vert, subvert, seed, rows=None):
        n, c = self.encode_chunks, title.shape[0]
        if c % n:
            raise ValueError(f"encode_chunks={n} must divide C={c}")
        step = c // n
        encode = _maybe_remat(self.encode_news, self.remat_encoder)
        return torch.cat([encode(title[r:r + step], body[r:r + step], vert[r:r + step],
                                 subvert[r:r + step], seed, r, rows) for r in range(0, c, step)])

    def forward(self, batch: dict) -> torch.Tensor:
        seed, rows = _seed_of(self, batch), batch.get("emb_rows")
        if "uniq_tokens" in batch:
            art = self._encode_chunked(batch["uniq_tokens"], batch["uniq_body"],
                                       batch["uniq_cat"], batch["uniq_subcat"], seed, rows)
            hist_vecs, cand_vecs = _dedup_gather(art, batch)
            return _dot_scores(cand_vecs, self.user_pool(hist_vecs))
        if self.encode_chunks > 1:
            raise ValueError("encode_chunks applies to the dedup path only; this batch is per slot")
        (b, h), k = batch["hist_tokens"].shape[:2], batch["cand_tokens"].shape[1]

        def both(name):
            x, y = batch[f"hist_{name}"], batch[f"cand_{name}"]
            return torch.cat([x.reshape(b * h, *x.shape[2:]), y.reshape(b * k, *y.shape[2:])])

        encode = _maybe_remat(self.encode_news, self.remat_encoder)
        vecs = encode(both("tokens"), both("body"), both("cat"), both("subcat"), seed, 0, rows)
        hist_vecs, cand_vecs = vecs[:b * h].reshape(b, h, -1), vecs[b * h:].reshape(b, k, -1)
        return _dot_scores(cand_vecs, self.user_pool(hist_vecs))

"""NRMS (Wu et al., EMNLP 2019) as an ``nn.Module``; counterpart of
``NRMS`` in ``ebnerd_tpu/models/newsrec.py``.

One module scores K candidates at once and returns raw logits [B, K].
``use_fused_encoder=True`` routes both towers through the fused news
encoder (``ops/news_encoder.news_encoder``: the Hopper kernels on CUDA
tensors, forward and recompute backward); the unfused path runs
``SelfAttention`` + ``AdditiveAttention``. Both paths share one parameter
tree, so ``bridge.py`` loads the same JAX weights into either.

Training mode (``model.train()``) applies the reference's two dropouts in
the news tower, the embedding dropout and the dropout between attention
and pooling, each with keep 1 - hparams.dropout; the user tower has none.
Fused, both masks come from the kernel's Philox streams under one 64-bit
seed per step; unfused, from a ``torch.Generator`` seeded with it. The
seed is ``batch["dropout_seed"]`` (the trainer draws one per step), or one
drawn from torch's global generator.

Batch dict (tensors on the model's device), per slot:
  hist_tokens  int [B, H, T]
  cand_tokens  int [B, K, T]
or deduped (``training/dedup.py``, ``models/inputs.py``):
  uniq_tokens  int [C, T]    the batch's unique articles, bucket-padded
  hist_slot    int [B, H]    positions into uniq_tokens
  cand_slot    int [B, K]
  art_n_uniq   int           valid unique articles (the kernels skip the rest)
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from ..ops.news_encoder import PackedWeights, news_encoder, pack_weights
from .config import HParamsNRMS
from .layers import AdditiveAttention, SelfAttention, WordEmbed

__all__ = ["NRMS"]


def _encode_both(encode, hist: torch.Tensor, cand: torch.Tensor):
    """One encoder call over history and candidate articles concatenated
    along the article axis, then split (same math as two calls)."""
    (b, h), k = hist.shape[:2], cand.shape[1]
    both = torch.cat([hist.reshape(b * h, *hist.shape[2:]),
                      cand.reshape(b * k, *cand.shape[2:])])
    vecs = encode(both)
    return vecs[: b * h].reshape(b, h, -1), vecs[b * h:].reshape(b, k, -1)


def _dedup_gather(art_vecs: torch.Tensor, batch: dict):
    """[C, D] unique-article vectors -> ([B, H, D], [B, K, D]) by slot
    gathers; their backward sums the slot cotangents into [C, D] (by
    ``F.embedding``'s sort and segment reduction, in fp32: popular
    articles fill thousands of slots)."""
    return (F.embedding(batch["hist_slot"], art_vecs),
            F.embedding(batch["cand_slot"], art_vecs))


def _fold_seed(seed: int) -> int:
    """The 64-bit seed for a ``torch.Generator``: the CPU generator keeps
    only the low 32 bits, so the high word is mixed into them."""
    hi = seed >> 32
    return seed ^ ((hi * 0x9E3779B9) & 0xFFFFFFFF)


def _draw_seed() -> int:
    """A 64-bit dropout seed from torch's global generator."""
    lo, hi = torch.randint(0, 1 << 32, (2,)).tolist()
    return (hi << 32) | lo


class NRMS(nn.Module):
    """NRMS, eval and training mode (see the module docstring).

    ``dtype`` is the compute dtype (``torch.bfloat16`` or ``torch.float32``);
    parameters are fp32 on ``device``, initialised from ``seed`` with a
    ``torch.Generator`` on that device."""

    def __init__(self, hparams: HParamsNRMS, vocab_size: int = 32000,
                 word_emb_dim: int = 300, dtype: torch.dtype = torch.float32,
                 use_fused_encoder: bool = False, transposed_self_att: bool = False,
                 device="cuda", seed: int = 0):
        super().__init__()
        hp = hparams
        if hp.newsencoder_units_per_layer:
            raise NotImplementedError(
                "NRMS's dense stack (newsencoder_units_per_layer) is not ported "
                "yet (ROADMAP A6)")
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
        self.news_self_att = SelfAttention(word_emb_dim, hp.head_num, hp.head_dim,
                                           transposed=transposed_self_att, **kw)
        self.news_pool = AdditiveAttention(d, hp.attention_hidden_dim, **kw)
        self.user_self_att = SelfAttention(d, hp.head_num, hp.head_dim,
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

    def _fused(self, x: torch.Tensor, tower: str, n_valid: Optional[int] = None,
               seed: Optional[int] = None) -> torch.Tensor:
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

    @staticmethod
    def _dropout(x: torch.Tensor, keep: float, gen: torch.Generator) -> torch.Tensor:
        """Inverted dropout with a mask drawn from ``gen`` (flax's
        ``where(mask, x / keep, 0)``)."""
        mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))

    def encode_news(self, tokens: torch.Tensor, n_valid: Optional[int] = None,
                    seed: Optional[int] = None) -> torch.Tensor:
        """tokens [N, T] -> news vectors [N, head_num*head_dim]. In training
        mode with dropout, ``seed`` (64-bit) fixes both masks."""
        x = self.word_embedding(tokens)
        keep = self._keep()
        if keep < 1.0 and seed is None:
            seed = _draw_seed()
        if self.use_fused_encoder:
            return self._fused(x, "news", n_valid, seed)
        if keep == 1.0:
            return self.news_pool(self.news_self_att(x, x, x))
        gen = torch.Generator(device=x.device).manual_seed(_fold_seed(seed))
        x = self._dropout(x, keep, gen)
        return self.news_pool(self._dropout(self.news_self_att(x, x, x), keep, gen))

    def encode_user(self, hist_vecs: torch.Tensor) -> torch.Tensor:
        """hist_vecs [B, H, D] -> user vector [B, D]. No history mask: a
        padded slot carries the padding article's vector, as in the JAX
        model."""
        if self.use_fused_encoder:
            return self._fused(hist_vecs, "user")
        return self.user_pool(self.user_self_att(hist_vecs, hist_vecs, hist_vecs))

    def forward(self, batch: dict) -> torch.Tensor:
        seed = batch.get("dropout_seed")
        if "uniq_tokens" in batch:
            art = self.encode_news(batch["uniq_tokens"], batch.get("art_n_uniq"), seed)
            hist_vecs, cand_vecs = _dedup_gather(art, batch)
        else:
            hist_vecs, cand_vecs = _encode_both(
                lambda x: self.encode_news(x, seed=seed), batch["hist_tokens"],
                batch["cand_tokens"])
        user = self.encode_user(hist_vecs)
        return torch.einsum("bkd,bd->bk", cand_vecs, user)

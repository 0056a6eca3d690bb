"""NRMS (Wu et al., EMNLP 2019) as an ``nn.Module``; counterpart of
``NRMS`` in ``ebnerd_tpu/models/newsrec.py``.

One module scores K candidates at once and returns raw logits [B, K].
``use_fused_encoder=True`` routes both towers through the fused news
encoder (``ops/news_encoder.py``: the Hopper kernel on CUDA tensors);
the unfused path runs ``SelfAttention`` + ``AdditiveAttention``. Both
paths share one parameter tree, so ``bridge.py`` loads the same JAX
weights into either.

Batch dict (tensors on the model's device):
  hist_tokens  int [B, H, T]
  cand_tokens  int [B, K, T]
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .. import resolve_device
from ..ops.news_encoder import PackedWeights, fused_news_encoder, pack_weights
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


class NRMS(nn.Module):
    """NRMS in eval mode (dropout is identity; training is a later slice).

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

    def _fused(self, x: torch.Tensor, tower: str, n_valid: Optional[int] = None) -> torch.Tensor:
        # bf16 models keep x in bf16 and run the kernel at bf16 with fp32
        # accumulation; fp32 models keep full fp32 numerics
        compute = torch.bfloat16 if self.dtype == torch.bfloat16 else torch.float32
        packed = self.packed_weights(tower, compute) if x.device.type == "cuda" else None
        out = fused_news_encoder(
            x.to(compute), *self._tower_weights(tower), num_heads=self.hparams.head_num,
            compute_dtype=compute, n_valid=n_valid, packed=packed)
        return out.to(self.dtype)

    def encode_news(self, tokens: torch.Tensor, n_valid: Optional[int] = None) -> torch.Tensor:
        """tokens [N, T] -> news vectors [N, head_num*head_dim]."""
        x = self.word_embedding(tokens)
        if self.use_fused_encoder:
            return self._fused(x, "news", n_valid)
        return self.news_pool(self.news_self_att(x, x, x))

    def encode_user(self, hist_vecs: torch.Tensor) -> torch.Tensor:
        """hist_vecs [B, H, D] -> user vector [B, D]. No history mask: a
        padded slot carries the padding article's vector, as in the JAX
        model."""
        if self.use_fused_encoder:
            return self._fused(hist_vecs, "user")
        return self.user_pool(self.user_self_att(hist_vecs, hist_vecs, hist_vecs))

    def forward(self, batch: dict) -> torch.Tensor:
        if "uniq_tokens" in batch:
            raise NotImplementedError(
                "the unique-article (dedup) batch path is not ported yet (ROADMAP A3)")
        hist_vecs, cand_vecs = _encode_both(
            self.encode_news, batch["hist_tokens"], batch["cand_tokens"])
        user = self.encode_user(hist_vecs)
        return torch.einsum("bkd,bd->bk", cand_vecs, user)

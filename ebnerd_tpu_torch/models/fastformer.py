"""Fastformer (Wu et al. 2021, "Fastformer: Additive Attention Can Be All
You Need") and the original text classifier ``FastformerWu`` as
``nn.Module``s; counterparts of ``ebnerd_tpu/models/fastformer.py``.

The same conventions as the JAX modules: LayerNorm with epsilon 1e-12,
exact erf gelu, a -1e4 additive mask bias made in the compute dtype,
normal(0.02) initialisation with zero biases (the pooling layers keep
``AdditiveAttention``'s Glorot), LayerNorm scale 1 and bias 0. In bf16 the
Dense layers compute in bf16 and every LayerNorm returns fp32 (flax's
``LayerNorm`` with ``dtype=None`` promotes to its fp32 parameters), so the
embedding's dropout sees fp32 and the layers' ``att_out``/``ffn_out``
dropouts see bf16.

``Fastformer`` adds the position-0 embedding to every token (each article
is one position of the history axis); ``FastformerWu`` adds per-token
positions. ``Fastformer``'s dropout sites are streams 0 (embedding) and
1 + 2i (``att_out``), 2 + 2i (``ffn_out``) of layer i, on the
seed-recompute kernel with ``prng_dropout=True``; ``FastformerWu`` takes
generator-seeded masks, as its JAX module passes no ``prng_dropout``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from .config import HParamsFastformer
from .layers import AdditiveAttention, Dense, Embed, PrngDropout, WordEmbed
from .newsrec import _dedup_gather, _encode_both, _seed_of

__all__ = ["Fastformer", "FastformerWu", "FastSelfAttention", "FastformerLayer", "LayerNorm"]

_STD = 0.02


def _normal_dense(din: int, dout: int, dtype, device, generator) -> Dense:
    dense = Dense(din, dout, dtype, device, generator)
    with torch.no_grad():
        dense.weight.normal_(0.0, _STD, generator=generator)
    return dense


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` (``scale``, ``bias``, epsilon 1e-12 as the JAX
    modules set it) over the last axis, computed in fp32 and returned in
    fp32."""

    def __init__(self, features: int, device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.to(torch.float32), self.scale.shape, self.scale, self.bias, 1e-12)


class FastSelfAttention(nn.Module):
    """Additive linear-complexity attention over x [B, L, D] with an
    additive mask bias [B, L]: a softmax-pooled global query per head, the
    keys scaled by it, a softmax-pooled global key, its product with each
    query through ``transform``, plus the query (residual)."""

    def __init__(self, din: int, num_heads: int, head_dim: int, dtype, device, generator=None):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, head_dim
        # 1 / sqrt(head_dim) as the JAX module computes it, in the compute dtype
        self.scale = float(1.0 / torch.sqrt(torch.tensor(float(head_dim), dtype=dtype)))
        d = num_heads * head_dim
        for name, i, o in (("query", din, d), ("key", din, d), ("query_att", d, num_heads),
                           ("key_att", d, num_heads), ("transform", d, d)):
            setattr(self, name, _normal_dense(i, o, dtype, device, generator))

    def forward(self, x: torch.Tensor, mask_bias: torch.Tensor) -> torch.Tensor:
        q, k = self.query(x), self.key(x)                          # [B, L, D]
        scale = self.scale
        heads = lambda y: y.unflatten(-1, (self.num_heads, self.head_dim))
        bias = mask_bias[..., None]
        alpha = torch.softmax(self.query_att(q) * scale + bias, dim=-2)    # [B, L, H]
        pooled_q = torch.einsum("blh,blhd->bhd", alpha, heads(q))
        p = heads(k) * pooled_q[:, None]                                    # [B, L, H, Dh]
        beta = torch.softmax(self.key_att(p.flatten(-2)) * scale + bias, dim=-2)
        pooled_k = torch.einsum("blh,blhd->bhd", beta, p)
        return self.transform((pooled_k[:, None] * heads(q)).flatten(-2)) + q


class _SelfOutput(nn.Module):
    """Dense -> dropout -> LayerNorm(+ residual)."""

    def __init__(self, din: int, dim: int, rate: float, dtype, device, generator=None,
                 use_kernel: bool = False):
        super().__init__()
        self.dense = _normal_dense(din, dim, dtype, device, generator)
        self.drop = PrngDropout(rate, use_kernel=use_kernel)
        self.norm = LayerNorm(dim, device)

    def forward(self, x, residual, seed, stream):
        return self.norm(self.drop(self.dense(x), seed, stream) + residual)


class FastformerLayer(nn.Module):
    """FastSelfAttention -> att_out -> intermediate (exact gelu) -> ffn_out.
    ``stream`` is the dropout stream of ``att_out``; ``ffn_out`` takes the
    next one."""

    def __init__(self, num_heads: int, head_dim: int, intermediate_dim: int, rate: float,
                 dtype, device, generator=None, use_kernel: bool = False):
        super().__init__()
        d = num_heads * head_dim
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.attention = FastSelfAttention(d, num_heads, head_dim, **kw)
        self.att_out = _SelfOutput(d, d, rate, use_kernel=use_kernel, **kw)
        self.intermediate = _normal_dense(d, intermediate_dim, **kw)
        self.ffn_out = _SelfOutput(intermediate_dim, d, rate, use_kernel=use_kernel, **kw)

    def forward(self, x, mask_bias, seed=None, stream: int = 1):
        att = self.att_out(self.attention(x, mask_bias), x, seed, stream)
        inter = F.gelu(self.intermediate(att), approximate="none")
        return self.ffn_out(inter, att, seed, stream + 1)


class _Encoder(nn.Module):
    """Embedding -> transform -> + position embedding -> LayerNorm ->
    dropout -> layers -> additive pooling over tokens, shared by both
    modules."""

    def __init__(self, hp: HParamsFastformer, vocab_size: int, word_emb_dim: Optional[int],
                 dtype, device, seed: int, use_kernel: bool, word_emb_init=None):
        super().__init__()
        self.device = resolve_device(device)
        self.hparams, self.dtype = hp, dtype
        head_dim = hp.embedding_dim // hp.n_heads
        if head_dim * hp.n_heads != hp.embedding_dim:
            raise ValueError(
                f"embedding_dim {hp.embedding_dim} not divisible by n_heads {hp.n_heads}")
        gen = torch.Generator(device=self.device).manual_seed(seed)
        kw = dict(dtype=dtype, device=self.device, generator=gen)
        d = hp.embedding_dim
        emb_dim = word_emb_dim or d
        self.word_embedding = WordEmbed(vocab_size, emb_dim, **kw)
        self.position_embedding = Embed(hp.max_position, d, self.device, gen)
        with torch.no_grad():
            self.word_embedding.embedding.normal_(0.0, _STD, generator=gen)
            self.position_embedding.embedding.normal_(0.0, _STD, generator=gen)
        if word_emb_init is not None:
            self.word_embedding.load_(word_emb_init)
        self.embedding_transform = _normal_dense(emb_dim, d, **kw)
        self.emb_norm = LayerNorm(d, self.device)
        self.emb_drop = PrngDropout(hp.dropout, use_kernel=use_kernel)
        self.layers = nn.ModuleList(
            FastformerLayer(hp.n_heads, head_dim, hp.intermediate_dim, hp.dropout,
                            use_kernel=use_kernel, **kw) for _ in range(hp.n_layers))
        self.token_pool = AdditiveAttention(d, d, **kw)

    def _encode(self, tokens: torch.Tensor, pos: torch.Tensor, seed,
                rows: Optional[torch.Tensor] = None) -> torch.Tensor:
        token_mask = (tokens != 0).to(self.dtype)
        # -1e4 rounded to the compute dtype, as the JAX module makes it
        mask_bias = (1.0 - token_mask) * float(torch.tensor(-1e4, dtype=self.dtype))
        x = self.embedding_transform(self.word_embedding(tokens, rows))
        x = self.emb_drop(self.emb_norm(x + pos.to(x.dtype)), seed, 0)
        for i, layer in enumerate(self.layers):
            x = layer(x, mask_bias, seed, 1 + 2 * i)
        return self.token_pool(x, mask=token_mask)


class Fastformer(_Encoder):
    """History/candidate Fastformer scorer: [B, K] logits from the concat
    MLP head ``output_layer`` over [user, candidate]. The user vector is
    ``user_pool`` over the history's article vectors, masked by
    ``(hist_tokens != 0).any(-1)`` (on the dedup path, gathered from the
    unique axis).

    Batch: per slot ``hist_tokens`` [B, H, T], ``cand_tokens`` [B, K, T], or
    deduped ``uniq_tokens`` [C, T] with ``hist_slot``/``cand_slot``."""

    def __init__(self, hparams: HParamsFastformer, vocab_size: int = 32000,
                 word_emb_dim: Optional[int] = None, dtype: torch.dtype = torch.float32,
                 prng_dropout: bool = False, device="cuda", seed: int = 0, word_emb_init=None):
        super().__init__(hparams, vocab_size, word_emb_dim, dtype, device, seed, prng_dropout,
                         word_emb_init)
        d = hparams.embedding_dim
        gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        kw = dict(dtype=dtype, device=self.device, generator=gen)
        self.user_pool = AdditiveAttention(d, d, **kw)
        self.output_layer = _normal_dense(2 * d, 1, **kw)
        self.eval()

    def encode_articles(self, tokens: torch.Tensor, seed: Optional[int] = None,
                        rows: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens [N, T] -> article vectors [N, D] (position 0 on every token;
        ``rows``: the row-sparse mode's compact word rows, ``WordEmbed``)."""
        return self._encode(tokens, self.position_embedding.embedding[0], seed, rows)

    def score(self, hist_vecs: torch.Tensor, hist_mask: torch.Tensor,
              cand_vecs: torch.Tensor) -> torch.Tensor:
        """The user tower and the head: [B, H, D], [B, H], [B, K, D] -> [B, K]."""
        user = self.user_pool(hist_vecs, mask=hist_mask)
        concat = torch.cat([user[:, None].expand_as(cand_vecs), cand_vecs], dim=-1)
        return self.output_layer(concat)[..., 0]

    def forward(self, batch: dict) -> torch.Tensor:
        seed, rows = _seed_of(self, batch), batch.get("emb_rows")
        if "uniq_tokens" in batch:
            uniq = batch["uniq_tokens"]
            hist_vecs, cand_vecs = _dedup_gather(self.encode_articles(uniq, seed, rows), batch)
            hist_mask = (uniq != 0).any(-1)[batch["hist_slot"]]
        else:
            hist_vecs, cand_vecs = _encode_both(lambda x: self.encode_articles(x, seed, rows),
                                                batch["hist_tokens"], batch["cand_tokens"])
            hist_mask = (batch["hist_tokens"] != 0).any(-1)
        return self.score(hist_vecs, hist_mask.to(self.dtype), cand_vecs)


class FastformerWu(_Encoder):
    """The original Fastformer text classifier: token ids [B, L] -> class
    logits [B, n_classes], per-token position embeddings, generator-seeded
    dropout. ``loss_and_logits`` returns (mean softmax cross-entropy
    against integer targets, logits)."""

    def __init__(self, hparams: HParamsFastformer, vocab_size: int = 32000,
                 word_emb_dim: Optional[int] = None, n_classes: int = 4,
                 dtype: torch.dtype = torch.float32, device="cuda", seed: int = 0,
                 word_emb_init=None):
        super().__init__(hparams, vocab_size, word_emb_dim, dtype, device, seed, False,
                         word_emb_init)
        gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.output_layer = _normal_dense(hparams.embedding_dim, n_classes, dtype, self.device,
                                          gen)
        self.eval()

    def forward(self, input_ids: torch.Tensor, dropout_seed: Optional[int] = None) -> torch.Tensor:
        seed = _seed_of(self, {"dropout_seed": dropout_seed})
        pos = self.position_embedding.embedding[: input_ids.shape[1]][None]
        return self.output_layer(self._encode(input_ids, pos, seed))

    def loss_and_logits(self, input_ids: torch.Tensor, targets: torch.Tensor,
                        dropout_seed: Optional[int] = None):
        logits = self(input_ids, dropout_seed)
        logp = torch.log_softmax(logits, dim=-1)
        return -logp.gather(-1, targets[:, None].long()).mean(), logits


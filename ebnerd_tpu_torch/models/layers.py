"""NRMS layers as ``nn.Module``s (counterparts of ``WordEmbed``,
``AdditiveAttention`` and ``SelfAttention`` in ``ebnerd_tpu/models/layers.py``).

Weights are fp32 parameters; ``dtype`` is the compute dtype the inputs
and weights are cast to, as the flax modules do. Linear maps keep
``nn.Linear``'s [out, in] layout (``bridge.py`` transposes the JAX
[in, out] kernels).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["WordEmbed", "AdditiveAttention", "SelfAttention", "glorot_"]


def glorot_(w: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """In-place Glorot-uniform init of a [fan_out, fan_in] weight (the JAX
    package's ``glorot_uniform``; same distribution, different stream)."""
    fan_out, fan_in = w.shape
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        return w.uniform_(-bound, bound, generator=generator)


class WordEmbed(nn.Module):
    """Dense word-embedding table [V, E] (fp32). Gathers the token rows and
    casts only them to ``dtype``: the same values as casting the whole
    table first, without a full-table cast per call. The gather is
    ``F.embedding``, whose backward sums duplicate tokens by sort and
    segment reduction in fp32 (the backward of ``table[tokens]`` serialises
    the duplicates of Zipf-skewed tokens: 58 ms of a 250 ms H100 step)."""

    def __init__(self, num_embeddings: int, features: int, dtype: torch.dtype,
                 device: torch.device, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.empty(num_embeddings, features, device=device))
        glorot_(self.embedding, generator)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return F.embedding(tokens, self.embedding).to(self.dtype)


class AdditiveAttention(nn.Module):
    """Additive attention pooling over the second-to-last axis:
    [..., L, D] -> [..., D]. ``W`` holds W and b, ``q`` the query vector."""

    def __init__(self, din: int, dim: int, dtype: torch.dtype, device: torch.device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.W = nn.Linear(din, dim, bias=True, device=device)
        self.q = nn.Linear(dim, 1, bias=False, device=device)
        glorot_(self.W.weight, generator)
        nn.init.zeros_(self.W.bias)
        glorot_(self.q.weight, generator)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        dt = self.dtype
        att = torch.tanh(x.to(dt) @ self.W.weight.to(dt).T + self.W.bias.to(dt))
        att = (att @ self.q.weight.to(dt).T)[..., 0]
        att = att - att.max(dim=-1, keepdim=True).values.detach()
        expo = torch.exp(att)
        if mask is not None:
            expo = expo * mask.to(expo.dtype)
        weight = expo / (expo.sum(dim=-1, keepdim=True) + 1e-8)
        return (x * weight[..., None].to(x.dtype)).sum(dim=-2)


class SelfAttention(nn.Module):
    """Multi-head attention with NRMS conventions: no projection biases, no
    output projection, scale 1/sqrt(head_dim), optional -1e12 key mask.
    ``transposed=True`` applies the transposed softmax weights (the
    reference layer's adjoint quirk, see the JAX ``SelfAttention``)."""

    def __init__(self, din: int, num_heads: int, head_dim: int, dtype: torch.dtype,
                 device: torch.device, generator: Optional[torch.Generator] = None,
                 transposed: bool = False):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, head_dim
        self.dtype = dtype
        self.transposed = transposed
        d = num_heads * head_dim
        self.WQ = nn.Linear(din, d, bias=False, device=device)
        self.WK = nn.Linear(din, d, bias=False, device=device)
        self.WV = nn.Linear(din, d, bias=False, device=device)
        for lin in (self.WQ, self.WK, self.WV):
            glorot_(lin.weight, generator)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        dt = self.dtype

        def proj(lin, x):
            y = x.to(dt) @ lin.weight.to(dt).T
            return y.reshape(*y.shape[:-1], self.num_heads, self.head_dim)

        qh, kh, vh = proj(self.WQ, q), proj(self.WK, k), proj(self.WV, v)
        logits = torch.einsum("...qhd,...khd->...hqk", qh, kh) / math.sqrt(self.head_dim)
        if key_mask is not None:
            neg = torch.tensor(-1e12, dtype=logits.dtype, device=logits.device)
            logits = torch.where(key_mask[..., None, None, :].bool(), logits, neg)
        weights = torch.softmax(logits, dim=-1)
        if self.transposed:
            out = torch.einsum("...hqk,...qhd->...khd", weights, vh)
        else:
            out = torch.einsum("...hqk,...khd->...qhd", weights, vh)
        return out.reshape(*out.shape[:-2], self.num_heads * self.head_dim)

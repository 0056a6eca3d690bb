"""Model layers as ``nn.Module``s (counterparts of ``WordEmbed``,
``AdditiveAttention``, ``SelfAttention``, ``PersonalizedAttentivePooling``,
``WeightedBatchNorm``, ``PrngDropout``, ``ConvEncoder``, ``MaskedGRU`` and
flax's ``Dense`` and ``Embed`` as the JAX package uses them,
``ebnerd_tpu/models/layers.py``).

Weights are fp32 parameters; ``dtype`` is the compute dtype the inputs
and weights are cast to, as the flax modules do. Linear maps keep
``nn.Linear``'s [out, in] layout and convolutions ``Conv1d``'s
[out, in, window] (``bridge.py`` transposes the JAX [in, out] and
[window, in, out] kernels).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dropout import prng_dropout

__all__ = ["WordEmbed", "AdditiveAttention", "SelfAttention", "PersonalizedAttentivePooling",
           "WeightedBatchNorm", "PrngDropout", "ConvEncoder", "MaskedGRU", "Dense", "Embed",
           "glorot_", "fold_seed", "draw_seed", "generator_dropout"]


def glorot_(w: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """In-place Glorot-uniform init of a [fan_out, fan_in] weight (the JAX
    package's ``glorot_uniform``; same distribution, different stream)."""
    fan_out, fan_in = w.shape
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        return w.uniform_(-bound, bound, generator=generator)


def fold_seed(seed: int) -> int:
    """The 64-bit seed for a ``torch.Generator``: the CPU generator keeps
    only the low 32 bits, so the high word is mixed into them."""
    hi = seed >> 32
    return seed ^ ((hi * 0x9E3779B9) & 0xFFFFFFFF)


def draw_seed() -> int:
    """A 64-bit dropout seed from torch's global generator."""
    lo, hi = torch.randint(0, 1 << 32, (2,)).tolist()
    return (hi << 32) | lo


def generator_dropout(x: torch.Tensor, keep: float, gen: torch.Generator) -> torch.Tensor:
    """Inverted dropout with a mask drawn from ``gen`` (flax's
    ``where(mask, x / keep, 0)``)."""
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class PrngDropout(nn.Module):
    """Dropout at one rate for the call sites of a model (flax's
    ``PrngDropout`` / ``nn.Dropout`` in the conv families). Each call names
    the step's 64-bit ``seed`` and the site's ``stream``; ``row0`` is the
    global row of x[0] when a caller encodes a tensor in chunks of rows, so
    the chunks get the masks of the whole.

    ``use_kernel=True``: ``ops.dropout.prng_dropout``, the seed-recompute
    kernel on CUDA tensors (its plain version on the CPU), masks regenerated
    in the backward. ``use_kernel=False``: a mask from a ``torch.Generator``
    seeded with (seed, stream, row0), kept by autograd. A seed that is a
    tensor (the trainer's ``scan_steps`` path, whose steps a CUDA graph
    replays) always takes the kernel: a generator would need its seed on
    the host. Identity in eval mode and at rate 0."""

    def __init__(self, rate: float, use_kernel: bool = True):
        super().__init__()
        self.rate = rate
        self.use_kernel = use_kernel

    def forward(self, x: torch.Tensor, seed, stream: int, row0: int = 0) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        if self.use_kernel or isinstance(seed, torch.Tensor):
            return prng_dropout(x, seed, stream, keep, offset=row0 * x[0].numel())
        mixed = (seed ^ (stream * 0x9E3779B97F4A7C15) ^ (row0 * 0xBF58476D1CE4E5B9)) & ((1 << 64) - 1)
        gen = torch.Generator(device=x.device).manual_seed(fold_seed(mixed))
        return generator_dropout(x, keep, gen)


class Dense(nn.Linear):
    """flax ``nn.Dense`` with a compute dtype: x and the fp32 weight and
    bias are cast to ``dtype``. Glorot-uniform weight, zero bias."""

    def __init__(self, din: int, dout: int, dtype: torch.dtype, device: torch.device,
                 generator: Optional[torch.Generator] = None):
        super().__init__(din, dout, bias=True, device=device)
        self.dtype = dtype
        glorot_(self.weight, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class Embed(nn.Module):
    """flax ``nn.Embed`` (the user and category tables): an fp32 table
    [num, features], gathered in fp32. ``zero=True`` starts it at zeros
    (LSTUR's user embedding), else normal with std 1/sqrt(features), flax's
    default scale."""

    def __init__(self, num: int, features: int, device: torch.device,
                 generator: Optional[torch.Generator] = None, zero: bool = False):
        super().__init__()
        self.embedding = nn.Parameter(torch.zeros(num, features, device=device))
        if not zero:
            with torch.no_grad():
                self.embedding.normal_(0.0, 1.0 / math.sqrt(features), generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.embedding)


class WordEmbed(nn.Module):
    """Dense word-embedding table [V, E] (fp32). Gathers the token rows and
    casts only them to ``dtype``: the same values as casting the whole
    table first, without a full-table cast per call. The gather is
    ``F.embedding``, whose backward sums duplicate tokens by sort and
    segment reduction in fp32 (the backward of ``table[tokens]`` serialises
    the duplicates of Zipf-skewed tokens: 58 ms of a 250 ms H100 step).

    ``rows`` (the row-sparse mode, ``training/sparse_embed.py``; the JAX
    module's ``emb_over`` collection) is a compact [C, E] slice of the
    table: the tokens are then slots into it, and the [V, E] parameter is
    not read. It is passed per call, never kept."""

    def __init__(self, num_embeddings: int, features: int, dtype: torch.dtype,
                 device: torch.device, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.empty(num_embeddings, features, device=device))
        glorot_(self.embedding, generator)

    def forward(self, tokens: torch.Tensor, rows: Optional[torch.Tensor] = None) -> torch.Tensor:
        return F.embedding(tokens, self.embedding if rows is None else rows).to(self.dtype)

    def load_(self, matrix) -> None:
        """Copy a pretrained [V, E] matrix (numpy or a tensor) into the table,
        cast to its fp32, as the JAX modules' ``word_emb_init``
        (``embedding_initializer``) loads one; raises on another shape."""
        m = matrix if isinstance(matrix, torch.Tensor) else torch.from_numpy(np.asarray(matrix))
        if tuple(m.shape) != tuple(self.embedding.shape):
            raise ValueError(f"embedding shape {tuple(self.embedding.shape)} != matrix "
                             f"{tuple(m.shape)}")
        with torch.no_grad():
            self.embedding.copy_(m.to(torch.float32))


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


class PersonalizedAttentivePooling(nn.Module):
    """Query-conditioned attention pooling (NPA's): values [..., L, D] and a
    query [..., A] -> [..., D]. Dropout on the values (``drop_values``), a
    tanh projection of them (``project``, ``att_proj``: per position, so it
    commutes with slot gathers), then the query dot, a softmax over L and
    the weighted sum of the dropped values (``pool``). The three are
    separate because NPA's dedup path runs the first two per unique article
    and only ``pool`` per slot. ``pool`` broadcasts the query over the
    leading axes it lacks (a [B, 1, A] query pools [B, N, L, D] values)."""

    def __init__(self, din: int, attention_dim: int, rate: float, dtype: torch.dtype,
                 device: torch.device, generator: Optional[torch.Generator] = None,
                 use_kernel: bool = False):
        super().__init__()
        self.att_proj = Dense(din, attention_dim, dtype, device, generator)
        self.value_drop = PrngDropout(rate, use_kernel=use_kernel)

    def drop_values(self, values: torch.Tensor, seed: int, stream: int) -> torch.Tensor:
        return self.value_drop(values, seed, stream)

    def project(self, values_dropped: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.att_proj(values_dropped))

    @staticmethod
    def pool(values_dropped: torch.Tensor, proj: torch.Tensor,
             query: torch.Tensor) -> torch.Tensor:
        att = (proj @ query.to(proj.dtype)[..., :, None])[..., 0]
        weight = torch.softmax(att, dim=-1)
        return (values_dropped * weight[..., None].to(values_dropped.dtype)).sum(dim=-2)

    def forward(self, values: torch.Tensor, query: torch.Tensor, seed: int,
                stream: int) -> torch.Tensor:
        vd = self.drop_values(values, seed, stream)
        return self.pool(vd, self.project(vd), query)


class WeightedBatchNorm(nn.Module):
    """BatchNorm over every axis but the last, whose training-mode moments
    weight each leading-axis row (the JAX ``WeightedBatchNorm``): with
    ``weights`` [N], mean = sum w x / (sum w * prod(inner dims)) and the
    biased var = E_w[x**2] - mean**2; without, the plain batch moments. The
    dedup path passes each unique article's slot count, which reproduces
    the per-slot moments exactly, and pad rows weigh 0. The running stats
    (buffers ``mean`` and ``var``) follow ra = m * ra + (1 - m) * batch,
    m = 0.99, in every training call; eval mode normalises by them.
    Computes in fp32 and returns fp32. ``torch.nn.BatchNorm1d`` keeps the
    unbiased variance and takes no row weights.

    ``sum_moments``, when set (the trainer sets it for a step on the
    per-slot path under a mesh), sums [sum w x, sum w x**2, sum w * inner]
    over the processes, differentiably, so the moments are the global
    batch's, as they are under JAX's GSPMD."""

    sum_moments = None

    MOMENTUM = 0.99  # flax's
    EPSILON = 1e-3  # Keras BatchNormalization's, as the JAX stack sets it

    def __init__(self, features: int, device: torch.device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor, weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        xf = x.to(torch.float32)
        if not self.training:
            mean, var = self.mean, self.var
        else:
            red = tuple(range(x.dim() - 1))
            if self.sum_moments is not None:
                mean, var = self._summed_moments(xf, weights, red)
            elif weights is None:
                mean = xf.mean(red)
                var = xf.square().mean(red) - mean.square()
            else:
                w = weights.to(torch.float32).reshape(-1, *([1] * (x.dim() - 1)))
                denom = w.sum() * float(math.prod(x.shape[1:-1]))
                mean = (xf * w).sum(red) / denom
                var = (xf.square() * w).sum(red) / denom - mean.square()
            m = self.MOMENTUM
            with torch.no_grad():
                self.mean.copy_(m * self.mean + (1.0 - m) * mean)
                self.var.copy_(m * self.var + (1.0 - m) * var)
        return (xf - mean) * torch.rsqrt(var + self.EPSILON) * self.scale + self.bias

    def _summed_moments(self, xf: torch.Tensor, weights: Optional[torch.Tensor], red: tuple):
        """(mean, biased var) from the row-weighted sums of every process."""
        inner = float(math.prod(xf.shape[1:-1]))
        if weights is None:
            s1, s2 = xf.sum(red), xf.square().sum(red)
            count = torch.full((1,), inner * xf.shape[0], dtype=torch.float32, device=xf.device)
        else:
            w = weights.to(torch.float32).reshape(-1, *([1] * (xf.dim() - 1)))
            s1, s2 = (xf * w).sum(red), (xf.square() * w).sum(red)
            count = (w.sum() * inner).reshape(1)
        tot = self.sum_moments(torch.cat([s1, s2, count]))
        f = xf.shape[-1]
        mean = tot[:f] / tot[-1]
        return mean, tot[f:2 * f] / tot[-1] - mean.square()


class ConvEncoder(nn.Module):
    """1-D convolution over tokens with SAME padding and relu: x [N, L, C]
    -> [N, L, filters]. ``weight`` is [filters, C, window] (flax keeps
    [window, C, filters]); SAME pads (window - 1) // 2 on the left and the
    rest on the right, as flax does. The convolution is PyTorch's
    ``conv2d`` in ``dtype`` over x as it lies: [N, L, C] is the
    channels-last layout of [N, C, 1, L], so cuDNN converts no layout and
    the output is [N, L, filters] contiguous. It pads both sides by the
    right-hand amount and, for an even window, drops the one extra leading
    position."""

    def __init__(self, cin: int, filters: int, window: int, dtype: torch.dtype,
                 device: torch.device, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(filters, cin, window, device=device))
        self.bias = nn.Parameter(torch.zeros(filters, device=device))
        bound = math.sqrt(6.0 / ((cin + filters) * window))  # Glorot over [window, C, filters]
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        w = self.weight.shape[-1]
        left = (w - 1) // 2
        right = w - 1 - left
        x4 = x.to(dt).transpose(1, 2).unsqueeze(2)  # [N, C, 1, L], channels-last strides
        k4 = self.weight.to(dt).unsqueeze(2).contiguous(memory_format=torch.channels_last)
        y = F.conv2d(x4, k4, self.bias.to(dt), padding=(0, right))[..., right - left:]
        return F.relu(y.squeeze(2).transpose(1, 2))


class MaskedGRU(nn.Module):
    """GRU over x [B, L, D] with per-step masking: steps where mask == 0
    keep the state. Returns the final state.

    The cell is flax's ``GRUCell`` with its exact parameters: ``ir``,
    ``iz``, ``in_`` (flax ``in``) map the input with a bias, ``hr`` and
    ``hz`` the state without one, ``hn`` with one;
    r = sig(ir x + hr h), z = sig(iz x + hz h), n = tanh(in x + r * hn h),
    h' = (1 - z) n + z h. As in the JAX model the cell computes in fp32 and
    casts the new state back to the caller's state dtype each step. The
    input maps of all steps run as one matmul; its per-step gate inputs
    come from ``unbind`` and ``split``, whose backward is one stack and a
    cat per step (a slice of it would fill and add a gradient of the full
    [B, L, 3U] per gate and step)."""

    def __init__(self, din: int, units: int, device: torch.device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.units = units
        for name, n_in, bias in (("ir", din, True), ("iz", din, True), ("in_", din, True),
                                 ("hr", units, False), ("hz", units, False), ("hn", units, True)):
            lin = nn.Linear(n_in, units, bias=bias, device=device)
            glorot_(lin.weight, generator)
            if bias:
                nn.init.zeros_(lin.bias)
            setattr(self, name, lin)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                initial_state: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, steps, _ = x.shape
        u = self.units
        h = (torch.zeros(b, u, dtype=x.dtype, device=x.device) if initial_state is None
             else initial_state)
        w_i = torch.cat([self.ir.weight, self.iz.weight, self.in_.weight])
        b_i = torch.cat([self.ir.bias, self.iz.bias, self.in_.bias])
        xi = F.linear(x.to(torch.float32), w_i, b_i).unbind(1)    # L x [B, 3U]
        w_h = torch.cat([self.hr.weight, self.hz.weight, self.hn.weight])
        keep = mask.bool().unbind(1)
        for t in range(steps):
            hf = h.to(torch.float32)
            h_r, h_z, h_n = (hf @ w_h.T).split(u, dim=-1)
            x_r, x_z, x_n = xi[t].split(u, dim=-1)
            r = torch.sigmoid(x_r + h_r)
            z = torch.sigmoid(x_z + h_z)
            n = torch.tanh(x_n + r * (h_n + self.hn.bias))
            new = ((1.0 - z) * n + z * hf).to(h.dtype)
            h = torch.where(keep[t][:, None], new, h)
        return h

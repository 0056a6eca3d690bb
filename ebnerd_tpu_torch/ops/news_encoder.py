"""Fused NRMS news encoder: the Hopper kernels' wrappers and their plain versions.

``fused_news_encoder`` is the port of the Pallas TPU kernel
``ebnerd_tpu/ops/news_encoder.py:fused_news_encoder`` (its forward, with
the dropout branches). Per article it computes the packed QKV projection,
multi-head self-attention (no biases, no output projection, scale
1/sqrt(head_dim), softmax per head) and additive pooling
``softmax_t(tanh(oW+b)·q)`` (max-subtracted, +1e-8) followed by the
weighted sum over t. Dropout comes either from ``rng_seed`` (a 64-bit
seed: the Philox masks of ``ops/philox.py``, stream 0 on x with
``emb_keep_prob``, stream 1 on the attention output with ``keep_prob``) or
from an external 0/1 ``drop_mask`` [N, T, D] with ``keep_prob``.

``fused_news_encoder_bwd`` is the port of the recompute backward
``_news_encoder_bwd`` (``csrc/news_encoder_bwd.cu``: a per-block kernel,
a wgmma GEMM for dx and the weight gradients, and a fixed-order
reduction). ``news_encoder`` is the differentiable entry point: on CUDA a
``torch.autograd.Function`` whose forward launches K1 and whose backward
launches K2; on the CPU autograd of the plain version.

``rng_seed`` and ``n_valid`` may be device tensors (a one-element int64
seed, a one-element int32 count on x's device): the kernels then read them
from device memory at run time, so one CUDA graph replays a step for any
seed and any valid count of its bucket (``training/trainer.py``'s
``scan_steps``). With a device ``n_valid`` every launch takes the bucket's
geometry (N articles: the grids, the GEMMs' row slices and the reductions'
rows), the kernels skip the blocks and rows past the count they read, and
the blocks past it write zero partials (``csrc/news_encoder_bwd.cu``);
articles at or past it still come out as zeros with zero gradients. A
host ``n_valid`` keeps the launches and bits it always had.

The kernels read rows of x with 16-byte vector loads and TMA, so they take
a Din that is a multiple of 8 in bf16 (4 in fp32). Any other Din is padded
on the kernel side only: ``pack_weights`` gives Wqkv zero rows and
``kernel_input`` gives x zero columns up to that multiple, and the
backward drops the pad columns of dx and the pad rows of dWqkv. No
parameter changes shape. The stream-0 mask is keyed by (row, column
group), not by the row's width, so padding leaves the mask of the first
Din columns as it is.

In bf16 with the Philox embedding mask, the mask is drawn once per call
of ``news_encoder`` (``kernel_input``: K2's mask kernel gives round(x *
mask) and one keep bit per element): K1 and K2's per-block kernel read
the masked x, the dWqkv product reads it, dx takes the keep bits, and the
function keeps them for its backward instead of x.

Each call takes one of three routes (``route``): the kernels' narrow
instance (T, head width <= 32, padded attention width <= 256), their wide
one (T <= 32 with a head width up to 64 or an attention width up to 512),
or, for every T past 32 and every other shape, and for a layout past a
block's shared memory, the tiled route (``csrc/news_encoder_tiled.cu``):
T1 the QKV projection to device memory, T2 the attention by query tiles,
T3 the pooling per article, forward and backward, T4 the attention backward
per (article, head), then the backward's GEMMs and reductions as on the
other routes. Both wrappers choose the route before any launch, and the
autograd function keeps the forward's choice for its backward.

On a CUDA tensor each wrapper launches its kernel (see the notes in
``csrc/``) or raises; on a CPU tensor it calls the plain version, which the
CPU tests and ``chip_smoke.py`` hold the kernels against.

Layouts follow the JAX package: x [N, T, Din]; wq/wk/wv [Din, D];
w_att [D, A]; b_att [A]; q_att [A, 1]; output [N, D] fp32.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from . import _build, philox

__all__ = ["PackedWeights", "fused_news_encoder", "fused_news_encoder_bwd", "news_encoder",
           "news_encoder_reference", "news_encoder_bwd_reference", "pack_weights", "pack_qkv",
           "unpack_qkv", "bwd_gemm", "bwd_gemm_reference", "gemm_splits", "slice_rows",
           "emb_mask", "emb_mask_reference", "pack_bits", "kernel_input", "qkv_plan",
           "launch_bwd_core", "bwd_core_reference", "padded_din", "check_shape",
           "articles_per_block", "o_width", "route", "panel_layout", "attention_variant",
           "qkv_variant", "pool_variant", "fp32_variant", "tf32_round", "tf32_matmul",
           "tiled_qkv", "tiled_attention", "tiled_pool", "tiled_pool_bwd",
           "tiled_attention_bwd", "tiled_forward", "tiled_bwd_core",
           "tiled_qkv_reference", "tiled_attention_reference", "tiled_pool_reference",
           "tiled_pool_bwd_reference", "tiled_attention_bwd_reference",
           "reduce_rows", "reduce_plan", "NewsEncoderFunction"]

_PANEL = 256         # packed QKV columns per GEMM panel of the kernels
# The shapes each instance of K1 and K2 takes (``route``; csrc/news_encoder_common.cuh):
_NARROW_T = 32       # the narrow instance: T, head width and padded A up to these
_NARROW_HEAD_DIM = 32
_NARROW_ATT_DIM = 256
_MAX_T = 64          # the wide instance: an article within one block of 64 rows
_MAX_HEAD_DIM = 64
_MAX_ATT_DIM = 512   # padded attention width: two pooling chunks of 256 columns
_LOG2E = 1.4426950408889634  # the kernels' softmaxes run in base 2
_BLOCK_ROWS = 64     # rows (tokens) of a block of the forward and the per-block kernel
_SMEM_LIMIT = 232448
_STAGED_T = 128      # T2's and T4's staged kernels: T rounded up to 16 at most this
_POOL_T, _POOL_A = 128, 256  # T3's resident kernel: T rounded up to 16 and a_pad at most these
_GEMM_TILE = (128, 256)  # rows and columns of one bf16 GEMM tile (csrc/news_encoder_bwd.cu)
_GEMM_K_TILE = 64        # rows of a k-tile; a weight-gradient slice is a multiple of it
_SMS = 132               # streaming multiprocessors of an H100 SXM
_QKV_K_TILE = 64         # contraction depth of a k-tile of the bf16 QKV stage
_QKV_STAGES = 3          # its TMA ring's depth where shared memory allows (PERF.md)
# CTAs sharing each weight k-tile by multicast (PERF.md, on an H100): K1
# gains from clusters of 2 at both towers' shapes; K2's per-block kernel,
# whose QKV stage is a smaller share of its time, loses 1-2.5% with them at
# the news tower's and gains nothing at the user tower's
_FWD_CLUSTER = 2
_BWD_CLUSTER = 1
_MAX_SLICES = 64         # weight-gradient slices at most (partials: slices x M x N fp32)
_MIN_SLICE_ROWS = 4096   # rows of a slice at least (64 k-tiles)
_REDUCE_BLOCKS = 2 * _SMS  # blocks the reduction aims for (two per SM)
_REDUCE_MIN_ROWS = 64    # rows of a reduction chunk at least
_TF32_MIN_HEAD_DIM = 8   # fp32 on the tensor cores: a head fills one k-step of a TF32 tile


def _round(t: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """Cast to the compute dtype and back to fp32: the kernel's rounding
    points (bf16 operands, fp32 accumulation; identity in fp32)."""
    return t.to(cdt).to(torch.float32)


class Dropout(NamedTuple):
    """One launch's dropout, as the kernels take it: Philox key (or
    ``seed_dev``, the seed tensor the kernels read it from) and 24-bit
    thresholds (0 = stream off) with their 1/keep, or an external fp32
    0/1 mask [N*T, D] with 1/keep."""
    seed_lo: int = 0
    seed_hi: int = 0
    thr_emb: int = 0
    thr_att: int = 0
    inv_emb: float = 1.0
    inv_att: float = 1.0
    ext_mask: Optional[torch.Tensor] = None
    inv_ext: float = 1.0
    seed_dev: Optional[torch.Tensor] = None


def dropout_config(n: int, t: int, d: int, keep_prob: float = 1.0, emb_keep_prob: float = 1.0,
                   rng_seed=None, drop_mask=None, device=None) -> Dropout:
    """Check the dropout arguments as ``fused_news_encoder`` takes them and
    turn them into the kernels' parameters. ``rng_seed`` with
    ``keep_prob`` / ``emb_keep_prob`` < 1: Philox streams 1 / 0; else
    ``drop_mask`` with ``keep_prob`` < 1; a mask at keep 1 is ignored, as
    in the JAX package."""
    for name, k in (("keep_prob", keep_prob), ("emb_keep_prob", emb_keep_prob)):
        if not 0.0 < k <= 1.0:
            raise ValueError(f"{name} must be in (0, 1], got {k}")
    if rng_seed is not None and (keep_prob < 1.0 or emb_keep_prob < 1.0):
        lo, hi, ptr = philox.kernel_seed(rng_seed, device if device is not None else "cpu")
        return Dropout(lo, hi,
                       philox.threshold(emb_keep_prob) if emb_keep_prob < 1.0 else 0,
                       philox.threshold(keep_prob) if keep_prob < 1.0 else 0,
                       philox.inverse(emb_keep_prob), philox.inverse(keep_prob),
                       seed_dev=None if ptr is None else rng_seed)
    if emb_keep_prob < 1.0:
        raise ValueError("emb_keep_prob < 1 needs rng_seed (the embedding mask is in-kernel only)")
    if keep_prob < 1.0:
        if drop_mask is None:
            raise ValueError("keep_prob < 1 needs drop_mask or rng_seed")
        if tuple(drop_mask.shape) != (n, t, d):
            raise ValueError(f"drop_mask must be [{n}, {t}, {d}], got {tuple(drop_mask.shape)}")
        ext = drop_mask.detach().to(device=device, dtype=torch.float32).reshape(n * t, d)
        return Dropout(ext_mask=ext.contiguous(), inv_ext=philox.inverse(keep_prob))
    return Dropout()


def tf32_round(v: torch.Tensor) -> torch.Tensor:
    """fp32 ``v`` rounded to TF32 (10 mantissa bits) to nearest, ties away
    from zero, as ``cvt.rna.tf32.f32`` rounds: half a TF32 unit (bit 12)
    added to the magnitude bits of the fp32 pattern, then the 13 low bits
    cleared (sign-magnitude, so the sign bit is untouched)."""
    if v.dtype != torch.float32:
        raise ValueError(f"tf32_round takes fp32, got {v.dtype}")
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _Tf32Matmul(torch.autograd.Function):
    """``tf32_matmul``, whose gradients are products of the same kind (as
    the backward kernel's are)."""

    @staticmethod
    def forward(ctx, a, b, passes):
        ctx.save_for_backward(a, b)
        ctx.passes = passes
        ah, bh = tf32_round(a), tf32_round(b)
        if passes == 1:
            return ah @ bh
        al, bl = tf32_round(a - ah), tf32_round(b - bh)
        return al @ bh + ah @ bl + ah @ bh

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = tf32_matmul(g, b.transpose(-1, -2), ctx.passes).sum_to_size(a.shape)
        db = tf32_matmul(a.transpose(-1, -2), g, ctx.passes).sum_to_size(b.shape)
        return da, db, None


def tf32_matmul(a: torch.Tensor, b: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """Plain version of the fp32 kernels' tensor-core product (``a @ b``,
    fp32, batched as ``@``): ``passes`` 3 is 3xTF32, each operand split into
    hi = ``tf32_round(v)`` and lo = ``tf32_round(v - hi)`` and the product
    lo hi + hi lo + hi hi summed in fp32 (lo lo dropped), within about 1e-6
    of an fp32 product's scale; ``passes`` 1 is one TF32 product, hi hi,
    about 5e-4 relative per operand. Differentiable: the gradients are
    products of the same kind."""
    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    return _Tf32Matmul.apply(a.float(), b.float(), passes)


def news_encoder_reference(x, wq, wk, wv, w_att, b_att, q_att, *, num_heads: int,
                           compute_dtype: torch.dtype = torch.float32,
                           n_valid: Optional[int] = None, keep_prob: float = 1.0,
                           emb_keep_prob: float = 1.0, rng_seed=None,
                           drop_mask=None, tf32_passes: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the kernel (mirrors
    ``ebnerd_tpu/ops/news_encoder.py:news_encoder_reference`` and the TPU
    kernel's dropout), rounding to ``compute_dtype`` where the kernel does:
    x (after its embedding mask) and the weights before the QKV product,
    Q/K/V after it, the attention probabilities before the product with V,
    and o (after its dropout), W_att, tanh(.) and q_att before the pooling
    products. Sums are fp32. Articles at or past ``n_valid`` are zeros.
    Differentiable: autograd of it is the backward's plain version.
    ``tf32_passes`` 3 (or 1) takes the fp32 kernels' tensor-core products
    (``tf32_matmul``) for x Wqkv, Q K^T, P V and o W_att and, through
    autograd, for their gradients; 0, plain fp32 products."""
    n, t, din = x.shape
    d = wq.shape[1]
    hd = d // num_heads
    nv = _n_valid(n, n_valid)
    cdt = compute_dtype
    if tf32_passes and cdt != torch.float32:
        raise ValueError("tf32_passes takes the fp32 compute dtype")
    drop = dropout_config(n, t, d, keep_prob, emb_keep_prob, rng_seed, drop_mask, x.device)
    xf = x[:nv].to(torch.float32)
    if drop.thr_emb:
        xf = xf * philox.mask(rng_seed, philox.STREAM_EMB, nv * t, din, emb_keep_prob,
                              device=x.device).reshape(nv, t, din)
    xf = _round(xf, cdt)

    mm = (lambda u, v: tf32_matmul(u, v, tf32_passes)) if tf32_passes else torch.matmul

    def proj(w):
        return _round(mm(xf, _round(w, cdt)), cdt).reshape(nv, t, num_heads, hd)

    qh, kh, vh = proj(wq), proj(wk), proj(wv)
    scale = 1.0 / math.sqrt(hd)
    if tf32_passes:  # by heads: [nv, heads, t, hd]
        qp, kp, vp = (u.transpose(1, 2) for u in (qh, kh, vh))
        probs = torch.softmax(mm(qp, kp.transpose(-1, -2)) * scale, dim=-1)
        o = mm(probs, vp).transpose(1, 2).reshape(nv, t, d)
    else:
        logits = torch.einsum("nqhd,nkhd->nhqk", qh, kh) * scale
        probs = torch.softmax(logits, dim=-1)
        o = torch.einsum("nhqk,nkhd->nqhd", _round(probs, cdt), vh).reshape(nv, t, d)
    if drop.thr_att:
        o = o * philox.mask(rng_seed, philox.STREAM_ATT, nv * t, d, keep_prob,
                            device=x.device).reshape(nv, t, d)
    elif drop.ext_mask is not None:
        o = o * (drop.ext_mask.reshape(n, t, d)[:nv] * drop.inv_ext)
    att = torch.tanh(mm(_round(o, cdt), _round(w_att, cdt)) + b_att.float())
    att = (_round(att, cdt) @ _round(q_att.reshape(-1, 1), cdt))[..., 0]
    att = att - att.max(dim=-1, keepdim=True).values
    expo = torch.exp(att)
    weight = expo / (expo.sum(dim=-1, keepdim=True) + 1e-8)
    pooled = torch.einsum("ntd,nt->nd", o, weight)
    if nv == n:
        return pooled
    return torch.cat([pooled, pooled.new_zeros(n - nv, d)])


def news_encoder_bwd_reference(x, wq, wk, wv, w_att, b_att, q_att, g, **kw) -> tuple:
    """Plain version of the backward: autograd of ``news_encoder_reference``
    under the cotangent g [N, D]; returns (dx, dwq, dwk, dwv, dw, db, dq)."""
    with torch.enable_grad():
        ins = [v.detach().requires_grad_(True) for v in (x, wq, wk, wv, w_att, b_att, q_att)]
        out = news_encoder_reference(*ins, **kw)
        return torch.autograd.grad(out, ins, g)


def check_shape(*, d: int, num_heads: int, a: int, t: Optional[int] = None) -> None:
    """Raise ValueError, naming the limit, for a shape the kernels do not
    take, called by both wrappers before any launch (``t=None``: the weights
    alone, as ``pack_weights`` checks them). Every T >= 1, head width,
    attention width and Din has a route (``route``): what is left is that
    the heads split D."""
    if d % num_heads:
        raise ValueError(f"d={d} not divisible by num_heads={num_heads}")
    if t is not None and t < 1:
        raise ValueError(f"the kernels take T >= 1; got T={t}")


def route(t: int, head_dim: int, a_pad: int, smem: int = 0, instance: bool = False) -> str:
    """The kernels' route for articles of T tokens, heads ``head_dim`` wide
    and a padded attention width ``a_pad``: ``"narrow"`` (K1 and K2's
    narrow instance: T, head width <= 32, a_pad <= 256), ``"wide"`` (their
    wide instance: T <= 32 with a head width up to 64 or an a_pad up to
    512) or ``"tiled"`` (T1-T4) for every other shape, and where ``smem``,
    the shared memory the instance's block needs (the larger of the
    forward's and the backward's), passes a block's. T 33-64 takes the
    tiled route: at the history-50 and history-64 user towers ([16,384, T,
    400] bf16, 20 heads of 20, A 200) its forward and backward took 31.1
    and 34.1 ms against the wide instance's 65.2 and 71.1 (PERF.md,
    ``tools/route_times.py``); at T <= 32 the narrow instance was faster
    (15.2 against 15.9 ms at history 20, 35.2 against 36.5 at the news
    tower), and no wide shape there was timed. ``instance`` asks for the
    wide instance at T 33-64 (its own limits, T, head width <= 64 and
    a_pad <= 512), which only the checks and timing tools that hold it
    against its plain version use."""
    if t > _MAX_T or head_dim > _MAX_HEAD_DIM or a_pad > _MAX_ATT_DIM or smem > _SMEM_LIMIT:
        return "tiled"
    if t <= _NARROW_T and head_dim <= _NARROW_HEAD_DIM and a_pad <= _NARROW_ATT_DIM:
        return "narrow"
    return "wide" if t <= _NARROW_T or instance else "tiled"


def _route(packed: "PackedWeights", t: int, din: int, force_tiled: bool = False,
           instance: bool = False) -> str:
    """``route`` for a call on CUDA, with the shared memory the libraries
    report for the instance's block at its shallowest QKV ring (the
    launchers refuse a block past the limit)."""
    d, a_pad = packed.w_att.shape
    heads = packed.num_heads
    r = "tiled" if force_tiled else route(t, d // heads, a_pad, instance=instance)
    if r == "tiled":
        return r
    is_bf16 = int(packed.wqkv.dtype == torch.bfloat16)
    low = min(2, max(1, -(-din // _QKV_K_TILE))) if is_bf16 else 1
    var = _fp32_code(packed)
    smem = max(_library().news_encoder_smem_bytes(t, d, heads, a_pad, is_bf16, low, var),
               _library_bwd().news_encoder_bwd_smem_bytes(t, d, heads, a_pad, is_bf16, low, var))
    return route(t, d // heads, a_pad, smem, instance=instance)


def articles_per_block(t: int) -> int:
    """Articles in one block of the forward and of the per-block kernel:
    as many whole articles as 64 rows hold, at least 1 (T <= 64)."""
    return max(1, _BLOCK_ROWS // t)


def o_width(d: int) -> int:
    """The width of the backward's round(o) buffer: D rounded up to a
    multiple of 8, so that its rows are whole 16 bytes for the dW product's
    TMA (zero columns past D)."""
    return -(-d // 8) * 8


def panel_layout(num_heads: int, head_dim: int) -> tuple[int, int, int, int]:
    """(heads per group, panel width, groups, packed columns P) of the QKV
    layout: a panel holds Q, K and V of ``gh`` heads side by side. Where a
    head's three slices fit 256 columns, gh = 256 // (3 * head_dim) and
    every panel is 256 wide (the layout K1 and K2 read); a wider head has a
    panel of its own, 3 * head_dim rounded up to 64 columns, and P is
    rounded up to a whole 256 (zero columns past the panels)."""
    if 3 * head_dim <= _PANEL:
        gh = _PANEL // (3 * head_dim)
        n_groups = -(-num_heads // gh)
        return gh, _PANEL, n_groups, n_groups * _PANEL
    pw = -(-3 * head_dim // 64) * 64
    return 1, pw, num_heads, -(-num_heads * pw // _PANEL) * _PANEL


def _pack_panels(parts, num_heads: int) -> torch.Tensor:
    """Q, K, V (or their weights or gradients) [rows, D] -> [rows, P] in
    ``panel_layout``'s order (zeros elsewhere)."""
    rows, d = parts[0].shape
    hd = d // num_heads
    gh, pw, n_groups, p_cols = panel_layout(num_heads, hd)
    panels = parts[0].new_zeros(rows, n_groups, pw)
    for i, v in enumerate(parts):
        heads = v.new_zeros(rows, n_groups * gh * hd)
        heads[:, :d] = v
        panels[:, :, i * gh * hd:(i + 1) * gh * hd] = heads.reshape(rows, n_groups, gh * hd)
    out = panels.reshape(rows, n_groups * pw)
    if p_cols == n_groups * pw:
        return out
    return torch.nn.functional.pad(out, (0, p_cols - n_groups * pw))


def bwd_core_reference(x, packed: "PackedWeights", g, *, t: int, nv: int, drop: "Dropout",
                       seed=None, keep_prob: float = 1.0) -> tuple:
    """Plain version of the backward's per-block kernel (``launch_bwd_core``)
    on ``kernel_input``'s x [rows, Din] (no stream-0 mask left to draw),
    in fp32 from the rounded operands, rounding where the kernel does.
    Returns, for the nv * T valid rows: dQ|dK|dV [rows, P] in the panel
    layout, round(o) [rows, ``o_width(D)``] (zero columns past D) and
    round(dz) [rows, a_pad] in the compute dtype, and the per-block partials
    of db and dq [blocks, A] fp32 (the blocks of ``articles_per_block(T)``
    articles before nv). ``seed`` (64-bit) and
    ``keep_prob`` regenerate the stream-1 mask when ``drop.thr_att``."""
    if drop.thr_emb:
        raise ValueError("bwd_core_reference takes x with its stream-0 mask applied")
    cdt = packed.wqkv.dtype
    heads = packed.num_heads
    d, a_pad = packed.w_att.shape
    a, din = packed.b_att.shape[0], x.shape[1]
    hd, rows = d // heads, nv * t
    scale = 1.0 / math.sqrt(hd)
    wq, wk, wv = (w.float() for w in unpack_qkv(packed.wqkv, heads, d))
    xv = x[:rows].float()
    q, k, v = (_round(xv @ w, cdt).reshape(nv, t, heads, hd) for w in (wq, wk, wv))
    probs = torch.softmax(torch.einsum("nqhd,nkhd->nhqk", q, k) * scale, dim=-1)
    o = torch.einsum("nhqk,nkhd->nqhd", _round(probs, cdt), v).reshape(nv, t, d)
    mask = torch.ones_like(o)
    if drop.thr_att:
        mask = philox.mask(seed, philox.STREAM_ATT, rows, d, keep_prob,
                           device=x.device).reshape(nv, t, d)
    elif drop.ext_mask is not None:
        mask = drop.ext_mask[:rows].reshape(nv, t, d) * drop.inv_ext
    o = o * mask
    o_c = _round(o, cdt)
    hact = torch.tanh(o_c @ packed.w_att[:, :a].float() + packed.b_att)
    att = _round(hact, cdt) @ _round(packed.q_att, cdt)
    expo = torch.exp(att - att.max(dim=-1, keepdim=True).values)
    w = expo / (expo.sum(dim=-1, keepdim=True) + 1e-8)
    gv = g[:nv].float()
    dvals = (o_c * _round(gv, cdt)[:, None, :]).sum(-1)
    datt = _round(w * (dvals - (w * dvals).sum(-1, keepdim=True)), cdt)
    dz = datt[..., None] * _round(packed.q_att, cdt) * (1 - hact * hact)
    nb = articles_per_block(t)
    blocks = -(-nv // nb)
    pad = blocks * nb - nv
    per_block = lambda v_: torch.cat([v_, v_.new_zeros(pad, t, a)]).reshape(blocks, nb * t, a).sum(1)
    db_part = per_block(dz)
    dq_part = per_block(_round(hact, cdt) * datt[..., None])
    dz_c = _round(torch.nn.functional.pad(dz, (0, a_pad - a)), cdt)
    do = _round((w[..., None] * gv[:, None, :] + dz_c @ packed.w_att.float().T) * mask, cdt)
    do = do.reshape(nv, t, heads, hd)
    dp = torch.einsum("nqhd,nkhd->nhqk", do, v)
    ds = _round(probs * (dp - (probs * dp).sum(-1, keepdim=True)) * scale, cdt)
    dv = torch.einsum("nhqk,nqhd->nkhd", _round(probs, cdt), do)
    dq = torch.einsum("nhqk,nkhd->nqhd", ds, k)
    dk = torch.einsum("nhqk,nqhd->nkhd", ds, q)
    dqkv = _pack_panels([_round(u.reshape(rows, d), cdt) for u in (dq, dk, dv)], heads)
    o_c = torch.nn.functional.pad(o_c.reshape(rows, d), (0, o_width(d) - d))
    return (dqkv.to(cdt), o_c.to(cdt), dz_c.reshape(rows, a_pad).to(cdt), db_part, dq_part)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the forward's C entry points on a loaded kernel library."""
    p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    lib.news_encoder_fwd.argtypes = [p, i, p, p, p, p, p, i, i, i, i, i, i, i, i, i, p, f, i,
                                     u, u, p, u, u, f, f, p, f, i, i, i, p]
    lib.news_encoder_fwd.restype = i
    lib.news_encoder_smem_bytes.argtypes = [i] * 7
    lib.news_encoder_smem_bytes.restype = ctypes.c_longlong
    lib.news_encoder_error_string.argtypes = [i]
    lib.news_encoder_error_string.restype = ctypes.c_char_p
    return lib


def bind_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the backward's C entry points on a loaded kernel library."""
    p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    lib.news_encoder_bwd_core.argtypes = ([p, i] + [p] * 7 + [i] + [p] * 3 + [i] * 9
                                          + [p, f, i, u, u, p, u, u, f, f, p, f, i, i, i, p])
    lib.news_encoder_bwd_core.restype = i
    lib.news_encoder_gemm.argtypes = [p, p, p, p] + [i] * 10 + [p, i, i, u, u, p, u, f, p]
    lib.news_encoder_gemm.restype = i
    lib.news_encoder_mask_x.argtypes = [p, i, p, p, i, i, p, i, i, u, u, p, u, f, p]
    lib.news_encoder_mask_x.restype = i
    lib.news_encoder_reduce.argtypes = [p, i, ctypes.c_longlong, i, p, p, p]
    lib.news_encoder_reduce.restype = i
    lib.news_encoder_bwd_smem_bytes.argtypes = [i] * 7
    lib.news_encoder_bwd_smem_bytes.restype = ctypes.c_longlong
    lib.news_encoder_bwd_error_string.argtypes = [i]
    lib.news_encoder_bwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return bind(_build.load("news_encoder"))


@functools.lru_cache(maxsize=None)
def _library_bwd() -> ctypes.CDLL:
    return bind_bwd(_build.load("news_encoder_bwd"))


class PackedWeights(NamedTuple):
    """The kernels' weight operands, made once per set of weights by
    ``pack_weights`` and reused by every launch, forward and backward."""
    wqkv: torch.Tensor   # [din_pad, n_groups * 256] compute dtype, head-group panels
    heads_per_group: int
    w_att: torch.Tensor  # [D, a_pad] compute dtype, zero columns past A
    b_att: torch.Tensor  # [A] fp32
    q_att: torch.Tensor  # [A] fp32
    num_heads: int
    din: int             # x's width; wqkv's rows past it are zeros (``padded_din``)


def padded_din(din: int, dtype: torch.dtype) -> int:
    """The width the kernels take for x [..., Din] in ``dtype``: Din rounded
    up to a whole 16 bytes (a multiple of 8 in bf16, 4 in fp32)."""
    vec = 16 // dtype.itemsize
    return -(-din // vec) * vec


def pack_qkv(wq, wk, wv, num_heads: int, cdt: torch.dtype,
             rows: Optional[int] = None) -> tuple[torch.Tensor, int]:
    """[Din, D] x3 -> ([rows, P] in ``cdt``, heads per group), ``rows`` >=
    Din (default Din) with zero rows past Din.

    The kernels compute Q/K/V one 256-column panel at a time. In
    ``panel_layout``'s order, group g holds Q of heads [g*gh, (g+1)*gh) at
    its columns [0, gh*hd), K at [gh*hd, 2*gh*hd) and V at [2*gh*hd,
    3*gh*hd); the remaining columns, and the heads past ``num_heads`` in the
    last group, are zero."""
    din, d = wq.shape
    rows = din if rows is None else rows
    packed = _pack_panels([w.to(cdt) for w in (wq, wk, wv)], num_heads)
    out = torch.zeros(rows, packed.shape[1], dtype=cdt, device=wq.device)
    out[:din] = packed
    return out, panel_layout(num_heads, d // num_heads)[0]


def unpack_qkv(wqkv: torch.Tensor, num_heads: int, d: int) -> tuple:
    """Inverse of ``pack_qkv`` (or of ``_pack_panels``): [rows, P] -> three
    [rows, D]."""
    rows = wqkv.shape[0]
    hd = d // num_heads
    gh, pw, n_groups, _ = panel_layout(num_heads, hd)
    panels = wqkv[:, :n_groups * pw].reshape(rows, n_groups, pw)
    return tuple(panels[:, :, i * gh * hd:(i + 1) * gh * hd].reshape(rows, -1)[:, :d]
                 for i in range(3))


def pack_weights(wq, wk, wv, w_att, b_att, q_att, *, num_heads: int,
                 compute_dtype: torch.dtype) -> PackedWeights:
    """Check the weights against the kernel's limits and pack them into its
    operands: the QKV head-group panels, with zero rows up to
    ``padded_din``, and W_att with zero columns up to a multiple of 16, both
    in ``compute_dtype``; b and q flat in fp32."""
    wq, wk, wv, w_att, b_att, q_att = (w.detach() for w in (wq, wk, wv, w_att, b_att, q_att))
    din, d = wq.shape
    a = w_att.shape[1]
    for name, w in zip(("wq", "wk", "wv", "w_att", "b_att", "q_att"),
                       (wq, wk, wv, w_att, b_att, q_att)):
        if w.device != wq.device:
            raise ValueError(f"{name} is on {w.device}, wq on {wq.device}")
        if not w.is_floating_point():
            raise ValueError(f"{name} must be a float tensor")
    if wk.shape != (din, d) or wv.shape != (din, d):
        raise ValueError(f"wq/wk/wv must be [{din}, {d}]")
    if w_att.shape != (d, a) or b_att.shape != (a,) or tuple(q_att.shape) not in ((a, 1), (a,)):
        raise ValueError("pooling params must be W [D, A], b [A], q [A, 1]")
    check_shape(d=d, num_heads=num_heads, a=a)
    wqkv, gh = pack_qkv(wq, wk, wv, num_heads, compute_dtype, padded_din(din, compute_dtype))
    a_pad = -(-a // 16) * 16
    w_pad = torch.nn.functional.pad(w_att.to(compute_dtype), (0, a_pad - a)).contiguous()
    return PackedWeights(wqkv, gh, w_pad, b_att.to(torch.float32).contiguous(),
                         q_att.reshape(-1).to(torch.float32).contiguous(), num_heads, din)


def _check_compute(compute_dtype):
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")


def _packed_for(x, weights, packed, num_heads, compute_dtype) -> PackedWeights:
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if packed is None:
        return pack_weights(*weights, num_heads=num_heads, compute_dtype=compute_dtype)
    if packed.num_heads != num_heads or packed.wqkv.dtype != compute_dtype:
        raise ValueError("packed weights were made for other heads or another compute dtype")
    return packed


def fused_news_encoder(x, wq, wk, wv, w_att, b_att, q_att, *, num_heads: int,
                       compute_dtype: torch.dtype = torch.float32,
                       n_valid: Optional[int] = None, keep_prob: float = 1.0,
                       emb_keep_prob: float = 1.0, drop_mask=None, rng_seed=None,
                       packed: Optional[PackedWeights] = None) -> torch.Tensor:
    """Pooled article vectors [N, D] fp32. CPU tensors take the plain
    version; CUDA tensors launch the kernel (or raise), with ``packed``
    (``pack_weights`` of these weights, kept by the caller across calls) or
    else weights packed for this call."""
    _check_compute(compute_dtype)
    kw = dict(num_heads=num_heads, compute_dtype=compute_dtype, n_valid=n_valid,
              keep_prob=keep_prob, emb_keep_prob=emb_keep_prob, rng_seed=rng_seed,
              drop_mask=drop_mask)
    if x.device.type == "cpu":
        return news_encoder_reference(x, wq, wk, wv, w_att, b_att, q_att, **kw)
    return _forward(x, (wq, wk, wv, w_att, b_att, q_att), packed, num_heads, compute_dtype,
                    n_valid, keep_prob, emb_keep_prob, rng_seed, drop_mask)[0]


def _forward(x, weights, packed, num_heads, compute_dtype, n_valid, keep_prob, emb_keep_prob,
             rng_seed, drop_mask, force_tiled: bool = False, instance: bool = False) -> tuple:
    """The forward on a CUDA x [N, T, Din], K1 or the tiled route by
    ``_route`` (``force_tiled`` takes the tiled route at any shape,
    ``instance`` the wide instance at T 33-64):
    (out, xin, keep, packed, drop, nv, nv_dev, tiled), with xin and keep
    from ``kernel_input`` (what the backward needs), the packed weights, the
    call's dropout, its valid article count and whether it went tiled."""
    packed = _packed_for(x, weights, packed, num_heads, compute_dtype)
    n, t, _ = x.shape
    drop = dropout_config(n, t, weights[0].shape[1], keep_prob, emb_keep_prob, rng_seed,
                          drop_mask, x.device)
    _check_x(x, packed)
    nv, nv_dev = _valid(n, n_valid, x.device)
    xin, keep, drop_in = kernel_input(x, nv, drop, nv_dev)
    tiled = _route(packed, t, xin.shape[1], force_tiled, instance) == "tiled"
    if tiled:
        out = tiled_forward(xin, packed, nv, drop_in, n=n, t=t, nv_dev=nv_dev)
    else:
        out = launch(_library(), xin, packed, nv, drop_in, n=n, t=t, nv_dev=nv_dev)
    return out, xin, keep, packed, drop, nv, nv_dev, tiled


def _n_valid(n: int, n_valid) -> int:
    return n if n_valid is None else max(0, min(int(n_valid), n))


def _valid(n: int, n_valid, device) -> tuple:
    """(nv, nv_dev) for the kernels: a count on ``device`` (a CUDA tensor)
    stays there as a 0-dim int32 tensor that the kernels read, and the
    launches take the bucket's geometry, nv = n; anything else is read on
    the host, nv_dev None."""
    if (isinstance(n_valid, torch.Tensor) and n_valid.device.type != "cpu"
            and n_valid.device == torch.device(device)):
        if n_valid.numel() != 1 or n_valid.is_floating_point():
            raise ValueError("a device n_valid must be one integer")
        return n, n_valid.reshape(()).to(torch.int32)
    return _n_valid(n, n_valid), None


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check_x(x, packed: PackedWeights):
    """x [N, T, Din] as the kernels take it, before ``kernel_input``."""
    n, t, din = x.shape
    cdt = packed.wqkv.dtype
    if x.dtype != cdt:
        raise ValueError(f"x is {x.dtype}; the kernel takes x in the compute dtype {cdt}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")
    if packed.wqkv.device != x.device or packed.din != din:
        raise ValueError(f"packed weights are for Din {packed.din} on "
                         f"{packed.wqkv.device}; x is [..., {din}] on {x.device}")
    check_shape(d=packed.w_att.shape[0], num_heads=packed.num_heads, a=packed.b_att.shape[0],
                t=t)


def _check_launch(lib, err: int, what: str, error_string) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: " + error_string(err).decode())


def kernel_input(x, nv: int, drop: Dropout, nv_dev: Optional[torch.Tensor] = None) -> tuple:
    """The kernels' x operand for x [N, T, Din] with ``nv`` valid articles:
    (x2, keep, drop_in), x2 ``padded_din`` wide (zero columns past Din). In
    bf16 with the stream-0 (embedding) mask, x2 is round(x * mask) of the
    nv * T valid rows and keep its keep bits, drawn once by ``emb_mask``
    (into the padded width, so padding costs no copy there) for both
    kernels and the backward's products, and drop_in is ``drop`` without
    stream 0, which the kernels then do not draw. Else x2 is x as
    [N * T, Din] (a padded copy when Din is not the padded width), keep None
    and drop_in ``drop`` (fp32 draws the mask in its kernels)."""
    n, t, din = x.shape
    width = padded_din(din, x.dtype)
    x2 = x.reshape(n * t, din)
    keep, drop_in = None, drop
    if x.dtype == torch.bfloat16 and drop.thr_emb:
        # a device count (nv = n): the kernel zeroes the rows past it
        xm, keep = emb_mask(nv * t, width, drop, device=x.device, x=x2,
                            valid=None if nv_dev is None else (nv_dev, t))
        drop_in = drop._replace(thr_emb=0, inv_emb=1.0)
        if nv:
            return xm, keep, drop_in
        # with no valid row, x2 stands in for the empty xm: the kernels read nothing
    if width != din:
        x2 = torch.nn.functional.pad(x2, (0, width - din))
    return x2, keep, drop_in


def qkv_plan(n: int, t: int, din: int, smem_bytes, *, forward: bool) -> tuple[int, int]:
    """(ring stages, cluster size) of the bf16 QKV stage for x [N, T, Din]
    in K1 (``forward``) or K2's per-block kernel, a function of the shapes
    and the kernel alone: the deepest ring up to ``_QKV_STAGES`` stages (and
    no deeper than Din's 64-deep k-tiles; at least 2 where there are 2
    k-tiles, as the kernel needs) whose shared memory, ``smem_bytes(stages)``,
    fits a block; and the kernel's cluster size (``_FWD_CLUSTER``,
    ``_BWD_CLUSTER``), or 1 when there are fewer blocks than that."""
    blocks = -(-n // articles_per_block(t))
    nk = max(1, -(-din // _QKV_K_TILE))
    low, top = min(2, nk), min(_QKV_STAGES, nk)
    fits = [s for s in range(low, top + 1) if smem_bytes(s) <= _SMEM_LIMIT]
    cluster = _FWD_CLUSTER if forward else _BWD_CLUSTER
    return (max(fits) if fits else low), (cluster if blocks >= cluster else 1)


def _kernel_x(x, packed: PackedWeights, nv: int, n: int, t: int):
    """x as the kernels take it from ``kernel_input`` ([rows, Din]), with
    the rows they read: bf16 at most nv * T (the rest are zeros to TMA),
    fp32 all N * T."""
    rows, din = x.shape
    if x.dtype != packed.wqkv.dtype or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous, 16-byte aligned, in the compute dtype")
    if packed.wqkv.shape[0] != din or packed.wqkv.device != x.device:
        raise ValueError("packed weights do not match x")
    if x.dtype == torch.bfloat16:
        if rows < nv * t:
            raise ValueError(f"x has {rows} rows; the {nv} valid articles need {nv * t}")
        return min(rows, nv * t)
    if rows != n * t:
        raise ValueError(f"fp32 x must have all {n * t} rows, got {rows}")
    return rows


def launch(lib: ctypes.CDLL, x, packed: PackedWeights, nv: int, drop: Dropout, *, n: int,
           t: int, nv_dev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the forward kernel library ``lib`` on the current stream, on x
    [rows, Din] from ``kernel_input`` for N articles of T tokens, ``nv``
    valid (or, with ``nv_dev``, the count that int32 device scalar holds;
    nv is then N), and count the launch (``_build.count``); raises if the
    launch is refused. ``fused_news_encoder`` passes the library
    built from ``csrc/news_encoder.cu``; the profiling tool passes variants
    of it."""
    x_rows = _kernel_x(x, packed, nv, n, t)
    din = x.shape[1]
    d, a_pad = packed.w_att.shape
    a = packed.b_att.shape[0]
    is_bf16 = int(packed.wqkv.dtype == torch.bfloat16)
    var = _fp32_code(packed)
    smem_of = lambda s: lib.news_encoder_smem_bytes(t, d, packed.num_heads, a_pad, is_bf16, s,
                                                    var)
    stages, cluster = qkv_plan(n, t, din, smem_of, forward=True) if is_bf16 else (1, 1)
    smem = smem_of(stages)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"shape needs {smem} B of shared memory per block (> {_SMEM_LIMIT})")
    out = torch.empty(n, d, dtype=torch.float32, device=x.device)
    scale = 1.0 / math.sqrt(d // packed.num_heads)
    ext = drop.ext_mask
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.news_encoder_fwd(
            x.data_ptr(), x_rows, packed.wqkv.data_ptr(), packed.w_att.data_ptr(),
            packed.b_att.data_ptr(), packed.q_att.data_ptr(), out.data_ptr(), n, t, din, d,
            packed.num_heads, packed.heads_per_group, a, a_pad, nv, _ptr(nv_dev), scale, is_bf16,
            drop.seed_lo, drop.seed_hi, _ptr(drop.seed_dev), drop.thr_emb, drop.thr_att,
            drop.inv_emb, drop.inv_att, _ptr(ext), drop.inv_ext, stages, cluster, var, stream)
    _check_launch(lib, err, "news_encoder_fwd", lib.news_encoder_error_string)
    _build.count(fused_news_encoder)
    if not is_bf16:
        _build.count(fused_news_encoder.tf32x3 if var else fused_news_encoder.fma)
    return out


fused_news_encoder.launches = fused_news_encoder.captured = 0
# the fp32 launches by their stages (each counted on the wrapper too): 3xTF32 on the tensor
# cores, or the FMA stages (``fp32_variant``)
fused_news_encoder.tf32x3 = _build.KernelCount()
fused_news_encoder.fma = _build.KernelCount()


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def gemm_splits(m: int, n: int, rows: int) -> int:
    """Row slices of a weight-gradient GEMM [rows] -> [m, n], one fp32
    partial each. Of the slice counts s up to ``_MAX_SLICES`` that keep a
    slice at ``_MIN_SLICE_ROWS`` rows or more, the one with the least waves
    of CTAs per slice's share of the rows, ceil(tiles * s / 132) / s
    (tiles: 128 x 256 output tiles), or the smallest s within 2% of it. A
    function of the shapes alone, so a gradient's summation order (and its
    bits) is the same on every run and every card."""
    tiles = -(-m // _GEMM_TILE[0]) * -(-n // _GEMM_TILE[1])
    top = max(1, min(_MAX_SLICES, rows // _MIN_SLICE_ROWS))
    cost = {s: -(-tiles * s // _SMS) / s for s in range(1, top + 1)}
    best = min(cost.values())
    return min(s for s, c in cost.items() if c <= 1.02 * best)


def slice_rows(rows: int, splits: int) -> int:
    """Rows of each slice: the rows cut into ``splits`` slices, rounded up
    to a whole k-tile (the last slice takes what is left, or nothing)."""
    per = -(-rows // splits)
    return max(1, -(-per // _GEMM_K_TILE)) * _GEMM_K_TILE


def bwd_gemm(a: torch.Tensor, b: torch.Tensor, *, dx: bool, rows: int,
             drop: Dropout = Dropout(), splits: int = 1, keep=None, valid=None) -> torch.Tensor:
    """The backward's GEMM (``csrc/news_encoder_bwd.cu``) on CUDA tensors in
    the compute dtype, masked by Philox stream 0 when ``drop.thr_emb``:

    - ``dx=True``: a = dqkv [M, K], b = wqkv [N, K] -> (a b^T) * mask
      [M, N] in a's dtype, rows at or past ``rows`` zero;
    - ``dx=False``: a [R, M], b [R, N] -> fp32 partials [splits, M, N] of
      round(a * mask)^T b over rows [0, rows), cut into ``splits`` slices
      of ``slice_rows`` rows (``reduce_rows`` sums them).

    bf16 runs on the tensor cores (wgmma, TMA) and takes the mask as
    ``emb_mask`` draws it: dx from ``keep``, its keep bits (scaled by
    ``drop.inv_emb``); the weight gradient from a masked a, with
    ``Dropout()``. fp32 runs by FMA and draws the mask in the kernel.
    ``valid`` = (count, mul), an int32 device scalar and a multiplier: the
    kernel reads rows = mul * count at run time, at most ``rows``."""
    if a.dtype != b.dtype or a.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("a and b must share the compute dtype (float32 or bfloat16)")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")
    is_bf16 = a.dtype == torch.bfloat16
    if is_bf16 and drop.thr_emb and not (dx and keep is not None):
        raise ValueError("bf16 takes the stream-0 mask as emb_mask draws it (keep bits or a masked a)")
    if keep is not None and (keep.dtype != torch.int32 or not keep.is_contiguous()
                             or keep.shape[0] < rows):
        raise ValueError("keep must be contiguous int32 [rows, words]")
    if a.device.type != "cuda":
        raise ValueError(f"no kernel for device {a.device}")
    if dx:
        (m, k), n = a.shape, b.shape[0]
        if b.shape[1] != k:
            raise ValueError(f"a is [{m}, {k}], b is {tuple(b.shape)}")
        out = torch.empty(m, n, dtype=a.dtype, device=a.device)
        kk, lda, ldb, kps = k, k, k, k
    else:
        m, n = a.shape[1], b.shape[1]
        if not 0 <= rows <= min(a.shape[0], b.shape[0]):
            raise ValueError(f"rows={rows} outside [0, {min(a.shape[0], b.shape[0])}]")
        out = torch.empty(splits, m, n, dtype=torch.float32, device=a.device)
        kk, lda, ldb, kps = rows, m, n, slice_rows(rows, splits)
    lib = _library_bwd()
    with torch.cuda.device(a.device):
        err = lib.news_encoder_gemm(a.data_ptr(), b.data_ptr(), out.data_ptr(), _ptr(keep),
                                    0 if keep is None else keep.shape[1], m, n, kk,
                                    lda, ldb, int(dx), splits, kps, rows,
                                    _ptr(None if valid is None else valid[0]),
                                    0 if valid is None else valid[1], int(is_bf16),
                                    drop.seed_lo, drop.seed_hi, _ptr(drop.seed_dev), drop.thr_emb,
                                    drop.inv_emb, _stream(a.device))
    _check_launch(lib, err, "news_encoder_gemm", lib.news_encoder_bwd_error_string)
    _build.count(bwd_gemm)
    return out


bwd_gemm.launches = bwd_gemm.captured = 0


def emb_mask(rows: int, width: int, drop: Dropout, *, device, x=None, valid=None) -> tuple:
    """The stream-0 (embedding) mask of rows [0, rows), columns [0, width),
    drawn once by K2's mask kernel (CUDA) for both products that need it:
    (xm, keep) with xm = round(x[:rows] * mask) [rows, width] in bf16 (None
    when x is None; x may be narrower than ``width``, and xm is zero past
    its columns) and keep [rows, ceil(width / 32)] int32, bit j of word q
    keeping column 32 q + j. ``valid`` = (count, mul), an int32 device
    scalar and a multiplier: rows at or past mul * count (read at run time)
    get zeros in xm and no kept bit."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if not drop.thr_emb:
        raise ValueError("emb_mask needs the stream-0 mask (drop.thr_emb)")
    keep = torch.empty(rows, -(-width // 32), dtype=torch.int32, device=dev)
    xm = None
    if x is not None:
        if x.dtype != torch.bfloat16 or not x.is_contiguous() or not 0 < x.shape[1] <= width:
            raise ValueError(f"x must be contiguous bf16 [R, C], 0 < C <= {width}")
        xm = torch.empty(rows, width, dtype=x.dtype, device=dev)
    x_cols = width if x is None else x.shape[1]
    lib = _library_bwd()
    with torch.cuda.device(dev):
        err = lib.news_encoder_mask_x(_ptr(x), x_cols, _ptr(xm), keep.data_ptr(), keep.shape[1],
                                      rows, _ptr(None if valid is None else valid[0]),
                                      0 if valid is None else valid[1], width, drop.seed_lo,
                                      drop.seed_hi, _ptr(drop.seed_dev), drop.thr_emb, drop.inv_emb,
                                      _stream(dev))
    _check_launch(lib, err, "news_encoder_mask_x", lib.news_encoder_bwd_error_string)
    _build.count(emb_mask)
    return xm, keep


emb_mask.launches = emb_mask.captured = 0


def pack_bits(kept: torch.Tensor) -> torch.Tensor:
    """[rows, width] bool -> [rows, ceil(width / 32)] int32, bit j of word q
    holding column 32 q + j (zeros past width): the layout of ``emb_mask``."""
    rows, width = kept.shape
    words = -(-width // 32)
    padded = torch.zeros(rows, words * 32, dtype=torch.int64, device=kept.device)
    padded[:, :width] = kept.to(torch.int64)
    vals = (padded.reshape(rows, words, 32) << torch.arange(32, device=kept.device)).sum(-1)
    return torch.where(vals >= 1 << 31, vals - (1 << 32), vals).to(torch.int32)


def emb_mask_reference(rows: int, width: int, seed, emb_keep: float, x=None) -> tuple:
    """Plain version of ``emb_mask`` from ``philox.mask``."""
    device = "cpu" if x is None else x.device
    m = philox.mask(seed, philox.STREAM_EMB, rows, width, emb_keep, device=device)
    xm = None
    if x is not None:
        xf = torch.nn.functional.pad(x[:rows].float(), (0, width - x.shape[1]))
        xm = (xf * m).to(x.dtype)
    return xm, pack_bits(m > 0)


def bwd_gemm_reference(a, b, *, dx: bool, rows: int, drop: Dropout = Dropout(),
                       seed=None, emb_keep: float = 1.0) -> torch.Tensor:
    """Plain version of ``bwd_gemm`` (the dx product, or the sum of the
    weight-gradient partials) in fp32 from the rounded operands; ``seed``
    and ``emb_keep`` regenerate the stream-0 mask."""
    af, bf = a.float(), b.float()
    if dx:
        out = af @ bf.T
        if drop.thr_emb:
            out = out * philox.mask(seed, philox.STREAM_EMB, out.shape[0], out.shape[1],
                                    emb_keep, device=a.device)
        out[rows:] = 0
        return out.to(a.dtype)
    af = af[:rows]
    if drop.thr_emb:
        af = _round(af * philox.mask(seed, philox.STREAM_EMB, rows, af.shape[1], emb_keep,
                                     device=a.device), a.dtype)
    return af.T @ bf[:rows]


def reduce_plan(nrows: int, ncols: int) -> int:
    """Rows per chunk of ``reduce_rows``' first pass. One chunk (one pass)
    when the columns alone give ``_REDUCE_BLOCKS`` blocks; else the rows
    are cut into chunks of at least ``_REDUCE_MIN_ROWS`` rows, as many as
    that many blocks need (or the rows allow), and a second pass adds the
    chunk sums in order.
    Depends on the shape alone."""
    vec = 4 if ncols % 4 == 0 else 1
    per_block = 32 * (1 if nrows > 32 else 8)  # column groups of a block (csrc)
    blocks = -(-(ncols // vec) // per_block)
    chunks = min(-(-_REDUCE_BLOCKS // blocks), nrows // _REDUCE_MIN_ROWS)
    return -(-nrows // chunks) if chunks > 1 else max(nrows, 1)


def reduce_rows(part: torch.Tensor) -> torch.Tensor:
    """Sum of ``part`` [R, C] fp32 (CUDA) over its rows in a fixed order
    (the same bits on every run) -> [C]."""
    if part.device.type != "cuda":
        raise ValueError(f"no kernel for device {part.device}")
    part = part.reshape(part.shape[0], -1)
    if part.dtype != torch.float32 or not part.is_contiguous():
        raise ValueError("part must be contiguous fp32")
    nrows, ncols = part.shape
    per_chunk = reduce_plan(nrows, ncols)
    out = torch.empty(ncols, dtype=torch.float32, device=part.device)
    scratch = (torch.empty(-(-nrows // per_chunk), ncols, dtype=torch.float32, device=part.device)
               if nrows > per_chunk else None)
    lib = _library_bwd()
    with torch.cuda.device(part.device):
        err = lib.news_encoder_reduce(part.data_ptr(), nrows, ncols, per_chunk,
                                      None if scratch is None else scratch.data_ptr(),
                                      out.data_ptr(), _stream(part.device))
    _check_launch(lib, err, "news_encoder_reduce", lib.news_encoder_bwd_error_string)
    _build.count(reduce_rows)
    return out


reduce_rows.launches = reduce_rows.captured = 0


def fused_news_encoder_bwd(x, wq, wk, wv, w_att, b_att, q_att, g, *, num_heads: int,
                           compute_dtype: torch.dtype = torch.float32,
                           n_valid: Optional[int] = None, keep_prob: float = 1.0,
                           emb_keep_prob: float = 1.0, drop_mask=None, rng_seed=None,
                           packed: Optional[PackedWeights] = None) -> tuple:
    """Gradients (dx, dwq, dwk, dwv, dw, db, dq) of ``fused_news_encoder``
    under the cotangent g [N, D], with the forward's arguments. CPU tensors
    take the plain version (autograd of ``news_encoder_reference``); CUDA
    tensors launch the recompute backward (or raise). g must be contiguous
    fp32; rows of g at or past ``n_valid`` are ignored, as the forward's
    output there does not depend on the inputs."""
    _check_compute(compute_dtype)
    kw = dict(num_heads=num_heads, compute_dtype=compute_dtype, n_valid=n_valid,
              keep_prob=keep_prob, emb_keep_prob=emb_keep_prob, rng_seed=rng_seed,
              drop_mask=drop_mask)
    if x.device.type == "cpu":
        return news_encoder_bwd_reference(x, wq, wk, wv, w_att, b_att, q_att, g, **kw)
    packed = _packed_for(x, (wq, wk, wv, w_att, b_att, q_att), packed, num_heads, compute_dtype)
    n, t, din = x.shape
    d = wq.shape[1]
    drop = dropout_config(n, t, d, keep_prob, emb_keep_prob, rng_seed, drop_mask, x.device)
    _check_x(x, packed)
    nv, nv_dev = _valid(n, n_valid, x.device)
    xin, keep, _ = kernel_input(x, nv, drop, nv_dev)
    return _backward(xin, keep, packed, g, n, t, nv, drop, nv_dev)


def _backward(xin, keep, packed: PackedWeights, g, n: int, t: int, nv: int,
              drop: Dropout, nv_dev: Optional[torch.Tensor] = None,
              force_tiled: bool = False, instance: bool = False) -> tuple:
    """K2 on ``kernel_input``'s (xin, keep) for N articles of T tokens, nv
    valid (or, with ``nv_dev``, the count that device scalar holds, nv
    then N: the bucket's geometry), under the call's dropout ``drop``: the
    per-block kernel (or, by ``_route``, the tiled route's T1-T4;
    ``force_tiled`` takes it at any shape, ``instance`` the wide instance
    at T 33-64), dx, dWqkv and dW products and the reductions."""
    din, d = xin.shape[1], packed.w_att.shape[0]
    if g.dtype != torch.float32 or not g.is_contiguous() or tuple(g.shape) != (n, d):
        raise ValueError(f"g must be contiguous fp32 [{n}, {d}]")
    din_x = packed.din
    masked = keep is not None  # bf16 with the stream-0 mask: xin is round(x * mask)
    drop_in = drop._replace(thr_emb=0, inv_emb=1.0) if masked else drop
    if _route(packed, t, din, force_tiled, instance) == "tiled":
        qkv, o_c, dz_c, db_part, dq_part = tiled_bwd_core(xin, packed, g, nv, drop_in, n=n, t=t,
                                                          nv_dev=nv_dev)
        nv_blocks = nv  # one partial row per article
    else:
        qkv, o_c, dz_c, db_part, dq_part = launch_bwd_core(_library_bwd(), xin, packed, g, nv,
                                                           drop_in, n=n, t=t, nv_dev=nv_dev)
        nv_blocks = -(-nv // articles_per_block(t))
    _build.count(fused_news_encoder_bwd)
    a_pad, a, p_cols = packed.w_att.shape[1], packed.b_att.shape[0], packed.wqkv.shape[1]
    rows = nv * t
    valid = None if nv_dev is None else (nv_dev, t)
    dx = bwd_gemm(qkv, packed.wqkv, dx=True, rows=rows, drop=drop, keep=keep, valid=valid)
    dx = (dx if din == din_x else dx[:, :din_x]).reshape(n, t, din_x)
    dwqkv = reduce_rows(bwd_gemm(xin, qkv, dx=False, rows=rows, drop=drop_in, valid=valid,
                                 splits=gemm_splits(din, p_cols, rows))).reshape(din, p_cols)
    dw = reduce_rows(bwd_gemm(o_c, dz_c, dx=False, rows=rows, valid=valid,
                              splits=gemm_splits(o_c.shape[1], a_pad, rows)))
    dw = dw.reshape(o_c.shape[1], a_pad)[:d]
    db = reduce_rows(db_part[:nv_blocks])
    dq = reduce_rows(dq_part[:nv_blocks])
    dwq, dwk, dwv = (w[:din_x] for w in unpack_qkv(dwqkv, packed.num_heads, d))
    return dx, dwq, dwk, dwv, dw[:, :a], db[:a], dq[:a].reshape(a, 1)


fused_news_encoder_bwd.launches = fused_news_encoder_bwd.captured = 0


def launch_bwd_core(lib: ctypes.CDLL, x, packed: PackedWeights, g, nv: int, drop: Dropout, *,
                    n: int, t: int, nv_dev: Optional[torch.Tensor] = None) -> tuple:
    """Launch the backward's per-block kernel from the library ``lib`` on
    the current stream, on x [rows, Din] from ``kernel_input``: (dqkv
    [N*T, P], round(o) [N*T, D], round(dz) [N*T, a_pad] in the compute
    dtype (round(o) ``o_width(D)`` wide, zeros past D), db and dq partials
    [blocks, a_pad] fp32; rows and blocks past
    ``nv`` articles are left unwritten; with ``nv_dev``, the int32 device
    count the kernel reads, nv is N and the blocks past the count write zero
    partials and zero the rows the GEMMs' last k-tile reads). Raises if the
    launch is refused.
    ``fused_news_encoder_bwd`` passes the
    library built from ``csrc/news_encoder_bwd.cu``; the profiling tool
    variants."""
    x_rows = _kernel_x(x, packed, nv, n, t)
    din = x.shape[1]
    d, a_pad = packed.w_att.shape
    a = packed.b_att.shape[0]
    cdt = packed.wqkv.dtype
    is_bf16 = int(cdt == torch.bfloat16)
    var = _fp32_code(packed)
    smem_of = lambda s: lib.news_encoder_bwd_smem_bytes(t, d, packed.num_heads, a_pad, is_bf16,
                                                        s, var)
    stages, cluster = qkv_plan(n, t, din, smem_of, forward=False) if is_bf16 else (1, 1)
    smem = smem_of(stages)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"shape needs {smem} B of shared memory per block (> {_SMEM_LIMIT})")
    n_blocks = -(-n // articles_per_block(t))
    p_cols = packed.wqkv.shape[1]
    dev = x.device
    qkv = torch.empty(n * t, p_cols, dtype=cdt, device=dev)
    o_c = torch.empty(n * t, o_width(d), dtype=cdt, device=dev)
    # the wide instance's do product reads whole 64-row tiles of round(dz): the last block's
    # reach past the N * T rows stays inside the allocation
    dz_c = torch.empty(n * t + _BLOCK_ROWS, a_pad, dtype=cdt, device=dev)[:n * t]
    db_part = torch.empty(n_blocks, a_pad, dtype=torch.float32, device=dev)
    dq_part = torch.empty_like(db_part)
    ext = drop.ext_mask
    with torch.cuda.device(dev):
        err = lib.news_encoder_bwd_core(
            x.data_ptr(), x_rows, packed.wqkv.data_ptr(), packed.w_att.data_ptr(),
            packed.b_att.data_ptr(), packed.q_att.data_ptr(), g.data_ptr(), qkv.data_ptr(),
            o_c.data_ptr(), o_c.shape[1], dz_c.data_ptr(), db_part.data_ptr(), dq_part.data_ptr(),
            n, t, din, d, packed.num_heads, packed.heads_per_group, a, a_pad, nv, _ptr(nv_dev),
            1.0 / math.sqrt(d // packed.num_heads), is_bf16, drop.seed_lo, drop.seed_hi,
            _ptr(drop.seed_dev), drop.thr_emb, drop.thr_att, drop.inv_emb, drop.inv_att, _ptr(ext),
            drop.inv_ext, stages, cluster, var, _stream(dev))
    _check_launch(lib, err, "news_encoder_bwd_core", lib.news_encoder_bwd_error_string)
    _build.count(launch_bwd_core)
    if not is_bf16:
        _build.count(launch_bwd_core.tf32x3 if var else launch_bwd_core.fma)
    return qkv, o_c, dz_c, db_part, dq_part


launch_bwd_core.launches = launch_bwd_core.captured = 0
launch_bwd_core.tf32x3 = _build.KernelCount()  # as fused_news_encoder's
launch_bwd_core.fma = _build.KernelCount()


# ---- the tiled route (T1-T4, csrc/news_encoder_tiled.cu) ----


def bind_tiled(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the tiled route's C entry points on a loaded kernel library."""
    p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    lib.tiled_qkv.argtypes = [p, i, p, p, i, i, i, i, i, p, i, u, u, p, u, f, i, p]
    lib.tiled_attention.argtypes = ([p, p, i, i, p] + [i] * 8
                                    + [p, f, i, u, u, p, u, f, p, f, i, p])
    lib.tiled_pool.argtypes = ([p, i] + [p] * 11 + [i] * 6 + [p, i, i, u, u, p, u, f, p, f, i, p])
    lib.tiled_attention_bwd.argtypes = [p] * 5 + [i] * 8 + [p, f, i, i, p]
    for fn in (lib.tiled_qkv, lib.tiled_attention, lib.tiled_pool, lib.tiled_attention_bwd):
        fn.restype = i
    lib.tiled_error_string.argtypes = [i]
    lib.tiled_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _library_tiled() -> ctypes.CDLL:
    return bind_tiled(_build.load("news_encoder_tiled"))


def attention_variant(t: int, head_dim: int, dtype: torch.dtype, backward: bool = False) -> str:
    """The kernel T2 (or, with ``backward``, T4) launches for articles of T
    tokens and heads ``head_dim`` wide in the compute ``dtype``: "staged"
    (an (article, head) pair in one block's shared memory, a row of logits
    in registers) where T rounded up to 16 is at most 128, the head's
    columns come in whole 4-byte pieces (cp.async's smallest: an even width
    in bf16) and the pair's tiles fit a block; else "streamed" (the pair in
    shared memory, any T, the logits swept by key tiles) where its plan
    fits a block; else "gather" (fragments gathered from device memory by
    query tiles, any shape). A row of a tile: the head width rounded up to
    16, and 16 bytes. The staged tiles: Q, K and V (T4: and dO) of T16
    rows; T4 also round(P) and dS [T16 x T16 + 16 bytes] and the rows' max
    and sum. At T 128 the head width reaches 288 (T2) and 144 (T4) in bf16,
    144 and 32 in fp32. The streamed plan (``streamed_plan`` in
    ``csrc/news_encoder_tiled.cu``): the same matrices whole where they fit,
    else a round's rows of one matrix (T4: two; T2: 128 rows where the head
    is at most 64 wide, each warp taking two 16-row tiles, else 64) and two
    slots of the swept pair in tiles of 16 rows at the least; T4 adds 4 x
    T16 fp32. Past T 128 the head width reaches 896 for T2 in bf16, 448 in fp32,
    at any T; T4's falls with T by its statistics: bf16 576 to T 512, 512 at
    T 2,000; fp32 288 to T 512, 256 to T 2,048. The launchers refuse a
    request past its kernel's tiles."""
    elem = torch.tensor([], dtype=dtype).element_size()
    t16, w16 = -(-t // 16) * 16, -(-head_dim // 16) * 16
    row = (w16 + 16 // elem) * elem
    mats = 4 if backward else 3
    smem = t16 * row * mats
    if backward:
        smem += 2 * t16 * (t16 + 16 // elem) * elem + 2 * t16 * 4
    if t16 <= _STAGED_T and head_dim * elem % 4 == 0 and smem <= _SMEM_LIMIT:
        return "staged"
    stats = 16 * t16 if backward else 0  # T4: a float4 a row (its statistics and delta)
    round_rows = 128 if w16 <= 64 and not backward else 64  # 4 warps of two 16-row tiles, or one
    rows = min(t16 * mats, (2 if backward else 1) * round_rows + 4 * 16)  # whole, or streamed
    return "streamed" if rows * row + stats <= _SMEM_LIMIT else "gather"


def qkv_variant(dtype: torch.dtype) -> str:
    """The kernel T1 launches in the compute ``dtype``: "tma" in bf16 (128-row
    blocks, x's row block loaded once where Din is at most 512, else
    streamed with the weight, the output tile stored by TMA apart from the
    weight ring; any Din and P the wrapper takes), "panel" in fp32 (PR 16's
    kernel, whose bf16 half stays for timing beside it). The launcher
    refuses a "tma" request in fp32."""
    return "tma" if dtype == torch.bfloat16 else "panel"


def fp32_variant(head_dim: int) -> str:
    """The stages K1 and K2's per-block kernel run in fp32 for heads
    ``head_dim`` wide (both instances): "tf32x3" (every product on the
    tensor cores, mma.sync m16n8k8 in 3xTF32: each operand split into a
    TF32 high part and remainder, three TF32 products summed in fp32, see
    ``tf32_matmul``) where a head fills at least one k-step of a TF32 tile
    (8 columns), else "fma" (the FMA stages, one thread per output row or
    column; ROADMAP C2's head width 4). The C entries take it as their
    ``fp32_variant`` (``_FP32_VARIANT``); bf16 ignores it."""
    return "tf32x3" if head_dim >= _TF32_MIN_HEAD_DIM else "fma"


_FP32_VARIANT = {"fma": 0, "tf32x3": 1}


def _fp32_code(packed: "PackedWeights") -> int:
    """The C entries' ``fp32_variant`` for these weights (0 in bf16)."""
    if packed.wqkv.dtype == torch.bfloat16:
        return 0
    return _FP32_VARIANT[fp32_variant(packed.w_att.shape[0] // packed.num_heads)]


def pool_variant(t: int, d: int, a_pad: int, dtype: torch.dtype, backward: bool = False) -> str:
    """The kernel T3 (or, with ``backward``, its backward) launches for
    articles of T tokens, D wide, a padded attention width ``a_pad``, in the
    compute ``dtype``: "resident" (a persistent block an SM holding W_att
    in shared memory; T rounded up to 16 at most 128, a_pad at most 256)
    where its layout fits a block; else "streamed" (the same block walking
    the article in rounds of 128 rows; any T, a_pad at most 256; its
    backward keeps each round's tanh in a block's scratch in device memory)
    where its layout fits; else "chunked" (the route's first T3 kernel: a block an
    article, W_att streamed by 256 columns for every 64 rows). Both layouts
    (``pool_plan`` and ``pool_stream_plan`` in
    ``csrc/news_encoder_tiled.cu``): W_att [D16, a_pad + 16 bytes], then
    chunks of round(o) [rows, 64 + 16 bytes] (resident: T16 rows, two
    buffers in the bf16 forward, which rounds fp32 o through registers, else
    three; streamed: 128 rows, two buffers) or, the larger, the backward's
    round(dz) tile (resident [T16, a_pad + 16 bytes], streamed 64 rows of
    it) or the forward's 8 KB, then fp32 arrays: 2 a_pad and 2 T16 (the
    backward: + T16 + D + 512) and a scratch (resident max(4 T16, 4 a_pad);
    streamed 512, the backward max(512, 4 a_pad)). At the history-100 user
    tower (T 100, D 400, A 208 padded, bf16) resident takes 210,944 and
    231,168 bytes; at the history-200 one streamed takes 213,376 + 8 T16
    and 220,800 bytes (T 200), so its bf16 backward reaches D 416 there and
    T 1,168 at D 400. The launchers refuse a request past the kernel's
    layout."""
    elem = torch.tensor([], dtype=dtype).element_size()
    r16 = lambda v: -(-v // 16) * 16
    a128 = lambda v: -(-v // 128) * 128
    t16, pad = r16(t), 16 // elem
    ldw, lda = a_pad + pad, 64 + pad
    w_bytes = a128(r16(d) * ldw * elem)
    bwd_floats = t16 + d + 8 * 64 if backward else 0  # dvals, g, the mask bits
    bufs = 3 if backward or elem == 4 else 2  # round(o) chunks in flight: cp.async, or registers
    region = max(bufs * t16 * lda * elem, 8 * 256 * 4, t16 * ldw * elem if backward else 0)
    floats = 2 * a_pad + 2 * t16 + bwd_floats + max(4 * t16, 4 * a_pad)
    if t16 <= _POOL_T and a_pad <= _POOL_A and w_bytes + a128(region) + 4 * floats <= _SMEM_LIMIT:
        return "resident"
    region = max(2 * _POOL_T * lda * elem, 8 * 256 * 4,
                 _POOL_T // 2 * ldw * elem if backward else 0)
    floats = 2 * a_pad + 2 * t16 + bwd_floats + max(4 * _POOL_T, 4 * a_pad if backward else 0)
    if a_pad <= _POOL_A and w_bytes + a128(region) + 4 * floats <= _SMEM_LIMIT:
        return "streamed"
    return "chunked"


def _heads(packed: PackedWeights) -> tuple:
    """(D, heads, head width, heads per group, panel width, P) of packed weights."""
    d, heads = packed.w_att.shape[0], packed.num_heads
    gh, pw, _, p_cols = panel_layout(heads, d // heads)
    return d, heads, d // heads, gh, pw, p_cols


def _philox_mask(drop: Dropout, stream: int, rows: int, width: int, device) -> torch.Tensor:
    """Plain version of the Philox mask of ``stream`` that a kernel draws
    from ``drop``'s key (or seed tensor), threshold and 1/keep."""
    key = ((drop.seed_lo, drop.seed_hi) if drop.seed_dev is None
           else philox.split_seed(drop.seed_dev))
    thr, inv = ((drop.thr_emb, drop.inv_emb) if stream == philox.STREAM_EMB
                else (drop.thr_att, drop.inv_att))
    return philox.key_mask(key, thr, inv, stream, rows, width, device=device)


def _att_mask(drop: Dropout, rows: int, d: int, device) -> torch.Tensor:
    """Plain version of the stream-1 mask (or the external one times 1/keep)
    of the first ``rows`` rows, or 1."""
    if drop.thr_att:
        return _philox_mask(drop, philox.STREAM_ATT, rows, d, device)
    if drop.ext_mask is not None:
        return drop.ext_mask[:rows] * drop.inv_ext
    return torch.ones(rows, d, device=device)


def _pool_weights(o_c: torch.Tensor, packed: PackedWeights) -> tuple:
    """The pooling of round(o) [nv, T, D] fp32: (weights [nv, T], tanh(z + b)
    [nv, T, A])."""
    cdt, a = packed.wqkv.dtype, packed.b_att.shape[0]
    hact = torch.tanh(o_c @ packed.w_att[:, :a].float() + packed.b_att)
    att = _round(hact, cdt) @ _round(packed.q_att, cdt)
    expo = torch.exp(att - att.max(dim=-1, keepdim=True).values)
    return expo / (expo.sum(dim=-1, keepdim=True) + 1e-8), hact


def tiled_qkv_reference(x, packed: PackedWeights, drop: Dropout, *, n: int, t: int,
                        nv: int) -> torch.Tensor:
    """Plain version of T1: round(round(x * stream-0 mask) @ Wqkv) [N*T, P]
    in the compute dtype for the nv * T valid rows of ``kernel_input``'s x,
    zeros past them."""
    cdt, rows = packed.wqkv.dtype, nv * t
    xf = x[:rows].float()
    if drop.thr_emb:
        xf = xf * _philox_mask(drop, philox.STREAM_EMB, rows, x.shape[1], x.device)
    out = torch.zeros(n * t, packed.wqkv.shape[1], dtype=cdt, device=x.device)
    out[:rows] = (_round(xf, cdt) @ packed.wqkv.float()).to(cdt)
    return out


def tiled_attention_reference(qkv, packed: PackedWeights, drop: Dropout, *, n: int, t: int,
                              nv: int, backward: bool = False) -> tuple:
    """Plain version of T2 on Q|K|V [N*T, P]: (o, stats). o is the
    attention output after the stream-1 (or external) mask, [N*T, D] fp32,
    or with ``backward`` round(o) [N*T, ``o_width(D)``] in the compute dtype;
    stats [2, N*T, heads] fp32 holds each row's max of the base-2 logits
    (s * scale * log2 e) and its sum of exp2 (zeros past the nv * T valid
    rows)."""
    cdt = packed.wqkv.dtype
    d, heads, hd, _, _, _ = _heads(packed)
    rows = nv * t
    q, k, v = (u.float().reshape(nv, t, heads, hd) for u in unpack_qkv(qkv[:rows], heads, d))
    s = torch.einsum("nqhd,nkhd->nhqk", q, k) * (1.0 / math.sqrt(hd) * _LOG2E)
    mx = s.amax(dim=-1, keepdim=True)
    e = torch.exp2(s - mx)
    total = e.sum(dim=-1, keepdim=True)
    o = torch.einsum("nhqk,nkhd->nqhd", _round(e / total, cdt), v).reshape(rows, d)
    o = o * _att_mask(drop, rows, d, qkv.device)
    width, dt = (o_width(d), cdt) if backward else (d, torch.float32)
    out = torch.zeros(n * t, width, dtype=dt, device=qkv.device)
    out[:rows, :d] = o.to(dt)
    stats = torch.zeros(2, n * t, heads, device=qkv.device)
    for i, u in enumerate((mx, total)):
        stats[i, :rows] = u[..., 0].permute(0, 2, 1).reshape(rows, heads)
    return out, stats


def tiled_pool_reference(o, packed: PackedWeights, *, n: int, t: int, nv: int) -> torch.Tensor:
    """Plain version of T3's forward: the pooled [N, D] fp32 of o [N*T, D]
    fp32, zeros at or past nv."""
    d, cdt = packed.w_att.shape[0], packed.wqkv.dtype
    ov = o[:nv * t, :d].float().reshape(nv, t, d)
    w, _ = _pool_weights(_round(ov, cdt), packed)
    out = torch.zeros(n, d, device=o.device)
    out[:nv] = torch.einsum("ntd,nt->nd", ov, w)
    return out


def tiled_pool_bwd_reference(o_c, packed: PackedWeights, g, drop: Dropout, *, n: int, t: int,
                             nv: int) -> tuple:
    """Plain version of T3's backward from round(o) [N*T, >= D] and the
    cotangent g [N, D]: (do [N*T, D], round(dz) [N*T, a_pad] in the compute
    dtype, db and dq partials [N, a_pad] fp32 per article), zeros past the
    nv valid articles."""
    cdt = packed.wqkv.dtype
    d, a_pad = packed.w_att.shape
    a, rows, dev = packed.b_att.shape[0], nv * t, o_c.device
    oc = o_c[:rows, :d].float().reshape(nv, t, d)
    w, hact = _pool_weights(oc, packed)
    gv = g[:nv].float()
    dvals = (oc * _round(gv, cdt)[:, None, :]).sum(-1)
    datt = _round(w * (dvals - (w * dvals).sum(-1, keepdim=True)), cdt)
    dz = datt[..., None] * _round(packed.q_att, cdt) * (1 - hact * hact)
    db_part = torch.zeros(n, a_pad, device=dev)
    dq_part = torch.zeros(n, a_pad, device=dev)
    db_part[:nv, :a] = dz.sum(1)
    dq_part[:nv, :a] = (_round(hact, cdt) * datt[..., None]).sum(1)
    dz_c = torch.zeros(n * t, a_pad, dtype=cdt, device=dev)
    dz_c[:rows, :a] = dz.reshape(rows, a).to(cdt)
    mask = _att_mask(drop, rows, d, dev)
    do = torch.zeros(n * t, d, dtype=cdt, device=dev)
    do[:rows] = (((w[..., None] * gv[:, None, :]).reshape(rows, d)
                  + dz_c[:rows].float() @ packed.w_att.float().T) * mask).to(cdt)
    return do, dz_c, db_part, dq_part


def tiled_attention_bwd_reference(qkv, do, stats, packed: PackedWeights, *, n: int, t: int,
                                  nv: int) -> torch.Tensor:
    """Plain version of T4: dQ|dK|dV [N*T, P] in T1's layout and the compute
    dtype from Q|K|V, do [N*T, D] and T2's stats, with P from the stats
    (zeros past the nv * T valid rows)."""
    cdt = packed.wqkv.dtype
    d, heads, hd, _, _, p_cols = _heads(packed)
    rows, scale = nv * t, 1.0 / math.sqrt(hd)
    q, k, v = (u.float().reshape(nv, t, heads, hd) for u in unpack_qkv(qkv[:rows], heads, d))
    dov = do[:rows].float().reshape(nv, t, heads, hd)
    mx, total = (u[:rows].reshape(nv, t, heads).permute(0, 2, 1)[..., None] for u in stats)
    probs = torch.exp2(torch.einsum("nqhd,nkhd->nhqk", q, k) * (scale * _LOG2E) - mx) / total
    dp = torch.einsum("nqhd,nkhd->nhqk", dov, v)
    ds = _round(probs * (dp - (probs * dp).sum(-1, keepdim=True)) * scale, cdt)
    dv = torch.einsum("nhqk,nqhd->nkhd", _round(probs, cdt), dov)
    dq = torch.einsum("nhqk,nkhd->nqhd", ds, k)
    dk = torch.einsum("nhqk,nqhd->nkhd", ds, q)
    out = torch.zeros(n * t, p_cols, dtype=cdt, device=qkv.device)
    out[:rows] = _pack_panels([_round(u.reshape(rows, d), cdt) for u in (dq, dk, dv)],
                              heads).to(cdt)
    return out


def _launch_tiled(fn, name: str, dev, *args) -> None:
    """Launch the tiled library's entry point ``name`` on the current stream
    of ``dev`` (the stream is the last argument) and count it on ``fn``."""
    lib = _library_tiled()
    with torch.cuda.device(dev):
        err = getattr(lib, name)(*args, _stream(dev))
    _check_launch(lib, err, name, lib.tiled_error_string)
    _build.count(fn)


def tiled_qkv(x, packed: PackedWeights, drop: Dropout, *, n: int, t: int, nv: int,
              nv_dev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """T1: Q|K|V [N*T, P] in the compute dtype for ``kernel_input``'s x
    [rows, Din] (fp32: the stream-0 mask drawn here; bf16: x comes masked);
    rows past the nv valid articles (or the count ``nv_dev`` holds; nv is
    then N) are left unwritten. The kernel is ``qkv_variant``'s. CPU
    tensors take the plain version."""
    if x.device.type == "cpu":
        return tiled_qkv_reference(x, packed, drop, n=n, t=t, nv=nv)
    x_rows = _kernel_x(x, packed, nv, n, t)
    cdt, p_cols = packed.wqkv.dtype, packed.wqkv.shape[1]
    qkv = torch.empty(n * t, p_cols, dtype=cdt, device=x.device)
    tma = qkv_variant(cdt) == "tma"
    _launch_tiled(tiled_qkv.tma if tma else tiled_qkv, "tiled_qkv", x.device, x.data_ptr(),
                  x_rows, packed.wqkv.data_ptr(), qkv.data_ptr(), nv * t, n, t, x.shape[1], p_cols,
                  _ptr(nv_dev), int(cdt == torch.bfloat16), drop.seed_lo, drop.seed_hi,
                  _ptr(drop.seed_dev), drop.thr_emb, drop.inv_emb, int(tma))
    return qkv


tiled_qkv.launches = tiled_qkv.captured = 0
tiled_qkv.tma = _build.KernelCount()  # the "tma" kernel's; PR 16's panel kernel's above


def tiled_attention(qkv, packed: PackedWeights, drop: Dropout, *, n: int, t: int, nv: int,
                    nv_dev: Optional[torch.Tensor] = None, backward: bool = False) -> tuple:
    """T2 on Q|K|V [N*T, P]: (o, stats) as ``tiled_attention_reference``
    gives them; the forward (``backward`` False) keeps no stats (None) and
    leaves the rows past the valid articles unwritten, the backward's
    round(o) is zero there. The kernel is ``attention_variant``'s. CPU
    tensors take the plain version."""
    if qkv.device.type == "cpu":
        o, stats = tiled_attention_reference(qkv, packed, drop, n=n, t=t, nv=nv, backward=backward)
        return o, (stats if backward else None)
    cdt, dev = packed.wqkv.dtype, qkv.device
    d, heads, hd, gh, pw, p_cols = _heads(packed)
    if backward:
        o = torch.zeros(n * t, o_width(d), dtype=cdt, device=dev)
        stats = torch.empty(2, n * t, heads, device=dev)
    else:
        o, stats = torch.empty(n * t, d, device=dev), None
    variant = attention_variant(t, hd, cdt)
    _launch_tiled(getattr(tiled_attention, variant, tiled_attention), "tiled_attention", dev,
                  qkv.data_ptr(), o.data_ptr(), o.shape[1], int(not backward), _ptr(stats), n, t,
                  d, heads, gh, pw, p_cols, nv, _ptr(nv_dev), 1.0 / math.sqrt(hd),
                  int(cdt == torch.bfloat16), drop.seed_lo, drop.seed_hi, _ptr(drop.seed_dev),
                  drop.thr_att, drop.inv_att, _ptr(drop.ext_mask), drop.inv_ext,
                  _ATT_VARIANT[variant])
    return o, stats


# attention_variant's answer as the C entries of T2 and T4 take it
_ATT_VARIANT = {"gather": 0, "staged": 1, "streamed": 2}
tiled_attention.launches = tiled_attention.captured = 0
# the staged and streamed kernels' counts; the gathering one's above
tiled_attention.staged = _build.KernelCount()
tiled_attention.streamed = _build.KernelCount()


def _launch_pool(fn, src, packed: PackedWeights, g, outs, n, t, nv, nv_dev, drop, backward):
    """Launch T3 on ``src`` with its outputs (out, dz_c, do, db_part,
    dq_part; None where the direction writes none) in ``pool_variant``'s
    kernel, counted on ``fn.resident``, ``fn.streamed`` or ``fn``; the
    chunked kernel gets its own scratch, the streamed backward a block's
    (the tanh of an article's rounds of 128 rows, by thread)."""
    d, a_pad = packed.w_att.shape
    dev, cdt = src.device, packed.wqkv.dtype
    variant = pool_variant(t, d, a_pad, cdt, backward)
    att = wts = None
    if variant == "chunked":
        att, wts = (torch.empty(n * t, device=dev) for _ in range(2))
    elif variant == "streamed" and backward:  # each block's tanh of its article's rounds
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        rounds = -(-t // _POOL_T)
        att = torch.empty(min(n, sms) * rounds * _POOL_SCRATCH, device=dev)
    _launch_tiled(getattr(fn, variant, fn), "tiled_pool", dev, src.data_ptr(), src.shape[1],
                  packed.w_att.data_ptr(), packed.b_att.data_ptr(), packed.q_att.data_ptr(),
                  _ptr(g), _ptr(outs[0]), _ptr(att), _ptr(wts), *map(_ptr, outs[1:]), n, t, d,
                  packed.b_att.shape[0], a_pad, nv, _ptr(nv_dev), int(cdt == torch.bfloat16),
                  int(backward), drop.seed_lo, drop.seed_hi, _ptr(drop.seed_dev), drop.thr_att,
                  drop.inv_att, _ptr(drop.ext_mask), drop.inv_ext, _POOL_VARIANT[variant])


# pool_variant's answer as the C entry of T3 takes it
_POOL_VARIANT = {"chunked": 0, "resident": 1, "streamed": 2}
_POOL_SCRATCH = 4 * 8 * 256 * 4  # fp32 a round of the streamed backward's block: acc by thread


def tiled_pool(o, packed: PackedWeights, *, n: int, t: int, nv: int,
               nv_dev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """T3's forward: the pooled [N, D] fp32 of T2's o [N*T, D] fp32, zeros
    at or past the valid count. The kernel is ``pool_variant``'s. CPU
    tensors take the plain version."""
    if o.device.type == "cpu":
        return tiled_pool_reference(o, packed, n=n, t=t, nv=nv)
    out = torch.empty(n, packed.w_att.shape[0], device=o.device)
    outs = (out, None, None, None, None)
    _launch_pool(tiled_pool, o, packed, None, outs, n, t, nv, nv_dev, Dropout(), False)
    return out


tiled_pool.launches = tiled_pool.captured = 0
# the resident and streamed kernels' counts; the chunked one's above
tiled_pool.resident = _build.KernelCount()
tiled_pool.streamed = _build.KernelCount()


def tiled_pool_bwd(o_c, packed: PackedWeights, g, drop: Dropout, *, n: int, t: int, nv: int,
                   nv_dev: Optional[torch.Tensor] = None) -> tuple:
    """T3's backward from T2's round(o) and the cotangent g [N, D] fp32: (do,
    round(dz), db and dq partials) as ``tiled_pool_bwd_reference`` gives
    them (do is left unwritten past the valid articles, round(dz) zero
    there). The kernel is ``pool_variant``'s (backward). CPU tensors take
    the plain version."""
    if o_c.device.type == "cpu":
        return tiled_pool_bwd_reference(o_c, packed, g, drop, n=n, t=t, nv=nv)
    cdt, dev = packed.wqkv.dtype, o_c.device
    d, a_pad = packed.w_att.shape
    do = torch.empty(n * t, d, dtype=cdt, device=dev)
    dz_c = torch.zeros(n * t, a_pad, dtype=cdt, device=dev)
    db_part = torch.empty(n, a_pad, device=dev)
    dq_part = torch.empty_like(db_part)
    _launch_pool(tiled_pool_bwd, o_c, packed, g, (None, dz_c, do, db_part, dq_part), n, t, nv,
                 nv_dev, drop, True)
    return do, dz_c, db_part, dq_part


tiled_pool_bwd.launches = tiled_pool_bwd.captured = 0
tiled_pool_bwd.resident = _build.KernelCount()
tiled_pool_bwd.streamed = _build.KernelCount()


def tiled_attention_bwd(qkv, do, stats, packed: PackedWeights, *, n: int, t: int, nv: int,
                        nv_dev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """T4: dQ|dK|dV [N*T, P] in T1's layout (zeros in the columns no head
    takes and past the valid rows) from Q|K|V, T3's do and T2's stats. The
    kernel is ``attention_variant``'s. CPU tensors take the plain version."""
    if qkv.device.type == "cpu":
        return tiled_attention_bwd_reference(qkv, do, stats, packed, n=n, t=t, nv=nv)
    cdt, dev = packed.wqkv.dtype, qkv.device
    d, heads, hd, gh, pw, p_cols = _heads(packed)
    variant = attention_variant(t, hd, cdt, backward=True)
    dqkv = torch.zeros(n * t, p_cols, dtype=cdt, device=dev)
    delta = torch.empty(n * t, heads, device=dev) if variant == "gather" else None
    _launch_tiled(getattr(tiled_attention_bwd, variant, tiled_attention_bwd),
                  "tiled_attention_bwd", dev, qkv.data_ptr(), do.data_ptr(), stats.data_ptr(),
                  _ptr(delta), dqkv.data_ptr(), n, t, d, heads, gh, pw, p_cols, nv, _ptr(nv_dev),
                  1.0 / math.sqrt(hd), int(cdt == torch.bfloat16), _ATT_VARIANT[variant])
    return dqkv


tiled_attention_bwd.launches = tiled_attention_bwd.captured = 0
tiled_attention_bwd.staged = _build.KernelCount()
tiled_attention_bwd.streamed = _build.KernelCount()


def tiled_forward(x, packed: PackedWeights, nv: int, drop: Dropout, *, n: int, t: int,
                  nv_dev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The tiled route's forward on ``kernel_input``'s x: T1, T2, T3 -> [N, D]
    fp32 (the plain versions on the CPU)."""
    qkv = tiled_qkv(x, packed, drop, n=n, t=t, nv=nv, nv_dev=nv_dev)
    o, _ = tiled_attention(qkv, packed, drop, n=n, t=t, nv=nv, nv_dev=nv_dev)
    del qkv
    return tiled_pool(o, packed, n=n, t=t, nv=nv, nv_dev=nv_dev)


def tiled_bwd_core(x, packed: PackedWeights, g, nv: int, drop: Dropout, *, n: int, t: int,
                   nv_dev: Optional[torch.Tensor] = None) -> tuple:
    """The tiled route in place of the per-block kernel (``launch_bwd_core``):
    T1 and T2 recompute Q|K|V and round(o), T3's backward gives do,
    round(dz) and the db and dq partials (one row per article), T4
    dQ|dK|dV. Returns (dqkv, round(o), round(dz), db_part, dq_part), each
    zero past the valid rows but the partials, which are zero past the valid
    articles (the plain versions on the CPU)."""
    qkv = tiled_qkv(x, packed, drop, n=n, t=t, nv=nv, nv_dev=nv_dev)
    o_c, stats = tiled_attention(qkv, packed, drop, n=n, t=t, nv=nv, nv_dev=nv_dev, backward=True)
    do, dz_c, db_part, dq_part = tiled_pool_bwd(o_c, packed, g, drop, n=n, t=t, nv=nv,
                                                nv_dev=nv_dev)
    dqkv = tiled_attention_bwd(qkv, do, stats, packed, n=n, t=t, nv=nv, nv_dev=nv_dev)
    return dqkv, o_c, dz_c, db_part, dq_part


class NewsEncoderFunction(torch.autograd.Function):
    """The fused encoder on CUDA with its recompute backward: the forward
    launches K1 on ``kernel_input``'s x (in bf16 with the embedding mask:
    round(x * mask), drawn once here), the backward K2 with the same packed
    weights and dropout, so the attention-output mask is regenerated bit
    for bit. It keeps the kernels' x and the keep bits, not x. The seed,
    ``n_valid`` and the mask get no gradient."""

    @staticmethod
    def forward(ctx, x, wq, wk, wv, w_att, b_att, q_att, packed, num_heads, compute_dtype,
                n_valid, keep_prob, emb_keep_prob, rng_seed, drop_mask):
        _check_compute(compute_dtype)
        out, xin, keep, packed, drop, nv, nv_dev, tiled = _forward(
            x, (wq, wk, wv, w_att, b_att, q_att), packed, num_heads, compute_dtype, n_valid,
            keep_prob, emb_keep_prob, rng_seed, drop_mask)
        ctx.save_for_backward(xin, keep)
        ctx.packed, ctx.shape, ctx.drop, ctx.nv_dev = packed, (*x.shape[:2], nv), drop, nv_dev
        ctx.tiled = tiled
        return out

    @staticmethod
    def backward(ctx, g):
        xin, keep = ctx.saved_tensors
        grads = _backward(xin, keep, ctx.packed, g.contiguous().float(), *ctx.shape, ctx.drop,
                          ctx.nv_dev, force_tiled=ctx.tiled)
        return (*grads,) + (None,) * 8


def news_encoder(x, wq, wk, wv, w_att, b_att, q_att, *, num_heads: int,
                 compute_dtype: torch.dtype = torch.float32, n_valid: Optional[int] = None,
                 keep_prob: float = 1.0, emb_keep_prob: float = 1.0, drop_mask=None,
                 rng_seed=None, packed: Optional[PackedWeights] = None) -> torch.Tensor:
    """Differentiable fused news encoder (counterpart of the JAX custom VJP
    ``news_encoder``): on CUDA the kernels (forward K1, recompute backward
    K2); on the CPU the plain version, differentiated by autograd."""
    kw = dict(num_heads=num_heads, compute_dtype=compute_dtype, n_valid=n_valid,
              keep_prob=keep_prob, emb_keep_prob=emb_keep_prob, rng_seed=rng_seed,
              drop_mask=drop_mask)
    if x.device.type == "cpu":
        _check_compute(compute_dtype)
        return news_encoder_reference(x, wq, wk, wv, w_att, b_att, q_att, **kw)
    return NewsEncoderFunction.apply(x, wq, wk, wv, w_att, b_att, q_att, packed, num_heads,
                                     compute_dtype, n_valid, keep_prob, emb_keep_prob,
                                     rng_seed, drop_mask)

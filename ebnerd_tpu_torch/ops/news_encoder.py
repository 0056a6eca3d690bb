"""Fused NRMS news encoder: the Hopper kernel's wrapper and its plain version.

``fused_news_encoder`` is the port of the Pallas TPU kernel
``ebnerd_tpu/ops/news_encoder.py:fused_news_encoder`` (its forward, eval
mode). Per article it computes the packed QKV projection, multi-head
self-attention (no biases, no output projection, scale 1/sqrt(head_dim),
softmax per head) and additive pooling ``softmax_t(tanh(oW+b)·q)``
(max-subtracted, +1e-8) followed by the weighted sum over t.

On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/news_encoder.cu`` (see the note there on what bounds it); on a CPU
tensor it calls ``news_encoder_reference``, the plain PyTorch version,
which the CPU tests and ``chip_smoke.py`` hold the kernel against.

Layouts follow the JAX package: x [N, T, Din]; wq/wk/wv [Din, D];
w_att [D, A]; b_att [A]; q_att [A, 1]; output [N, D] fp32.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from . import _build

__all__ = ["PackedWeights", "fused_news_encoder", "news_encoder_reference", "pack_weights"]

_PANEL = 256         # packed QKV columns per head group (one GEMM panel of the kernel)
_MAX_T = 32          # one warp lane per token in the kernel's pooling softmax
_MAX_HEAD_DIM = 32
_MAX_ATT_DIM = 256   # padded attention width: one pooling column per thread
_SMEM_LIMIT = 232448


def _round(t: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """Cast to the compute dtype and back to fp32: the kernel's rounding
    points (bf16 operands, fp32 accumulation; identity in fp32)."""
    return t.to(cdt).to(torch.float32)


def news_encoder_reference(x, wq, wk, wv, w_att, b_att, q_att, *, num_heads: int,
                           compute_dtype: torch.dtype = torch.float32,
                           n_valid: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel (mirrors
    ``ebnerd_tpu/ops/news_encoder.py:news_encoder_reference``), rounding to
    ``compute_dtype`` where the kernel does: x and the weights before the
    QKV product, Q/K/V after it, the attention probabilities before the
    product with V, and o, W_att, tanh(.) and q_att before the pooling
    products. Sums are fp32. Articles at or past ``n_valid`` are zeros."""
    n, t, din = x.shape
    d = wq.shape[1]
    hd = d // num_heads
    nv = n if n_valid is None else max(0, min(int(n_valid), n))
    cdt = compute_dtype
    xf = _round(x[:nv], cdt)

    def proj(w):
        return _round(xf @ _round(w, cdt), cdt).reshape(nv, t, num_heads, hd)

    qh, kh, vh = proj(wq), proj(wk), proj(wv)
    scale = 1.0 / math.sqrt(hd)
    logits = torch.einsum("nqhd,nkhd->nhqk", qh, kh) * scale
    probs = torch.softmax(logits, dim=-1)
    o = torch.einsum("nhqk,nkhd->nqhd", _round(probs, cdt), vh).reshape(nv, t, d)
    att = torch.tanh(_round(o, cdt) @ _round(w_att, cdt) + b_att.float())
    att = (_round(att, cdt) @ _round(q_att, cdt))[..., 0]
    att = att - att.max(dim=-1, keepdim=True).values
    expo = torch.exp(att)
    weight = expo / (expo.sum(dim=-1, keepdim=True) + 1e-8)
    pooled = torch.einsum("ntd,nt->nd", o, weight)
    if nv == n:
        return pooled
    out = torch.zeros(n, d, dtype=torch.float32, device=x.device)
    out[:nv] = pooled
    return out


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' signatures on a loaded kernel library."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.news_encoder_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, i,
                                     ctypes.c_float, i, p]
    lib.news_encoder_fwd.restype = i
    lib.news_encoder_smem_bytes.argtypes = [i, i, i]
    lib.news_encoder_smem_bytes.restype = ctypes.c_longlong
    lib.news_encoder_error_string.argtypes = [i]
    lib.news_encoder_error_string.restype = ctypes.c_char_p
    return lib


def _library() -> ctypes.CDLL:
    return bind(_build.load("news_encoder"))


class PackedWeights(NamedTuple):
    """The kernel's weight operands, made once per set of weights by
    ``pack_weights`` and reused by every launch."""
    wqkv: torch.Tensor   # [Din, n_groups * 256] compute dtype, head-group panels
    heads_per_group: int
    w_att: torch.Tensor  # [D, a_pad] compute dtype, zero columns past A
    b_att: torch.Tensor  # [A] fp32
    q_att: torch.Tensor  # [A] fp32
    num_heads: int


def pack_qkv(wq, wk, wv, num_heads: int, cdt: torch.dtype) -> tuple[torch.Tensor, int]:
    """[Din, D] x3 -> ([Din, n_groups * 256] in ``cdt``, heads per group).

    The kernel computes Q/K/V one head group at a time: panel g holds Q of
    heads [g*gh, (g+1)*gh) at columns [0, gh*hd), K at [gh*hd, 2*gh*hd) and
    V at [2*gh*hd, 3*gh*hd); the remaining columns, and the heads past
    ``num_heads`` in the last group, are zero."""
    din, d = wq.shape
    hd = d // num_heads
    gh = _PANEL // (3 * hd)
    n_groups = -(-num_heads // gh)
    out = torch.zeros(din, n_groups, _PANEL, dtype=cdt, device=wq.device)
    for i, w in enumerate((wq, wk, wv)):
        heads = torch.zeros(din, n_groups * gh * hd, dtype=cdt, device=wq.device)
        heads[:, :d] = w
        out[:, :, i * gh * hd:(i + 1) * gh * hd] = heads.reshape(din, n_groups, gh * hd)
    return out.reshape(din, n_groups * _PANEL), gh


def pack_weights(wq, wk, wv, w_att, b_att, q_att, *, num_heads: int,
                 compute_dtype: torch.dtype) -> PackedWeights:
    """Check the weights against the kernel's limits and pack them into its
    operands: the QKV head-group panels and W_att with zero columns up to a
    multiple of 16, both in ``compute_dtype``; b and q flat in fp32."""
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
    if d % num_heads:
        raise ValueError(f"d={d} not divisible by num_heads={num_heads}")
    if d // num_heads > _MAX_HEAD_DIM or a > _MAX_ATT_DIM:
        raise ValueError(f"kernel takes head_dim <= {_MAX_HEAD_DIM}, A <= {_MAX_ATT_DIM}; "
                         f"got head_dim={d // num_heads}, A={a}")
    wqkv, gh = pack_qkv(wq, wk, wv, num_heads, compute_dtype)
    a_pad = -(-a // 16) * 16
    w_pad = torch.nn.functional.pad(w_att.to(compute_dtype), (0, a_pad - a)).contiguous()
    return PackedWeights(wqkv, gh, w_pad, b_att.to(torch.float32).contiguous(),
                         q_att.reshape(-1).to(torch.float32).contiguous(), num_heads)


def fused_news_encoder(x, wq, wk, wv, w_att, b_att, q_att, *, num_heads: int,
                       compute_dtype: torch.dtype = torch.float32,
                       n_valid: Optional[int] = None, keep_prob: float = 1.0,
                       drop_mask=None, rng_seed=None,
                       packed: Optional[PackedWeights] = None) -> torch.Tensor:
    """Pooled article vectors [N, D] fp32. CPU tensors take the plain
    version; CUDA tensors launch the kernel (or raise), with ``packed``
    (``pack_weights`` of these weights, kept by the caller across calls) or
    else weights packed for this call. Dropout is not ported yet:
    ``keep_prob < 1``, ``drop_mask`` and ``rng_seed`` raise."""
    if keep_prob < 1.0 or drop_mask is not None or rng_seed is not None:
        raise NotImplementedError(
            "in-kernel dropout is not ported yet (ROADMAP: training slice)")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
    if x.device.type == "cpu":
        return news_encoder_reference(x, wq, wk, wv, w_att, b_att, q_att,
                                      num_heads=num_heads, compute_dtype=compute_dtype,
                                      n_valid=n_valid)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if packed is None:
        packed = pack_weights(wq, wk, wv, w_att, b_att, q_att, num_heads=num_heads,
                              compute_dtype=compute_dtype)
    elif packed.num_heads != num_heads or packed.wqkv.dtype != compute_dtype:
        raise ValueError("packed weights were made for other heads or another compute dtype")
    out = launch(_library(), x, packed, n_valid)
    fused_news_encoder.launches += 1
    return out


def launch(lib: ctypes.CDLL, x, packed: PackedWeights,
           n_valid: Optional[int] = None) -> torch.Tensor:
    """Launch the kernel library ``lib`` on x [N, T, Din] (in the packed
    weights' compute dtype) on the current stream; raises if the launch is
    refused. ``fused_news_encoder`` passes the library built from
    ``csrc/news_encoder.cu``; the profiling tool passes variants of it."""
    n, t, din = x.shape
    cdt = packed.wqkv.dtype
    d, a_pad = packed.w_att.shape
    a = packed.b_att.shape[0]
    if x.dtype != cdt:
        raise ValueError(f"x is {x.dtype}; the kernel takes x in the compute dtype {cdt}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")
    if packed.wqkv.device != x.device or packed.wqkv.shape[0] != din:
        raise ValueError(f"packed weights are [{packed.wqkv.shape[0]}, ...] on "
                         f"{packed.wqkv.device}; x is [..., {din}] on {x.device}")
    vec = 16 // x.element_size()
    if t > _MAX_T or din % vec:
        raise ValueError(f"kernel takes T <= {_MAX_T}, Din % {vec} == 0; got T={t}, Din={din}")
    is_bf16 = int(cdt == torch.bfloat16)
    smem = lib.news_encoder_smem_bytes(d, a_pad, is_bf16)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"shape needs {smem} B of shared memory per block (> {_SMEM_LIMIT})")
    out = torch.empty(n, d, dtype=torch.float32, device=x.device)
    nv = n if n_valid is None else max(0, min(int(n_valid), n))
    scale = 1.0 / math.sqrt(d // packed.num_heads)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.news_encoder_fwd(
            x.data_ptr(), packed.wqkv.data_ptr(), packed.w_att.data_ptr(),
            packed.b_att.data_ptr(), packed.q_att.data_ptr(), out.data_ptr(), n, t, din, d,
            packed.num_heads, packed.heads_per_group, a, a_pad, nv, scale, is_bf16, stream)
    if err != 0:
        raise RuntimeError("news_encoder_fwd launch failed: "
                           + lib.news_encoder_error_string(err).decode())
    return out


fused_news_encoder.launches = 0

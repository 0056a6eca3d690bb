"""Seed-recompute inverted dropout: the Hopper kernel's wrapper and its
plain version (counterpart of ``prng_dropout`` in ``ebnerd_tpu/ops/dropout.py``).

``y = x * mask / keep`` over a tensor of any shape. Element n of the
flattened tensor has the global index g = offset + n and takes word g % 4 of
Philox4x32-10((g // 4 low word, g // 4 high word, stream, DROPOUT_TAG),
64-bit seed) (``ops/philox.py``); it is kept iff
``(bits >> 8) < floor(keep * 2**24)``. The product is taken in fp32 and
rounded once to x's dtype, as the TPU kernel does. Every element has its
own counter, so a tensor split into chunks, each with the element offset of
its first element, gets the same mask as the whole.

``prng_dropout`` is a ``torch.autograd.Function``: its backward is the same
kernel on the cotangent with the same (seed, stream, keep, offset), so no
mask is stored. ``keep == 1`` returns x itself. ``dropout_apply`` launches
``csrc/dropout.cu`` on a CUDA tensor (or raises) and calls the plain
version, ``dropout_reference``, on a CPU tensor.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, philox

__all__ = ["DROPOUT_TAG", "prng_dropout", "dropout_apply", "dropout_reference", "keep_mask",
           "PrngDropoutFunction"]

DROPOUT_TAG = 0x4B330001  # counter word 3 (csrc/philox.cuh); the fused encoder's is 0
_U32 = 0xFFFFFFFF
_CHUNK = 1 << 21  # counters per step of the plain version (bounds its memory)


def _check(keep: float, offset: int, stream: int) -> None:
    philox.threshold(keep)
    if offset < 0 or not 0 <= stream <= _U32:
        raise ValueError(f"offset must be >= 0 and stream a uint32; got {offset}, {stream}")


def _words(seed, stream: int, c0: int, c1: int, device) -> torch.Tensor:
    """Philox words [4 * (c1 - c0)] int64 of counters [c0, c1)."""
    key = philox.split_seed(seed)
    out = []
    for start in range(c0, c1, _CHUNK):
        c = torch.arange(start, min(c1, start + _CHUNK), device=device, dtype=torch.int64)
        ctr = torch.stack([c & _U32, c >> 32, torch.full_like(c, stream),
                           torch.full_like(c, DROPOUT_TAG)], dim=-1)
        out.append(philox.philox4x32(ctr, key).reshape(-1))
    return torch.cat(out) if out else torch.empty(0, dtype=torch.int64, device=device)


def keep_mask(n: int, seed, stream: int, keep: float, offset: int = 0,
              device="cpu") -> torch.Tensor:
    """Plain version of the mask: bool [n], True where elements
    [offset, offset + n) are kept."""
    _check(keep, offset, stream)
    if n == 0:
        return torch.zeros(0, dtype=torch.bool, device=device)
    c0, c1 = offset >> 2, ((offset + n - 1) >> 2) + 1
    w = _words(seed, stream, c0, c1, device)
    lead = offset & 3
    return (w[lead:lead + n] >> 8) < philox.threshold(keep)


def dropout_reference(x: torch.Tensor, seed, stream: int, keep: float,
                      offset: int = 0) -> torch.Tensor:
    """Plain version of the kernel, bit-equal to it: x * (kept ? 1/keep : 0)
    in fp32, rounded once to x's dtype; the same shape as x, contiguous.
    Works through the tensor in chunks so its memory stays bounded."""
    _check(keep, offset, stream)
    flat = x.reshape(-1)
    out = torch.empty(flat.shape, dtype=x.dtype, device=x.device)
    inv = torch.tensor(philox.inverse(keep), dtype=torch.float32, device=x.device)
    step = 4 * _CHUNK
    for s in range(0, flat.numel(), step):
        part = flat[s:s + step]
        m = keep_mask(part.numel(), seed, stream, keep, offset + s, x.device)
        out[s:s + step] = (part.to(torch.float32) * (m.to(torch.float32) * inv)).to(x.dtype)
    return out.reshape(x.shape)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    lib.dropout_apply.argtypes = [p, p, ctypes.c_longlong, ctypes.c_ulonglong, u, u, u, u,
                                  ctypes.c_float, i, p]
    lib.dropout_apply.restype = i
    lib.dropout_error_string.argtypes = [i]
    lib.dropout_error_string.restype = ctypes.c_char_p
    return lib


def dropout_apply(x: torch.Tensor, seed, stream: int, keep: float,
                  offset: int = 0) -> torch.Tensor:
    """x * mask / keep, a new contiguous tensor of x's shape and dtype:
    on a CUDA tensor from the kernel (``csrc/dropout.cu``), which is
    counted in ``dropout_apply.launches``; on a CPU tensor from the plain
    version."""
    _check(keep, offset, stream)
    if x.device.type == "cpu":
        return dropout_reference(x, seed, stream, keep, offset)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the kernel takes float32 or bfloat16, got {x.dtype}")
    x = x.contiguous()
    y = torch.empty_like(x)
    lo, hi = philox.split_seed(seed)
    lib = bind(_build.load("dropout"))
    with torch.cuda.device(x.device):
        err = lib.dropout_apply(x.data_ptr(), y.data_ptr(), x.numel(), offset, lo, hi, stream,
                                philox.threshold(keep), philox.inverse(keep),
                                int(x.dtype == torch.bfloat16),
                                torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError("dropout_apply launch failed: " + lib.dropout_error_string(err).decode())
    dropout_apply.launches += 1
    return y


dropout_apply.launches = 0


class PrngDropoutFunction(torch.autograd.Function):
    """Forward and backward both ``dropout_apply`` under the same (seed,
    stream, keep, offset): dx = dy * mask / keep with the mask regenerated,
    never saved."""

    @staticmethod
    def forward(ctx, x, seed, stream, keep, offset):
        ctx.args = (seed, stream, keep, offset)
        return dropout_apply(x, seed, stream, keep, offset)

    @staticmethod
    def backward(ctx, dy):
        return dropout_apply(dy, *ctx.args), None, None, None, None


def prng_dropout(x: torch.Tensor, seed, stream: int, keep: float,
                 offset: int = 0) -> torch.Tensor:
    """Inverted dropout of x with the mask of (seed, stream) at element
    ``offset`` (see the module docstring); differentiable. ``keep == 1``
    returns x with no launch."""
    _check(keep, offset, stream)
    if keep == 1.0:
        return x
    return PrngDropoutFunction.apply(x, seed, stream, keep, offset)

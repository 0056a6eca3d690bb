"""Counter-based dropout masks shared by the fused news encoder's forward
and backward (counterpart of ``_prng_mask`` in
``ebnerd_tpu/ops/news_encoder.py`` and of the mask-dump probe
``dump_masks`` in ``scripts/check_rng_dropout.py``).

The generator is Philox4x32-10 (Salmon et al., SC 2011), keyed by a
64-bit seed (low word, high word). Element (row, col) of stream ``s``
takes word ``col % 4`` of Philox((row, col // 4, s, 0), key), where
``row`` is the global row ``article * T + t``. It is kept iff
``(bits >> 8) < floor(keep * 2**24)``, the TPU kernel's 24-bit threshold,
and then scaled by ``1 / keep``. Every element has its own counter, so
any split of the rows into blocks regenerates the same mask: the
forward kernel, the backward kernel and the plain version agree bit for
bit. Stream 0 is the embedding mask (din wide), stream 1 the
attention-output mask (D wide).

``philox4x32`` and ``mask`` are the plain versions in torch integer ops
(32 x 32 -> 64-bit products are split into 16-bit limbs, so no int64
product overflows).

``dump_masks`` writes masks through the CUDA device function the kernels
use (``csrc/philox.cuh``, launched from ``csrc/philox.cu``) when asked for
a CUDA device, and through the plain version on the CPU.

A seed is a Python int in [0, 2**64) or a one-element int64 tensor that
holds its 64 bits (a seed >= 2**63 is a negative int64). The plain versions
split a tensor seed with tensor ops, on its own device, so a step whose
seed lives on the card reads it from there without a synchronisation; the
kernels' wrappers pass a seed tensor on the kernel's device by pointer
(``kernel_seed``), and the kernel reads its key from device memory.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["philox4x32", "threshold", "inverse", "split_seed", "kernel_seed", "mask",
           "key_mask", "dump_masks"]

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF
_ROUNDS = 10
_CHUNK = 1 << 21  # counters per step of the plain generator (bounds its memory)
STREAM_EMB, STREAM_ATT = 0, 1


def _mulhilo(m: int, a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of the 64-bit product m * a, a uint32 values
    held in int64; 16-bit limbs keep every partial product below 2**49."""
    p_lo = (a & 0xFFFF) * m            # < 2**48
    p_hi = (a >> 16) * m               # < 2**48
    mid = p_lo + ((p_hi & 0xFFFF) << 16)
    return ((p_hi >> 16) + (mid >> 32)) & _U32, mid & _U32


def philox4x32(counter, key) -> torch.Tensor:
    """Philox4x32-10 of int64 counters [..., 4] (uint32 words) under
    ``key`` = (k0, k1), Python ints or 0-dim int64 tensors (``split_seed``);
    returns the four output words [..., 4] as int64 in [0, 2**32)."""
    c = [counter[..., i].to(torch.int64) & _U32 for i in range(4)]
    k0, k1 = (k.to(counter.device, torch.int64) & _U32 if isinstance(k, torch.Tensor)
              else int(k) & _U32 for k in key)
    for r in range(_ROUNDS):
        if r:
            k0, k1 = (k0 + _W0) & _U32, (k1 + _W1) & _U32
        hi0, lo0 = _mulhilo(_M0, c[0])
        hi1, lo1 = _mulhilo(_M1, c[2])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
    return torch.stack(c, dim=-1)


def threshold(keep: float) -> int:
    """The 24-bit keep threshold floor(keep * 2**24)."""
    if not 0.0 < keep <= 1.0:
        raise ValueError(f"keep probability must be in (0, 1], got {keep}")
    return int(keep * (1 << 24))


def inverse(keep: float) -> float:
    """1 / keep computed in fp32: the kept elements' scale in every kernel."""
    return float(torch.tensor(1.0, dtype=torch.float32) / torch.tensor(keep, dtype=torch.float32))


def split_seed(seed) -> tuple:
    """A 64-bit seed as its (low, high) 32-bit words: Python ints for an
    int, 0-dim int64 tensors on the seed's device for a one-element integer
    tensor (its 64 bits; no synchronisation)."""
    if isinstance(seed, torch.Tensor):
        if seed.numel() != 1 or seed.is_floating_point() or seed.dtype == torch.bool:
            raise ValueError("rng_seed must be one integer")
        s = seed.reshape(()).to(torch.int64)
        return s & _U32, (s >> 32) & _U32
    seed = int(seed)
    if not 0 <= seed < (1 << 64):
        raise ValueError(f"rng_seed must be in [0, 2**64), got {seed}")
    return seed & _U32, seed >> 32


def kernel_seed(seed, device) -> tuple:
    """A seed as a kernel on the CUDA ``device`` takes it: (low, high,
    pointer). A one-element int64 tensor on ``device`` goes by pointer (the
    words are then 0 and unread); an int, or a tensor elsewhere (read on
    the host), by value with a null pointer."""
    if (isinstance(seed, torch.Tensor) and seed.device.type != "cpu"
            and seed.device == torch.device(device)):
        if seed.numel() != 1 or seed.dtype != torch.int64:
            raise ValueError(f"a device seed must be one int64, got {seed.dtype} x {seed.numel()}")
        return 0, 0, seed.data_ptr()
    if isinstance(seed, torch.Tensor):
        seed = int(seed.reshape(()).to(torch.int64)) & ((1 << 64) - 1)
    lo, hi = split_seed(seed)
    return lo, hi, None


def mask(seed, stream: int, rows: int, width: int, keep: float, *,
         row0: int = 0, device="cpu") -> torch.Tensor:
    """Plain version: the inverted-dropout mask [rows, width] fp32 (0 or
    1/keep) of global rows [row0, row0 + rows) of ``stream``."""
    return key_mask(split_seed(seed), threshold(keep), inverse(keep), stream, rows, width,
                    row0=row0, device=device)


def key_mask(key, thr: int, inv: float, stream: int, rows: int, width: int, *,
             row0: int = 0, device="cpu") -> torch.Tensor:
    """``mask`` from the parameters a kernel takes: the seed's (low, high)
    words, the 24-bit threshold and 1/keep."""
    scale = torch.tensor(inv, dtype=torch.float32)
    groups = -(-width // 4)
    n = rows * groups
    out = torch.empty(n, 4, dtype=torch.float32, device=device)
    for start in range(0, n, _CHUNK):
        idx = torch.arange(start, min(n, start + _CHUNK), device=device, dtype=torch.int64)
        ctr = torch.stack([idx // groups + row0, idx % groups,
                           torch.full_like(idx, stream), torch.zeros_like(idx)], dim=-1)
        bits = philox4x32(ctr, key)
        kept = (bits >> 8) < thr
        out[start:start + len(idx)] = kept.to(torch.float32) * scale.to(device)
    return out.reshape(rows, groups * 4)[:, :width].contiguous()


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    lib.philox_dump_masks.argtypes = [p, i, i, i, u, u, u, ctypes.c_float, p]
    lib.philox_dump_masks.restype = i
    lib.philox_error_string.argtypes = [i]
    lib.philox_error_string.restype = ctypes.c_char_p
    return lib


def dump_masks(seed, stream: int, rows: int, width: int, keep: float,
               device="cuda") -> torch.Tensor:
    """Masks [rows, width] fp32 (0 or 1/keep) of ``stream`` for global rows
    [0, rows), as the fused encoder's kernels apply them: on a CUDA device
    from a kernel that calls the kernels' device function, on the CPU from
    the plain version."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return mask(seed, stream, rows, width, keep)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    lo, hi, _ = kernel_seed(seed, "cpu")  # a host seed: K4 is on no training path
    thr = threshold(keep)
    out = torch.empty(rows, width, dtype=torch.float32, device=dev)
    lib = bind(_build.load("philox"))
    with torch.cuda.device(dev):
        stream_ptr = torch.cuda.current_stream(dev).cuda_stream
        err = lib.philox_dump_masks(out.data_ptr(), rows, width, stream, lo, hi, thr,
                                    float(keep), stream_ptr)
    if err != 0:
        raise RuntimeError("philox_dump_masks launch failed: "
                           + lib.philox_error_string(err).decode())
    _build.count(dump_masks)
    return out


dump_masks.launches = dump_masks.captured = 0

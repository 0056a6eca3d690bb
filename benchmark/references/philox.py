"""Philox4x32-10 dropout masks in plain torch integer ops: a frozen copy of
the arithmetic the NRMS news encoder's masks follow, kept with the
benchmark so that the yardstick does not move when the program does.

Element (row, col) of stream ``s`` under a 64-bit seed takes word
``col % 4`` of Philox((row, col // 4, s, 0), (seed low word, seed high
word)); ``row`` is ``article * T + t`` over the call's articles. It is kept
iff ``(bits >> 8) < floor(keep * 2**24)`` and then scaled by ``1 / keep``
computed in fp32. 32 x 32 -> 64-bit products are split into 16-bit limbs,
so no int64 product overflows.
"""
from __future__ import annotations

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF
_ROUNDS = 10
_CHUNK = 1 << 24  # counters per pass (bounds the memory: about 30 int64 temporaries of this)


def _mulhilo(m: int, a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of m * a, a holding uint32 values in int64."""
    p_lo = (a & 0xFFFF) * m
    p_hi = (a >> 16) * m
    mid = p_lo + ((p_hi & 0xFFFF) << 16)
    return ((p_hi >> 16) + (mid >> 32)) & _U32, mid & _U32


def philox4x32(c: list, k0: int, k1: int) -> list:
    """Philox4x32-10 of four int64 counter words (uint32 values) under the
    key (k0, k1); returns the four output words."""
    for r in range(_ROUNDS):
        if r:
            k0, k1 = (k0 + _W0) & _U32, (k1 + _W1) & _U32
        hi0, lo0 = _mulhilo(_M0, c[0])
        hi1, lo1 = _mulhilo(_M1, c[2])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
    return c


def mask(seed: int, stream: int, rows: int, width: int, keep: float, row0: int = 0,
         device="cpu") -> torch.Tensor:
    """The inverted-dropout mask [rows, width] fp32 (0 or 1/keep) of rows
    [row0, row0 + rows) of ``stream``."""
    thr = int(keep * (1 << 24))
    inv = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(keep, dtype=torch.float32)
    k0, k1 = seed & _U32, (seed >> 32) & _U32
    groups = -(-width // 4)
    n = rows * groups
    out = torch.empty(n, 4, dtype=torch.float32, device=device)
    for start in range(0, n, _CHUNK):
        idx = torch.arange(start, min(n, start + _CHUNK), device=device, dtype=torch.int64)
        words = philox4x32([idx // groups + row0, idx % groups, torch.full_like(idx, stream),
                            torch.zeros_like(idx)], k0, k1)
        bits = torch.stack(words, dim=-1)
        out[start:start + len(idx)] = ((bits >> 8) < thr).to(torch.float32) * inv.to(device)
    return out.reshape(rows, groups * 4)[:, :width]

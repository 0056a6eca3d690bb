"""Ragged (list-valued) column as offsets + values.

Copy of the numpy paths of ``ebnerd_tpu/data/ragged.py`` (no native
ctypes branch; the two agree bit for bit). A ``Ragged`` holds ``n``
variable-length rows as:

    values : np.ndarray, shape [total]
    offsets: np.int64 ndarray, shape [n + 1]; row i = values[offsets[i]:offsets[i+1]]
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Sequence

import numpy as np

__all__ = ["Ragged"]


@dataclass(frozen=True)
class Ragged:
    values: np.ndarray
    offsets: np.ndarray

    def __post_init__(self):
        if self.offsets.ndim != 1 or self.offsets.dtype != np.int64:
            object.__setattr__(self, "offsets", np.asarray(self.offsets, np.int64))
        if self.values.ndim != 1:
            raise ValueError(f"values must be 1-D, got shape {self.values.shape}")

    @staticmethod
    def from_lists(rows: Iterable[Sequence], dtype=None) -> "Ragged":
        """Build from a python list of lists. ``None`` rows become empty rows."""
        rows = [r if r is not None else [] for r in rows]
        lengths = np.fromiter((len(r) for r in rows), dtype=np.int64, count=len(rows))
        offsets = np.zeros(len(rows) + 1, dtype=np.int64)
        np.cumsum(lengths, out=offsets[1:])
        if len(rows) and offsets[-1]:
            values = np.concatenate([np.asarray(r, dtype=dtype) for r in rows if len(r)])
        else:
            values = np.empty(0, dtype=dtype or np.int64)
        if dtype is not None:
            values = values.astype(dtype, copy=False)
        return Ragged(values, offsets)

    @staticmethod
    def from_lengths(values: np.ndarray, lengths: np.ndarray) -> "Ragged":
        offsets = np.zeros(len(lengths) + 1, dtype=np.int64)
        np.cumsum(lengths, out=offsets[1:])
        return Ragged(np.asarray(values), offsets)

    def __len__(self) -> int:
        return len(self.offsets) - 1

    @property
    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    @property
    def total(self) -> int:
        return int(self.offsets[-1])

    def row_ids(self) -> np.ndarray:
        """[total] array mapping each value to its row index."""
        return np.repeat(np.arange(len(self), dtype=np.int64), self.lengths)

    def row(self, i: int) -> np.ndarray:
        return self.values[self.offsets[i] : self.offsets[i + 1]]

    def to_lists(self) -> list[list]:
        return [self.row(i).tolist() for i in range(len(self))]

    def take_rows(self, indices: np.ndarray) -> "Ragged":
        """Gather rows (with repetition allowed): out row j = self row indices[j]."""
        indices = np.asarray(indices, dtype=np.int64)
        if indices.size and (indices.min() < 0 or indices.max() >= len(self)):
            bad = indices[(indices < 0) | (indices >= len(self))][0]
            raise IndexError(
                f"take_rows index {bad} out of range for Ragged with {len(self)} rows")
        lengths = self.lengths[indices]
        out_offsets = np.zeros(len(indices) + 1, dtype=np.int64)
        np.cumsum(lengths, out=out_offsets[1:])
        total = int(out_offsets[-1])
        if total == 0:
            return Ragged(self.values[:0], out_offsets)
        vals = self.values[_ranges(self.offsets[indices], lengths, total)]
        return Ragged(vals, out_offsets)

    def to_padded(self, width: int, pad_value=0, align: str = "right") -> tuple[np.ndarray, np.ndarray]:
        """Densify into a [n, width] matrix plus a boolean validity mask.

        align="right": values end-aligned (left-padded), the layout used
        for histories. align="left": values start-aligned (right-padded),
        used for candidate lists. Rows longer than ``width`` keep their
        tail (right) / head (left).
        """
        n = len(self)
        lengths = np.minimum(self.lengths, width)
        out = np.full((n, width), pad_value, dtype=self.values.dtype)
        mask = np.zeros((n, width), dtype=bool)
        total = int(lengths.sum())
        cols = _ranges(np.zeros(n, np.int64), lengths, total)
        rows = np.repeat(np.arange(n, dtype=np.int64), lengths)
        if align == "right":
            srcs = _ranges(self.offsets[1:] - lengths, lengths, total)
            cols = cols + np.repeat(width - lengths, lengths)
        elif align == "left":
            srcs = _ranges(self.offsets[:-1], lengths, total)
        else:
            raise ValueError(f"unknown align: {align}")
        out[rows, cols] = self.values[srcs]
        mask[rows, cols] = True
        return out, mask


def _ranges(starts: np.ndarray, lengths: np.ndarray, total: int) -> np.ndarray:
    """Concatenate [arange(s, s+l) for s, l in zip(starts, lengths)] without a
    python loop (prefix-sum trick)."""
    if total == 0:
        return np.empty(0, dtype=np.int64)
    starts = np.asarray(starts, np.int64)
    lengths = np.asarray(lengths, np.int64)
    nz = lengths > 0
    starts, lengths = starts[nz], lengths[nz]
    ends = starts + lengths
    flat = np.ones(total, dtype=np.int64)
    row_start_pos = np.zeros(len(starts), dtype=np.int64)
    np.cumsum(lengths[:-1], out=row_start_pos[1:])
    flat[row_start_pos] = np.concatenate(([starts[0]], starts[1:] - ends[:-1] + 1))
    np.cumsum(flat, out=flat)
    return flat

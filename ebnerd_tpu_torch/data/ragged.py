"""Ragged (list-valued) column as offsets + values (copy of
``ebnerd_tpu/data/ragged.py``).

``take_rows``, ``tail``, ``to_padded`` and ``isin_per_row`` call the
port's native library (``ebnerd_tpu_torch/native/``, g++ at first use)
where JAX calls its own, and take the numpy path for the inputs its
kernels do not take, or for every input with ``EBNERD_TPU_NO_NATIVE=1``;
both paths give the same bits. A ``Ragged`` holds ``n`` variable-length
rows as:

    values : np.ndarray, shape [total]
    offsets: np.int64 ndarray, shape [n + 1]; row i = values[offsets[i]:offsets[i+1]]
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Sequence

import numpy as np

from .. import native

__all__ = ["Ragged"]


def _gather_ranges(values: np.ndarray, starts: np.ndarray,
                   lengths: np.ndarray, total: int) -> np.ndarray:
    """values[starts[i] : starts[i]+lengths[i]] concatenated: the native
    single pass where it takes ``values``, else numpy's; the same bits."""
    out = native.gather_ranges(values, starts, lengths, total)
    if out is not None:
        return out
    return values[_ranges(starts, lengths, total)]


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

    @staticmethod
    def from_dense(matrix: np.ndarray) -> "Ragged":
        """Every row gets the full width of a dense [n, k] matrix."""
        n, k = matrix.shape
        offsets = np.arange(n + 1, dtype=np.int64) * k
        return Ragged(matrix.reshape(-1), offsets)

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
        # The native gather is a raw memcpy: refuse a bad index here.
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
        vals = _gather_ranges(self.values, self.offsets[indices], lengths, total)
        return Ragged(vals, out_offsets)

    def tail(self, n: int) -> "Ragged":
        """Keep the last ``n`` values of every row (``truncate_history``
        without padding)."""
        keep = np.minimum(self.lengths, n)
        starts = self.offsets[1:] - keep
        out_offsets = np.zeros(len(self) + 1, dtype=np.int64)
        np.cumsum(keep, out=out_offsets[1:])
        vals = _gather_ranges(self.values, starts, keep, int(out_offsets[-1]))
        return Ragged(vals, out_offsets)

    def to_padded(self, width: int, pad_value=0, align: str = "right") -> tuple[np.ndarray, np.ndarray]:
        """Densify into a [n, width] matrix plus a boolean validity mask.

        align="right": values end-aligned (left-padded), the layout used
        for histories. align="left": values start-aligned (right-padded),
        used for candidate lists. Rows longer than ``width`` keep their
        tail (right) / head (left).
        """
        n = len(self)
        if (self.values.dtype == np.int32 and align in ("right", "left")
                and _fits_int32(pad_value)):
            res = native.to_padded(self.values, self.offsets, width,
                                   pad_value, align == "right")
            if res is not None:
                return res
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

    def isin_per_row(self, other: "Ragged") -> np.ndarray:
        """For every value v in row i of self: is v in row i of ``other``?
        A [self.total] bool array, aligned with self.values (the kernel
        behind binary labels)."""
        if len(self) != len(other):
            raise ValueError("row counts differ")
        if self.values.dtype.kind in "iu" and other.values.dtype.kind in "iu":
            res = native.isin_per_row(self.values, self.offsets,
                                      other.values, other.offsets)
            if res is not None:
                return res
        self_keys = _row_scoped_keys(self.row_ids(), self.values)
        other_keys = _row_scoped_keys(other.row_ids(), other.values)
        return np.isin(self_keys, other_keys)

    def filter_values(self, keep: np.ndarray) -> "Ragged":
        """Drop values where keep==False, preserving row structure."""
        keep = np.asarray(keep, dtype=bool)
        new_lengths = np.bincount(self.row_ids()[keep], minlength=len(self)).astype(np.int64)
        out_offsets = np.zeros(len(self) + 1, dtype=np.int64)
        np.cumsum(new_lengths, out=out_offsets[1:])
        return Ragged(self.values[keep], out_offsets)

    def explode_with_row_ids(self) -> tuple[np.ndarray, np.ndarray]:
        """(values, row_ids): one entry per value with the row it came from."""
        return self.values, self.row_ids()

    def concat_values(self, other: "Ragged") -> "Ragged":
        """Per-row concatenation: out row i = self row i ++ other row i."""
        if len(self) != len(other):
            raise ValueError("row counts differ")
        la, lb = self.lengths, other.lengths
        out_offsets = np.zeros(len(self) + 1, dtype=np.int64)
        np.cumsum(la + lb, out=out_offsets[1:])
        out = np.empty(int(out_offsets[-1]), dtype=np.result_type(self.values, other.values))
        out[_ranges(out_offsets[:-1], la, int(la.sum()))] = self.values
        out[_ranges(out_offsets[:-1] + la, lb, int(lb.sum()))] = other.values
        return Ragged(out, out_offsets)

    def shuffle_within_rows(self, rng: np.random.Generator) -> tuple["Ragged", np.ndarray]:
        """Shuffle the values inside each row independently: (the shuffled
        ragged, the permutation into self.values), so that parallel columns
        (labels) can be shuffled the same way. Draws ``total`` uniforms from
        ``rng``."""
        keys = self.row_ids().astype(np.float64) * 2.0 + rng.random(self.total)
        perm = np.argsort(keys, kind="stable")
        return Ragged(self.values[perm], self.offsets.copy()), perm


def _fits_int32(pad_value) -> bool:
    try:
        return bool(np.int32(pad_value) == pad_value)
    except (OverflowError, ValueError, TypeError):
        return False


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


def _row_scoped_keys(row_ids: np.ndarray, values: np.ndarray) -> np.ndarray:
    """(row, value) as one int64 key for vectorized membership; values must
    be in uint32 range (EB-NeRD's article and user ids are)."""
    v = values.astype(np.int64)
    if v.size and (v.min() < 0 or v.max() >= (1 << 32)):
        raise ValueError("values out of uint32 range for row-scoped keys")
    return (row_ids.astype(np.int64) << 32) | v

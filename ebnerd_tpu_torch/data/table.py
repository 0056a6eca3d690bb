"""A minimal columnar table: named columns of np.ndarray or Ragged.

Copy of ``ebnerd_tpu/data/table.py``. The Arrow and parquet functions
import ``pyarrow`` when they are called, never at import: the rest of the
port runs without it (the card's machine has none).
"""
from __future__ import annotations

from typing import Iterator, Mapping, Union

import numpy as np

from .ragged import Ragged

Column = Union[np.ndarray, Ragged]

__all__ = ["Table", "read_parquet", "write_parquet"]


def _col_len(c: Column) -> int:
    return len(c) if isinstance(c, Ragged) else c.shape[0]


class Table:
    def __init__(self, columns: Mapping[str, Column]):
        self._cols: dict[str, Column] = dict(columns)
        n = {_col_len(c) for c in self._cols.values()}
        if len(n) > 1:
            raise ValueError(
                f"column length mismatch: { {k: _col_len(v) for k, v in self._cols.items()} }")
        self._n = n.pop() if n else 0

    def __len__(self) -> int:
        return self._n

    def __contains__(self, name: str) -> bool:
        return name in self._cols

    def __getitem__(self, name: str) -> Column:
        return self._cols[name]

    def __iter__(self) -> Iterator[str]:
        return iter(self._cols)

    @property
    def columns(self) -> list[str]:
        return list(self._cols)

    def with_columns(self, **cols: Column) -> "Table":
        out = dict(self._cols)
        out.update(cols)
        return Table(out)

    def select(self, names: list[str]) -> "Table":
        return Table({n: self._cols[n] for n in names})

    def drop(self, names: list[str]) -> "Table":
        return Table({n: c for n, c in self._cols.items() if n not in names})

    def rename(self, mapping: Mapping[str, str]) -> "Table":
        return Table({mapping.get(n, n): c for n, c in self._cols.items()})

    def take(self, indices: np.ndarray) -> "Table":
        indices = np.asarray(indices)
        return Table({
            n: c.take_rows(indices) if isinstance(c, Ragged) else c[indices]
            for n, c in self._cols.items()
        })

    def filter(self, mask: np.ndarray) -> "Table":
        return self.take(np.flatnonzero(np.asarray(mask, dtype=bool)))

    def head(self, n: int) -> "Table":
        return self.take(np.arange(min(n, self._n)))

    def slice(self, start: int, length: int) -> "Table":
        stop = min(start + length, self._n)
        return self.take(np.arange(start, stop))

    def sample_fraction(self, fraction: float, rng: np.random.Generator,
                        shuffle: bool = True) -> "Table":
        k = int(round(self._n * fraction))
        idx = rng.choice(self._n, size=k, replace=False)
        if not shuffle:
            idx = np.sort(idx)
        return self.take(idx)

    def shuffle(self, rng: np.random.Generator) -> "Table":
        return self.take(rng.permutation(self._n))

    def concat(self, other: "Table") -> "Table":
        out = {}
        for n, c in self._cols.items():
            o = other[n]
            if isinstance(c, Ragged):
                values = np.concatenate([c.values, o.values])
                offsets = np.concatenate([c.offsets, o.offsets[1:] + c.offsets[-1]])
                out[n] = Ragged(values, offsets)
            else:
                out[n] = np.concatenate([c, o])
        return Table(out)

    def to_dict(self) -> dict[str, list]:
        return {
            n: (c.to_lists() if isinstance(c, Ragged) else c.tolist())
            for n, c in self._cols.items()
        }

    def __repr__(self) -> str:
        parts = ", ".join(
            f"{n}: {'list[' + str(c.values.dtype) + ']' if isinstance(c, Ragged) else c.dtype}"
            for n, c in self._cols.items()
        )
        return f"Table(n={self._n}, {parts})"

    # -- Arrow interop (pyarrow imported here, not at module import) ----------
    @staticmethod
    def from_arrow(table, columns: list[str] | None = None) -> "Table":
        """A ``pyarrow.Table`` -> Table; list columns become Ragged."""
        import pyarrow as pa

        cols: dict[str, Column] = {}
        names = columns if columns is not None else table.column_names
        for name in names:
            arr = table.column(name).combine_chunks()
            if isinstance(arr, pa.ChunkedArray):
                arr = arr.chunk(0) if arr.num_chunks else pa.array([], type=arr.type)
            cols[name] = _from_arrow_array(arr)
        return Table(cols)

    def to_arrow(self):
        """Table -> ``pyarrow.Table``; Ragged columns become large lists."""
        import pyarrow as pa

        arrays, names = [], []
        for n, c in self._cols.items():
            names.append(n)
            if isinstance(c, Ragged):
                arrays.append(
                    pa.LargeListArray.from_arrays(pa.array(c.offsets), pa.array(c.values)))
            elif c.dtype == object:
                arrays.append(pa.array(c.tolist()))
            else:
                arrays.append(pa.array(c))
        return pa.table(dict(zip(names, arrays)))


def _from_arrow_array(arr) -> Column:
    import pyarrow as pa

    if pa.types.is_list(arr.type) or pa.types.is_large_list(arr.type):
        if arr.null_count:
            arr = arr.fill_null([])  # null rows -> empty rows, as the JAX package reads them
        offsets = np.asarray(arr.offsets, dtype=np.int64)
        values = _scalar_np(arr.values)
        if offsets[0] != 0:  # a sliced array: trim to its own values
            values = values[offsets[0]:offsets[-1]]
            offsets = offsets - offsets[0]
        return Ragged(values, offsets)
    return _scalar_np(arr)


def _scalar_np(arr) -> np.ndarray:
    import pyarrow as pa

    if pa.types.is_string(arr.type) or pa.types.is_large_string(arr.type):
        return np.asarray(arr.to_pylist(), dtype=object)
    if pa.types.is_timestamp(arr.type):
        return np.asarray(arr.cast(pa.int64())).astype("datetime64[us]")
    return np.asarray(arr.to_numpy(zero_copy_only=False))


def read_parquet(path, columns: list[str] | None = None) -> Table:
    """Read a parquet file (needs pyarrow)."""
    import pyarrow.parquet as pq

    return Table.from_arrow(pq.read_table(path, columns=columns), columns)


def write_parquet(table: Table, path) -> None:
    """Write a Table as parquet (needs pyarrow)."""
    import pyarrow.parquet as pq

    pq.write_table(table.to_arrow(), path)

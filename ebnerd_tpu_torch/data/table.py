"""A minimal columnar table: named columns of np.ndarray or Ragged.

Copy of the in-memory part of ``ebnerd_tpu/data/table.py``; the Arrow and
parquet IO are left out, so the port needs no pyarrow.
"""
from __future__ import annotations

from typing import Iterator, Mapping, Union

import numpy as np

from .ragged import Ragged

Column = Union[np.ndarray, Ragged]

__all__ = ["Table"]


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

    def __repr__(self) -> str:
        parts = ", ".join(
            f"{n}: {'list[' + str(c.values.dtype) + ']' if isinstance(c, Ragged) else c.dtype}"
            for n, c in self._cols.items()
        )
        return f"Table(n={self._n}, {parts})"

"""id -> row index -> dense value matrix (copy of ``ebnerd_tpu/data/lookup.py``;
``map_ids`` calls the native library for integer ids, as JAX does).

The id->index mapping runs once over whole ragged columns (vectorized
searchsorted) and yields int32 index arrays; the value matrix lives on
the device and the gather ``matrix[indices]`` happens there. Row 0 is the
unknown/padding row, so missing ids and ragged padding share index 0.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import native
from .ragged import Ragged

__all__ = ["Lookup", "create_lookup_objects", "map_list_article_id_to_value"]


@dataclass(frozen=True)
class Lookup:
    """matrix[0] is the unknown/padding row; known id ``ids[i]`` maps to row
    ``i + 1``."""

    ids: np.ndarray       # sorted unique known ids, shape [V]
    matrix: np.ndarray    # [V + 1, ...] with row 0 = unknown representation

    @staticmethod
    def from_values(
        ids: np.ndarray, values: np.ndarray, unknown_representation: str = "zeros"
    ) -> "Lookup":
        ids = np.asarray(ids)
        values = np.asarray(values)
        if ids.ndim != 1 or len(ids) != len(values):
            raise ValueError("ids must be 1-D and aligned with values")
        order = np.argsort(ids, kind="stable")
        ids, values = ids[order], values[order]
        if len(ids) > 1 and (ids[1:] == ids[:-1]).any():
            raise ValueError("duplicate ids in lookup")
        if unknown_representation == "zeros":
            unknown = np.zeros_like(values[:1])
        elif unknown_representation == "mean":
            unknown = np.mean(values, axis=0, dtype=values.dtype, keepdims=True)
        else:
            raise ValueError(
                f"'{unknown_representation}' is not a specified method. "
                "Can be either 'zeros' or 'mean'."
            )
        return Lookup(ids=ids, matrix=np.concatenate([unknown, values], axis=0))

    def map_ids(self, ids: np.ndarray) -> np.ndarray:
        """Vectorized id -> row index; unknown ids -> 0."""
        ids = np.asarray(ids)
        if (self.ids.dtype.kind in "iu" and ids.dtype.kind in "iu"
                and self.ids.dtype != np.uint64 and ids.dtype != np.uint64):
            res = native.map_ids(self.ids, ids.reshape(-1))
            if res is not None:
                return res.reshape(ids.shape)
        pos = np.searchsorted(self.ids, ids)
        pos_c = np.minimum(pos, len(self.ids) - 1)
        found = self.ids[pos_c] == ids
        return np.where(found, pos_c + 1, 0).astype(np.int32)

    def map_ragged(self, col: Ragged) -> Ragged:
        """Map a ragged id column to a ragged row-index column in one pass."""
        return Ragged(self.map_ids(col.values), col.offsets.copy())

    @property
    def n_rows(self) -> int:
        return self.matrix.shape[0]


def map_list_article_id_to_value(col: Ragged, lookup: Lookup) -> Ragged:
    """Map a ragged article-id column to row indices in one vectorized pass
    (the JAX package's alias for ``Lookup.map_ragged``)."""
    return lookup.map_ragged(col)


def create_lookup_objects(
    lookup_dictionary: dict[int, np.ndarray], unknown_representation: str = "zeros"
) -> tuple[dict[int, int], np.ndarray]:
    """Dict API: ({id: row_index}, matrix) with matrix[0] the unknown row
    and the ids in the dict's order from row 1. Prefer ``Lookup`` for bulk
    mapping."""
    ids = np.asarray(list(lookup_dictionary.keys()))
    values = np.stack([np.asarray(v) for v in lookup_dictionary.values()])
    if unknown_representation == "zeros":
        unknown = np.zeros_like(values[:1])
    elif unknown_representation == "mean":
        unknown = np.mean(values, axis=0, dtype=values.dtype, keepdims=True)
    else:
        raise ValueError(
            f"'{unknown_representation}' is not a specified method. "
            "Can be either 'zeros' or 'mean'."
        )
    matrix = np.concatenate([unknown, values], axis=0)
    indexes = {int(id_): i for i, id_ in enumerate(ids, start=1)}
    return indexes, matrix

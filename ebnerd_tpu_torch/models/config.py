"""Model hyper-parameter bundles (copy of ``HParamsBase`` and ``HParamsNRMS``
from ``ebnerd_tpu/models/config.py``; the same fields and defaults)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

DEFAULT_TITLE_SIZE = 30

__all__ = ["HParamsBase", "HParamsNRMS"]


@dataclass(frozen=True)
class HParamsBase:
    title_size: int = DEFAULT_TITLE_SIZE
    history_size: int = 20
    optimizer: str = "adam"
    loss: str = "cross_entropy_loss"
    dropout: float = 0.2
    learning_rate: float = 1e-4

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclass(frozen=True)
class HParamsNRMS(HParamsBase):
    head_num: int = 20
    head_dim: int = 20
    attention_hidden_dim: int = 200
    newsencoder_units_per_layer: tuple[int, ...] | None = None
    newsencoder_l2_regularization: float = 1e-4

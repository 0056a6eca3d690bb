"""Model hyper-parameter bundles (copy of ``ebnerd_tpu/models/config.py``:
the same classes, fields and defaults)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

DEFAULT_TITLE_SIZE = 30
DEFAULT_BODY_SIZE = 40
DEFAULT_DOCUMENT_SIZE = 768

__all__ = ["HParamsBase", "HParamsNRMS", "HParamsNRMSDocVec", "HParamsLSTUR", "HParamsNPA",
           "HParamsNAML", "HParamsFastformer"]


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


@dataclass(frozen=True)
class HParamsNRMSDocVec(HParamsBase):
    title_size: int = DEFAULT_DOCUMENT_SIZE  # document-vector dimension
    head_num: int = 16
    head_dim: int = 16
    attention_hidden_dim: int = 200
    newsencoder_units_per_layer: tuple[int, ...] = (512, 512, 512)
    newsencoder_l2_regularization: float = 1e-4


@dataclass(frozen=True)
class HParamsLSTUR(HParamsBase):
    n_users: int = 50000
    cnn_activation: str = "relu"
    type: str = "ini"
    attention_hidden_dim: int = 200
    gru_unit: int = 400
    filter_num: int = 400
    window_size: int = 3


@dataclass(frozen=True)
class HParamsNPA(HParamsBase):
    n_users: int = 50000
    cnn_activation: str = "relu"
    attention_hidden_dim: int = 200
    user_emb_dim: int = 400
    filter_num: int = 400
    window_size: int = 3


@dataclass(frozen=True)
class HParamsNAML(HParamsBase):
    body_size: int = DEFAULT_BODY_SIZE
    vert_num: int = 100
    vert_emb_dim: int = 10
    subvert_num: int = 100
    subvert_emb_dim: int = 10
    dense_activation: str = "relu"
    cnn_activation: str = "relu"
    attention_hidden_dim: int = 200
    filter_num: int = 400
    window_size: int = 3


@dataclass(frozen=True)
class HParamsFastformer:
    """Fastformer's bundle; it has no ``HParamsBase`` parent."""

    embedding_dim: int = 256
    n_layers: int = 2
    n_heads: int = 8
    intermediate_dim: int = 256
    max_position: int = 1024
    dropout: float = 0.2
    learning_rate: float = 1e-4
    history_size: int = 20
    title_size: int = DEFAULT_TITLE_SIZE
    optimizer: str = "adam"
    loss: str = "cross_entropy_loss"

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

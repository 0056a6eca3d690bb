"""The training step (counterpart of ``TrainerConfig`` and ``Trainer`` in
``ebnerd_tpu/training/trainer.py``, up to its train step).

One step: host dedup of the index batch (when on), the batch build on the
device (``models/inputs.py``), the model's logits in training mode, the
loss (+ optional L2), ``backward()`` and dense Adam. Adam uses optax's
defaults, betas (0.9, 0.999) and eps 1e-8; the learning rate lives in the
optimizer's ``param_groups``, the counterpart of the JAX trainer's
injected hyperparameter. Dropout masks come from one 64-bit seed per
step, drawn from a generator seeded with ``config.seed``.

Not ported yet: ``fit`` with its callbacks, checkpoints and the prefetch
thread, gradient accumulation and ``scan_steps`` (ROADMAP A5), row-sparse
embeddings (A12) and a bf16 Adam first moment (A3).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from .. import resolve_device
from .dedup import dedup_capable, prep_dedup_batch
from .losses import l2_penalty, loss_fn_for

__all__ = ["Trainer", "TrainerConfig"]


@dataclass
class TrainerConfig:
    learning_rate: float = 1e-4
    loss: str = "cross_entropy_loss"
    optimizer: str = "adam"
    l2_regularization: float = 0.0
    seed: int = 42
    # apply the optimizer every N micro-batches (ROADMAP A5)
    accumulation_steps: int = 1
    # N steps per dispatch (ROADMAP A5)
    scan_steps: int = 1
    # row-sparse word-embedding updates (ROADMAP A12)
    sparse_embedding: bool = False
    # train-time unique-article dedup (training/dedup.py): "auto" = on
    # whenever dedup_capable(model) says so; True forces; False per slot
    dedup_articles: Any = "auto"
    dedup_min_bucket: int = 512
    # dtype of Adam's first moment; None = fp32 (ROADMAP A3)
    adam_mu_dtype: Optional[str] = None


_UNPORTED = (("accumulation_steps", 1, "A5"), ("scan_steps", 1, "A5"),
             ("sparse_embedding", False, "A12"), ("adam_mu_dtype", None, "A3"))


class Trainer:
    """Runs the train step of one newsrec model.

    Args:
      model: an ``nn.Module`` whose ``forward(batch)`` returns [B, K]
        logits (``models/newsrec.py``), its parameters on ``device``.
      tables: dict of value tables (numpy or tensors), moved to ``device``
        once (``models/inputs.py`` convention).
      batch_builder: gathers model inputs from tables + an index batch.
    """

    def __init__(self, model: torch.nn.Module, tables: dict, batch_builder,
                 config: TrainerConfig = TrainerConfig(), device="cuda"):
        for name, default, item in _UNPORTED:
            if getattr(config, name) != default:
                raise NotImplementedError(
                    f"TrainerConfig.{name}={getattr(config, name)!r} is not ported yet "
                    f"(ROADMAP {item})")
        if config.optimizer != "adam":
            raise ValueError(f"this optimizer not defined {config.optimizer}")
        self.device = resolve_device(device)
        self.model = model
        self.config = config
        self.builder = batch_builder
        self.tables = {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor)
                                          else v).to(self.device, torch.long)
                       for k, v in tables.items()}
        dedup_ok, why = dedup_capable(model)
        if config.dedup_articles is True and not dedup_ok:
            raise ValueError(f"dedup_articles: {type(model).__name__}: {why}")
        self.dedup = dedup_ok if config.dedup_articles == "auto" else bool(config.dedup_articles)
        self.loss_fn = loss_fn_for(config.loss)
        self.optimizer = torch.optim.Adam(model.parameters(), lr=config.learning_rate,
                                          betas=(0.9, 0.999), eps=1e-8)
        self.seeds = torch.Generator().manual_seed(config.seed)
        self.step_count = 0

    def next_seed(self) -> int:
        """The next step's 64-bit dropout seed."""
        lo, hi = torch.randint(0, 1 << 32, (2,), generator=self.seeds).tolist()
        return (hi << 32) | lo

    def prepare(self, raw: dict) -> dict:
        """Host dedup (when on) and the batch build on the device: an index
        batch -> the model batch plus ``labels`` on the device."""
        if self.dedup and "hist_idx" in raw:
            raw = prep_dedup_batch(raw, self.config.dedup_min_bucket)
        batch = self.builder(self.tables, raw)
        batch["labels"] = torch.as_tensor(np.asarray(raw["labels"])).to(
            self.device, torch.float32, non_blocking=True)
        return batch

    def step(self, batch: dict) -> torch.Tensor:
        """One optimizer step on a prepared batch; returns the loss (a
        device scalar: reading it synchronises)."""
        self.model.train()
        batch = dict(batch, dropout_seed=self.next_seed())
        logits = self.model(batch)
        loss = self.loss_fn(logits, batch["labels"])
        if self.config.l2_regularization:
            loss = loss + self.config.l2_regularization * l2_penalty(self.model)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        self.step_count += 1
        return loss.detach()

    def train_step(self, raw: dict) -> torch.Tensor:
        """``step(prepare(raw))``."""
        return self.step(self.prepare(raw))

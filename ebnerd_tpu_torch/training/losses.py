"""Training losses (counterpart of ``ebnerd_tpu/training/losses.py``):
"cross_entropy_loss" is categorical CE over the npratio+1 candidates,
"log_loss" binary CE on sigmoid scores; ``l2_penalty`` is the selective L2
on the dense stack's kernels (``l2_dense*`` modules)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["categorical_crossentropy", "binary_logloss", "l2_penalty", "loss_fn_for"]


def categorical_crossentropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Softmax CE over the candidate axis; labels are 0/1 rows summing to 1."""
    logp = torch.log_softmax(logits, dim=-1)
    return -(labels * logp).sum(dim=-1).mean()


def binary_logloss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Element-wise sigmoid binary cross-entropy over all candidates."""
    return -(labels * F.logsigmoid(logits) + (1.0 - labels) * F.logsigmoid(-logits)).mean()


def l2_penalty(model: torch.nn.Module, substr: str = "l2_dense") -> torch.Tensor:
    """Sum of squared kernels (Linear weights) of the modules whose name
    contains ``substr``."""
    total = None
    for name, p in model.named_parameters():
        parts = name.split(".")
        if any(substr in s for s in parts[:-1]) and parts[-1] == "weight":
            sq = p.float().square().sum()
            total = sq if total is None else total + sq
    if total is None:
        return torch.zeros((), dtype=torch.float32,
                           device=next(iter(model.parameters())).device)
    return total


def loss_fn_for(name: str):
    if name == "cross_entropy_loss":
        return categorical_crossentropy
    if name == "log_loss":
        return binary_logloss
    raise ValueError(f"this loss not defined {name}")

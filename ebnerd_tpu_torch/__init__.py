"""PyTorch/CUDA port of ``ebnerd_tpu`` for NVIDIA Hopper (H100).

The package mirrors the layout of ``ebnerd_tpu`` (``data/``, ``models/``,
``ops/``, ``serving.py``) so each module's counterpart is easy to find.
It imports torch and numpy only; it never imports JAX or ``ebnerd_tpu``.
Host-side modules it needs are kept here as copies.

Entry points run on the card by default (``device="cuda"``) and raise
when CUDA is absent unless the caller passes ``device="cpu"``. Kernels
are built from ``csrc/`` with ``nvcc`` at first use (``ops/_build.py``).
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for but
    absent. Never picks a device on the caller's behalf."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev

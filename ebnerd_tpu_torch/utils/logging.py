"""Scalar logging for training (copy of ``ScalarLogger`` from
``ebnerd_tpu/utils/logging.py``; its ``StepTimer`` and ``trace_profile``
call JAX and are ROADMAP A13).

Scalars always go to a JSONL file (greppable, dependency-free); a
TensorBoard event file is written too when a SummaryWriter
implementation is importable.
"""
from __future__ import annotations

import json
import time
from pathlib import Path

__all__ = ["ScalarLogger"]


class ScalarLogger:
    """Append-only scalar sink: JSONL always, TensorBoard when available."""

    def __init__(self, log_dir, tensorboard: bool = True):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.log_dir / "scalars.jsonl", "a")
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=str(self.log_dir))
            except Exception:
                self._tb = None

    def log(self, tag: str, value: float, step: int) -> None:
        self._jsonl.write(
            json.dumps({"tag": tag, "value": float(value), "step": int(step),
                        "ts": time.time()}) + "\n"
        )
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def log_dict(self, scalars: dict, step: int) -> None:
        for tag, value in scalars.items():
            if isinstance(value, (int, float)):
                self.log(tag, value, step)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

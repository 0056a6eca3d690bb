"""Training observability (counterpart of ``ebnerd_tpu/utils/logging.py``):
scalar logging, step timing and profiler traces.

Scalars always go to a JSONL file (greppable, dependency-free); a
TensorBoard event file is written too when a SummaryWriter
implementation is importable. ``StepTimer`` synchronises the result's
CUDA device before it reads the clock (the JAX one blocks on the result);
``trace_profile`` records ``torch.profiler`` and writes a Chrome trace.
"""
from __future__ import annotations

import json
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Optional

import torch

__all__ = ["ScalarLogger", "StepTimer", "trace_profile"]


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


def _cuda_devices(result) -> set:
    """The CUDA devices of the tensors in ``result`` (nested lists, tuples
    and dicts)."""
    if isinstance(result, torch.Tensor):
        return {result.device} if result.is_cuda else set()
    if isinstance(result, dict):
        result = list(result.values())
    if isinstance(result, (list, tuple)):
        return set().union(*(_cuda_devices(r) for r in result)) if result else set()
    return set()


class StepTimer:
    """Wall-clock step timing, synchronised: ``stop(result)`` waits for the
    CUDA devices that hold ``result``'s tensors before it reads the clock,
    so a step's time includes its device work (impressions/s as the bench
    measures it)."""

    def __init__(self):
        self._t0: Optional[float] = None
        self.history: list[float] = []

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, result=None) -> float:
        if result is not None:
            for dev in _cuda_devices(result):
                torch.cuda.synchronize(dev)
        dt = time.perf_counter() - self._t0
        self.history.append(dt)
        return dt

    @property
    def mean(self) -> float:
        return sum(self.history) / max(len(self.history), 1)


@contextmanager
def trace_profile(log_dir, enabled: bool = True):
    """Record the block with ``torch.profiler`` (CPU, and CUDA when a card
    is there) and write a Chrome trace, ``trace.json``, into ``log_dir``
    (open it with Perfetto or chrome://tracing)."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(str(log_dir / "trace.json"))

"""Checkpoints of a Trainer's full state with ``torch.save`` (counterpart
of ``ebnerd_tpu/training/checkpoint.py``, which saves with orbax).

A checkpoint is ``Trainer.state_dict()``: the model's parameters, the
optimizer's state (Adam's moments, its step and the learning rate), the
trainer's step count, the dropout-seed generator's state and any
gradients accumulated toward the next update. It lives in
``directory/step_<n>/state.pt`` (or ``directory/best``), written under a
temporary name and moved into place by ``os.replace``: a save cut short
leaves only a ``.tmp-*`` directory, which ``latest_step``, the manager
and resume ignore.
"""
from __future__ import annotations

import os
import shutil
import tempfile
from pathlib import Path
from typing import Optional

import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "CheckpointManager"]

_STATE_FILE = "state.pt"


def _step_of(name: str) -> Optional[int]:
    """n for a directory named ``step_<n>``, else None."""
    if not name.startswith("step_"):
        return None
    try:
        return int(name[len("step_"):])
    except ValueError:
        return None


def save_checkpoint(trainer, directory, step: Optional[int] = None) -> Path:
    """Write ``trainer.state_dict()`` under ``directory/step_<n>`` (or
    ``directory/best`` when step is None), atomically, replacing one there."""
    directory = Path(directory).resolve()
    directory.mkdir(parents=True, exist_ok=True)
    name = "best" if step is None else f"step_{step}"
    path = directory / name
    tmp = Path(tempfile.mkdtemp(prefix=f".tmp-{name}-", dir=directory))
    try:
        torch.save(trainer.state_dict(), tmp / _STATE_FILE)
        if path.exists():  # move the old one aside, then the new one in
            old = Path(tempfile.mkdtemp(prefix=f".tmp-old-{name}-", dir=directory))
            os.replace(path, old / name)
            os.replace(tmp, path)
            shutil.rmtree(old)
        else:
            os.replace(tmp, path)
    finally:
        if tmp.exists():
            shutil.rmtree(tmp)
    return path


def restore_checkpoint(trainer, directory, step: Optional[int] = None) -> dict:
    """The state saved under ``directory/step_<n>`` (or ``best``), its
    tensors on ``trainer.device``; apply it with
    ``trainer.load_state_dict``."""
    name = "best" if step is None else f"step_{step}"
    path = Path(directory).resolve() / name / _STATE_FILE
    return torch.load(path, map_location=trainer.device, weights_only=True)


def _steps_on_disk(directory: Path) -> list[int]:
    if not directory.exists():
        return []
    return sorted(s for s in (_step_of(p.name) for p in directory.iterdir()) if s is not None)


def latest_step(directory) -> Optional[int]:
    """Largest step_<n> checkpoint present, or None."""
    steps = _steps_on_disk(Path(directory))
    return steps[-1] if steps else None


class CheckpointManager:
    """Best-metric gating + periodic checkpoints for a Trainer.

    Mirrors the reference's ModelCheckpoint(save_best_only) semantics on
    top of full-state saves; ``keep`` bounds how many step checkpoints
    stay on disk, counting those a previous process left there.
    """

    def __init__(self, directory, keep: int = 3):
        self.directory = Path(directory)
        self.keep = keep
        self._saved_steps: list[int] = _steps_on_disk(self.directory)

    def save_step(self, trainer, step: int) -> Path:
        path = save_checkpoint(trainer, self.directory, step=step)
        if step not in self._saved_steps:
            self._saved_steps.append(step)
        while len(self._saved_steps) > self.keep:
            old = self._saved_steps.pop(0)
            self._remove(f"step_{old}")
        return path

    def save_best(self, trainer) -> Path:
        return save_checkpoint(trainer, self.directory, step=None)

    def restore_best(self, trainer) -> dict:
        return restore_checkpoint(trainer, self.directory, step=None)

    def restore_latest(self, trainer):
        """(state, step) of the newest step checkpoint, or (None, None)."""
        step = latest_step(self.directory)
        if step is None:
            return None, None
        return restore_checkpoint(trainer, self.directory, step=step), step

    def _remove(self, name: str) -> None:
        path = self.directory / name
        if path.exists():
            shutil.rmtree(path)

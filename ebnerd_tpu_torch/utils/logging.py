"""Training observability (counterpart of ``ebnerd_tpu/utils/logging.py``):
scalar logging, step timing, spans and profiler traces.

Scalars always go to a JSONL file (greppable, dependency-free); a
TensorBoard event file is written too when a SummaryWriter
implementation is importable. ``StepTimer`` synchronises the result's
CUDA device before it reads the clock (the JAX one blocks on the result);
``trace_profile`` records ``torch.profiler`` and writes a Chrome trace and
the block's spans.

``span(name, batch)`` marks a stretch of host work (the training loop's
boundaries, ``training/trainer.py``). It records only while a
``torch.profiler`` session records, so it adds no option: ``trace_profile``
or an operator's own profiler turns the spans on, and off each costs one
check of a flag. On, a span enters ``record_function(name)`` where this
thread is traced (the thread that started the session; a Python thread
started by the program is not, so its spans are records alone), appends a
record (name, batch id, thread, start and end, the enclosing span on the
same thread) to a store of the newest ``SPAN_RECORDS``, and adds its host
seconds to ``span_totals()``. Records are stamped in Unix-epoch
nanoseconds, the clock of the profiler's trace
(``prof.profiler.kineto_results.trace_start_ns()`` plus an event's
microseconds), so a record lines up with the kernels and idle gaps of the
same trace. A span that an exception leaves records nothing (a feed's
end, ``StopIteration``, is no batch). Names hold no ``#``, which the
profiler's own ranges carry (``Optimizer.step#Adam.step``).
"""
from __future__ import annotations

import collections
import json
import threading
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Optional

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["ScalarLogger", "StepTimer", "trace_profile", "span", "span_totals", "span_records",
           "reset_spans", "SPAN_RECORDS"]

SPAN_RECORDS = 1 << 16  # records kept; the totals count every span


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
    (open it with Perfetto or chrome://tracing), and beside it the block's
    spans, ``spans.json``: ``totals`` ({name: [count, seconds]}) and
    ``records`` (``span_records()``, on the trace's clock)."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    reset_spans()
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(str(log_dir / "trace.json"))
    (log_dir / "spans.json").write_text(json.dumps({"totals": span_totals(),
                                                    "records": span_records()}))


# -- spans ----------------------------------------------------------------

_lock = threading.Lock()
_local = threading.local()
_records: collections.deque = collections.deque(maxlen=SPAN_RECORDS)
_totals: dict = {}         # name -> [count, seconds]
_offset_ns: Optional[int] = None  # epoch ns - perf_counter ns, taken at the first record


class _Off:
    """The span while no profiler records: binds None and does nothing."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class Span:
    """A recording span; ``with span(...) as s`` binds it (None when off).
    ``batch`` may be set before the span ends."""
    __slots__ = ("name", "batch", "parent", "_range", "_t0")

    def __init__(self, name: str, batch):
        if "#" in name:
            raise ValueError(f"span {name!r}: a span's name holds no '#'")
        self.name, self.batch = name, batch

    def __enter__(self) -> "Span":
        self._range = None
        if torch.autograd._profiler_enabled():  # this thread is traced
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        stack = _local.__dict__.setdefault("stack", [])
        self.parent = stack[-1].name if stack else None
        stack.append(self)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, kind, exc, tb) -> bool:
        t1 = time.perf_counter_ns()
        _local.stack.pop()
        if self._range is not None:
            self._range.__exit__(kind, exc, tb)
        if kind is None:
            _add(self, t1)
        return False


def _add(s: Span, t1: int) -> None:
    global _offset_ns
    thread = threading.current_thread().name
    with _lock:
        if _offset_ns is None:
            _offset_ns = time.time_ns() - time.perf_counter_ns()
        _records.append((s.name, s.batch, thread, s.parent, s._t0 + _offset_ns, t1 + _offset_ns))
        total = _totals.setdefault(s.name, [0, 0.0])
        total[0] += 1
        total[1] += (t1 - s._t0) / 1e9


def span(name: str, batch=None):
    """A span of host work named ``name`` over batch ``batch`` (a context
    manager); it records only while a ``torch.profiler`` session records."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return Span(name, batch)


def span_totals() -> dict:
    """{name: (count, host seconds)} of every span recorded since
    ``reset_spans``."""
    with _lock:
        return {k: (c, sec) for k, (c, sec) in _totals.items()}


def span_records() -> list:
    """The newest ``SPAN_RECORDS`` spans, oldest first: dicts of ``name``,
    ``batch``, ``thread``, ``parent`` (the enclosing span's name on the same
    thread, or None), ``start_ns`` and ``end_ns`` (Unix-epoch nanoseconds,
    the profiler trace's clock)."""
    with _lock:
        rows = list(_records)
    keys = ("name", "batch", "thread", "parent", "start_ns", "end_ns")
    return [dict(zip(keys, r)) for r in rows]


def reset_spans() -> None:
    """Forget every record and total; the next record takes the clock's
    offset anew."""
    global _offset_ns
    with _lock:
        _records.clear()
        _totals.clear()
        _offset_ns = None

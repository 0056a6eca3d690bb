"""The harness: one run of one cell of ``BENCHMARK.json``.

Everything that belongs to one configuration, traffic mix or metric sits
in files of its own that the harness finds by name:

- ``BENCHMARK.json``'s configuration entry names its file (under
  ``configs/``), which names the system under test (``systems/<system>.py``,
  its class ``System``) and the plain reference (``references/<reference>.py``);
- a cell's ``traffic`` is ``traffic/<traffic>.json``, read by the one
  generator ``traffic.py``;
- a per-layer metric ``<name>`` is read by ``metrics/<name>.py``'s
  ``read(ctx)``, which returns None where it finds nothing to read;
- the kernel-name table is ``parts/*.json`` (``devtrace.py``);
- a cell's limits for ``correct`` are ``limits/<cell>.json``.

A run: make the data and the weights from the seed, build the system,
drive its first ``CHECK_STEPS`` steps and read what the reference is
compared on, warm up, then measure ``seconds`` (traced by
``torch.profiler`` with ``trace``). After the window: the device's peak
memory, the system freed, the reference over the same first steps, and
each compared number beside its limit.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from . import devtrace, traffic, work

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ebnerd_tpu")
CHECK_STEPS = 3   # steps the reference follows
WARMUP = 2        # further warm-up steps before the window
NUMBERS = ("loss_gap", "grad_gap", "change_gap")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def sub_seed(seed: int, i: int) -> int:
    """The ``i``-th 63-bit seed derived from a run's ``--seed``."""
    lo, hi = np.random.SeedSequence([seed % (1 << 64), i]).generate_state(2, np.uint32)
    return ((int(hi) << 32) | int(lo)) & ((1 << 63) - 1)


def load_cell(name: str) -> SimpleNamespace:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration, mix,
    limits (None where the cell has no limits file) and metric entries."""
    spec = load_json(REPO / "BENCHMARK.json")
    cell = next((w for w in spec["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    limits_path = HERE / "limits" / f"{name}.json"

    def applies(m: dict) -> bool:
        return name in m["workloads"] if "workloads" in m else True

    e2e = [m for m in spec["end_to_end"] if applies(m)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if applies(m) and m["moves"] in moved]
    return SimpleNamespace(name=name, chips=cell["chips"], cfg=load_json(REPO / entry["file"]),
                           mix=load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
                           limits=load_json(limits_path) if limits_path.exists() else None,
                           end_to_end=e2e, per_layer=per_layer)


def system_of(cfg: dict):
    return importlib.import_module(f"benchmark.systems.{cfg['system']}").System


def reference_of(cfg: dict):
    return importlib.import_module(f"benchmark.references.{cfg['reference']}")


def reader(name: str):
    """``read`` of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def made(cell: SimpleNamespace, seed: int, device) -> tuple:
    """(data, weights, trainer seed, feed seed) of a run, from its seed."""
    data = traffic.make(cell.mix, cell.cfg, sub_seed(seed, 0), device)
    weights = reference_of(cell.cfg).make_weights(cell.cfg, sub_seed(seed, 1), device)
    return data, weights, sub_seed(seed, 2), sub_seed(seed, 3)


def compare(prog: dict, ref: dict) -> dict:
    """The numbers compared: the widest relative gap of a step's loss; the
    worst weight's gap between the first gradient's norms, and between the
    norms of the change after the last step, each over the reference's
    norm of that weight or of the median weight, whichever is larger.
    Weights whose first gradient in the reference is under a thousandth of
    the median weight's (moved by round-off alone under Adam) are left out
    of the change."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    g = ref["grad_norms"]
    g_med = statistics.median(g.values())
    grad = max(abs(prog["grad_norms"][k] - g[k]) / max(g[k], g_med) for k in g)
    moved = [k for k in g if g[k] >= 1e-3 * g_med]
    c = ref["change_norms"]
    c_med = statistics.median(c[k] for k in moved)
    change = max(abs(prog["change_norms"][k] - c[k]) / max(c[k], c_med) for k in moved)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}


def checks(gaps: dict, limits: Optional[dict]) -> tuple:
    """(correct, {number: {"value", "limit"}}): correct when every compared
    number is within its limit. A number whose limit is null in the cell's
    limits file is not compared (it has no upper reading); a cell without a
    limits file is never correct."""
    if limits is None:
        return False, {k: {"value": gaps[k], "limit": None} for k in NUMBERS}
    out = {k: {"value": gaps[k], "limit": limits[k]["limit"]} for k in NUMBERS
           if limits[k]["limit"] is not None}
    for k in NUMBERS:
        if k not in out:
            log(f"not compared {k} {gaps[k]!r}")
    return all(v["value"] <= v["limit"] for v in out.values()), out


def free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


class _Laps:
    """Set-up phases on the host clock, logged to standard error."""

    def __init__(self, t0: float):
        self.t = t0

    def __call__(self, what: str) -> None:
        now = time.perf_counter()
        log(f"set-up: {what}: {now - self.t:.3f} s")
        self.t = now


def run_cell(cell: SimpleNamespace, seed: int, seconds: float, trace: bool, device="cuda",
             t0: Optional[float] = None) -> dict:
    """One run; returns the result line's object."""
    t0 = time.perf_counter() if t0 is None else t0
    cuda = torch.device(device).type == "cuda"
    lap = _Laps(t0)
    data, weights, trainer_seed, feed_seed = made(cell, seed, device)
    lap("data and weights made")
    system = system_of(cell.cfg)(cell.cfg, cell.mix, data, weights, trainer_seed, feed_seed,
                                 device)
    lap("system built (" + ", ".join(f"{k} {v:.3f} s" for k, v in system.laps.items()) + ")")
    prog = system.first_steps(weights, CHECK_STEPS)
    del weights
    lap(f"first {CHECK_STEPS} steps read")
    system.fit(limit=WARMUP)
    lap(f"{WARMUP} warm-up steps")
    host_spans: dict = {}
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        system.instrument(host_spans)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts) as prof:
            win = system.window(seconds)
    else:
        win = system.window(seconds)
    setup_s = win["start"] - t0
    kept = system.stream.kept or []
    peak_bytes = torch.cuda.max_memory_allocated() if cuda else 0
    del system
    free()
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(peak_bytes)}
    metrics, breakdown = {}, None
    if trace:
        tr = devtrace.reduce(prof, devtrace.load_parts())
        del prof
        ctx = SimpleNamespace(cfg=cell.cfg, mix=cell.mix, trace=tr, window_s=win["seconds"],
                              steps=win["steps"], batches=kept, host_spans=host_spans,
                              peak=work.peaks(device_info["kind"]))
        for m in cell.per_layer:
            value = reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=tr.busy_s, window_s=win["seconds"])
        breakdown = {"device_ops": sorted(map(list, tr.part_s.items()), key=lambda kv: -kv[1])[:10],
                     "idle_gaps": sorted(map(list, tr.gaps_by_host.items()),
                                         key=lambda kv: -kv[1])[:10]}
    else:
        values = dict(win["metrics"], setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    del kept
    reference = reference_of(cell.cfg)
    weights = reference.make_weights(cell.cfg, sub_seed(seed, 1), device)
    t_ref = time.perf_counter()
    ref = reference.train(cell.cfg, cell.mix, data, weights, trainer_seed, feed_seed, CHECK_STEPS)
    log(f"reference: {time.perf_counter() - t_ref:.3f} s")
    correct, compared = checks(compare(prog, ref), cell.limits)
    for k, v in compared.items():
        log(f"check {k} {v['value']!r} limit {v['limit']!r}")
    out = {"correct": correct and win["finite"], "attempted": win["steps"],
           "failed": 0 if win["finite"] else win["steps"], "metrics": metrics,
           "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = compared  # last: the numbers compared beside their limits
    return out


def forbidden_modules() -> list:
    """Modules of JAX, flax, optax or the JAX package loaded in this
    process, by whole top-level name."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})

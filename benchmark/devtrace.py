"""Reading a ``torch.profiler`` trace of the measured window: the device's
kernels, each assigned to a part of the step by the name table
(``parts/*.json``), the device's busy time as the union of kernel
intervals, the device spans of annotated ranges (the optimizer's
``Optimizer.step#...``), and the idle gaps between kernels, each named by
what the host's main thread was doing then. The arithmetic of the busy
union and of the gaps is that of the port's ``tools/step_profile.py``.

A part file holds ``name`` (the part), ``patterns`` (substrings of kernel
names) and ``groups`` (the sets a metric sums, such as "encoder"). A
kernel belongs to the part of the longest pattern found in its name, ties
to the part whose name sorts first; one that no pattern finds is "other".
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

import torch

PARTS_DIR = Path(__file__).resolve().parent / "parts"
HOST_PREFIX = "fit."  # the benchmark's own host ranges (``record_function``)


def load_parts(folder: Path = PARTS_DIR) -> list:
    """Every part file of ``folder``, as (name, patterns, groups)."""
    out = []
    for path in sorted(folder.glob("*.json")):
        d = json.loads(path.read_text())
        out.append((d["name"], tuple(d["patterns"]), tuple(d.get("groups", ()))))
    return out


def part_of(name: str, parts: list) -> tuple:
    """(part, groups) of the kernel called ``name``."""
    best, best_key = ("other", ()), None
    for part, patterns, groups in parts:
        for pat in patterns:
            key = (-len(pat), part)
            if pat in name and (best_key is None or key < best_key):
                best, best_key = (part, groups), key
    return best


def busy_us(spans: list) -> float:
    """Union of the intervals ``spans`` [(start, end)], in their unit."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(spans: list) -> list:
    """The device's idle gaps [(start, end)] between the intervals ``spans``."""
    out, end = [], None
    for s, e in sorted(spans):
        if end is not None and s > end:
            out.append((end, s))
        if end is None or e > end:
            end = e
    return out


@dataclass
class Trace:
    """A window's trace, reduced. Times are seconds."""
    kernels: int = 0                                  # kernels in the window
    busy_s: float = 0.0
    part_s: dict = field(default_factory=dict)        # part -> seconds
    group_s: dict = field(default_factory=dict)       # group -> seconds
    annotation_s: dict = field(default_factory=dict)  # annotated range -> device seconds
    gaps_by_host: dict = field(default_factory=dict)  # host activity -> idle seconds


def _host_names(gaps: list, cpu: list) -> list:
    """For each gap, what the main thread was doing at its midpoint: the
    benchmark's outermost host range and the innermost operator in it."""
    main = {e.thread for e in cpu if e.name.startswith(HOST_PREFIX)}
    events = sorted((e.time_range.start, e.time_range.end, e.name) for e in cpu
                    if e.thread in main)
    order = sorted(range(len(gaps)), key=lambda i: (gaps[i][0] + gaps[i][1]) / 2)
    names = [""] * len(gaps)
    active, j = [], 0
    for i in order:
        mid = (gaps[i][0] + gaps[i][1]) / 2
        while j < len(events) and events[j][0] <= mid:
            active.append(events[j])
            j += 1
        active = [ev for ev in active if ev[1] >= mid]
        outer = next((ev[2] for ev in active if ev[2].startswith(HOST_PREFIX)), "fit loop")
        inner = max(active, key=lambda ev: ev[0])[2] if active else ""
        names[i] = outer if inner in ("", outer) else f"{outer} > {inner}"
    return names


def reduce(prof, parts: list) -> Trace:
    """The ``Trace`` of a finished ``torch.profiler.profile``."""
    events = prof.events()
    cuda = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    cpu = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    tr = Trace()
    spans = []
    for e in cuda:
        start, end = e.time_range.start, e.time_range.end
        if getattr(e, "is_user_annotation", False) or "#" in e.name:
            tr.annotation_s[e.name] = tr.annotation_s.get(e.name, 0.0) + (end - start) / 1e6
            continue
        part, groups = part_of(e.name, parts)
        tr.kernels += 1
        spans.append((start, end))
        tr.part_s[part] = tr.part_s.get(part, 0.0) + (end - start) / 1e6
        for g in groups:
            tr.group_s[g] = tr.group_s.get(g, 0.0) + (end - start) / 1e6
    tr.busy_s = busy_us(spans) / 1e6
    gaps = idle_gaps(spans)
    for (s, e), name in zip(gaps, _host_names(gaps, cpu)):
        tr.gaps_by_host[name] = tr.gaps_by_host.get(name, 0.0) + (e - s) / 1e6
    return tr

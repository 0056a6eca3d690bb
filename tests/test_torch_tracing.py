"""The port's spans (``utils/logging.span``): off, a span leaves no record,
no total and enters no profiler range; on, under ``torch.profiler``, each
span on the profiled thread yields one record and one CPU event of its
name, on the trace's own clock, a nested span names its parent, spans of
other threads land in the totals, and ``trace_profile`` writes them as
``spans.json``. All on the CPU."""
import json
import os
import sys
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ebnerd_tpu_torch.utils import logging as plog

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def fresh():
    plog.reset_spans()
    yield
    plog.reset_spans()


def _work():
    a = torch.randn(32, 32)
    return (a @ a).sum()


def test_off_a_span_records_nothing(monkeypatch):
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name) or pytest.fail("entered a range"))
    with plog.span("t.off", 3) as s:
        _work()
    assert s is None
    assert plog.span_totals() == {} and plog.span_records() == [] and entered == []


def test_on_each_span_is_one_record_and_one_event_on_the_trace_clock():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with plog.span("t.outer", 1) as outer:
            _work()
            with plog.span("t.inner", 1):
                _work()
        with plog.span("t.later") as later:
            later.batch = 2
    assert outer is not None and outer.name == "t.outer"
    records = plog.span_records()
    assert [(r["name"], r["batch"], r["parent"]) for r in records] == [
        ("t.inner", 1, "t.outer"), ("t.outer", 1, None), ("t.later", 2, None)]
    assert {r["thread"] for r in records} == {threading.current_thread().name}
    events = {}
    for e in prof.events():
        if e.name.startswith("t."):
            events.setdefault(e.name, []).append(e)
    assert {k: len(v) for k, v in events.items()} == {"t.outer": 1, "t.inner": 1, "t.later": 1}
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    for r in records:
        ev = events[r["name"]][0]
        lo = start_ns + ev.time_range.start * 1000
        hi = start_ns + ev.time_range.end * 1000
        assert lo - 1e6 <= r["start_ns"] <= r["end_ns"] <= hi + 1e6, (r, lo, hi)
    totals = plog.span_totals()
    assert {k: v[0] for k, v in totals.items()} == {"t.outer": 1, "t.inner": 1, "t.later": 1}
    assert totals["t.outer"][1] >= totals["t.inner"][1] > 0
    assert totals["t.outer"][1] == pytest.approx((records[1]["end_ns"] - records[1]["start_ns"])
                                                 / 1e9, abs=1e-6)


def test_spans_of_two_threads_land_in_the_totals():
    def worker():
        for i in range(3):
            with plog.span("t.worker", i):
                with plog.span("t.worker_part", i):
                    _work()

    with profile(activities=[ProfilerActivity.CPU]):
        t = threading.Thread(target=worker, name="t-worker")
        t.start()
        for i in range(2):
            with plog.span("t.main", i):
                _work()
        t.join(timeout=60)
    assert not t.is_alive()
    totals = plog.span_totals()
    assert {k: v[0] for k, v in totals.items()} == {"t.worker": 3, "t.worker_part": 3,
                                                    "t.main": 2}
    by_name = {}
    for r in plog.span_records():
        by_name.setdefault(r["name"], []).append(r)
    assert {r["thread"] for r in by_name["t.worker"]} == {"t-worker"}
    assert [r["parent"] for r in by_name["t.worker_part"]] == ["t.worker"] * 3
    assert [r["batch"] for r in by_name["t.worker"]] == [0, 1, 2]
    assert {r["parent"] for r in by_name["t.main"]} == {None}


def test_threads_racing_lose_no_span():
    n_threads, n_spans = 4 * (os.cpu_count() or 1), 500

    def worker():
        for i in range(n_spans):
            with plog.span("t.race", i):
                pass

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            threads = [threading.Thread(target=worker) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert plog.span_totals()["t.race"][0] == n_threads * n_spans
    assert len(plog.span_records()) == min(n_threads * n_spans, plog.SPAN_RECORDS)


def test_a_span_left_by_an_exception_records_nothing():
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(StopIteration):
            with plog.span("t.end", 9):
                next(iter(()))
        with plog.span("t.after", 10) as s:
            pass
    assert [r["name"] for r in plog.span_records()] == ["t.after"]
    assert s.parent is None


def test_a_name_with_a_hash_is_refused_when_on():
    with plog.span("t#off"):  # off: not looked at
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError, match="#"):
            plog.span("t#on")


def test_the_store_keeps_the_newest_records_and_counts_all():
    def worker():
        for i in range(plog.SPAN_RECORDS + 5):
            with plog.span("t.many", i):
                pass

    with profile(activities=[ProfilerActivity.CPU]):
        t = threading.Thread(target=worker)  # not traced: records alone, no range
        t.start()
        t.join(timeout=120)
    assert not t.is_alive()
    records = plog.span_records()
    assert len(records) == plog.SPAN_RECORDS
    assert records[0]["batch"] == 5 and records[-1]["batch"] == plog.SPAN_RECORDS + 4
    assert plog.span_totals()["t.many"][0] == plog.SPAN_RECORDS + 5
    plog.reset_spans()
    assert plog.span_totals() == {} and plog.span_records() == []


def test_trace_profile_writes_the_spans(tmp_path):
    with plog.span("t.before"):  # off: outside the block
        pass
    with plog.trace_profile(tmp_path / "trace"):
        with plog.span("t.step", 7):
            _work()
    out = json.loads((tmp_path / "trace" / "spans.json").read_text())
    assert list(out["totals"]) == ["t.step"] and out["totals"]["t.step"][0] == 1
    assert [(r["name"], r["batch"]) for r in out["records"]] == [("t.step", 7)]
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert "t.step" in {e.get("name") for e in trace["traceEvents"]}

"""The readers of the program's spans (``metrics/fit.wait_ms.py``,
``fit.prepare_ms``, ``step.host_ms``, ``host.feed_ms``,
``device.idle_wait_pct``) against a fake context and filled totals, and
None where nothing was recorded or the program has no spans; then a traced
run on the CPU at a tiny size, which reads the four host metrics."""
from types import SimpleNamespace

import pytest

from benchmark import core
from benchmark.tests.conftest import tiny
from ebnerd_tpu_torch.utils import logging as plog

TOTALS = {"trainer.wait": (10, 0.02), "trainer.prepare": (10, 0.005), "trainer.step": (10, 2.5),
          "trainer.epoch_end": (1, 0.1), "feed.batch": (11, 0.77), "feed.prep": (11, 0.7)}
GAPS = {"fit loop > trainer.wait": 0.03, "fit.step": 0.02, "fit loop": 0.01,
        "fit.step > trainer.wait": 0.004}


def ctx(kernels=100, window_s=2.0, gaps=GAPS):
    return SimpleNamespace(window_s=window_s, steps=10,
                           trace=SimpleNamespace(kernels=kernels, gaps_by_host=dict(gaps)))


@pytest.fixture
def totals(monkeypatch):
    def fill(values):
        monkeypatch.setattr(plog, "span_totals", lambda: dict(values))
    return fill


@pytest.mark.parametrize("name, want", [("fit.wait_ms", 2.0), ("fit.prepare_ms", 0.5),
                                        ("step.host_ms", 250.0), ("host.feed_ms", 70.0),
                                        ("device.idle_wait_pct", 1.7)])
def test_a_reader_reads_the_totals(totals, name, want):
    totals(TOTALS)
    assert core.reader(name)(ctx()) == pytest.approx(want)


@pytest.mark.parametrize("name", ["fit.wait_ms", "fit.prepare_ms", "step.host_ms",
                                  "host.feed_ms", "device.idle_wait_pct"])
def test_nothing_recorded_reads_none(totals, monkeypatch, name):
    read = core.reader(name)
    totals({})
    assert read(ctx()) is None
    totals({k: (0, 0.0) for k in TOTALS})
    assert read(ctx()) is None
    monkeypatch.delattr(plog, "span_totals")  # a program without spans
    assert read(ctx()) is None


def test_the_idle_wait_needs_a_device_trace(totals):
    totals(TOTALS)
    read = core.reader("device.idle_wait_pct")
    assert read(ctx(kernels=0)) is None and read(ctx(window_s=0.0)) is None
    assert read(ctx(gaps={"fit.step": 0.5})) == 0.0


def test_the_wait_is_over_the_steps(totals):
    totals({"trainer.wait": (4, 0.04)})
    assert core.reader("fit.wait_ms")(ctx()) is None  # no step
    totals({"trainer.wait": (4, 0.04), "trainer.step": (2, 1.0)})
    assert core.reader("fit.wait_ms")(ctx()) == pytest.approx(20.0)


def test_a_traced_run_reads_the_span_metrics():
    plog.reset_spans()
    cell = tiny("nrms-bf16.h20")
    cell.per_layer = [m for m in cell.per_layer
                      if m["name"] in ("fit.wait_ms", "fit.prepare_ms", "step.host_ms",
                                       "host.feed_ms", "host.dedup_ms", "device.idle_wait_pct")]
    out = core.run_cell(cell, 2**31 + 11, 0.5, True, "cpu")
    got = {k: v["value"] for k, v in out["metrics"].items()}
    # the CPU has no device trace: no idle gaps to name
    assert set(got) == {"fit.wait_ms", "fit.prepare_ms", "step.host_ms", "host.feed_ms",
                        "host.dedup_ms"}
    assert all(v >= 0 for v in got.values()) and got["step.host_ms"] > 0
    assert got["host.feed_ms"] >= got["host.dedup_ms"]
    plog.reset_spans()

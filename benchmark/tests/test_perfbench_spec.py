"""BENCHMARK.json and every file the harness finds by name: present,
parsable, and within the benchmark contract's rules for names, units and
limits."""
import json
import re

import pytest

from benchmark import core, devtrace

SPEC = core.load_json(core.REPO / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                         "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)


def test_names_units_and_lines():
    names = ([c["name"] for c in SPEC["configs"]] + [w["name"] for w in SPEC["workloads"]]
             + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
             + [w["traffic"] for w in SPEC["workloads"]])
    assert all(NAME.match(n) for n in names), names
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    texts = ([w["why"] for w in SPEC["workloads"]] + [c["why"] for c in SPEC["configs"]]
             + [c["source"] for c in SPEC["configs"]] + [m["layer"] for m in SPEC["per_layer"]])
    assert all(LINE.match(t) for t in texts)
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_metrics_and_bounds():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
               for m in e2e.values())
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        assert (core.HERE / "metrics" / f"{m['name']}.py").exists()
    cells = {w["name"] for w in SPEC["workloads"]}
    assert all(set(m.get("workloads", cells)) <= cells for m in SPEC["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_files(cell):
    c = core.load_cell(cell)
    assert c.chips == 1
    assert c.limits is not None and all(c.limits[k]["limit"] is None or c.limits[k]["limit"] > 0
                                        for k in core.NUMBERS)
    assert any(c.limits[k]["limit"] for k in core.NUMBERS)
    assert {"batch_size", "npratio", "history_size", "articles", "table_batches"} <= set(c.mix)
    assert core.system_of(c.cfg) and core.reference_of(c.cfg)
    assert [m["name"] for m in c.end_to_end][:1] and c.per_layer


def test_config_files():
    for entry in SPEC["configs"]:
        assert entry["file"].startswith("benchmark/configs/")
        cfg = core.load_json(core.REPO / entry["file"])
        assert entry["reduced"] == [] and cfg["compute_dtype"] in ("float32", "bfloat16")
        assert cfg["control"] == {"float32": "tf32", "bfloat16": "fp8"}[cfg["compute_dtype"]]


def test_part_files():
    parts = devtrace.load_parts()
    assert len({p[0] for p in parts}) == len(parts)
    assert devtrace.part_of("void tiled_attention_bwd_staged_kernel<float>", parts)[0] == \
        "T4 tiled_attention_bwd"
    assert devtrace.part_of("tiled_attention_staged_kernel", parts)[1] == \
        ("encoder", "tiled_attention")
    assert devtrace.part_of("bwd_gemm_tf32x3_kernel", parts)[0] == "K2 GEMM"
    assert devtrace.part_of("something unknown", parts) == ("other", ())

"""The port's ``utils/logging.py``: ``ScalarLogger`` writes the JAX
logger's JSONL records; ``StepTimer`` times like the JAX one and
synchronises only CUDA devices (none here); ``trace_profile`` writes a
Chrome trace of the block into ``log_dir``."""
import json
import time

import torch

from ebnerd_tpu.utils.logging import ScalarLogger as JScalarLogger
from ebnerd_tpu.utils.logging import StepTimer as JStepTimer
from ebnerd_tpu_torch.utils import logging as plog

torch.set_num_threads(1)


def test_scalar_logger_writes_the_jax_records(tmp_path):
    for cls, sub in ((JScalarLogger, "j"), (plog.ScalarLogger, "p")):
        with cls(tmp_path / sub, tensorboard=False) as lg:
            lg.log("loss", 0.5, 1)
            lg.log_dict({"auc": 0.7, "name": "skipped", "n": 3}, step=2)
    rows = {s: [{k: v for k, v in json.loads(ln).items() if k != "ts"}
                for ln in (tmp_path / s / "scalars.jsonl").read_text().splitlines()]
            for s in ("j", "p")}
    assert rows["p"] == rows["j"] == [{"tag": "loss", "value": 0.5, "step": 1},
                                      {"tag": "auc", "value": 0.7, "step": 2},
                                      {"tag": "n", "value": 3.0, "step": 2}]


def test_step_timer_times_and_averages():
    jt, pt = JStepTimer(), plog.StepTimer()
    assert pt.mean == jt.mean == 0.0
    for _ in range(2):
        pt.start()
        time.sleep(0.02)
        dt = pt.stop({"loss": torch.ones(2), "parts": [torch.zeros(1), 3]})
        assert dt >= 0.01
    assert len(pt.history) == 2 and pt.mean == sum(pt.history) / 2
    pt.start()
    assert pt.stop() >= 0.0 and len(pt.history) == 3
    assert plog._cuda_devices({"a": [torch.ones(1)], "b": (1, "x")}) == set()


def test_trace_profile_writes_a_chrome_trace(tmp_path):
    with plog.trace_profile(tmp_path / "trace"):
        a = torch.randn(64, 64)
        (a @ a).sum()
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::matmul" in names or "aten::mm" in names
    with plog.trace_profile(tmp_path / "off", enabled=False):
        pass
    assert not (tmp_path / "off").exists()

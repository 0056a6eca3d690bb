"""One short run of a cell on the card, as the driver runs it (``chip``:
skips without a CUDA card)."""
import json
import subprocess
import sys

import pytest
import torch

from benchmark import core


@pytest.mark.chip
def test_a_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run([sys.executable, str(core.HERE / "run.py"), "--workload",
                           "nrms-bf16.h20", "--seed", str(2**31 + 21), "--seconds", "2",
                           "--trace", "0"], capture_output=True, text=True, timeout=1500,
                          cwd=core.REPO)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"

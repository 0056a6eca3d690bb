"""The plain reference against the port's ``device="cpu"`` step (its plain
versions) at a tiny width, and the reference's frozen Philox copy against
the port's masks."""
import pytest
import torch

from benchmark import core, readings
from benchmark.references import philox
from benchmark.tests.conftest import tiny


@pytest.mark.parametrize("seed", [7, 2**31 + 11])
@pytest.mark.parametrize("name", ["nrms-fp32.h20", "nrms-fp32.h50"])
def test_reference_follows_the_port_on_the_cpu(name, seed):
    cell = tiny(name)
    (kind, gaps, leaves), = readings.readings(cell, seed, "cpu", True, False, False)
    assert kind == "program"
    # both fp32 on the CPU: only the order of sums differs
    assert gaps["loss_gap"] < 1e-5 and gaps["grad_gap"] < 1e-4 and gaps["change_gap"] < 1e-4
    assert all(v[0] > 0 and v[2] > 0 for v in leaves.values())


@pytest.mark.parametrize("stream,width,row0", [(0, 32, 0), (1, 8, 45), (0, 1030, 3)])
def test_philox_copy_matches_the_port(stream, width, row0):
    from ebnerd_tpu_torch.ops import philox as port

    seed = 0x9E3779B97F4A7C15
    ours = philox.mask(seed, stream, 90, width, 0.8, row0)
    theirs = port.mask(seed, stream, 90, width, 0.8, row0=row0)
    torch.testing.assert_close(ours, theirs, rtol=0, atol=0)


def test_step_seeds_are_the_trainers():
    from ebnerd_tpu_torch.training import Trainer, TrainerConfig  # noqa: F401

    from ebnerd_tpu_torch.models import NRMS, HParamsNRMS, token_batch
    from benchmark.references import nrms

    model = NRMS(HParamsNRMS(), vocab_size=10, word_emb_dim=8, device="cpu")
    trainer = Trainer(model, {"title": torch.zeros(3, 30, dtype=torch.long)}, token_batch,
                      TrainerConfig(seed=2**40 + 3), device="cpu")
    assert nrms.step_seeds(2**40 + 3, 3) == [trainer.next_seed() for _ in range(3)]


def test_compare_reads_each_number():
    ref = {"losses": [2.0, 2.0, 2.0], "grad_norms": {"a": 1.0, "b": 2.0, "c": 1e-9},
           "change_norms": {"a": 1.0, "b": 1.0, "c": 5.0}}
    prog = {"losses": [2.0, 2.2, 2.0], "grad_norms": {"a": 1.1, "b": 2.0, "c": 0.5},
            "change_norms": {"a": 1.0, "b": 1.5, "c": 0.0}}
    gaps = core.compare(prog, ref)
    assert gaps["loss_gap"] == pytest.approx(0.1)
    assert gaps["grad_gap"] == pytest.approx(0.5)   # c's gap over the median weight's norm, 1
    assert gaps["change_gap"] == pytest.approx(0.5)  # c is left out: its gradient is round-off

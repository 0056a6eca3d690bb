"""A run with the timed path broken underneath comes out not correct, once
for each fault a training cell can have, and a sound run comes out
correct; so does the control, the reference in the precision below the
configuration's in the program's place. All on the CPU at a tiny size,
past the harness's look for a card, against the cell's own limits."""
import pytest
import torch

from benchmark import core
from benchmark.tests.conftest import tiny


def run(cell):
    return core.run_cell(cell, 2**31 + 3, 0.3, False, "cpu")


def test_a_sound_run_is_correct():
    out = run(tiny("nrms-fp32.h20"))
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert set(out) == {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"train_imp_s", "setup_s"}


def _frozen(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def _half_batch(monkeypatch):
    from ebnerd_tpu_torch.training import trainer as mod

    loss_for = mod.loss_fn_for

    def half(name):
        fn = loss_for(name)
        return lambda logits, labels: fn(logits[: len(logits) // 2], labels[: len(labels) // 2])

    monkeypatch.setattr(mod, "loss_fn_for", half)


def _altered_answer(monkeypatch):
    from ebnerd_tpu_torch.models import newsrec

    scores = newsrec._dot_scores
    monkeypatch.setattr(newsrec, "_dot_scores", lambda news, user: scores(news, user) + torch.tensor(
        [0.5] + [0.0] * (news.shape[1] - 1), dtype=news.dtype))


@pytest.mark.parametrize("name", ["nrms-fp32.h20", "nrms-fp32.h50", "nrms-bf16.h20"])
@pytest.mark.parametrize("fault", [_frozen, _half_batch, _altered_answer])
def test_a_broken_step_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch)
    assert not run(tiny(name))["correct"]


@pytest.mark.parametrize("name", ["nrms-fp32.h20", "nrms-fp32.h50", "nrms-bf16.h20"])
def test_the_control_is_not_correct(name):
    cell = tiny(name)
    data, weights, trainer_seed, feed_seed = core.made(cell, 2**31 + 9, "cpu")
    ref = core.reference_of(cell.cfg)
    base = ref.train(cell.cfg, cell.mix, data, weights, trainer_seed, feed_seed, core.CHECK_STEPS)
    control = ref.train(cell.cfg, cell.mix, data, weights, trainer_seed, feed_seed,
                        core.CHECK_STEPS, precision=cell.cfg["control"])
    assert not core.checks(core.compare(control, base), cell.limits)[0]

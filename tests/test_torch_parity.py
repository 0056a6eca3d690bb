"""The port's accuracy-check tools (``ebnerd_tpu_torch/tools/parity_headline.py``
and ``parity_train.py``) against ``scripts/parity_headline.py`` and
``scripts/parity_train.py`` (both import only numpy at module level): the
splits bit-equal, the gate as the scripts apply it, the recorded
references as ``PARITY_TRAIN.json`` holds them, and the toy NRMS run on
the CPU ending within 0.02 of JAX's recorded final AUC. The slow test
trains JAX and the port live on the toy split."""
import itertools
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ebnerd_tpu_torch.tools import parity_headline as port_headline
from ebnerd_tpu_torch.tools import parity_train as port_train

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))
import parity_headline as jax_headline  # noqa: E402
import parity_train as jax_train  # noqa: E402

RECORDS = json.loads((REPO / "PARITY_TRAIN.json").read_text())


def _arrays(tree) -> list:
    if isinstance(tree, np.ndarray):
        return [tree]
    return list(itertools.chain.from_iterable(_arrays(x) for x in tree))


_SPLITS = {
    "headline_dataset": lambda m: m.make_dataset(),
    "headline_w2v": lambda m: m.make_w2v(),
    "signal_dataset": lambda m: m.make_signal_dataset(0, return_indices=True),
    "docvec_dataset": lambda m: m.make_docvec_dataset(0),
}
_MODULES = {"headline_dataset": (port_headline, jax_headline),
            "headline_w2v": (port_headline, jax_headline),
            "signal_dataset": (port_train, jax_train),
            "docvec_dataset": (port_train, jax_train)}
_CACHE: dict = {}


def _split(name: str, side: int) -> list:
    key = (name, side)
    if key not in _CACHE:
        _CACHE[key] = _arrays(_SPLITS[name](_MODULES[name][side]))
    return _CACHE[key]


@pytest.mark.parametrize("name,index", [(n, i) for n, k in
                                        (("headline_dataset", 7), ("headline_w2v", 1),
                                         ("signal_dataset", 10), ("docvec_dataset", 6))
                                        for i in range(k)])
def test_split_arrays_bit_equal_to_the_scripts(name, index):
    port, ref = _split(name, 0), _split(name, 1)
    assert len(port) == len(ref)
    assert port[index].dtype == ref[index].dtype
    np.testing.assert_array_equal(port[index], ref[index])


def test_toy_word_table_is_the_script_main_s():
    rng = np.random.default_rng(1)
    ref = (rng.standard_normal((jax_train.VOCAB, jax_train.EMB)) * 0.1).astype(np.float32)
    np.testing.assert_array_equal(port_train.make_w2v(), ref)


def test_widths_and_learning_rates_are_the_scripts():
    for name in ("VOCAB", "EMB", "T", "H", "NPRATIO", "K", "HEADS", "HEAD_DIM", "ATT",
                 "DROPOUT", "N_ARTICLES", "N_TRAIN", "N_VAL", "REF_BS", "REF_LR", "BUCKET"):
        assert getattr(port_headline, name) == getattr(jax_headline, name), name
    for name in ("VOCAB", "EMB", "H", "T", "NPRATIO", "K", "HEADS", "HEAD_DIM", "ATT",
                 "N_ARTICLES", "N_TRAIN", "N_VAL", "EPOCHS", "BATCH", "LR"):
        assert getattr(port_train, name) == getattr(jax_train, name), name
    for bs, _ in port_headline.RUNS:  # the recorded runs' learning rates
        assert port_headline.learning_rate(bs) == pytest.approx(
            RECORDS[f"nrms_fused_bf16_bs{bs}"]["seed42"]["lr"], rel=1e-12)


def test_recorded_references_are_parity_train_json_s():
    assert port_headline.HEADLINE_REFERENCE_AUC == RECORDS["headline_reference"]["val_auc"][-1]
    for entry, curve in port_train.REFERENCE_VAL_AUC.items():
        assert list(curve) == RECORDS[entry]["reference_val_auc"], entry
    for bs, epochs in port_headline.RUNS:  # the recorded configurations, not the plain-lr one
        rec = RECORDS[f"nrms_fused_bf16_bs{bs}"]
        assert rec["seed42"]["epochs"] == rec["seed7"]["epochs"] == epochs
        assert f"seed{port_headline.SEEDS[0]}" in rec and f"seed{port_headline.SEEDS[1]}" in rec


def test_auc_is_the_script_s():
    rng = np.random.default_rng(3)
    probs = rng.random((50, 5)).astype(np.float32)
    probs[:5] = 0.5  # ties
    labels = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 50)]
    assert port_headline.auc_from_probs(probs, labels) == jax_headline.auc_from_probs(probs,
                                                                                      labels)


def _runs(*finals):
    return {f"seed{i}": {"val_auc": [0.5, f]} for i, f in enumerate(finals)}


def test_verdict_is_the_scripts_rule_on_every_seed():
    """max(2 x spread, 0.02) around the reference, as the scripts' rule;
    every seed is held, where ``run_verdict`` and ``_verdict`` hold the
    first only."""
    ok = port_headline.verdict({"a": _runs(0.90, 0.91)}, 0.8972)["a"]
    assert ok["pass"] and ok["tolerance"] == pytest.approx(0.02)
    assert not port_headline.verdict({"a": _runs(0.95, 0.95)}, 0.8972)["a"]["pass"]
    wide = port_headline.verdict({"a": _runs(0.90, 0.70)}, 0.8972)["a"]
    assert wide["tolerance"] == pytest.approx(0.4) and wide["pass"]
    # the first seed within 0.02, the second 0.025 off with a spread of 0.01: the
    # scripts pass it, the port does not
    first, second = [0.8972 + 0.015], [0.8972 + 0.025]
    ref = jax_train._verdict([0.8972], first, second)
    port = port_headline.verdict({"x": {"a": {"val_auc": first}, "b": {"val_auc": second}}},
                                 0.8972)["x"]
    assert port["tolerance"] == pytest.approx(ref["tolerance"])
    assert ref["pass"] and not port["pass"]


def test_tools_raise_without_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_headline.main(["--device", "cuda"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_train.main(["--device", "cuda"])


def test_headline_run_smoke_on_the_cpu():
    """Two steps of the headline run at batch 64 on the CPU (the kernels'
    plain versions): finite loss and AUC, and the epoch's bookkeeping."""
    torch.set_num_threads(1)
    data = (port_headline.make_dataset(), port_headline.make_w2v())
    r = port_headline.run(64, 42, 1, "cpu", data, steps_per_epoch=2, n_val=32, log=lambda s: None)
    assert r["steps"] == 2 and len(r["val_auc"]) == 1
    assert np.isfinite(r["loss"][0]) and 0.0 <= r["val_auc"][0] <= 1.0
    assert r["lr"] == port_headline.learning_rate(64)


def test_toy_nrms_on_the_cpu_ends_near_jax_recorded_auc():
    """The port's toy NRMS run (fp32, unfused, batch 64, lr 1e-3, 3 epochs,
    seed 42) ends within 0.02 of JAX's recorded final AUC."""
    torch.set_num_threads(1)
    r = port_train.train_entry("nrms", 42, "cpu", log=lambda s: None)
    jax_final = RECORDS["nrms"]["ebnerd_tpu_val_auc"][-1]
    assert jax_final == 0.9118
    assert abs(r["val_auc"][-1] - jax_final) <= 0.02, r["val_auc"]


@pytest.mark.slow
def test_toy_nrms_trains_to_jax_s_auc_live():
    """JAX's ``train_ours`` and the port's run on the same toy split, both
    seeds: the port's final AUC within ``_verdict``'s tolerance of JAX's."""
    torch.set_num_threads(1)
    train, val = jax_train.make_signal_dataset(seed=0)
    w2v = port_train.make_w2v()
    jax_a = jax_train.train_ours(train, val, w2v, seed=42)
    jax_b = jax_train.train_ours(train, val, w2v, seed=7)
    port = {s: port_train.train_entry("nrms", s, "cpu", log=lambda m: None)["val_auc"]
            for s in (42, 7)}
    v = jax_train._verdict(jax_a, port[42], port[7])
    assert v["pass"], (jax_a, jax_b, port, v)

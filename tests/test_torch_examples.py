"""The port's examples (``ebnerd_tpu_torch/examples/``) against the JAX
package's (``examples/``) on the same synthetic splits, in process on the
CPU: the port builds each split in memory, the JAX example writes it as
parquet and reads it back.

- ``dataset_overview``: every printed line (counts, periods, rows) equal;
- ``feature_baselines``: each feature's ``predictions.txt`` equal line for
  line;
- ``make_beyond_accuracy``: ``beyond_accuracy_baselines.json`` equal within
  1e-9 (the same float64 numpy arithmetic; the bound only covers the last
  bits of a different summation order);
- ``make_embedding_artifacts --synthetic``: ids and vectors bit-equal;
- ``quick_start_dummy``: per family, step 1's loss from JAX's initial
  parameters (through ``bridge.py``) at dropout 0 within 1e-5 (fp32 forward
  of a 5-way softmax cross-entropy; the two frameworks' sums differ in
  order);
- ``history_length_study``: the JAX-trained NRMSDocVec bridged into the port,
  the AUC at each history length within 1e-5 (scores in fp32, ranks then
  decide the AUC).
"""
import contextlib
import dataclasses
import importlib.util
import io
import json
import sys
import zipfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ebnerd_tpu_torch import bridge
from ebnerd_tpu_torch.examples import (dataset_overview, feature_baselines,
                                       history_length_study, make_beyond_accuracy,
                                       make_embedding_artifacts, quick_start_dummy)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def _jax_example(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stdout(fn, *args) -> tuple:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue().splitlines()


def test_dataset_overview_prints_what_the_jax_example_prints(monkeypatch, tmp_path):
    from ebnerd_tpu.data import synthetic as jax_synthetic

    jmod = _jax_example("dataset_overview")
    write = jax_synthetic.make_synthetic_ebnerd  # the JAX example's fixed /tmp path, redirected
    monkeypatch.setattr(jax_synthetic, "make_synthetic_ebnerd",
                        lambda path, **kw: write(tmp_path / "train", **kw))
    monkeypatch.setattr(sys, "argv", ["dataset_overview"])
    _, jlines = _stdout(jmod.main)
    _, plines = _stdout(dataset_overview.main, [])
    assert len(plines) == len(jlines) > 20
    # every line but the last, which names the next step in each package
    assert plines[:-1] == jlines[:-1]
    assert any(line.startswith("history period:") for line in plines)


def _predictions(zip_path: Path) -> list:
    with zipfile.ZipFile(zip_path) as zf:
        return zf.read("predictions.txt").decode().splitlines()


def test_feature_baselines_write_the_jax_predictions(tmp_path):
    jmod = _jax_example("feature_baselines")
    jmod.main(["--synthetic", "--out_dir", str(tmp_path / "jax")])
    feature_baselines.main(["--synthetic", "--out_dir", str(tmp_path / "port")])
    names = sorted(p.name for p in (tmp_path / "jax").glob("*_predictions.zip"))
    assert names == sorted(p.name for p in (tmp_path / "port").glob("*_predictions.zip"))
    assert len(names) == 4
    for name in names:
        got, want = _predictions(tmp_path / "port" / name), _predictions(tmp_path / "jax" / name)
        assert len(got) == 1000 and got == want, name


def _close(a, b, tol: float, where: str = "") -> None:
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), where
        for k in a:
            _close(a[k], b[k], tol, f"{where}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), where
        for i, (u, v) in enumerate(zip(a, b)):
            _close(u, v, tol, f"{where}[{i}]")
    elif isinstance(a, (int, float)) and not isinstance(a, bool):
        assert abs(a - b) <= tol, f"{where}: {a} vs {b}"
    else:
        assert a == b, where


def test_make_beyond_accuracy_matches_the_jax_baselines(tmp_path):
    jmod = _jax_example("make_beyond_accuracy")
    jmod.main(["--synthetic", "--out_dir", str(tmp_path / "jax")])
    make_beyond_accuracy.main(["--synthetic", "--out_dir", str(tmp_path / "port")])
    name = "beyond_accuracy_baselines.json"
    got = json.loads((tmp_path / "port" / name).read_text())
    want = json.loads((tmp_path / "jax" / name).read_text())
    assert set(got) == {"editorial_topinview", "popular_toppageviews", "random", "_bounds"}
    _close(got, want, 1e-9)
    np.testing.assert_array_equal(np.load(tmp_path / "port" / "candidate_list.npy"),
                                  np.load(tmp_path / "jax" / "candidate_list.npy"))


def test_make_embedding_artifacts_synthetic_vectors_are_bit_equal(tmp_path):
    import pyarrow.parquet as pq

    jmod = _jax_example("make_embedding_artifacts")
    jmod.main(["--synthetic", "--dim", "64", "--out", str(tmp_path / "jax.parquet")])
    make_embedding_artifacts.main(["--synthetic", "--dim", "64",
                                   "--out", str(tmp_path / "port.parquet")])
    got, want = pq.read_table(tmp_path / "port.parquet"), pq.read_table(tmp_path / "jax.parquet")
    assert got.column_names == want.column_names
    np.testing.assert_array_equal(got.column("article_id").to_numpy(),
                                  want.column("article_id").to_numpy())
    gv = np.stack(got.column("document_vector").to_pylist()).astype(np.float32)
    wv = np.stack(want.column("document_vector").to_pylist()).astype(np.float32)
    assert gv.shape == (200, 64) and gv.tobytes() == wv.tobytes()


def test_make_embedding_artifacts_refuses_the_transformer_path(tmp_path):
    with pytest.raises(NotImplementedError, match="Not yet ported"):
        make_embedding_artifacts.main(["--out", str(tmp_path / "x.parquet")])
    assert not (tmp_path / "x.parquet").exists()


def _bridge(family: str, model: torch.nn.Module, variables) -> None:
    params = jax.device_get(variables["params"])
    if family == "nrms":
        bridge.load_nrms_params(model, params)
    elif family == "lstur":
        bridge.load_lstur_params(model, params)
    elif family == "naml":
        bridge.load_naml_params(model, params)
    else:
        sd = {"npa": lambda: bridge.npa_state_dict(params),
              "fastformer": lambda: bridge.fastformer_state_dict(params),
              "nrms_docvec": lambda: bridge.nrms_docvec_state_dict(
                  params, jax.device_get(variables["batch_stats"]))}[family]()
        model.load_state_dict(sd, strict=True)


@pytest.mark.parametrize("family", quick_start_dummy.MODELS)
def test_quick_start_dummy_first_loss_matches_jax_through_the_bridge(family):
    jmod = _jax_example("quick_start_dummy")
    jmodel = jmod.build(family)
    jmodel = jmodel.clone(hparams=dataclasses.replace(jmodel.hparams, dropout=0.0))
    batch = jmod.dummy_batch(family, np.random.default_rng(0))
    variables = jmodel.init(jax.random.key(0), batch, train=False)
    rest = {k: v for k, v in variables.items() if k != "params"}
    out = jmodel.apply(variables, batch, train=True, rngs={"dropout": jax.random.key(1)},
                       mutable=list(rest) or False)
    logits = out[0] if rest else out
    labels = jnp.zeros(logits.shape).at[:, 0].set(1.0)
    want = float(-jnp.mean(jnp.sum(labels * jax.nn.log_softmax(logits, -1), -1)))
    got = quick_start_dummy.run_one(family, "cpu", dropout=0.0,
                                    load=lambda m: _bridge(family, m, variables))
    assert abs(got["losses"][0] - want) <= 1e-5, (got["losses"][0], want)
    assert all(np.isfinite(got["losses"])) and tuple(got["preds"].shape) == (8, 5)


def test_quick_start_dummy_main_trains_every_family_on_the_cpu():
    out, lines = _stdout(quick_start_dummy.main, ["--device", "cpu"])
    assert set(out) == set(quick_start_dummy.MODELS) and len(lines) == 6
    for rec in out.values():
        assert len(rec["losses"]) == 3 and all(np.isfinite(rec["losses"]))


def test_history_length_study_aucs_match_the_jax_trained_model(monkeypatch, tmp_path):
    jmod = _jax_example("history_length_study")
    trainers = []

    class Recording(jmod.Trainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            trainers.append(self)

    monkeypatch.setattr(jmod, "Trainer", Recording)
    argv = ["--synthetic", "--epochs", "1", "--sweep", "1", "3", "20"]
    want = jmod.main(argv + ["--out_dir", str(tmp_path / "jax")])
    state = trainers[0].state
    args = history_length_study.get_args(argv + ["--out_dir", str(tmp_path / "port"),
                                                 "--device", "cpu"])
    trainer, lookup, _, val = history_length_study.setup(args)
    trainer.model.load_state_dict(bridge.nrms_docvec_state_dict(
        jax.device_get(state.params), jax.device_get(state.batch_stats)), strict=True)
    got = history_length_study.sweep(trainer, lookup, val, args)
    assert list(got) == [1, 3, 20]
    for h in got:
        assert 0.0 <= got[h] <= 1.0 and abs(got[h] - want[h]) <= 1e-5, (h, got[h], want[h])


def test_history_length_study_main_writes_the_sweep_on_the_cpu(tmp_path):
    aucs = history_length_study.main(["--synthetic", "--epochs", "1", "--sweep", "2", "5",
                                      "--bs", "128", "--device", "cpu",
                                      "--out_dir", str(tmp_path)])
    written = json.loads((tmp_path / "auc_history_length.json").read_text())
    assert written == {str(k): v for k, v in aucs.items()} and set(aucs) == {2, 5}
    assert all(0.0 <= v <= 1.0 for v in aucs.values())

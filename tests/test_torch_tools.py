"""The port's driver tools (``ebnerd_tpu_torch/tools/``) against the JAX
package's scripts on the CPU, at tiny sizes:

- ``bench_large``: the tables and batches bit-equal to
  ``scripts/bench_large.py``'s draws for the same seed (``subcat``: the JAX
  draw halved, as the tool documents), the ladder buckets and slots equal to
  JAX's ``prep_dedup_batch`` on the same raws, and a 2-step run of NAML and
  NRMS finite with the JAX script's JSON keys;
- ``bomb_feeds``: the batches of both feeds (the training feed's second
  epoch, a pass of the eval feed) bit-equal to the JAX script's feeds, which
  it builds from the same split written as parquet;
- ``profile_models``: its tables and batches equal to
  ``scripts/profile_models.py``'s draws;
- ``smoke``, ``bench_eval``, ``bench_fit``, ``profile_models`` and the port's
  bench: ``--device cpu`` at a tiny size runs and prints its JSON line,
  with its rates named as CPU rates.
"""
import contextlib
import importlib.util
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from ebnerd_tpu_torch.tools import (bench_eval, bench_fit, bench_large, bomb_feeds,
                                    profile_models, smoke)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
JAX_LARGE_KEYS = {"metric", "value", "unit", "step_ms", "config", "uniq_mean", "uniq_frac",
                  "ladder_buckets", "distinct_programs", "compile_warm_s", "prep_ms",
                  "hbm_peak_gb", "hbm_limit_gb"}


def _jax_script(name: str, monkeypatch, env: dict):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                  ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json_line(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    assert rc == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1]), buf.getvalue()


LARGE_ENV = {"BL_NART": "2000", "BL_BS": "64", "BL_STEPS": "2"}


@pytest.mark.parametrize("model", ["naml", "nrms"])
def test_bench_large_draws_equal_the_jax_script(monkeypatch, model):
    env = dict(LARGE_ENV, BL_MODEL=model)
    jmod = _jax_script("bench_large", monkeypatch, env)
    k = bench_large.knobs(env)
    tables, raws = bench_large.draw(k)
    r = np.random.default_rng(0)  # the JAX script's main, in its order
    want = {"title": r.integers(0, jmod.VOCAB, (jmod.N_ART + 1, jmod.T)).astype(np.int32)}
    if model == "naml":
        want["body"] = r.integers(0, jmod.VOCAB, (jmod.N_ART + 1, jmod.TB)).astype(np.int32)
        want["cat"] = r.integers(0, 30, jmod.N_ART + 1).astype(np.int32)
        want["subcat"] = r.integers(0, 200, jmod.N_ART + 1).astype(np.int32)
    assert set(tables) == set(want)
    for name in ("title", "body", "cat"):
        if name in want:
            np.testing.assert_array_equal(tables[name], want[name], err_msg=name)
    if model == "naml":
        np.testing.assert_array_equal(tables["subcat"], want["subcat"] // 2)
        assert tables["subcat"].max() < 100
    assert len(raws) == jmod.WARMUP + jmod.STEPS == 5
    for raw in raws:
        hist, cand = jmod._zipf(r, (jmod.BS, jmod.H)), jmod._zipf(r, (jmod.BS, jmod.K))
        np.testing.assert_array_equal(raw["hist_idx"], hist)
        np.testing.assert_array_equal(raw["cand_idx"], cand)
        assert raw["hist_idx"].dtype == hist.dtype and raw["labels"][:, 0].all()


def test_bench_large_ladder_buckets_equal_jax_prep():
    from ebnerd_tpu.training.dedup import prep_dedup_batch as jax_prep
    from ebnerd_tpu_torch.training.dedup import prep_dedup_batch

    k = bench_large.knobs(dict(LARGE_ENV, BL_BS="256"))
    _, raws = bench_large.draw(k)
    buckets = set()
    for raw in raws:
        got, want = prep_dedup_batch(raw, min_bucket=512), jax_prep(raw, min_bucket=512)
        assert got["n_uniq"] == want["n_uniq"]
        for key in ("art_uniq", "hist_slot", "cand_slot"):
            np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
        buckets.add(got["art_uniq"].shape[0])
    assert buckets and all(b % 256 == 0 for b in buckets)


@pytest.mark.parametrize("model", ["naml", "nrms"])
def test_bench_large_two_steps_on_the_cpu(monkeypatch, model):
    for key, v in dict(LARGE_ENV, BL_MODEL=model, BENCH_VOCAB="1000", BENCH_EMB="32").items():
        monkeypatch.setenv(key, v)
    out, _ = _json_line(bench_large.main, ["--device", "cpu"])
    assert JAX_LARGE_KEYS <= set(out)
    assert out["metric"] == f"{model}_large_train_impressions_per_sec_on_cpu"
    assert np.isfinite(out["loss"]) and out["value"] > 0
    assert out["hbm_peak_gb"] is None and out["device"] == "cpu"
    assert out["distinct_programs"] == len(out["ladder_buckets"]) >= 1
    assert 0 < out["uniq_frac"] <= 1 and out["launches_per_step"] == {}


def test_bench_large_refuses_an_unknown_model():
    with pytest.raises(ValueError, match="BL_MODEL"):
        bench_large.knobs({"BL_MODEL": "lstur"})


def test_bomb_feeds_batches_equal_the_jax_feeds(monkeypatch):
    jmod = _jax_script("bomb_feeds", monkeypatch, {})
    made = {}

    def recording(cls, key):
        class Recording(cls):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                made[key] = self
        return Recording

    monkeypatch.setattr(jmod, "NewsrecFeed", recording(jmod.NewsrecFeed, "train"))
    monkeypatch.setattr(jmod, "EvalFeed", recording(jmod.EvalFeed, "eval"))
    with contextlib.redirect_stdout(io.StringIO()):
        jmod.main(["--iterations", "1", "--n_impressions", "300"])
    feed, efeed, rows, _ = bomb_feeds.feeds(300, 32, 20)
    assert rows > 32
    for _ in feed.epoch():  # the JAX feed ran one epoch: both take their second, whole
        pass
    pairs = (list(zip(feed.epoch(), made["train"].epoch(), strict=True))
             + list(zip(efeed.batches(), made["eval"].batches(), strict=True)))
    assert len(pairs) > 4
    for got, want in pairs:
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]),
                                          err_msg=key)


def test_bomb_feeds_prints_its_json_line():
    out, text = _json_line(bomb_feeds.main, ["--iterations", "2", "--n_impressions", "200"])
    assert "NewsrecFeed x2 epochs" in text and "EvalFeed x2 passes" in text
    assert out["newsrec_batches"] > 0 and out["eval_batches"] > 0 and out["device"] == "host"


PM_ENV = {"PM_BS": "16", "PM_STEPS": "1", "PM_NART": "5000"}


def test_profile_models_draws_equal_the_jax_script(monkeypatch):
    jmod = _jax_script("profile_models", monkeypatch, PM_ENV)
    k = profile_models.knobs(PM_ENV)
    r, rj = np.random.default_rng(0), np.random.default_rng(0)
    tabs = profile_models.tables(r, k)
    want = {"title": rj.integers(0, jmod.VOCAB, (jmod.N_ART, jmod.T)).astype(np.int32),
            "body": rj.integers(0, jmod.VOCAB, (jmod.N_ART, 40)).astype(np.int32),
            "cat": rj.integers(0, 30, jmod.N_ART).astype(np.int32),
            "subcat": rj.integers(0, 200, jmod.N_ART).astype(np.int32),
            "docvec": rj.standard_normal((jmod.N_ART, 768)).astype(np.float32)}
    for name in ("title", "body", "cat", "docvec"):
        np.testing.assert_array_equal(tabs[name], want[name], err_msg=name)
    np.testing.assert_array_equal(tabs["subcat"], want["subcat"] // 2)
    for shape in ((16, 20), (16, 5)):
        np.testing.assert_array_equal(profile_models.draw(r, k, shape), jmod._draw(rj, shape))


def test_profile_models_every_family_on_the_cpu(monkeypatch):
    for key, v in dict(PM_ENV, BENCH_VOCAB="500", BENCH_EMB="16").items():
        monkeypatch.setenv(key, v)
    out, text = _json_line(profile_models.main, ["--device", "cpu"])
    assert set(out["families"]) == set(profile_models.FAMILIES)
    for name, rec in out["families"].items():
        assert "failed" not in rec, (name, rec)
        assert rec["ms_per_step"] > 0 and "imp_per_s_on_cpu" in rec and rec["uniq"] > 0
    assert text.count("full train step") == 6 and out["device"] == "cpu"


def test_bench_eval_on_the_cpu(monkeypatch):
    for key, v in {"BE_BS": "64", "BENCH_VOCAB": "500", "BENCH_EMB": "16",
                   "BENCH_NART": "300"}.items():
        monkeypatch.setenv(key, v)
    out, text = _json_line(bench_eval.main, ["120", "--device", "cpu"])
    assert "two-tower eval:" in text and "corpus encode (300 articles" in text
    assert out["metric"].endswith("_on_cpu") and out["n_impressions"] == 120
    assert out["n_scores"] >= 5 * 120 and out["value"] > 0


def test_bench_fit_on_the_cpu(monkeypatch):
    env = {"FIT_BS": "32", "FIT_STEPS": "2", "FIT_WARM_EPOCHS": "1", "FIT_WARM_STEPS": "1",
           "BENCH_VOCAB": "500", "BENCH_EMB": "16", "BENCH_NART": "300"}
    for key, v in env.items():
        monkeypatch.setenv(key, v)
    out, _ = _json_line(bench_fit.main, ["--device", "cpu"])
    assert out["metric"] == "nrms_fit_impressions_per_sec_on_cpu" and out["value"] > 0
    assert "bs32 steps2" in out["config"]


def test_bench_fit_table_is_the_jax_scripts_draw(monkeypatch):
    jmod = _jax_script("bench_fit", monkeypatch, {})
    import bench as jax_bench

    k = dict(bench_fit.knobs({}), steps=1, warm_epochs=1, warm_steps=1, bs=8)
    df, lookup = bench_fit.behaviors(k)
    rng = np.random.default_rng(0)
    tokens = jax_bench._token_table(rng, "zipf")[1:]
    ids = np.arange(1, jmod.N_ART + 1, dtype=np.int64) * 3 + 11
    np.testing.assert_array_equal(lookup.matrix[1:], tokens)
    hist = ids[jmod._zipf(rng, jmod.N_ART, (len(df), jmod.H))]
    np.testing.assert_array_equal(df["article_id_fixed"].values.reshape(len(df), -1), hist)


def test_smoke_runs_both_parts_on_the_cpu(monkeypatch):
    env = {"BENCH_BS": "16", "BENCH_VOCAB": "500", "BENCH_EMB": "16", "BENCH_NART": "200",
           "BENCH_STEPS": "2", "BENCH_WARMUP": "1"}  # set here, so the tool adds no variable
    for key, v in env.items():
        monkeypatch.setenv(key, v)
    out, text = _json_line(smoke.main, ["--device", "cpu"])
    assert "nrms_train_impressions_per_sec_on_cpu" in text and '"mfu_pct"' not in text
    assert out["smoke"] == "ok" and np.isfinite(out["loss"]) and out["scores"] > 0

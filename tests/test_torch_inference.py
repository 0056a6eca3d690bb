"""The port's chunked, resumable test inference against the JAX package's
(``training/inference.py``): chunks written as parquet and skipped on a
rerun by their presence, ``assemble_submission`` back in the split's
impression order, scores and ranks equal to JAX's on the same weights, and
the whole flow ``fit`` -> ``score`` -> ``MetricEvaluator`` -> submission."""
import zipfile

import jax
import numpy as np
import pytest
import torch

from ebnerd_tpu import constants as c
from ebnerd_tpu.data.behaviors import create_binary_labels_column, ebnerd_from_path
from ebnerd_tpu.data.lookup import Lookup as JaxLookup
from ebnerd_tpu.data.ragged import Ragged as JaxRagged
from ebnerd_tpu.data.table import read_parquet as jax_read_parquet
from ebnerd_tpu.models.config import HParamsNRMS as JaxHP
from ebnerd_tpu.models.inputs import token_batch as jax_token_batch
from ebnerd_tpu.models.newsrec import NRMS as JaxNRMS
from ebnerd_tpu.training import inference as jax_inference
from ebnerd_tpu.training.trainer import Trainer as JaxTrainer
from ebnerd_tpu.training.trainer import TrainerConfig as JaxConfig
from ebnerd_tpu.utils import submission as jax_submission
from ebnerd_tpu_torch.bridge import load_nrms_params
from ebnerd_tpu_torch.data import Lookup, Ragged, Table
from ebnerd_tpu_torch.models import NRMS, HParamsNRMS, token_batch
from ebnerd_tpu_torch.training import Trainer, TrainerConfig
from ebnerd_tpu_torch.training.inference import (RANKS_COL, SCORES_COL, assemble_submission,
                                                 chunked_score, split_chunks)
from ebnerd_tpu_torch.utils import submission

torch.set_num_threads(1)

H, T, VOCAB = 4, 6, 120
HP = dict(title_size=T, history_size=H, head_num=2, head_dim=4, attention_hidden_dim=8)


def port_table(df) -> Table:
    return Table({n: Ragged(df[n].values, df[n].offsets) if isinstance(df[n], JaxRagged)
                  else np.asarray(df[n]) for n in df.columns})


@pytest.fixture(scope="module")
def setup(ebnerd_fixture):
    """The split in both packages and one NRMS (JAX's init) in both."""
    df = create_binary_labels_column(ebnerd_from_path(ebnerd_fixture, history_size=H))
    ids = np.asarray(jax_read_parquet(ebnerd_fixture / "articles.parquet")[c.DEFAULT_ARTICLE_ID_COL])
    tokens = np.random.default_rng(0).integers(1, VOCAB, (len(ids), T)).astype(np.int32)
    jlookup = JaxLookup.from_values(ids, tokens)
    jtr = JaxTrainer(JaxNRMS(JaxHP(**HP), vocab_size=VOCAB, word_emb_dim=8),
                     {"title": jlookup.matrix}, jax_token_batch, JaxConfig(seed=0),
                     log_fn=lambda s: None)
    jtr.init_state({"hist_idx": np.zeros((4, H), np.int32), "cand_idx": np.zeros((4, 3), np.int32),
                    "labels": np.zeros((4, 3), np.float32)})
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(jtr.state.params))
    lookup = Lookup.from_values(ids, tokens)
    model = load_nrms_params(NRMS(HParamsNRMS(**HP), vocab_size=VOCAB, word_emb_dim=8,
                                  device="cpu"), params)
    tr = Trainer(model, {"title": lookup.matrix}, token_batch, TrainerConfig(seed=0),
                 device="cpu", log_fn=lambda s: None)
    return df, port_table(df), jlookup, lookup, jtr, tr


def test_split_chunks_equal_jax(setup):
    jdf, df = setup[:2]
    for n in (1, 3, 7):
        ours, ref = split_chunks(df, n), jax_inference.split_chunks(jdf, n)
        assert [len(x) for x in ours] == [len(x) for x in ref]
        assert sum(len(x) for x in ours) == len(df)


def test_chunked_score_equals_jax_and_resumes(setup, tmp_path):
    jdf, df, jlookup, lookup, jtr, tr = setup
    out = chunked_score(tr, df, lookup, history_size=H, batch_size=16, n_chunks=3,
                        out_dir=tmp_path / "port", log=lambda s: None)
    ref = jax_inference.chunked_score(jtr, jdf, jlookup, history_size=H, batch_size=16,
                                      n_chunks=3, out_dir=tmp_path / "jax", log=lambda s: None)
    assert out.columns == ref.columns and len(out) == len(df)
    np.testing.assert_array_equal(out[c.DEFAULT_IMPRESSION_ID_COL], ref[c.DEFAULT_IMPRESSION_ID_COL])
    np.testing.assert_array_equal(out[SCORES_COL].offsets, ref[SCORES_COL].offsets)
    np.testing.assert_allclose(out[SCORES_COL].values, ref[SCORES_COL].values, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(out[RANKS_COL].values, ref[RANKS_COL].values)
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == [
        f"pred_chunk_{i}.parquet" for i in range(3)]

    (tmp_path / "port" / "pred_chunk_1.parquet").unlink()
    calls = []
    again = chunked_score(tr, df, lookup, history_size=H, batch_size=16, n_chunks=3,
                          out_dir=tmp_path / "port", log=calls.append)
    assert sum("skipping" in m for m in calls) == 2
    np.testing.assert_array_equal(again[SCORES_COL].values, out[SCORES_COL].values)
    np.testing.assert_array_equal(again[RANKS_COL].values, out[RANKS_COL].values)


def test_assemble_submission_restores_the_split_order(setup, tmp_path):
    """Two parts scored apart (the test split's beyond-accuracy halves) come
    back in the split's impression order, rank for rank as the JAX package
    assembles them, and the zipped predictions.txt equals JAX's byte for
    byte."""
    jdf, df, jlookup, lookup, jtr, tr = setup
    ba = np.zeros(len(df), bool)
    ba[::3] = True
    parts = [chunked_score(tr, df.filter(m), lookup, history_size=H, batch_size=16,
                           n_chunks=n, out_dir=tmp_path / name, log=lambda s: None)
             for m, n, name in ((~ba, 2, "wo_ba"), (ba, 1, "w_ba"))]
    jparts = [jax_inference.chunked_score(jtr, jdf.filter(m), jlookup, history_size=H,
                                          batch_size=16, n_chunks=n, out_dir=tmp_path / f"j{name}",
                                          log=lambda s: None)
              for m, n, name in ((~ba, 2, "wo_ba"), (ba, 1, "w_ba"))]
    imp_ids = np.asarray(df[c.DEFAULT_IMPRESSION_ID_COL])
    ranks = assemble_submission(parts, imp_ids)
    want = jax_inference.assemble_submission(jparts, imp_ids)
    np.testing.assert_array_equal(ranks.values, want.values)
    np.testing.assert_array_equal(ranks.offsets, want.offsets)
    whole = chunked_score(tr, df, lookup, history_size=H, batch_size=16, n_chunks=1,
                          out_dir=tmp_path / "whole", log=lambda s: None)
    np.testing.assert_array_equal(ranks.values, whole[RANKS_COL].values)

    submission.write_submission_file(imp_ids, ranks, tmp_path / "p" / "predictions.txt")
    jax_submission.write_submission_file(imp_ids, want, tmp_path / "j" / "predictions.txt")
    blobs = [zipfile.ZipFile(tmp_path / d / "predictions.zip").read("predictions.txt")
             for d in ("p", "j")]
    assert blobs[0] == blobs[1]
    with pytest.raises(ValueError, match="impressions"):
        assemble_submission(parts[:1], imp_ids)
    with pytest.raises(ValueError, match="do not match"):
        assemble_submission(parts, imp_ids + 1)


def test_fit_score_evaluate_submit_on_the_cpu(tmp_path):
    """The user's flow on the port alone: fit with validation, score,
    MetricEvaluator, ranks, predictions.zip."""
    from ebnerd_tpu.data.behaviors import sampling_strategy_wu2019
    from ebnerd_tpu.data.synthetic import make_synthetic_ebnerd
    from ebnerd_tpu_torch.data import EvalFeed, NewsrecFeed
    from ebnerd_tpu_torch.evaluation import AucScore, MetricEvaluator, MrrScore, NdcgScore

    path = make_synthetic_ebnerd(tmp_path / "d", n_users=30, n_articles=60, n_impressions=128,
                                 seed=11)
    jdf = ebnerd_from_path(path, history_size=H)
    train = port_table(create_binary_labels_column(
        sampling_strategy_wu2019(jdf, npratio=3, shuffle=True, seed=2)))
    val = port_table(create_binary_labels_column(jdf))
    ids = np.asarray(jax_read_parquet(path / "articles.parquet")[c.DEFAULT_ARTICLE_ID_COL])
    lookup = Lookup.from_values(ids, np.random.default_rng(1).integers(1, VOCAB, (len(ids), T))
                                .astype(np.int32))
    model = NRMS(HParamsNRMS(**HP), vocab_size=VOCAB, word_emb_dim=8, device="cpu")
    tr = Trainer(model, {"title": lookup.matrix}, token_batch,
                 TrainerConfig(learning_rate=1e-3, seed=0), device="cpu", log_fn=lambda s: None)
    feed = EvalFeed(val, lookup, history_size=H, batch_size=32)
    hist = tr.fit(NewsrecFeed(train, lookup, history_size=H, batch_size=16), feed,
                  val[c.DEFAULT_LABELS_COL], epochs=2)
    assert len(hist) == 2 and all(0 <= h["val_auc"] <= 1 for h in hist)
    scores = tr.score(feed)
    assert scores.total == val[c.DEFAULT_INVIEW_ARTICLES_COL].total
    ev = MetricEvaluator(val[c.DEFAULT_LABELS_COL], scores,
                         [AucScore(), MrrScore(), NdcgScore(5)]).evaluate()
    assert ev.evaluations["auc"] == pytest.approx(max(h["val_auc"] for h in hist))
    imp_ids = np.asarray(val[c.DEFAULT_IMPRESSION_ID_COL])
    submission.write_submission_file(imp_ids, submission.rank_ragged_scores(scores),
                                     tmp_path / "predictions.txt")
    rt_ids, rt_ranks = submission.read_submission_file(
        zipfile.ZipFile(tmp_path / "predictions.zip").extract("predictions.txt", tmp_path / "x"))
    np.testing.assert_array_equal(rt_ids, imp_ids)
    np.testing.assert_array_equal(rt_ranks.values, submission.rank_ragged_scores(scores).values)

"""The port's copies of the evaluation, submission, logging and table
modules against the JAX package's: every per-impression metric equal to
JAX's per impression (ties and single-class impressions, which give NaN,
included), ``MetricEvaluator`` per metric class, submission ranks and the
zipped ``predictions.txt`` byte for byte, parquet round-trips through both
packages, and the table operations."""
import json
import zipfile

import numpy as np
import pytest

from ebnerd_tpu.data import table as jax_table
from ebnerd_tpu.data.ragged import Ragged as JaxRagged
from ebnerd_tpu.evaluation import protocols as jax_protocols
from ebnerd_tpu.evaluation import ranking as jax_ranking
from ebnerd_tpu.utils import logging as jax_logging
from ebnerd_tpu.utils import submission as jax_submission
from ebnerd_tpu_torch.data import Ragged, Table, read_parquet, write_parquet
from ebnerd_tpu_torch.evaluation import protocols, ranking
from ebnerd_tpu_torch.utils import ScalarLogger, submission


def _labels_scores(seed=0, n=60):
    """Ragged labels and scores: 1-12 candidates per impression, scores
    rounded to 1 decimal (ties), some impressions all-negative or
    all-positive (single-class), one impression of a single candidate."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, 13, n)
    lengths[0] = 1
    total = int(lengths.sum())
    labels = (rng.random(total) < 0.3).astype(np.int8)
    scores = np.round(rng.random(total), 1).astype(np.float32)
    offsets = np.concatenate([[0], np.cumsum(lengths)])
    labels[offsets[3]:offsets[4]] = 0
    labels[offsets[5]:offsets[6]] = 1
    return labels, scores, lengths


def _both(values, lengths):
    return Ragged.from_lengths(values, lengths), JaxRagged.from_lengths(values, lengths)


PER_IMPRESSION = ["per_impression_auc", "per_impression_mrr", "per_impression_ndcg",
                  "per_impression_logloss", "per_impression_accuracy", "per_impression_f1",
                  "per_impression_rmse"]


@pytest.mark.parametrize("name", PER_IMPRESSION)
@pytest.mark.parametrize("seed", [0, 1])
def test_per_impression_metrics_equal_jax(name, seed):
    labels, scores, lengths = _labels_scores(seed)
    (pl, jl), (ps, js) = _both(labels, lengths), _both(scores, lengths)
    ours, ref = getattr(ranking, name)(pl, ps), getattr(jax_ranking, name)(jl, js)
    np.testing.assert_array_equal(ours, ref)
    assert ours.dtype == ref.dtype and ours.shape == (len(lengths),)
    if name == "per_impression_auc":
        assert np.isnan(ours[[0, 3, 5]]).all()  # single-class impressions


def test_auc_ties_take_the_average_rank():
    labels, scores = np.array([1, 0, 0, 1, 0], np.int8), np.array([.5, .5, .2, .9, .9], np.float32)
    pl, _ = _both(labels, np.array([3, 2]))
    ps, _ = _both(scores, np.array([3, 2]))
    np.testing.assert_array_equal(ranking.per_impression_auc(pl, ps), [0.75, 0.5])


def test_metrics_reject_mismatched_structure():
    a, b = Ragged.from_lists([[1, 0], [0]]), Ragged.from_lists([[0.1], [0.2, 0.3, 0.4]])
    with pytest.raises(ValueError, match="identical ragged structure"):
        ranking.per_impression_auc(a, b)


METRICS = ["AucScore", "MrrScore", "NdcgScore", "LogLossScore", "AccuracyScore", "F1Score",
           "RootMeanSquaredError"]


@pytest.mark.parametrize("cls", METRICS)
def test_metric_evaluator_equals_jax(cls):
    labels, scores, lengths = _labels_scores(2)
    ours = protocols.MetricEvaluator(Ragged.from_lengths(labels, lengths),
                                     Ragged.from_lengths(scores, lengths),
                                     [getattr(protocols, cls)()]).evaluate()
    ref = jax_protocols.MetricEvaluator(JaxRagged.from_lengths(labels, lengths),
                                        JaxRagged.from_lengths(scores, lengths),
                                        [getattr(jax_protocols, cls)()]).evaluate()
    assert ours.evaluations.keys() == ref.evaluations.keys()
    for k, v in ref.evaluations.items():
        assert ours.evaluations[k] == v or (np.isnan(v) and np.isnan(ours.evaluations[k])), k
    assert str(ours) == str(ref)


def test_metric_evaluator_takes_lists_and_checks_the_protocol():
    ev = protocols.MetricEvaluator([[1, 0], [1, 1, 0]], [[0.8, 0.1], [0.9, 0.2, 0.1]],
                                   [protocols.AucScore(), protocols.NdcgScore(5)]).evaluate()
    assert ev.evaluations == {"auc": 1.0, "ndcg@5": 1.0}
    with pytest.raises(AttributeError, match="Metric protocol"):
        protocols.MetricEvaluator([[1]], [[0.5]], [object()])


# ---- submission -------------------------------------------------------------

@pytest.mark.parametrize("scores", [[0.1, 0.4, 0.2], [0.5, 0.5, 0.1, 0.5], [1.0]])
def test_rank_predictions_by_score_equals_jax(scores):
    np.testing.assert_array_equal(submission.rank_predictions_by_score(scores),
                                  jax_submission.rank_predictions_by_score(scores))


def test_rank_ragged_scores_equals_jax():
    _, scores, lengths = _labels_scores(3)
    ps, js = _both(scores, lengths)
    ours, ref = submission.rank_ragged_scores(ps), jax_submission.rank_ragged_scores(js)
    np.testing.assert_array_equal(ours.values, ref.values)
    np.testing.assert_array_equal(ours.offsets, ref.offsets)
    assert ours.values.dtype == ref.values.dtype


def test_submission_zip_equals_jax_byte_for_byte(tmp_path):
    _, scores, lengths = _labels_scores(4)
    ps, js = _both(scores, lengths)
    ids = np.arange(1000, 1000 + len(lengths))
    for name, mod, s in (("port", submission, ps), ("jax", jax_submission, js)):
        mod.write_submission_file(ids, mod.rank_ragged_scores(s), tmp_path / name / "predictions.txt")
        assert not (tmp_path / name / "predictions.txt").exists()  # rm_file
    blobs = [zipfile.ZipFile(tmp_path / n / "predictions.zip").read("predictions.txt")
             for n in ("port", "jax")]
    assert blobs[0] == blobs[1] and blobs[0].count(b"\n") == len(ids)
    path = tmp_path / "rt" / "predictions.txt"
    submission.write_submission_file(ids, submission.rank_ragged_scores(ps), path, rm_file=False)
    rt_ids, rt_ranks = submission.read_submission_file(path)
    np.testing.assert_array_equal(rt_ids, ids)
    np.testing.assert_array_equal(rt_ranks.values, submission.rank_ragged_scores(ps).values)
    with pytest.raises(ValueError, match="suffix"):
        submission.zip_submission_file(path, filename_zip="x.tar", verbose=False)


def test_scalar_logger_writes_what_jax_writes(tmp_path):
    for name, cls in (("port", ScalarLogger), ("jax", jax_logging.ScalarLogger)):
        with cls(tmp_path / name, tensorboard=False) as log:
            log.log("train/loss", 0.5, step=3)
            log.log_dict({"val/auc": 0.75, "skip": "text"}, step=4)
    rows = [[{k: v for k, v in json.loads(line).items() if k != "ts"}
             for line in (tmp_path / n / "scalars.jsonl").read_text().splitlines()]
            for n in ("port", "jax")]
    assert rows[0] == rows[1] == [{"tag": "train/loss", "value": 0.5, "step": 3},
                                  {"tag": "val/auc", "value": 0.75, "step": 4}]


# ---- table -------------------------------------------------------------------

def _table(mod_table, mod_ragged):
    rng = np.random.default_rng(5)
    return mod_table({
        "impression_id": np.arange(10, 20, dtype=np.uint32),
        "scores": mod_ragged.from_lists([rng.random(rng.integers(0, 5)).astype(np.float32)
                                         for _ in range(10)], dtype=np.float32),
        "ranks": mod_ragged.from_lists([rng.integers(1, 9, rng.integers(1, 4)) for _ in range(10)],
                                       dtype=np.int32),
        "title": np.asarray([f"t{i}" for i in range(10)], object),
        "time": np.arange(10).astype("datetime64[us]"),
    })


def _assert_tables_equal(a, b):
    assert a.columns == b.columns and len(a) == len(b)
    for n in a.columns:
        x, y = a[n], b[n]
        if hasattr(x, "offsets"):
            np.testing.assert_array_equal(x.offsets, y.offsets, err_msg=n)
            x, y = x.values, y.values
        np.testing.assert_array_equal(x, y, err_msg=n)
        assert x.dtype == y.dtype, n


def test_parquet_round_trips_through_both_packages(tmp_path):
    ours, ref = _table(Table, Ragged), _table(jax_table.Table, JaxRagged)
    write_parquet(ours, tmp_path / "port.parquet")
    jax_table.write_parquet(ref, tmp_path / "jax.parquet")
    for path in ("port.parquet", "jax.parquet"):
        _assert_tables_equal(read_parquet(tmp_path / path), jax_table.read_parquet(tmp_path / path))
        _assert_tables_equal(read_parquet(tmp_path / path), ours)
    sub = read_parquet(tmp_path / "jax.parquet", columns=["scores", "title"])
    assert sub.columns == ["scores", "title"]


def test_table_operations_equal_jax():
    ours, ref = _table(Table, Ragged), _table(jax_table.Table, JaxRagged)
    cases = [
        lambda t: t.drop(["title"]),
        lambda t: t.rename({"scores": "s"}),
        lambda t: t.slice(3, 4),
        lambda t: t.slice(8, 5),
        lambda t: t.sample_fraction(0.5, np.random.default_rng(1)),
        lambda t: t.sample_fraction(0.3, np.random.default_rng(1), shuffle=False),
        lambda t: t.shuffle(np.random.default_rng(2)),
        lambda t: t.concat(t.slice(2, 3)),
        lambda t: t.filter(np.arange(10) % 3 == 0).head(2),
    ]
    for op in cases:
        _assert_tables_equal(op(ours), op(ref))
    assert ours.to_dict() == ref.to_dict()
    assert repr(ours) == repr(ref)

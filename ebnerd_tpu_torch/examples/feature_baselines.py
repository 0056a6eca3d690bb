"""Non-learned feature baselines (the port of ``examples/feature_baselines.py``,
after the reference's ``examples/baseline/ebnerd_feat_baselines.py``): rank
the inview articles by an article-level statistic (total pageviews, total
inviews, total read time) or by how often the split shows them inview, and
write one submission zip per feature.

``--synthetic`` builds the JAX example's synthetic split in memory (no
pyarrow); ``--data_path`` reads parquet (pyarrow, when called).

  python -m ebnerd_tpu_torch.examples.feature_baselines --synthetic --out_dir /tmp/feat
"""
from __future__ import annotations

import argparse
from collections import Counter
from pathlib import Path

import numpy as np

from .. import constants as c
from ..data.behaviors import ebnerd_from_tables
from ..data.ragged import Ragged
from ..utils.submission import rank_ragged_scores, write_submission_file

FEATURES = (
    c.DEFAULT_TOTAL_PAGEVIEWS_COL,
    c.DEFAULT_TOTAL_INVIEWS_COL,
    c.DEFAULT_TOTAL_READ_TIME_COL,
)


def scores_from_article_stat(inview: Ragged, articles, stat_col: str) -> Ragged:
    """Ragged per-candidate scores = the article's stat value (missing
    articles score 0 -> ranked last, like the reference's null handling)."""
    ids = np.asarray(articles[c.DEFAULT_ARTICLE_ID_COL])
    stats = np.asarray(articles[stat_col], dtype=np.float64)
    order = np.argsort(ids, kind="stable")
    sorted_ids, sorted_stats = ids[order], stats[order]
    pos = np.searchsorted(sorted_ids, inview.values)
    pos_c = np.minimum(pos, len(sorted_ids) - 1)
    found = sorted_ids[pos_c] == inview.values
    vals = np.where(found, sorted_stats[pos_c], 0.0).astype(np.float32)
    return Ragged(vals, inview.offsets.copy())


def scores_from_inview_counts(inview: Ragged) -> Ragged:
    """Score = how often the article appears inview across the split
    (the reference's test-set inview-count baseline)."""
    counts = Counter(inview.values.tolist())
    vals = np.asarray([counts[v] for v in inview.values.tolist()], np.float32)
    return Ragged(vals, inview.offsets.copy())


def load_split(synthetic: bool, data_path=None, datasplit: str = "ebnerd_testset/test"):
    """(behaviors joined with a history of 1, articles)."""
    if synthetic:
        from ..data.synthetic import synthetic_ebnerd_tables

        history, behaviors, articles = synthetic_ebnerd_tables(
            n_users=100, n_articles=300, n_impressions=1000, seed=0)
        return ebnerd_from_tables(behaviors, history, history_size=1), articles
    from ..data.behaviors import ebnerd_from_path
    from ..data.table import read_parquet

    root = Path(data_path).expanduser()
    split = root / datasplit
    articles = read_parquet(split.parent / "articles.parquet"
                            if (split.parent / "articles.parquet").exists()
                            else root / "articles.parquet")
    return ebnerd_from_path(split, history_size=1), articles


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--data_path", type=str, default=None)
    p.add_argument("--datasplit", type=str, default="ebnerd_testset/test")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--out_dir", type=str, default="ebnerd_predictions/baselines")
    args = p.parse_args(argv)
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)

    df, articles = load_split(args.synthetic, args.data_path, args.datasplit)
    inview: Ragged = df[c.DEFAULT_INVIEW_ARTICLES_COL]
    imp_ids = np.asarray(df[c.DEFAULT_IMPRESSION_ID_COL])

    baselines = {feat: scores_from_article_stat(inview, articles, feat)
                 for feat in FEATURES}
    baselines["inview_counts"] = scores_from_inview_counts(inview)

    for name, scores in baselines.items():
        ranks = rank_ragged_scores(scores)
        write_submission_file(imp_ids, ranks, out / "predictions.txt",
                              filename_zip=f"{name}_predictions.zip")
        print(f"baseline {name}: wrote {name}_predictions.zip")
    return baselines


if __name__ == "__main__":
    main()

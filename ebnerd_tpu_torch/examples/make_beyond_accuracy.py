"""Build the beyond-accuracy evaluation artifacts and score baseline
recommenders on them (the port of ``examples/make_beyond_accuracy.py``,
after the reference's ``examples/beyond_accuracy/make_beyond_accuracy.ipynb``).

From the test split's ``is_beyond_accuracy`` impressions it derives the
fixed candidate list, an article attribute lookup (min-max normalized
pageview popularity, sentiment, category, document vectors) and truncated
user histories, then evaluates editorial (top-inviews), popularity
(top-pageviews) and random rankings with the full beyond-accuracy suite
(diversity, sentiment, novelty, serendipity, coverage, distribution).

``--synthetic`` builds the JAX example's synthetic test split in memory (no
pyarrow); ``--data_path`` reads parquet (pyarrow, when called).

  python -m ebnerd_tpu_torch.examples.make_beyond_accuracy --synthetic --out_dir /tmp/ba
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from .. import constants as c
from ..data.behaviors import ebnerd_from_tables
from ..evaluation.beyond_accuracy import (
    Coverage,
    Distribution,
    IntralistDiversity,
    Novelty,
    Sentiment,
    Serendipity,
)
from ..evaluation.utils import scale_range

N_RECOMMENDATIONS = 5
HISTORY_TRUNC = 20


def build_lookup(articles, docvecs: np.ndarray) -> dict:
    """{article_id: {attributes...}}: the beyond-accuracy lookup dict
    (notebook cells 31-33: min-max normalized pageviews + doc embeddings)."""
    ids = np.asarray(articles[c.DEFAULT_ARTICLE_ID_COL])
    pv = np.asarray(articles[c.DEFAULT_TOTAL_PAGEVIEWS_COL], dtype=np.float64)
    pop = scale_range(pv, t_min=1e-6, t_max=1.0)  # avoid -log2(0)
    sent = np.asarray(articles[c.DEFAULT_SENTIMENT_SCORE_COL], dtype=np.float64)
    cat = np.asarray(articles[c.DEFAULT_CATEGORY_COL])
    out = {}
    for i, aid in enumerate(ids):
        out[int(aid)] = {
            "popularity": float(pop[i]),
            "sentiment_score": float(sent[i]),
            "category": int(cat[i]),
            "vector": docvecs[i].tolist(),
        }
    return out


def load_split(args):
    """(behaviors joined with their truncated histories, articles)."""
    if args.synthetic:
        from ..data.synthetic import synthetic_ebnerd_tables

        history, behaviors, articles = synthetic_ebnerd_tables(
            n_users=120, n_articles=260, n_impressions=800, seed=args.seed, test_set=True)
        return ebnerd_from_tables(behaviors, history, history_size=HISTORY_TRUNC), articles
    from ..data.behaviors import ebnerd_from_path
    from ..data.table import read_parquet

    root = Path(args.data_path).expanduser()
    articles = read_parquet(root / "articles.parquet")
    return ebnerd_from_path(root / args.testsplit, history_size=HISTORY_TRUNC), articles


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--data_path", type=str, default=None)
    p.add_argument("--testsplit", type=str, default="ebnerd_testset/test")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--out_dir", type=str, default="ebnerd_predictions/beyond_accuracy")
    p.add_argument("--n_recommendations", type=int, default=N_RECOMMENDATIONS)
    p.add_argument("--seed", type=int, default=42)
    args = p.parse_args(argv)
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(args.seed)

    df, articles = load_split(args)
    if c.DEFAULT_IS_BEYOND_ACCURACY_COL in df:
        ba_rows = df.filter(np.asarray(df[c.DEFAULT_IS_BEYOND_ACCURACY_COL]))
    else:
        ba_rows = df
    if len(ba_rows) == 0:
        raise SystemExit("no beyond-accuracy rows in the split")

    # the fixed candidate list: the BA impressions share one inview set
    # (notebook cell 13 takes the first row's list)
    inview = ba_rows[c.DEFAULT_INVIEW_ARTICLES_COL]
    candidates = np.unique(inview.values)
    histories = ba_rows[c.DEFAULT_HISTORY_ARTICLE_ID_COL]

    ids = np.asarray(articles[c.DEFAULT_ARTICLE_ID_COL])
    docvecs = rng.standard_normal((len(ids), 32))  # placeholder w/o real embeddings
    lookup = build_lookup(articles, docvecs)
    known = [a for a in candidates if int(a) in lookup]

    top_by = lambda key: np.asarray(
        sorted(known, key=lambda a: -lookup[int(a)][key])[: args.n_recommendations]
    )
    k = args.n_recommendations
    recs = {
        "editorial_topinview": top_by("popularity"),  # proxy: inviews ~ pageviews
        "popular_toppageviews": top_by("popularity"),
        "random": rng.choice(known, size=k, replace=False),
    }

    div, sen, nov, ser, cov, dist = (IntralistDiversity(), Sentiment(),
                                     Novelty(), Serendipity(), Coverage(),
                                     Distribution())
    n_users = len(ba_rows)
    results = {}
    for name, rec in recs.items():
        R = np.tile(rec, (n_users, 1))
        H = [histories.row(i) for i in range(n_users)]
        cov_c, cov_f = cov(R, candidates)
        results[name] = {
            "intralist_diversity": float(np.nanmean(div(R, lookup, "vector"))),
            "sentiment": float(np.nanmean(sen(R, lookup, "sentiment_score"))),
            "novelty": float(np.nanmean(nov(R, lookup, "popularity"))),
            "serendipity": float(np.nanmean(ser(R, H, lookup, "vector"))),
            "coverage_count": cov_c,
            "coverage_fraction": float(cov_f),
            "category_distribution": dist(R, lookup, "category"),
        }
    # attainable bounds on the candidate list (notebook cells 42-72)
    lo_d, hi_d = div._candidate_diversity(known, k, lookup, "vector",
                                          max_number_combinations=2000,
                                          seed=args.seed)
    results["_bounds"] = {
        "diversity": [lo_d, hi_d],
        "sentiment": list(sen._candidate_sentiment(known, k, lookup,
                                                   "sentiment_score")),
        "novelty": list(nov._candidate_novelty(known, k, lookup, "popularity")),
    }
    (out / "beyond_accuracy_baselines.json").write_text(
        json.dumps(results, indent=2, default=str)
    )
    np.save(out / "candidate_list.npy", candidates)
    print(json.dumps({k2: {m: v for m, v in r.items()
                           if not isinstance(v, dict)}
                      for k2, r in results.items()}, indent=2, default=str))
    return results


if __name__ == "__main__":
    main()

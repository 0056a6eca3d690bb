"""Synthetic EB-NeRD split generator (copy of ``ebnerd_tpu/data/synthetic.py``).

``synthetic_ebnerd_tables`` builds the history, behaviors and articles
tables of one split in memory, with the real EB-NeRD schema (column names
and dtypes; the data is generated); ``make_synthetic_ebnerd`` writes the
same tables as the three parquet files of the JAX function (needs pyarrow
when called). Both draw from ``np.random.default_rng(seed)`` in the JAX
function's order, so the tables are bit-equal to what it writes.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from .. import constants as c
from .ragged import Ragged
from .table import Table, write_parquet

__all__ = ["make_synthetic_ebnerd", "make_synthetic_articles", "synthetic_ebnerd_tables"]

_WORDS = (
    "nyhed krim dansk politi sag mand kvinde bil vej hus penge job sport bold "
    "kamp sejr mål by land vejr regn sol vind grad uge dag tid år liv barn "
    "skole læge syg mad køb salg pris krone marked parti valg lov ret dom"
).split()


def _random_titles(rng: np.random.Generator, n: int, min_words=3, max_words=12) -> list[str]:
    lens = rng.integers(min_words, max_words + 1, size=n)
    return [" ".join(rng.choice(_WORDS, size=k)) for k in lens]


def make_synthetic_articles(
    rng: np.random.Generator,
    n_articles: int,
    first_id: int = 3000000,
) -> Table:
    ids = np.arange(first_id, first_id + n_articles, dtype=np.int32)
    n_cat = 25
    pageviews = rng.pareto(1.2, size=n_articles) * 1000.0
    return Table(
        {
            c.DEFAULT_ARTICLE_ID_COL: ids,
            c.DEFAULT_TITLE_COL: np.asarray(_random_titles(rng, n_articles), object),
            c.DEFAULT_SUBTITLE_COL: np.asarray(_random_titles(rng, n_articles), object),
            c.DEFAULT_BODY_COL: np.asarray(
                _random_titles(rng, n_articles, 20, 60), object
            ),
            c.DEFAULT_CATEGORY_COL: rng.integers(1, n_cat, size=n_articles).astype(np.int16),
            c.DEFAULT_SUBCATEGORY_COL: Ragged.from_lists(
                [
                    rng.integers(1, 90, size=rng.integers(0, 3)).astype(np.int16).tolist()
                    for _ in range(n_articles)
                ],
                dtype=np.int16,
            ),
            c.DEFAULT_SENTIMENT_SCORE_COL: rng.random(n_articles).astype(np.float32),
            c.DEFAULT_SENTIMENT_LABEL_COL: np.asarray(
                rng.choice(["Negative", "Neutral", "Positive"], size=n_articles), object
            ),
            c.DEFAULT_TOTAL_INVIEWS_COL: (pageviews * rng.uniform(2, 6, n_articles)).astype(np.int64),
            c.DEFAULT_TOTAL_PAGEVIEWS_COL: pageviews.astype(np.int64),
            c.DEFAULT_TOTAL_READ_TIME_COL: (pageviews * rng.uniform(5, 40, n_articles)).astype(np.float32),
        }
    )


def synthetic_ebnerd_tables(
    n_users: int = 50,
    n_articles: int = 120,
    n_impressions: int = 400,
    max_history: int = 40,
    max_inview: int = 15,
    seed: int = 7,
    test_set: bool = False,
) -> tuple[Table, Table, Table]:
    """(history, behaviors, articles) of one synthetic split, in memory."""
    rng = np.random.default_rng(seed)
    articles = make_synthetic_articles(rng, n_articles)
    article_ids = np.asarray(articles[c.DEFAULT_ARTICLE_ID_COL])

    user_ids = rng.choice(np.arange(10_000, 999_999), size=n_users, replace=False).astype(np.uint32)
    base_time = np.datetime64("2023-05-18T07:00:00", "us")

    # history: per-user ragged article list with timestamps/read-times/scrolls
    hist_lens = rng.integers(3, max_history + 1, size=n_users)
    hist_articles = Ragged.from_lists(
        [rng.choice(article_ids, size=k).tolist() for k in hist_lens], dtype=np.int32
    )
    ts_values = (
        base_time.astype(np.int64)
        - rng.integers(1, 21 * 24 * 3600, size=hist_articles.total) * 1_000_000
    )
    history = Table(
        {
            c.DEFAULT_USER_COL: user_ids,
            c.DEFAULT_HISTORY_IMPRESSION_TIMESTAMP_COL: Ragged(
                np.sort(ts_values).astype("datetime64[us]"), hist_articles.offsets
            ),
            c.DEFAULT_HISTORY_SCROLL_PERCENTAGE_COL: Ragged(
                rng.uniform(0, 100, hist_articles.total).astype(np.float32),
                hist_articles.offsets,
            ),
            c.DEFAULT_HISTORY_ARTICLE_ID_COL: hist_articles,
            c.DEFAULT_HISTORY_READ_TIME_COL: Ragged(
                rng.exponential(30, hist_articles.total).astype(np.float32),
                hist_articles.offsets,
            ),
        }
    )

    # behaviors: impressions with inview + clicked subsets
    imp_users = rng.choice(user_ids, size=n_impressions)
    inview_lens = rng.integers(2, max_inview + 1, size=n_impressions)
    inview_rows, clicked_rows = [], []
    for k in inview_lens:
        inview = rng.choice(article_ids, size=k, replace=False)
        n_click = 1 if rng.random() < 0.85 else min(2, k)
        clicked_rows.append(rng.choice(inview, size=n_click, replace=False).tolist())
        inview_rows.append(inview.tolist())
    behaviors = {
        c.DEFAULT_IMPRESSION_ID_COL: np.arange(1, n_impressions + 1, dtype=np.uint32),
        c.DEFAULT_ARTICLE_ID_COL: rng.choice(article_ids, size=n_impressions).astype(np.int32),
        c.DEFAULT_IMPRESSION_TIMESTAMP_COL: (
            base_time.astype(np.int64)
            + np.sort(rng.integers(0, 7 * 24 * 3600, size=n_impressions)) * 1_000_000
        ).astype("datetime64[us]"),
        c.DEFAULT_READ_TIME_COL: rng.exponential(25, n_impressions).astype(np.float32),
        c.DEFAULT_SCROLL_PERCENTAGE_COL: rng.uniform(0, 100, n_impressions).astype(np.float32),
        c.DEFAULT_DEVICE_COL: rng.integers(1, 4, size=n_impressions).astype(np.int8),
        c.DEFAULT_INVIEW_ARTICLES_COL: Ragged.from_lists(inview_rows, dtype=np.int32),
        c.DEFAULT_CLICKED_ARTICLES_COL: Ragged.from_lists(clicked_rows, dtype=np.int32),
        c.DEFAULT_USER_COL: imp_users,
        c.DEFAULT_IS_SSO_USER_COL: rng.random(n_impressions) < 0.3,
        c.DEFAULT_GENDER_COL: rng.integers(0, 3, size=n_impressions).astype(np.int8),
        c.DEFAULT_POSTCODE_COL: rng.integers(0, 5, size=n_impressions).astype(np.int8),
        c.DEFAULT_AGE_COL: rng.integers(0, 9, size=n_impressions).astype(np.int8),
        c.DEFAULT_IS_SUBSCRIBER_COL: rng.random(n_impressions) < 0.2,
        c.DEFAULT_SESSION_ID_COL: rng.integers(1, n_impressions, size=n_impressions).astype(np.uint32),
        c.DEFAULT_NEXT_READ_TIME_COL: rng.exponential(25, n_impressions).astype(np.float32),
        c.DEFAULT_NEXT_SCROLL_PERCENTAGE_COL: rng.uniform(0, 100, n_impressions).astype(np.float32),
    }
    if test_set:
        behaviors[c.DEFAULT_IS_BEYOND_ACCURACY_COL] = rng.random(n_impressions) < 0.1

    return history, Table(behaviors), articles


def make_synthetic_ebnerd(
    path: Path | str,
    n_users: int = 50,
    n_articles: int = 120,
    n_impressions: int = 400,
    max_history: int = 40,
    max_inview: int = 15,
    seed: int = 7,
    test_set: bool = False,
) -> Path:
    """Write history.parquet / behaviors.parquet / articles.parquet under ``path``."""
    history, behaviors, articles = synthetic_ebnerd_tables(
        n_users, n_articles, n_impressions, max_history, max_inview, seed, test_set)
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    write_parquet(history, path / "history.parquet")
    write_parquet(behaviors, path / "behaviors.parquet")
    write_parquet(articles, path / "articles.parquet")
    return path

"""Getting started with the EB-NeRD data layer (the port of
``examples/dataset_overview.py``, after the reference's
``examples/datasets/ebnerd_overview.ipynb``):

  load splits -> time-span sanity check -> truncate + join history ->
  binary labels -> wu2019 negative sampling -> known-user flag ->
  a peek at the articles table.

Runs against a real EB-NeRD root (``--data_path ~/ebnerd_data --datasplit
ebnerd_demo``; reads parquet, so it needs pyarrow) or, with no arguments,
against the JAX example's synthetic split built in memory (no pyarrow).

  python -m ebnerd_tpu_torch.examples.dataset_overview [--data_path ... --datasplit ...]
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from .. import constants as c
from ..data.behaviors import (
    add_known_user_column,
    create_binary_labels_column,
    ebnerd_from_tables,
    sampling_strategy_wu2019,
    truncate_history,
)
from ..data.descriptive import (
    min_max_impression_time_behaviors,
    min_max_impression_time_history,
)


def show(df, cols, n=5, title=""):
    if title:
        print(f"\n== {title} ==")
    for i in range(min(n, len(df))):
        row = {}
        for col in cols:
            v = df[col]
            row[col] = v.row(i).tolist() if hasattr(v, "row") else v[i]
        print(" ", row)


def load_split(data_path, datasplit):
    """(history, behaviors, articles) of the train split: parquet under
    ``data_path`` (pyarrow), or the JAX example's synthetic split in memory."""
    if data_path:
        from ..data.table import read_parquet

        split = Path(data_path).expanduser() / datasplit
        train = split / "train"
        return (read_parquet(train / "history.parquet"),
                read_parquet(train / "behaviors.parquet"),
                read_parquet(split / "articles.parquet"))
    from ..data.synthetic import synthetic_ebnerd_tables

    print("(no --data_path: generating a synthetic EB-NeRD split)")
    return synthetic_ebnerd_tables(n_users=60, n_articles=150, n_impressions=400, seed=11)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data_path", type=str, default=None)
    ap.add_argument("--datasplit", type=str, default="ebnerd_demo")
    ap.add_argument("--history_size", type=int, default=30)
    args = ap.parse_args(argv)

    history, behaviors, articles = load_split(args.data_path, args.datasplit)

    # -- raw splits (reference cells 3-6) ---------------------------------
    print(f"history: {len(history)} users, behaviors: {len(behaviors)} impressions")
    print("history period:  ", min_max_impression_time_history(history))
    print("behaviors period:", min_max_impression_time_behaviors(behaviors))

    # -- truncate + join history onto behaviors (cells 8-10) --------------
    truncate_history(history, c.DEFAULT_HISTORY_ARTICLE_ID_COL,
                     history_size=args.history_size)
    df = ebnerd_from_tables(behaviors, history, history_size=args.history_size)
    show(df, [c.DEFAULT_USER_COL, c.DEFAULT_HISTORY_ARTICLE_ID_COL],
         title=f"behaviors ⋈ history (tail {args.history_size}, left-pad 0)")
    lens = df[c.DEFAULT_HISTORY_ARTICLE_ID_COL].lengths
    assert (lens <= args.history_size).all()

    # -- binary labels (cells 11-13) ---------------------------------------
    labeled = create_binary_labels_column(df, shuffle=True, seed=123)
    show(labeled, [c.DEFAULT_INVIEW_ARTICLES_COL, c.DEFAULT_LABELS_COL],
         n=3, title="binary labels (one per inview article)")

    # -- wu2019 negative sampling (cell 14) --------------------------------
    sampled = create_binary_labels_column(
        sampling_strategy_wu2019(df, npratio=4, shuffle=True,
                                 with_replacement=True, seed=123))
    k = np.unique(sampled[c.DEFAULT_INVIEW_ARTICLES_COL].lengths)
    print(f"\nwu2019 npratio=4: every impression now has exactly {k} candidates")
    show(sampled, [c.DEFAULT_INVIEW_ARTICLES_COL, c.DEFAULT_LABELS_COL], n=3)

    # -- known users -------------------------------------------------------
    flagged = add_known_user_column(
        labeled, known_users=np.asarray(history[c.DEFAULT_USER_COL])[:10])
    frac = float(np.mean(np.asarray(flagged["is_known_user"])))
    print(f"\nis_known_user (vs first 10 history users): {frac:.1%} of impressions")

    # -- articles table (cells 15+) ----------------------------------------
    print(f"\narticles: {len(articles)} rows; columns: {articles.columns[:8]}...")
    show(articles, [c.DEFAULT_ARTICLE_ID_COL, c.DEFAULT_TITLE_COL,
                    c.DEFAULT_CATEGORY_COL], n=3)
    print("\noverview complete — next: python -m ebnerd_tpu_torch.train_newsrec")
    return {"df": df, "labeled": labeled, "sampled": sampled, "flagged": flagged}


if __name__ == "__main__":
    main()

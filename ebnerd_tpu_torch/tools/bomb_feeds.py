"""Input-pipeline stress test (the port of ``scripts/bomb_feeds.py``, the
counterpart of the reference's ``test/bombing/bomb_dataloader.py``): iterate
the feeds repeatedly and measure the host's batch throughput.

The JAX script's split (300 users, 1,000 articles, ``--n_impressions``,
seed 0), built in memory (``synthetic_ebnerd_tables``; the JAX script writes
it as parquet and reads it back), the history truncated to
``--history_size``, wu2019 sampling at npratio 4 with binary labels for the
training feed, binary labels on the whole split for the eval feed, a token
lookup of 30 ids per article from ``default_rng(0)``. Then ``--iterations``
epochs of ``NewsrecFeed`` and passes of ``EvalFeed``, each under
``time_it``. Host only: no device is touched.

Prints the JAX script's lines, then one JSON line: the batches, impressions
and seconds of each feed and their batches per second on this host.

Run: python -m ebnerd_tpu_torch.tools.bomb_feeds [--iterations 300]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def feeds(n_impressions: int, batch_size: int, history_size: int):
    """(NewsrecFeed, EvalFeed, train rows, pretransform seconds) over the
    JAX script's split."""
    from .. import constants as c
    from ..data.behaviors import (create_binary_labels_column, ebnerd_from_tables,
                                  sampling_strategy_wu2019)
    from ..data.dataloader import EvalFeed, NewsrecFeed
    from ..data.lookup import Lookup
    from ..data.synthetic import synthetic_ebnerd_tables

    history, behaviors, articles = synthetic_ebnerd_tables(
        n_users=300, n_articles=1000, n_impressions=n_impressions, seed=0)
    df = ebnerd_from_tables(behaviors, history, history_size=history_size)
    train_df = create_binary_labels_column(sampling_strategy_wu2019(df, npratio=4, seed=0))
    val_df = create_binary_labels_column(df)
    ids = np.asarray(articles[c.DEFAULT_ARTICLE_ID_COL])
    lookup = Lookup.from_values(
        ids, np.random.default_rng(0).integers(1, 1000, (len(ids), 30)).astype(np.int32))
    t0 = time.perf_counter()
    feed = NewsrecFeed(train_df, lookup, history_size=history_size, batch_size=batch_size)
    pre_s = time.perf_counter() - t0
    efeed = EvalFeed(val_df, lookup, history_size=history_size, batch_size=batch_size)
    return feed, efeed, len(train_df), pre_s


def run(iterations: int = 300, n_impressions: int = 2000, batch_size: int = 32,
        history_size: int = 20, echo=print) -> dict:
    """Build the feeds, then ``iterations`` epochs of ``NewsrecFeed`` and
    passes of ``EvalFeed``; returns the JSON line's record (``echo`` gets
    the JAX script's lines)."""
    from ..utils.misc import time_it

    t0 = time.perf_counter()
    feed, efeed, rows, pre_s = feeds(n_impressions, batch_size, history_size)
    build_s = time.perf_counter() - t0
    echo(f"NewsrecFeed pretransform: {pre_s:.3f}s ({rows} rows)")
    n_batches = 0
    t0 = time.perf_counter()
    with time_it(f"NewsrecFeed x{iterations} epochs", log=echo):
        for _ in range(iterations):
            for _batch in feed.epoch():
                n_batches += 1
    train_s = time.perf_counter() - t0
    echo(f"  {n_batches} batches, {n_batches * batch_size} impressions")
    e_batches = 0
    t0 = time.perf_counter()
    with time_it(f"EvalFeed x{iterations} passes", log=echo):
        for _ in range(iterations):
            for _batch in efeed.batches():
                e_batches += 1
    eval_s = time.perf_counter() - t0
    echo(f"  {e_batches} batches")
    return {
        "iterations": iterations, "feeds_build_s": round(build_s, 4),
        "pretransform_s": round(pre_s, 4),
        "newsrec_batches": n_batches, "newsrec_impressions": n_batches * batch_size,
        "newsrec_s": round(train_s, 4), "newsrec_batches_per_s": round(n_batches / train_s, 1),
        "eval_batches": e_batches, "eval_s": round(eval_s, 4),
        "eval_batches_per_s": round(e_batches / eval_s, 1), "device": "host"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--iterations", type=int, default=300)
    p.add_argument("--n_impressions", type=int, default=2000)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--history_size", type=int, default=20)
    args = p.parse_args(argv)
    print(json.dumps(run(args.iterations, args.n_impressions, args.batch_size,
                         args.history_size)))
    return 0

if __name__ == "__main__":
    sys.exit(main())

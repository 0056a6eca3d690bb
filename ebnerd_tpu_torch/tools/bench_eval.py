"""Serving-side benchmark (the port of ``scripts/bench_eval.py``): two-tower
eval scoring throughput on the card (impressions/s), plus the one-time
corpus encode.

NRMS at the bench's widths (250,002 x 1,024 word table, title 30, history
20, 20 x 20 heads, bf16, the fused encoder), random weights from seed 0,
25,000 articles of uniform token ids; N_IMP ragged impressions of 5-15
candidates and 1-20 history articles, the JAX script's draws. The corpus is
encoded once through the article tower (``Trainer._article_index``, K1), and
each impression then costs a vector gather and the user tower
(``Trainer.score``). The first scoring pass is a warm-up (on the card:
the kernels' build and first launches; the JAX script's compile), the
second is timed, synchronised.

Prints the JAX script's two lines, then one JSON line: metric, value
(impressions/s), unit, candidate_scores_per_s, corpus_encode_ms,
corpus_articles_per_s, n_impressions, bs, device and card. On the CPU the
metric is named ``..._on_cpu``: no device was measured.

Env: BE_BS (1024); for tiny runs also the bench's BENCH_VOCAB, BENCH_EMB and
BENCH_NART (``bench.widths``), which the JAX script fixes.

Run: python -m ebnerd_tpu_torch.tools.bench_eval [n_impressions] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from .. import bench, resolve_device

T, H = 30, 20


def run(n_imp: int, bs: int, device, vocab: int = bench.VOCAB, emb: int = bench.EMB,
        n_art: int = bench.N_ARTICLES) -> dict:
    from .. import constants as c
    from ..data.dataloader import EvalFeed
    from ..data.lookup import Lookup
    from ..data.ragged import Ragged
    from ..data.table import Table
    from ..models import NRMS, HParamsNRMS, token_batch
    from ..training import Trainer, TrainerConfig

    device = resolve_device(device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    rng = np.random.default_rng(0)
    model = NRMS(HParamsNRMS(dropout=0.2), vocab_size=vocab, word_emb_dim=emb,
                 dtype=torch.bfloat16, use_fused_encoder=True, device=device)
    tokens = rng.integers(0, vocab, (n_art, T)).astype(np.int32)
    ids = np.arange(1, n_art + 1, dtype=np.int64)
    lookup = Lookup.from_values(ids, tokens)
    trainer = Trainer(model, {"title": lookup.matrix}, token_batch,
                      TrainerConfig(learning_rate=1e-4, seed=0), device=device,
                      log_fn=lambda s: None)
    k = 5
    # the JAX script's init batch: drawn (and unused here) to keep its stream
    rng.integers(0, n_art + 1, (8, H))
    rng.integers(0, n_art + 1, (8, k))

    # ragged eval impressions: 5-15 candidates, 1-20 history articles
    inview = Ragged.from_lists(
        [rng.choice(ids, rng.integers(5, 16), replace=False) for _ in range(n_imp)])
    hist = Ragged.from_lists(
        [rng.choice(ids, rng.integers(1, H + 1), replace=False) for _ in range(n_imp)])
    df = Table({
        c.DEFAULT_IMPRESSION_ID_COL: np.arange(n_imp, dtype=np.uint32),
        c.DEFAULT_INVIEW_ARTICLES_COL: inview,
        c.DEFAULT_LABELS_COL: Ragged(np.zeros(inview.total, np.int8), inview.offsets.copy()),
        c.DEFAULT_HISTORY_ARTICLE_ID_COL: hist,
    })
    feed = EvalFeed(df, lookup, history_size=H, batch_size=bs)

    sync()
    t0 = time.perf_counter()
    trainer._article_index()
    sync()
    t_corpus = time.perf_counter() - t0

    scores = trainer.score(feed)  # warm
    if not np.isfinite(scores.values).all():
        raise RuntimeError("non-finite scores")
    sync()
    t0 = time.perf_counter()
    scores = trainer.score(feed)
    sync()
    dt = time.perf_counter() - t0
    print(f"corpus encode ({n_art} articles, one-time/param-state): "
          f"{t_corpus * 1000:.1f} ms ({n_art / t_corpus:,.0f} articles/s)")
    print(f"two-tower eval: {n_imp / dt:,.0f} impressions/s "
          f"({scores.total / dt:,.0f} candidate scores/s; "
          f"{n_imp} impressions in {dt * 1000:.1f} ms, bs {bs})")
    return {"metric": "nrms_two_tower_eval_impressions_per_sec_"
                      + ("per_chip" if cuda else "on_cpu"),
            "value": round(n_imp / dt, 1), "unit": "impressions/s",
            "candidate_scores_per_s": round(scores.total / dt, 1),
            "corpus_encode_ms": round(t_corpus * 1000, 2),
            "corpus_articles_per_s": round(n_art / t_corpus, 1),
            "n_impressions": n_imp, "n_scores": int(scores.total), "bs": bs,
            "device": device.type, "card": torch.cuda.get_device_name(0) if cuda else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_impressions", nargs="?", type=int, default=20_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    w = bench.widths()
    out = run(args.n_impressions, int(os.environ.get("BE_BS", "1024")), args.device,
              w["vocab"], w["emb"], w["n_articles"])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""End-to-end ``Trainer.fit`` throughput at the bench configuration (the port
of ``scripts/bench_fit.py``): the flagship number through the real host feed.

Drives the real pipeline: ``NewsrecFeed`` epoch batching, the prefetch thread
(2 batches ahead), the per-batch host dedup, the host -> device copies and
the fused training step (K1, K2), over a synthetic behaviors table with
``bench.py``'s shapes and Zipf(1.07) article popularity (the JAX script's
draws from ``default_rng(0)``: the Zipf token table, non-trivial article ids
``3 i + 11``, then the impressions). Reports impressions/s around ``fit()``'s
wall clock, to set beside ``bench.py``'s staged step: within about 5%, the
host feed is free.

Where the JAX script warms its compile cache over the dedup buckets with
``FIT_WARM_EPOCHS`` fits of ``FIT_WARM_STEPS`` steps, the card builds its
kernels and warms its allocator and libraries in the same fits.

Prints one JSON line: metric, value (impressions/s), unit, step_ms, config,
device, card. On the CPU the metric is named ``..._on_cpu``.

Env: FIT_BS (1024), FIT_STEPS (100 measured), FIT_WARM_EPOCHS (2),
FIT_WARM_STEPS (15), FIT_FUSED (1; 0 = unfused layers); for tiny runs also
the bench's BENCH_VOCAB, BENCH_EMB and BENCH_NART (``bench.widths``).

Run: python -m ebnerd_tpu_torch.tools.bench_fit [--device cpu]
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

H, NPRATIO = bench.HISTORY, bench.NPRATIO


def knobs(env=os.environ) -> dict:
    return {"bs": int(env.get("FIT_BS", "1024")), "steps": int(env.get("FIT_STEPS", "100")),
            "warm_epochs": int(env.get("FIT_WARM_EPOCHS", "2")),
            "warm_steps": int(env.get("FIT_WARM_STEPS", "15")),
            "fused": env.get("FIT_FUSED", "1") != "0",
            "vocab": bench.widths(env)["vocab"], "emb": bench.widths(env)["emb"],
            "n_art": bench.widths(env)["n_articles"]}


def behaviors(k: dict, seed: int = 0):
    """(behaviors table, lookup): the JAX script's draws."""
    from .. import constants as c
    from ..data.lookup import Lookup
    from ..data.ragged import Ragged
    from ..data.table import Table

    rng = np.random.default_rng(seed)
    n_art, bs = k["n_art"], k["bs"]
    ids = np.arange(1, n_art + 1, dtype=np.int64) * 3 + 11  # non-trivial id space
    tokens = bench.token_table(rng, "zipf", n_rows=n_art + 1, vocab=k["vocab"])[1:]
    lookup = Lookup.from_values(ids, tokens)
    kk = NPRATIO + 1
    n_imp = (k["warm_steps"] * k["warm_epochs"] + k["steps"] + 2) * bs
    hist = ids[bench.zipf_indices(rng, n_art, (n_imp, H))]
    cand = ids[bench.zipf_indices(rng, n_art, (n_imp, kk))]
    labels = np.zeros((n_imp, kk), np.float32)
    pos = rng.integers(0, kk, n_imp)
    labels[np.arange(n_imp), pos] = 1.0
    df = Table({
        c.DEFAULT_HISTORY_ARTICLE_ID_COL: Ragged.from_dense(hist),
        c.DEFAULT_INVIEW_ARTICLES_COL: Ragged.from_dense(cand),
        c.DEFAULT_LABELS_COL: Ragged.from_dense(labels),
        c.DEFAULT_USER_COL: np.arange(n_imp, dtype=np.int64),
    })
    return df, lookup


def run(k: dict, device) -> dict:
    from ..data.dataloader import NewsrecFeed
    from ..models import NRMS, HParamsNRMS, token_batch
    from ..training import Trainer, TrainerConfig

    device = resolve_device(device)
    cuda = device.type == "cuda"
    df, lookup = behaviors(k)
    model = NRMS(HParamsNRMS(dropout=0.2), vocab_size=k["vocab"], word_emb_dim=k["emb"],
                 dtype=torch.bfloat16, use_fused_encoder=k["fused"], device=device)
    trainer = Trainer(model, {"title": lookup.matrix}, token_batch,
                      TrainerConfig(learning_rate=1e-4, seed=0, early_stopping_patience=None,
                                    lr_patience=None),
                      device=device, log_fn=lambda s: None)
    feed = NewsrecFeed(df, lookup, history_size=H, batch_size=k["bs"], seed=0)
    for _ in range(k["warm_epochs"]):
        trainer.fit(feed, epochs=1, steps_per_epoch=k["warm_steps"])
    t0 = time.perf_counter()
    trainer.fit(feed, epochs=1, steps_per_epoch=k["steps"])  # ends by reading the loss
    dt = time.perf_counter() - t0
    return {"metric": "nrms_fit_impressions_per_sec" + ("" if cuda else "_on_cpu"),
            "value": round(k["bs"] * k["steps"] / dt, 1), "unit": "impressions/s",
            "step_ms": round(dt / k["steps"] * 1000, 2),
            "config": (f"bs{k['bs']} steps{k['steps']} fused={int(k['fused'])} bf16 dedup "
                       f"zipf prefetch2 vocab={k['vocab']}x{k['emb']} articles={k['n_art']}"),
            "device": device.type, "card": torch.cuda.get_device_name(0) if cuda else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(run(knobs(), args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

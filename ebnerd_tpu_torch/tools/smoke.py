"""Smoke gate of the port (the counterpart of ``scripts/smoke_tpu.py``): run
the bench-default training step and the fused kernels under a mesh, and exit
non-zero on any failure.

1. ``bench.main`` at its defaults (NRMS, the fused encoder, Philox dropout in
   the kernels, bf16, dedup) for 2 timed steps after 1 warm-up
   (``BENCH_STEPS`` / ``BENCH_WARMUP``, as the JAX script sets them); its JSON
   line is no benchmark number (too few steps);
2. the fused encoder under a one-process ``make_mesh()`` (a world-size-1
   process group: NCCL on the card, gloo on the CPU): one dedup training step
   of NRMS at the bench's widths on 2,048 articles, batch 64, then two-tower
   scoring of 32 impressions through ``Trainer.score`` (the article index
   built by the fused kernel).

Where the JAX script compiles for the TPU, the card runs the kernels built by
``nvcc`` at first use. ``--device cpu`` runs both on the CPU (the kernels'
plain versions); ``BENCH_VOCAB`` and ``BENCH_EMB`` (and ``BENCH_NART`` for
part 1) cut both parts for tiny runs (``bench.widths``).

Run: python -m ebnerd_tpu_torch.tools.smoke [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from .. import bench, resolve_device
from .dryrun_multihost import free_port


def mesh_fused_train_eval(device) -> dict:
    """One dedup training step and a two-tower scoring pass of the fused
    NRMS on a one-process mesh; returns the loss and the score count."""
    from .. import constants as c
    from ..data.dataloader import EvalFeed
    from ..data.lookup import Lookup
    from ..data.ragged import Ragged
    from ..data.table import Table
    from ..models import NRMS, HParamsNRMS, token_batch
    from ..parallel import distributed
    from ..parallel.mesh import make_mesh
    from ..training import Trainer, TrainerConfig

    device = resolve_device(device)
    vocab, emb = bench.widths()["vocab"], bench.widths()["emb"]
    n_articles, bs = 2048, 64
    rng = np.random.default_rng(0)
    table = rng.integers(0, vocab, size=(n_articles + 1, bench.TITLE)).astype(np.int32)
    distributed.initialize(f"localhost:{free_port()}", 1, 0, device=device)
    try:
        model = NRMS(HParamsNRMS(dropout=0.2), vocab_size=vocab, word_emb_dim=emb,
                     dtype=torch.bfloat16, use_fused_encoder=True, device=device)
        trainer = Trainer(model, {"title": table}, token_batch,
                          TrainerConfig(learning_rate=1e-4, seed=0), device=device,
                          log_fn=lambda s: None, mesh=make_mesh())
        k = bench.NPRATIO + 1
        labels = np.zeros((bs, k), np.float32)
        labels[:, 0] = 1.0
        batch = {
            "hist_idx": rng.integers(0, n_articles + 1, (bs, bench.HISTORY)).astype(np.int32),
            "cand_idx": rng.integers(0, n_articles + 1, (bs, k)).astype(np.int32),
            "labels": labels,
        }
        loss = float(trainer.train_step(batch))  # the trainer's host dedup prep, on the mesh
        if not np.isfinite(loss):
            raise RuntimeError(f"non-finite loss {loss}")

        ids = np.arange(1, n_articles + 1, dtype=np.int64)
        lookup = Lookup.from_values(ids, table[1:])
        inview = Ragged.from_lists(
            [rng.choice(ids, rng.integers(3, 9), replace=False) for _ in range(32)])
        hist = Ragged.from_lists(
            [rng.choice(ids, rng.integers(1, bench.HISTORY + 1), replace=False)
             for _ in range(32)])
        df = Table({
            c.DEFAULT_IMPRESSION_ID_COL: np.arange(32, dtype=np.uint32),
            c.DEFAULT_INVIEW_ARTICLES_COL: inview,
            c.DEFAULT_LABELS_COL: Ragged(np.zeros(inview.total, np.int8), inview.offsets.copy()),
            c.DEFAULT_HISTORY_ARTICLE_ID_COL: hist,
        })
        scores = trainer.score(EvalFeed(df, lookup, history_size=bench.HISTORY, batch_size=16))
        if scores.total != inview.total or not np.isfinite(scores.values).all():
            raise RuntimeError(f"{scores.total} scores for {inview.total} candidates, or not finite")
    finally:
        distributed.shutdown()
    print(f"[smoke] fused+dedup mesh train (loss {loss:.4f}) + two-tower eval "
          f"({scores.total} scores): OK", flush=True)
    return {"loss": loss, "scores": int(scores.total)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    os.environ.setdefault("BENCH_STEPS", "2")
    os.environ.setdefault("BENCH_WARMUP", "1")
    rc = bench.main(["--device", args.device])
    if rc:
        return rc
    print("[smoke] bench-default train step ran: OK", flush=True)
    out = mesh_fused_train_eval(args.device)
    print(json.dumps({"smoke": "ok", "device": args.device, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Training at the EB-NeRD large catalogue (125,000 articles) on one card: the
port's counterpart of ``scripts/bench_large.py``.

NAML (the default) at ``HParamsNAML`` defaults, title 30 + body 40 +
category + subcategory views, generator dropout (``prng_dropout`` False, as
the JAX script builds it), ``remat_encoder`` and ``encode_chunks`` 8; or
``BL_MODEL=nrms``, NRMS on the fused encoder (K1 and K2). Both on a 250,002 x
1,024 word table, bf16 compute, ``TrainerConfig(learning_rate=1e-4, seed=0,
dedup_articles=True)``, history 20, npratio 4. The draws are the JAX
script's, from ``np.random.default_rng(0)`` in its order: the tables, then
per batch ``hist_idx`` and ``cand_idx`` by Zipf(1.07) over the articles with
a permuted rank -> article map. One forced difference: the JAX script draws
``subcat`` in [0, 200) although ``subvert_num`` is 100 (XLA clamps the
out-of-range gather to row 99; ``F.embedding`` rejects it on the card), so
the port takes that same draw halved, into [0, 100): the stream after it,
and so every batch, stays the JAX script's.

Every batch is host-deduped (``prep_dedup_batch(raw, min_bucket=512)``, the
ladder's buckets) and staged on the device before the clock; the first step
at each distinct bucket runs once (``compile_warm_s``: on the card there is
no program to compile, so this is the first step's allocation and library
set-up per bucket, the counterpart of XLA's compile per ladder rung), then 3
warm steps, then ``BL_STEPS`` timed, synchronised.

Prints one JSON line with the JAX script's keys: metric, value
(impressions/s), unit, step_ms, config, uniq_mean, uniq_frac,
ladder_buckets, distinct_programs (the distinct buckets: one program each
under XLA), compile_warm_s, prep_ms, hbm_peak_gb
(``torch.cuda.max_memory_allocated``, GiB) and hbm_limit_gb (the card's
memory, GiB); and ``launches_per_step``, each kernel's launches per timed
step (NRMS: K1 2, K2 2 with its per-block kernel 2, GEMM 6, reduction 8, x
mask 1; NAML: none), ``device`` and ``card``. On the CPU the metric is named
``..._on_cpu`` and the memory keys are null: no device was measured.

Env: BL_BS (4096), BL_NART (125000), BL_STEPS (20), BL_MODEL (naml | nrms),
BL_REMAT (1), BL_CHUNKS (8); for tiny runs also the bench's BENCH_VOCAB and
BENCH_EMB (``bench.widths``), which the JAX script fixes.

Run: python -m ebnerd_tpu_torch.tools.bench_large [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from .. import resolve_device
from ..bench import widths, zipf_indices

H, T, TB, K = 20, 30, 40, 5
WARMUP = 3


def knobs(env=os.environ) -> dict:
    """The run's sizes and options from the environment (the JAX script's
    knobs and defaults; the word table's from ``bench.widths``)."""
    model = env.get("BL_MODEL", "naml")
    if model not in ("naml", "nrms"):
        raise ValueError(f"BL_MODEL must be naml or nrms, got {model!r}")
    return {"bs": int(env.get("BL_BS", "4096")), "n_art": int(env.get("BL_NART", "125000")),
            "steps": int(env.get("BL_STEPS", "20")), "model": model,
            "remat": env.get("BL_REMAT", "1") != "0", "chunks": int(env.get("BL_CHUNKS", "8")),
            "vocab": widths(env)["vocab"], "emb": widths(env)["emb"]}


def draw(k: dict, seed: int = 0) -> tuple[dict, list]:
    """(value tables, index batches) in the JAX script's draw order from
    ``default_rng(seed)``: title, then for NAML body, cat and subcat (the
    JAX draw in [0, 200) halved), then WARMUP + steps batches of
    ``hist_idx`` [bs, 20] and ``cand_idx`` [bs, 5] (Zipf ranks over the
    articles, permuted), labels one-hot on candidate 0."""
    r = np.random.default_rng(seed)
    n_art, vocab = k["n_art"], k["vocab"]
    tables = {"title": r.integers(0, vocab, (n_art + 1, T)).astype(np.int32)}
    if k["model"] == "naml":
        tables["body"] = r.integers(0, vocab, (n_art + 1, TB)).astype(np.int32)
        tables["cat"] = r.integers(0, 30, n_art + 1).astype(np.int32)
        tables["subcat"] = (r.integers(0, 200, n_art + 1) // 2).astype(np.int32)
    raws = []
    for _ in range(WARMUP + k["steps"]):
        raw = {"hist_idx": zipf_indices(r, n_art, (k["bs"], H)),
               "cand_idx": zipf_indices(r, n_art, (k["bs"], K)),
               "labels": np.zeros((k["bs"], K), np.float32)}
        raw["labels"][:, 0] = 1.0
        raws.append(raw)
    return tables, raws


def build_model(k: dict, device):
    """The JAX script's model at these knobs, weights from seed 0."""
    from ..models import NAML, NRMS, HParamsNAML, HParamsNRMS

    common = dict(vocab_size=k["vocab"], word_emb_dim=k["emb"], dtype=torch.bfloat16,
                  device=device, seed=0)
    if k["model"] == "naml":
        return NAML(HParamsNAML(), remat_encoder=k["remat"], encode_chunks=k["chunks"],
                    prng_dropout=False, **common)
    return NRMS(HParamsNRMS(), use_fused_encoder=True, **common)


def run(k: dict, device) -> dict:
    """Prep, stage, warm and time the steps; returns the JSON record."""
    from ..models.inputs import builder_for
    from ..ops import kernel_counters
    from ..training import Trainer, TrainerConfig
    from ..training.dedup import prep_dedup_batch

    device = resolve_device(device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    tables, raws = draw(k)
    trainer = Trainer(build_model(k, device), tables, builder_for(k["model"]),
                      TrainerConfig(learning_rate=1e-4, seed=0, dedup_articles=True),
                      device=device, log_fn=lambda s: None)
    n = len(raws)
    t_prep = time.perf_counter()
    preps = [prep_dedup_batch(raw, min_bucket=512) for raw in raws]
    uniqs = [p.pop("n_uniq") for p in preps]
    prep_ms = (time.perf_counter() - t_prep) / n * 1000
    buckets = sorted({p["art_uniq"].shape[0] for p in preps})
    staged = [trainer.prepare(p) for p in preps]
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    seen: dict = {}
    for s in staged:
        seen.setdefault(int(s["uniq_tokens"].shape[0]), s)
    t_c = time.perf_counter()
    for ex in seen.values():  # the first step at each bucket
        loss = trainer.step(ex)
    sync()
    warm_s = time.perf_counter() - t_c
    for i in range(WARMUP):
        loss = trainer.step(staged[i])
    sync()
    counters = kernel_counters()
    before = {name: fn.launches for name, fn in counters.items()}
    t0 = time.perf_counter()
    for i in range(WARMUP, n):
        loss = trainer.step(staged[i])
    sync()
    dt = time.perf_counter() - t0
    if not torch.isfinite(loss).all():
        raise RuntimeError(f"non-finite loss {loss}")
    steps, bs = k["steps"], k["bs"]
    per_step = {name: (fn.launches - before[name]) / steps for name, fn in counters.items()
                if fn.launches > before[name]}
    slots = bs * (H + K)
    card = torch.cuda.get_device_name(0) if cuda else None
    return {
        "metric": (f"{k['model']}_large_train_impressions_per_sec_"
                   + ("per_chip" if cuda else "on_cpu")),
        "value": round(bs * steps / dt, 1),
        "unit": "impressions/s",
        "step_ms": round(dt / steps * 1000, 2),
        "config": (f"bs{bs} n_articles={k['n_art']} bf16 dedup zipf steps{steps} "
                   f"vocab={k['vocab']}x{k['emb']} remat={int(k['remat'])} "
                   f"chunks={k['chunks']}"),
        "uniq_mean": int(np.mean(uniqs)),
        "uniq_frac": round(float(np.mean(uniqs)) / slots, 4),
        "ladder_buckets": buckets,
        "distinct_programs": len(buckets),
        "compile_warm_s": round(warm_s, 1),
        "prep_ms": round(prep_ms, 2),
        "hbm_peak_gb": round(torch.cuda.max_memory_allocated() / 2**30, 2) if cuda else None,
        "hbm_limit_gb": (round(torch.cuda.get_device_properties(0).total_memory / 2**30, 2)
                         if cuda else None),
        "launches_per_step": per_step,
        "loss": float(loss),
        "device": device.type,
        "card": card,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(run(knobs(), args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

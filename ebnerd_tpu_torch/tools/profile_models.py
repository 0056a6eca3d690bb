"""Per-family training-step timing on the card (the port of
``scripts/profile_models.py``): each family at its reproduction
configuration, one after another, through the port's training step
(``Trainer.step``, as ``bench.py`` runs it: forward, backward, Adam at lr
1e-4) on one staged batch.

The JAX script times a chained ``lax.scan`` of ``PM_STEPS`` steps in one
program; the port times ``PM_STEPS`` steps after one warm-up step, on the
synchronised host clock. The draws are the JAX script's, from
``default_rng(0)``: the tables (title, body 40, category in [0, 30),
subcategory, 768-wide document vectors), then per family its batch (Zipf or
uniform articles, users for LSTUR and NPA). One forced difference: the JAX
script draws ``subcat`` in [0, 200) although ``subvert_num`` is 100 (XLA
clamps the gather to row 99; ``F.embedding`` rejects it on the card), so the
port takes that draw halved, into [0, 100), and the stream after it is the
JAX script's. A family that fails prints FAILED and the sweep goes on, as in
the JAX script.

Prints the JAX script's lines (one per family: ms per step, impressions/s,
the dedup bucket and unique articles), then one JSON line with every
family's numbers, the device and the card. On the CPU the JSON names its
rates ``..._on_cpu``: no device was measured.

Env: PM_BS (512), PM_STEPS (10), PM_NART (25001), PM_DEDUP (1), PM_ART_DIST
(zipf | uniform), PM_DROPOUT (0.2), PM_REMAT (0), PM_PRNGDROP (0); for tiny
runs also the bench's BENCH_VOCAB and BENCH_EMB (``bench.widths``), which the
JAX script fixes.

Run: python -m ebnerd_tpu_torch.tools.profile_models [nrms lstur npa naml fastformer
     nrms_docvec] [--device cpu]
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

H, T, K = 20, 30, 5
N_USERS = 50_000
FAMILIES = ("nrms", "nrms_docvec", "lstur", "npa", "naml", "fastformer")


def knobs(env=os.environ) -> dict:
    return {"bs": int(env.get("PM_BS", "512")), "steps": int(env.get("PM_STEPS", "10")),
            "n_art": int(env.get("PM_NART", "25001")), "dedup": env.get("PM_DEDUP", "1") != "0",
            "art": env.get("PM_ART_DIST", "zipf"), "dropout": float(env.get("PM_DROPOUT", "0.2")),
            "remat": env.get("PM_REMAT", "0") != "0",
            "prng": env.get("PM_PRNGDROP", "0") != "0",
            "vocab": bench.widths(env)["vocab"], "emb": bench.widths(env)["emb"]}


def draw(r: np.random.Generator, k: dict, shape) -> np.ndarray:
    """Article rows, Zipf(1.07) over a permuted rank -> article map, or
    uniform (the JAX script's ``_draw``)."""
    if k["art"] == "uniform":
        return r.integers(0, k["n_art"], shape).astype(np.int32)
    return bench.zipf_indices(r, k["n_art"], shape)


def tables(r: np.random.Generator, k: dict) -> dict:
    """The JAX script's value tables (subcat: its draw halved)."""
    n, vocab = k["n_art"], k["vocab"]
    return {"title": r.integers(0, vocab, (n, T)).astype(np.int32),
            "body": r.integers(0, vocab, (n, 40)).astype(np.int32),
            "cat": r.integers(0, 30, n).astype(np.int32),
            "subcat": (r.integers(0, 200, n) // 2).astype(np.int32),
            "docvec": r.standard_normal((n, 768)).astype(np.float32)}


def build(name: str, k: dict, device):
    """The JAX script's model of one family (bf16, weights from seed 0)."""
    from ..models import (LSTUR, NAML, NPA, NRMS, Fastformer, NRMSDocVec)
    from ..models import config as mcfg

    common = dict(vocab_size=k["vocab"], word_emb_dim=k["emb"], dtype=torch.bfloat16,
                  device=device)
    dp = dict(dropout=k["dropout"])
    if name == "nrms":
        return NRMS(mcfg.HParamsNRMS(**dp), **common)
    if name == "lstur":
        return LSTUR(mcfg.HParamsLSTUR(n_users=N_USERS, **dp), remat_encoder=k["remat"],
                     prng_dropout=k["prng"], **common)
    if name == "npa":
        return NPA(mcfg.HParamsNPA(n_users=N_USERS, **dp), remat_encoder=k["remat"],
                   prng_dropout=k["prng"], **common)
    if name == "naml":
        return NAML(mcfg.HParamsNAML(**dp), remat_encoder=k["remat"], prng_dropout=k["prng"],
                    **common)
    if name == "fastformer":
        return Fastformer(mcfg.HParamsFastformer(**dp), prng_dropout=k["prng"], **common)
    if name == "nrms_docvec":
        return NRMSDocVec(mcfg.HParamsNRMSDocVec(), dtype=torch.bfloat16, device=device)
    raise ValueError(name)


def profile(name: str, r: np.random.Generator, tabs: dict, k: dict, device) -> dict:
    """Draw the family's batch, stage it, warm one step, time ``steps``."""
    from ..models.inputs import builder_for
    from ..training import Trainer, TrainerConfig
    from ..training.dedup import prep_dedup_batch

    cuda = device.type == "cuda"
    model = build(name, k, device)
    bs = k["bs"]
    raw = {"hist_idx": draw(r, k, (bs, H)), "cand_idx": draw(r, k, (bs, K))}
    if name in ("lstur", "npa"):
        raw["user_idx"] = r.integers(0, N_USERS, bs).astype(np.int32)
    rec, note = {}, ""
    if k["dedup"]:
        raw = prep_dedup_batch(raw, min_bucket=512)
        rec = {"bucket": int(raw["art_uniq"].shape[0]), "uniq": int(raw["n_uniq"])}
        note = f" dedup C={rec['bucket']} uniq={rec['uniq']}"
    labels = np.zeros((bs, K), np.float32)
    labels[:, 0] = 1.0
    raw["labels"] = labels
    trainer = Trainer(model, tabs, builder_for(name),
                      TrainerConfig(learning_rate=1e-4, seed=0, dedup_articles=k["dedup"]),
                      device=device, log_fn=lambda s: None)
    batch = trainer.prepare(raw)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    loss = trainer.step(batch)
    sync()
    t0 = time.perf_counter()
    for _ in range(k["steps"]):
        loss = trainer.step(batch)
    sync()
    ms = (time.perf_counter() - t0) / k["steps"] * 1000
    if not torch.isfinite(loss).all():
        raise RuntimeError(f"non-finite loss {loss}")
    print(f"{name:12s} full train step {ms:8.2f} ms/step {bs / ms * 1000:9.0f} imp/s{note}",
          flush=True)
    rate = "imp_per_s" if cuda else "imp_per_s_on_cpu"  # a CPU rate is no device metric
    return dict(rec, ms_per_step=round(ms, 3), **{rate: round(bs / ms * 1000, 1)})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("families", nargs="*", default=list(FAMILIES))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    k = knobs()
    r = np.random.default_rng(0)
    tabs = tables(r, k)
    card = torch.cuda.get_device_name(0) if device.type == "cuda" else None
    print(f"bs={k['bs']} device={card or 'cpu'} dtype=bf16", flush=True)
    out = {}
    for name in args.families:
        try:
            out[name] = profile(name, r, tabs, k, device)
        except Exception as e:  # noqa: BLE001 - one family must not stop the sweep
            print(f"{name:12s} FAILED: {type(e).__name__}: {str(e)[:140]}", flush=True)
            out[name] = {"failed": f"{type(e).__name__}: {str(e)[:140]}"}
    print(json.dumps({"bs": k["bs"], "steps": k["steps"], "n_articles": k["n_art"],
                      "families": out, "device": device.type, "card": card}))
    return 1 if any("failed" in rec for rec in out.values()) else 0


if __name__ == "__main__":
    sys.exit(main())

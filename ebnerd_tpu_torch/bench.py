"""Training throughput on one CUDA card (counterpart of the repo's
``bench.py``, and for the other families of ``scripts/profile_models.py``):
impressions per second of the training step.

``BENCH_MODEL=nrms`` (the default) runs the reference configuration of
``bench.py`` (ebnerd_small: history 20, title 30, npratio 4, 20 heads x 20,
attention 200, a 250,002 x 1,024 word table), token table resident on the
card, bf16 compute with fp32 parameters, the fused news encoder (forward
and recompute backward on the port's CUDA kernels), dropout 0.2 from the
kernel's Philox masks, unique-article dedup, dense Adam at lr 1e-4.
``BENCH_SPARSE=1`` takes the row-sparse word-table updates instead
(``training/sparse_embed.py``; each staged step carries its own touched
rows, cut to their count), ``BENCH_MU_DTYPE=bfloat16`` keeps Adam's
first moment in bf16 (``training/adam.py``); both apply to every family
with a word table. ``BENCH_SCAN=N`` (N > 1) times groups of N steps, each
one CUDA-graph replay (``TrainerConfig.scan_steps``): the batches are
padded to one dedup bucket and packed into groups before the timing, two
warm-up groups run the eager warm-up and the capture, BENCH_STEPS counts
whole groups' steps, and the peak memory counts from the capture (its
pool) on.
``BENCH_MODEL=lstur`` or ``naml`` runs that family at the configuration of
``profile_models.py`` with ``PM_BS=4096 PM_PRNGDROP=1``: the same table,
25,001 articles, body 40 (NAML), filter 400, window 3, attention 200, GRU
400 (LSTUR ``ini``), 50,000 users, dropout 0.2 on the seed-recompute
dropout kernel, batch 4,096. ``BENCH_MODEL=npa`` (``HParamsNPA``: filter
400, window 3, attention 200, user embedding 400, 50,000 users; partial
dedup) and ``fastformer`` (``HParamsFastformer``: 256 wide, 2 layers, 8
heads, intermediate 256, the word table then a 1,024 -> 256 transform)
take the same table, batch and K3 dropout; ``nrms_docvec``
(``HParamsNRMSDocVec``: 768-d document vectors, 16 x 16 heads, dense 512 x
3 with BatchNorm, attention 200) reads a 25,001 x 768 fp32 ``docvec``
table of standard normals and has no dropout kernel. Batches are
dedup-prepped and staged on the card before the timed steps (what a
prefetch thread provides in production).

Prints ONE JSON line with the keys of ``bench.py`` except ``vs_baseline``
and ``vs_gpu_estimate``: metric, value, unit, mfu_pct, step_ms, config,
dedup_uniq_frac, prep_ms (host sparse and dedup prep per batch),
sparse_rows (the first batch's touched word rows; 0 when dense) and
peak_gb. ``mfu_pct`` is ``bench.py``'s
dedup-aware analytic FLOPs over the card's own dense bf16 peak, taken from
its name; the other families have no analytic FLOP count in the JAX
package, so their line has no ``mfu_pct``.

Knobs (environment): BENCH_MODEL (nrms), BENCH_BS (16384 for NRMS, 4096
for LSTUR and NAML), BENCH_STEPS (30), BENCH_WARMUP (5), BENCH_DTYPE
(float32 for fp32 compute), BENCH_FUSED (0 = unfused layers; NRMS),
BENCH_PRNGDROP (0 = generator-seeded dropout; LSTUR, NAML, NPA, Fastformer),
BENCH_DROPOUT (0.2), BENCH_TOKEN_DIST / BENCH_ARTICLE_DIST (zipf or
uniform), BENCH_DEDUP (0 = per slot), BENCH_SPARSE (1 = row-sparse word
table), BENCH_MU_DTYPE (bfloat16 = a bf16 Adam first moment), BENCH_SCAN
(1; N steps a graph replay), BENCH_HISTORY (20; the user tower's T); for
tiny runs (the port's own) BENCH_VOCAB (250002), BENCH_EMB (1024),
BENCH_NART (25000).
BENCH_FUSED_BLOCK is a TPU block size and does not apply.

``--device cpu`` runs it on the CPU (kernels' plain versions): its metric is
named ``..._on_cpu`` and it reports no MFU and no peak memory.

Run: python -m ebnerd_tpu_torch.bench [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

VOCAB = 250_002      # xlm-roberta-large vocab
EMB = 1_024          # xlm-roberta-large word-embedding dim
N_ARTICLES = 25_000  # ebnerd_small-scale article table
TITLE = 30
HISTORY = 20
NPRATIO = 4
BODY = 40            # NAML's body tokens (HParamsNAML.body_size)
N_USERS = 50_000     # LSTUR's and NPA's users (scripts/profile_models.py)
DOCVEC = 768         # NRMSDocVec's document-vector width (HParamsNRMSDocVec.title_size)
FAMILIES = ("nrms", "lstur", "naml", "npa", "fastformer", "nrms_docvec")

# published dense bf16 tensor peaks (NVIDIA data sheets) by H100 part
BF16_PEAK = {"SXM": 989e12, "PCIe": 756e12, "NVL": 835e12}


def bf16_peak(name: str) -> tuple[str, float]:
    """(part, dense bf16 FLOP/s) of the card named ``name``."""
    for part in ("PCIe", "NVL"):
        if part in name:
            return part, BF16_PEAK[part]
    return "SXM", BF16_PEAK["SXM"]


def article_flops(d: int = 400, a: int = 200) -> float:
    """Analytic news-encoder FLOPs for ONE article forward (bench.py)."""
    t = TITLE
    return 3 * t * EMB * d * 2 + 2 * t * t * d * 2 + t * d * a * 2 + t * a * 2


def user_flops(d: int = 400, a: int = 200) -> float:
    h = HISTORY
    return 3 * h * d * d * 2 + 2 * h * h * d * 2 + h * d * a * 2


def flops_per_impression(uniq_frac: float, dedup: bool, d: int = 400, a: int = 200) -> float:
    """bench.py's train-step FLOPs per impression (forward x3): on the
    dedup path each unique article encodes once (pad rows excluded)."""
    k = NPRATIO + 1
    slots = HISTORY + k
    art = uniq_frac * slots if dedup else slots
    return 3.0 * (art * article_flops(d, a) + user_flops(d, a) + k * d * 2)


def zipf_indices(rng: np.random.Generator, n_rows: int, shape: tuple,
                 a: float = 1.07) -> np.ndarray:
    """Article row draws with Zipf(a) popularity over a shuffled
    rank->article assignment (bench.py ``_zipf_indices``)."""
    m = int(np.prod(shape))
    ranks = rng.zipf(a, size=3 * m)
    ranks = ranks[ranks <= n_rows][:m] - 1
    while len(ranks) < m:
        extra = rng.zipf(a, size=m)
        ranks = np.concatenate([ranks, extra[extra <= n_rows] - 1])[:m]
    perm = rng.permutation(n_rows).astype(np.int32)
    return perm[ranks].reshape(shape).astype(np.int32)


def batches(seed: int, steps: int, bs: int, n_rows: int, dist: str = "zipf",
            n_users: int = 0) -> dict:
    """Index batches [steps, bs, ...] (bench.py ``_batches``); with
    ``n_users``, also user rows drawn uniformly from [0, n_users)."""
    r = np.random.default_rng(seed)
    k = NPRATIO + 1
    labels = np.zeros((steps, bs, k), np.float32)
    labels[..., 0] = 1.0
    if dist == "uniform":
        hist = r.integers(0, n_rows, (steps, bs, HISTORY)).astype(np.int32)
        cand = r.integers(0, n_rows, (steps, bs, k)).astype(np.int32)
    else:
        hist = zipf_indices(r, n_rows, (steps, bs, HISTORY))
        cand = zipf_indices(r, n_rows, (steps, bs, k))
    out = {"hist_idx": hist, "cand_idx": cand, "labels": labels}
    if n_users:
        out["user_idx"] = r.integers(0, n_users, (steps, bs)).astype(np.int32)
    return out


def token_table(rng: np.random.Generator, dist: str, width: int = TITLE,
                n_rows: int = N_ARTICLES + 1, vocab: int = VOCAB) -> np.ndarray:
    """The [n_rows, width] article token table, Zipf(1.07) token ids over the
    vocabulary with a shuffled rank->id assignment (bench.py)."""
    shape = (n_rows, width)
    if dist == "uniform":
        return rng.integers(0, vocab, size=shape).astype(np.int32)
    m = shape[0] * shape[1]
    ranks = rng.zipf(1.07, size=3 * m)
    ranks = ranks[ranks <= vocab][:m] - 1
    perm = rng.permutation(vocab).astype(np.int32)
    return perm[ranks].reshape(shape).astype(np.int32)


def make_family(name: str, dtype: torch.dtype, dropout: float, token_dist: str = "zipf",
                fused: bool = True, prng: bool = True, device="cuda", vocab: int = VOCAB,
                emb: int = EMB, n_articles: int = N_ARTICLES):
    """(model, value tables, batch builder, n_users) of one family at the
    bench's configuration (``vocab``, ``emb`` and ``n_articles`` cut it for
    tiny runs), weights from seed 0. The category ids of NAML's tables lie
    in [0, vert_num) and [0, subvert_num)."""
    from .models import (LSTUR, NAML, NPA, NRMS, Fastformer, HParamsFastformer, HParamsLSTUR,
                         HParamsNAML, HParamsNPA, HParamsNRMS, HParamsNRMSDocVec, NRMSDocVec,
                         docvec_batch, naml_batch, token_batch)

    rng = np.random.default_rng(0)
    rows = n_articles + 1
    if name == "nrms_docvec":
        docvec = rng.standard_normal((rows, DOCVEC)).astype(np.float32)
        return (NRMSDocVec(HParamsNRMSDocVec(dropout=dropout), dtype=dtype, device=device, seed=0),
                {"docvec": docvec}, docvec_batch, 0)
    tables = {"title": token_table(rng, token_dist, n_rows=rows, vocab=vocab)}
    common = dict(vocab_size=vocab, word_emb_dim=emb, dtype=dtype, device=device, seed=0)
    if name == "nrms":
        return (NRMS(HParamsNRMS(dropout=dropout), use_fused_encoder=fused, **common), tables,
                token_batch, 0)
    if name == "lstur":
        model = LSTUR(HParamsLSTUR(n_users=N_USERS, dropout=dropout), prng_dropout=prng,
                      **common)
        return model, tables, token_batch, N_USERS
    if name == "naml":
        hp = HParamsNAML(dropout=dropout)
        tables["body"] = token_table(rng, token_dist, BODY, rows, vocab)
        tables["cat"] = rng.integers(0, hp.vert_num, rows).astype(np.int32)
        tables["subcat"] = rng.integers(0, hp.subvert_num, rows).astype(np.int32)
        return NAML(hp, prng_dropout=prng, **common), tables, naml_batch, 0
    if name == "npa":
        model = NPA(HParamsNPA(n_users=N_USERS, dropout=dropout), prng_dropout=prng, **common)
        return model, tables, token_batch, N_USERS
    if name == "fastformer":
        return (Fastformer(HParamsFastformer(dropout=dropout), prng_dropout=prng, **common),
                tables, token_batch, 0)
    raise ValueError(f"BENCH_MODEL must be one of {', '.join(FAMILIES)}; got {name!r}")


def widths(env=os.environ) -> dict:
    """The word table's rows and width and the article count: the bench's
    (250,002 x 1,024, 25,000 articles) unless BENCH_VOCAB, BENCH_EMB or
    BENCH_NART cut them for a tiny run; the tools that build the bench's
    NRMS or its families read them too."""
    return {"vocab": int(env.get("BENCH_VOCAB", str(VOCAB))),
            "emb": int(env.get("BENCH_EMB", str(EMB))),
            "n_articles": int(env.get("BENCH_NART", str(N_ARTICLES)))}


def optimizer_knobs(env=os.environ) -> tuple[bool, object]:
    """(sparse, mu_dtype) from BENCH_SPARSE and BENCH_MU_DTYPE; a dtype name
    the hand-written Adam does not take raises."""
    from .training.adam import mu_dtype_of

    mu_dtype = env.get("BENCH_MU_DTYPE") or None
    mu_dtype_of(mu_dtype)
    return env.get("BENCH_SPARSE", "0") != "0", mu_dtype


def dtype_knob(env=os.environ) -> torch.dtype:
    """BENCH_DTYPE: float32 for fp32 compute, else bf16."""
    return torch.float32 if env.get("BENCH_DTYPE") == "float32" else torch.bfloat16


def history_knob(env=os.environ) -> int:
    """BENCH_HISTORY: the history articles a user tower encodes (HISTORY,
    20, unless given; past 32 the user tower takes the tiled route)."""
    n = int(env.get("BENCH_HISTORY", str(HISTORY)))
    if n < 1:
        raise ValueError(f"BENCH_HISTORY must be >= 1, got {n}")
    return n


def scan_knob(env=os.environ) -> int:
    """BENCH_SCAN: the steps of one graph replay (1 = per step)."""
    n = int(env.get("BENCH_SCAN", "1"))
    if n < 1:
        raise ValueError(f"BENCH_SCAN must be >= 1, got {n}")
    return n


def stage(trainer, preps: list, scan: int) -> list:
    """The timed loop's work items from host-prepped batches (what a
    prefetch thread provides): batches on the card (``scan`` 1), or groups
    of ``scan`` packed for one copy, padded to one dedup bucket so that one
    graph serves them all."""
    from .training import pad_dedup_to

    if scan == 1:
        return [trainer.prepare(p) for p in preps]
    if "art_uniq" in preps[0]:
        bucket = max(p["art_uniq"].shape[0] for p in preps)
        preps = [pad_dedup_to(p, bucket) for p in preps]
    return [trainer.pack_group(preps[i:i + scan]) for i in range(0, len(preps) - scan + 1, scan)]


def run(trainer, item) -> torch.Tensor:
    """One work item of ``stage``: a step, or a group's steps (their losses)."""
    return trainer.step(item) if isinstance(item, dict) else trainer.run_group(item)


def main(argv=None) -> int:
    global HISTORY
    from .training import Trainer, TrainerConfig

    ap = argparse.ArgumentParser(description="training throughput of one family")
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args([] if argv is None else argv).device
    sparse, mu_dtype = optimizer_knobs()
    scan = scan_knob()
    HISTORY = history_knob()
    name = os.environ.get("BENCH_MODEL", "nrms").lower()
    if name not in FAMILIES:
        raise ValueError(f"BENCH_MODEL must be one of {', '.join(FAMILIES)}; got {name!r}")
    cuda = device != "cpu"
    if cuda and not torch.cuda.is_available():
        print("bench: needs a CUDA card (or --device cpu)", file=sys.stderr)
        return 2
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    bs = int(os.environ.get("BENCH_BS", "16384" if name == "nrms" else "4096"))
    steps = int(os.environ.get("BENCH_STEPS", "30"))
    warmup = int(os.environ.get("BENCH_WARMUP", "5"))
    if scan > 1:  # whole groups; two warm-up groups at least (the eager one, the capture)
        steps = max(1, steps // scan) * scan
        warmup = max(2, -(-warmup // scan)) * scan
    dtype = dtype_knob()
    fused = os.environ.get("BENCH_FUSED", "1") != "0"
    prng = os.environ.get("BENCH_PRNGDROP", "1") != "0"
    dropout = float(os.environ.get("BENCH_DROPOUT", "0.2"))
    token_dist = os.environ.get("BENCH_TOKEN_DIST", "zipf")
    art_dist = os.environ.get("BENCH_ARTICLE_DIST", "zipf")
    dedup = os.environ.get("BENCH_DEDUP", "1") != "0"
    sizes = widths()

    model, tables, builder, n_users = make_family(name, dtype, dropout, token_dist, fused, prng,
                                                  device, **sizes)
    trainer = Trainer(model, tables, builder,
                      TrainerConfig(learning_rate=1e-4, seed=0, dedup_articles=dedup,
                                    sparse_embedding=sparse, adam_mu_dtype=mu_dtype,
                                    scan_steps=scan),
                      device=device)
    all_b = batches(2, warmup + steps, bs, sizes["n_articles"] + 1, art_dist, n_users)
    raws = [{k: v[i] for k, v in all_b.items()} for i in range(warmup + steps)]
    t_prep = time.perf_counter()
    raws = [trainer._prep_host(r) for r in raws]  # the sparse rows, then the dedup
    prep_ms = (time.perf_counter() - t_prep) / (warmup + steps) * 1000
    sparse_rows = int(raws[0]["emb_valid"].sum()) if sparse else 0
    uniq_frac = (float(np.mean([r["n_uniq"] for r in raws]) / (bs * (HISTORY + NPRATIO + 1)))
                 if dedup else 1.0)
    staged = stage(trainer, raws, scan)
    sync()

    loss = None
    for item in staged[:warmup // scan]:
        loss = run(trainer, item)
        if cuda and (scan == 1 or trainer.scan_stats["captures"] == 0):
            # a graph's pool is allocated by its capture: the peak counts from there
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for item in staged[warmup // scan:]:
        loss = run(trainer, item)
    sync()
    dt = time.perf_counter() - t0
    if not torch.isfinite(loss).all():
        raise RuntimeError(f"non-finite loss {loss}")
    ips = bs * steps / dt
    card = torch.cuda.get_device_name(0) if cuda else "cpu"
    part, peak = bf16_peak(card)
    # a CPU run's rate is no device metric: it is named apart and has no MFU or peak memory
    out = {"metric": f"{name}_train_impressions_per_sec_" + ("per_chip" if cuda else "on_cpu"),
           "value": round(ips, 1), "unit": "impressions/s"}
    if name == "nrms" and cuda:
        hp = model.hparams
        d, a = hp.head_num * hp.head_dim, hp.attention_hidden_dim
        out["mfu_pct"] = round(ips * flops_per_impression(uniq_frac, dedup, d, a) / peak * 100, 2)
    variant = {"nrms": f"fused={int(fused)}", "nrms_docvec": "no-kernel"}.get(
        name, f"prngdrop={int(prng)}")
    out.update({
        "step_ms": round(dt / steps * 1000, 2),
        "config": (f"{name} bs{bs} {str(dtype).replace('torch.', '')} {variant} "
                   f"sparse={int(sparse)} mu={mu_dtype or 'float32'} dedup={int(dedup)} "
                   f"scan={scan} history={HISTORY} "
                   f"tok={token_dist} art={art_dist} steps{steps} "
                   f"vocab={sizes['vocab']}x{sizes['emb']} articles={sizes['n_articles']} "
                   f"card={card}" + (f" peak={part}" if cuda else "")),
        "dedup_uniq_frac": round(uniq_frac, 4),
        "prep_ms": round(prep_ms, 2),
        "sparse_rows": sparse_rows,
        "peak_gb": round(torch.cuda.max_memory_allocated() / 1e9, 2) if cuda else None,
        "scan_steps": scan,
        "captures": trainer.scan_stats["captures"],
        "capture_s": round(trainer.scan_stats["capture_s"], 3),
    })
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

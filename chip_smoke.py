#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (``ebnerd_tpu_torch``) on one card.

Phases:
  1. report the card (name and power limit from nvidia-smi);
  2. build every CUDA kernel of the serving path from ``ebnerd_tpu_torch/csrc``;
  3. hold each kernel against its plain PyTorch version at small shapes
     (fp32, n_valid) and at the shapes the serving path gives it (bf16);
  4. run NRMS two-tower serving at full width (250,002 x 1,024 vocabulary,
     25,000 articles, title 30, history 20, 20 x 20 heads, attention 200,
     bf16, fused encoder): ArticleIndex.build() then TwoTowerScorer.score()
     on a ragged feed, counting the kernel's launches in each tower, and
     compare the scores with the same scorer on the plain version; check a
     small fp32 model's fused scores against its unfused layers;
  5. print the ``kernels`` JSON line, then the ``ok`` line last.

Any failed check exits non-zero. Needs one CUDA card, nvcc (sm_90a) and
no network. Details go to build/chip_smoke.json.

Run: python3 chip_smoke.py
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

VOCAB, EMB, N_ART, T, H = 250_002, 1_024, 25_000, 30, 20
HEADS, HEAD_DIM, ATT = 20, 20, 200
N_IMP, BATCH, CHUNK = 4_096, 1_024, 4_096
WARM_WINDOWS = 5      # warm repeats of the index build and of scoring, timed each
BF16_REL_TOL = 2e-2   # max|kernel - plain| <= tol * max|plain| in bf16
FP32_ATOL = 1e-4      # fp32: only the summation order differs
SCORE_ATOL = 2e-2     # sigmoid scores, kernel path vs plain path, bf16 model
SMALL_ATOL = 1e-4     # sigmoid scores, fp32 model, fused kernel vs unfused layers
DEV = "cuda"
EMB_SCALE = 200.0     # Glorot's bound for 250,002 x 1,024 is 0.0049; x200 gives about 1

# Published dense peaks (NVIDIA data sheets) by part: bf16 tensor FLOP/s,
# fp32 (non-tensor) FLOP/s, memory bytes/s.
PEAKS = {
    "SXM": (989e12, 67e12, 3.35e12),
    "PCIe": (756e12, 51e12, 2.0e12),
    "NVL": (835e12, 60e12, 3.9e12),
}


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def peaks_for(name: str):
    for part in ("PCIe", "NVL"):
        if part in name:
            return part, PEAKS[part]
    return "SXM", PEAKS["SXM"]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def encoder_work(n_valid, t, din, d, heads, a, elem):
    """(FLOPs, bytes) the encoder needs for n_valid articles: QKV GEMM,
    attention (QK and PV), pooling projection, pooling logits, weighted
    sum; x of the valid articles and the weights read once, output
    written once."""
    hd = d // heads
    flops = n_valid * (2 * t * din * 3 * d + 2 * 2 * heads * t * t * hd
                       + 2 * t * d * a + 2 * t * a + 2 * t * d)
    nbytes = (n_valid * t * din * elem + 3 * din * d * elem + (d * a + 2 * a) * 4
              + n_valid * d * 4)
    return flops, nbytes


def kernel_case(name, n, t, din, cdt, peaks, gen, n_valid=None, iters=20,
                heads=HEADS, head_dim=HEAD_DIM, a=ATT):
    """Kernel vs plain version on one shape; returns the case record. The
    wrapper is called as the model calls it, with the weights packed once."""
    from ebnerd_tpu_torch.ops.news_encoder import (fused_news_encoder, news_encoder_reference,
                                                   pack_weights)

    d = heads * head_dim
    dev = torch.device(DEV)
    x = torch.randn(n, t, din, generator=gen, device=dev).to(cdt)
    ws = [torch.randn(*s, generator=gen, device=dev) * 0.05
          for s in ((din, d), (din, d), (din, d), (d, a), (a,), (a, 1))]
    kw = dict(num_heads=heads, compute_dtype=cdt, n_valid=n_valid)
    packed = pack_weights(*ws, num_heads=heads, compute_dtype=cdt)
    out = fused_news_encoder(x, *ws, **kw, packed=packed)
    check(torch.equal(out, fused_news_encoder(x, *ws, **kw)),
          f"{name}: weights packed by the caller and by the wrapper disagree")
    torch.cuda.synchronize()
    ref = news_encoder_reference(x, *ws, **kw)
    err = (out - ref).abs().max().item()
    scale = ref.abs().max().item()
    tol = FP32_ATOL if cdt == torch.float32 else BF16_REL_TOL * scale
    check(bool(torch.isfinite(out).all()), f"{name}: non-finite kernel output")
    check(err <= tol, f"{name}: max|kernel - plain| = {err} > {tol}")
    nv = n if n_valid is None else n_valid
    if nv < n:
        check(bool((out[nv:] == 0).all()), f"{name}: rows past n_valid are not zero")
    ms = time_ms(lambda: fused_news_encoder(x, *ws, **kw, packed=packed), iters)
    plain_ms = time_ms(lambda: news_encoder_reference(x, *ws, **kw), max(2, iters // 4))
    flops, nbytes = encoder_work(nv, t, din, d, heads, a, x.element_size())
    peak_ops = peaks[0] if cdt == torch.bfloat16 else peaks[1]
    t_ops, t_bytes = flops / peak_ops * 1e3, nbytes / peaks[2] * 1e3
    rec = {"case": name, "shape": [n, t, din], "heads": [heads, head_dim, a],
           "dtype": str(cdt).replace("torch.", ""),
           "n_valid": nv, "max_abs_err": err, "max_abs_ref": scale, "tol": tol,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "gflop": flops / 1e9, "mbytes": nbytes / 1e6, "library_ms": None}
    print(f"[kernel] {name}: {n}x{t}x{din} heads {heads}x{head_dim} A {a} {rec['dtype']} n_valid={nv} "
          f"max_abs_err={err:.3e} (tol {tol:.3e}) ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']}) library: none", flush=True)
    return rec


def synthetic_feed(n_imp, n_art, hist, seed):
    """Ragged impressions as in scripts/bench_eval.py: 5-15 candidates and
    1-hist history articles each."""
    from ebnerd_tpu_torch import constants as c
    from ebnerd_tpu_torch.data import Ragged, Table

    rng = np.random.default_rng(seed)
    ids = np.arange(1, n_art + 1, dtype=np.int64)
    inview = Ragged.from_lists([rng.choice(ids, rng.integers(5, 16), replace=False)
                                for _ in range(n_imp)])
    history = Ragged.from_lists([rng.choice(ids, rng.integers(1, hist + 1), replace=False)
                                 for _ in range(n_imp)])
    return ids, Table({
        c.DEFAULT_IMPRESSION_ID_COL: np.arange(n_imp, dtype=np.uint32),
        c.DEFAULT_INVIEW_ARTICLES_COL: inview,
        c.DEFAULT_LABELS_COL: Ragged(np.zeros(inview.total, np.int8), inview.offsets.copy()),
        c.DEFAULT_HISTORY_ARTICLE_ID_COL: history,
    })


def plain_encoder(*args, keep_prob=1.0, drop_mask=None, rng_seed=None, packed=None, **kw):
    """The plain version under the wrapper's signature (for the comparison run)."""
    from ebnerd_tpu_torch.ops.news_encoder import news_encoder_reference

    return news_encoder_reference(*args, **kw)


def serve(model, lookup, feed, batch_size):
    from ebnerd_tpu_torch.serving import ArticleIndex, TwoTowerScorer

    index = ArticleIndex(model, {"title": lookup.matrix}, batch_size=batch_size, device=DEV)
    index.build()
    return index, TwoTowerScorer(index).score(feed)


def serving_full_width(gen):
    """Phase 4: the port's serving path at full width; returns its record."""
    from ebnerd_tpu_torch.data import EvalFeed, Lookup
    from ebnerd_tpu_torch.models import NRMS, HParamsNRMS
    from ebnerd_tpu_torch.models import newsrec
    from ebnerd_tpu_torch.ops.news_encoder import fused_news_encoder
    from ebnerd_tpu_torch.serving import ArticleIndex, TwoTowerScorer

    model = NRMS(HParamsNRMS(), vocab_size=VOCAB, word_emb_dim=EMB, dtype=torch.bfloat16,
                 use_fused_encoder=True, device=DEV, seed=0)
    with torch.no_grad():  # unit-scale embeddings: logits away from sigmoid's flat middle
        model.word_embedding.embedding.mul_(EMB_SCALE)
    tokens = torch.randint(0, VOCAB, (N_ART, T), generator=gen, device=DEV)
    ids, table = synthetic_feed(N_IMP, N_ART, H, seed=0)
    lookup = Lookup.from_values(ids, tokens.cpu().numpy().astype(np.int32))
    feed = EvalFeed(table, lookup, history_size=H, batch_size=BATCH)
    torch.cuda.synchronize()

    # the main path, counted
    fused_news_encoder.launches = 0
    t0 = time.perf_counter()
    index = ArticleIndex(model, {"title": lookup.matrix}, batch_size=CHUNK, device=DEV)
    vecs = index.build()
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    art_launches = fused_news_encoder.launches
    t0 = time.perf_counter()
    scores = TwoTowerScorer(index).score(feed)
    t_score = time.perf_counter() - t0
    user_launches = fused_news_encoder.launches - art_launches
    n_batches = len(feed)

    check(art_launches == math.ceil(lookup.n_rows / CHUNK),
          f"article tower launched the kernel {art_launches} times")
    check(user_launches == n_batches, f"user tower launched the kernel {user_launches} "
                                      f"times for {n_batches} batches")
    check(vecs.shape == (N_ART + 1, HEADS * HEAD_DIM), f"index shape {tuple(vecs.shape)}")
    check(bool(torch.isfinite(vecs).all()), "non-finite article vectors")
    check(scores.values.shape == (feed.inview.total,), "score count")
    check(bool(np.isfinite(scores.values).all()), "non-finite scores")
    check(bool(((scores.values > 0) & (scores.values < 1)).all()), "scores outside (0, 1)")

    # warm windows of both towers (host clock, synchronised); the rate is
    # all the work over all the time of the windows
    builds_warm, scores_warm = [], []
    for _ in range(WARM_WINDOWS):
        t0 = time.perf_counter()
        index.build()
        torch.cuda.synchronize()
        builds_warm.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        TwoTowerScorer(index).score(feed)
        scores_warm.append(time.perf_counter() - t0)
    t_build_warm, t_score_warm = sum(builds_warm), sum(scores_warm)

    # the same scorer on the plain version
    with mock.patch.object(newsrec, "fused_news_encoder", plain_encoder):
        pindex, pscores = serve(model, lookup, feed, CHUNK)
    vec_err = (vecs.float() - pindex.vectors.float()).abs().max().item()
    vec_scale = pindex.vectors.float().abs().max().item()
    score_err = float(np.abs(scores.values - pscores.values).max())
    check(vec_err <= BF16_REL_TOL * vec_scale,
          f"article vectors: max|kernel - plain| = {vec_err} > {BF16_REL_TOL} * {vec_scale}")
    check(score_err <= SCORE_ATOL, f"scores: max|kernel - plain| = {score_err}")

    rec = {"articles": N_ART + 1, "impressions": N_IMP, "candidates": int(scores.values.size),
           "batch": BATCH, "chunk": CHUNK, "eval_batches": n_batches,
           "launches_article_tower": art_launches, "launches_user_tower": user_launches,
           "build_s": t_build, "build_warm_s": builds_warm,
           "articles_per_s": (N_ART + 1) / t_build,
           "articles_per_s_warm": WARM_WINDOWS * (N_ART + 1) / t_build_warm,
           "score_s": t_score, "score_warm_s": scores_warm,
           "impressions_per_s": N_IMP / t_score,
           "impressions_per_s_warm": WARM_WINDOWS * N_IMP / t_score_warm,
           "max_abs_vec_diff_vs_plain": vec_err, "max_abs_vec_plain": vec_scale,
           "max_abs_score_diff_vs_plain": score_err,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    ms = lambda ts: ", ".join(f"{s * 1e3:.3f}" for s in ts)
    print(f"[serve] index build: {N_ART + 1} articles in {t_build * 1e3:.1f} ms cold "
          f"({rec['articles_per_s']:,.0f} articles/s); warm windows {ms(builds_warm)} ms "
          f"({rec['articles_per_s_warm']:,.0f} articles/s); {art_launches} kernel launches",
          flush=True)
    print(f"[serve] scoring: {N_IMP} impressions in {t_score * 1e3:.1f} ms cold "
          f"({rec['impressions_per_s']:,.0f} imp/s); warm windows {ms(scores_warm)} ms "
          f"({rec['impressions_per_s_warm']:,.0f} imp/s); {user_launches} kernel launches "
          f"over {n_batches} batches", flush=True)
    print(f"[serve] kernel vs plain: max|dvec|={vec_err:.3e} (max|vec| {vec_scale:.3e}), "
          f"max|dscore|={score_err:.3e}", flush=True)
    return rec


def small_reference(gen):
    """fp32 model at small size: the fused (kernel) scores equal the unfused
    layers' scores on the card."""
    from ebnerd_tpu_torch.data import EvalFeed, Lookup
    from ebnerd_tpu_torch.models import NRMS, HParamsNRMS

    vocab, emb, n_art = 1_000, 128, 300
    tokens = torch.randint(1, vocab, (n_art, T), generator=gen, device=DEV)
    ids, table = synthetic_feed(256, n_art, H, seed=1)
    lookup = Lookup.from_values(ids, tokens.cpu().numpy().astype(np.int32))
    feed = EvalFeed(table, lookup, history_size=H, batch_size=64)
    out = {}
    for fused in (True, False):
        model = NRMS(HParamsNRMS(), vocab_size=vocab, word_emb_dim=emb, dtype=torch.float32,
                     use_fused_encoder=fused, device=DEV, seed=3)
        with torch.no_grad():  # spread the logits beyond sigmoid's flat middle
            model.word_embedding.embedding.mul_(50.0)
        out[fused] = serve(model, lookup, feed, 128)[1].values
    err = float(np.abs(out[True] - out[False]).max())
    check(err <= SMALL_ATOL, f"small fp32 model: fused vs unfused scores differ by {err}")
    print(f"[small] fp32 fused vs unfused two-tower scores: max|d|={err:.3e} "
          f"(score range {out[False].min():.3f}..{out[False].max():.3f})", flush=True)
    return {"max_abs_score_diff": err}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from ebnerd_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    part, peaks = peaks_for(kind)
    print(f"[card] {kind}; peaks used for bounds ({part}): bf16 {peaks[0] / 1e12:g} TFLOP/s, "
          f"fp32 {peaks[1] / 1e12:g} TFLOP/s, {peaks[2] / 1e12:g} TB/s", flush=True)
    record = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda}

    t0 = time.perf_counter()
    logs = _build.build()
    record["build_s"] = time.perf_counter() - t0
    print(f"[build] {', '.join(_build.SOURCES)} in {record['build_s']:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)

    gen = torch.Generator(device=DEV).manual_seed(0)
    cases = [
        kernel_case("fp32_small", 37, 30, 128, torch.float32, peaks, gen),
        kernel_case("fp32_n_valid", 50, 20, 400, torch.float32, peaks, gen, n_valid=29),
        # other head geometries: 2 heads per QKV panel; a short last panel; T 12
        kernel_case("fp32_heads_4x32", 10, 30, 256, torch.float32, peaks, gen,
                    heads=4, head_dim=32, a=64),
        kernel_case("bf16_heads_6x20", 9, 20, 128, torch.bfloat16, peaks, gen, n_valid=7,
                    heads=6, head_dim=20, a=200),
        kernel_case("bf16_heads_2x16", 11, 12, 64, torch.bfloat16, peaks, gen,
                    heads=2, head_dim=16, a=32),
        kernel_case("bf16_article_chunk", CHUNK, T, EMB, torch.bfloat16, peaks, gen),
        kernel_case("bf16_user_batch", BATCH, H, HEADS * HEAD_DIM, torch.bfloat16, peaks, gen),
    ]
    record["cases"] = cases
    record["small_reference"] = small_reference(gen)
    serving = serving_full_width(gen)
    record["serving"] = serving

    art = next(c for c in cases if c["case"] == "bf16_article_chunk")
    kernels = {"kernels": [{
        "name": "news_encoder_fwd", "route": "cuda",
        "source": "ebnerd_tpu_torch/csrc/news_encoder.cu",
        "replaces": "ebnerd_tpu/ops/news_encoder.py:231",
        "launches": serving["launches_article_tower"] + serving["launches_user_tower"],
        "launches_article_tower": serving["launches_article_tower"],
        "launches_user_tower": serving["launches_user_tower"],
        "max_abs_err": art["max_abs_err"], "ms": art["ms"], "plain_ms": art["plain_ms"],
        "bound_ms": art["bound_ms"], "bound_by": art["bound_by"], "library_ms": None,
        "checked": True,
        "cases": [{k: c[k] for k in ("case", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                     "bound_by")} for c in cases],
    }]}
    out_dir = Path(__file__).resolve().parent / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(dict(record, **kernels), indent=1))
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

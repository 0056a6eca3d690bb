"""The word table's gradient-and-optimizer slab on the card, per strategy
(counterpart of ``scripts/bench_embed_grad2.py``).

The table is xlm-roberta-large's (V 250,002 x E 1,024, fp32); a batch of
``bs`` impressions holds M = bs x 25 x 30 token slots (history 20 + 5
candidates, title 30), their ids drawn uniform or Zipf(1.07) over the
vocabulary with a shuffled rank -> id map; the cotangent of the gathered
rows is [M, E] fp32 (what the bf16 step's cast hands back to the gather).
Strategies, each from the cotangent to the updated table and moments:

  dense          ``F.embedding``'s backward into a [V, E] gradient
                 (``aten.embedding_dense_backward``: sorted indices and a
                 segment reduction), then ``torch.optim.Adam`` over [V, E]
                 (the port's default step)
  dense_bf16_mu  the same gradient, then the hand-written Adam with a bf16
                 first moment (``training/adam.py``)
  hostdedup      the host's unique ids and [V] -> slot remap (timed on the
                 host clock, apart); on the card the slots' remap, the rows'
                 gather for the forward, ``F.embedding``'s backward into the
                 compact [C, E] rows and ``rowwise_adam`` on them
                 (``training/sparse_embed.py``, the sparse mode's step)

JAX's ``devsort`` (argsort, permute, segment sum into [V, E]) is what
``F.embedding``'s CUDA backward already does, so it is not timed twice.

Times are CUDA events over ``--iters`` back-to-back iterations after two
warm ones. ``bound_ms``: the bytes the strategy must move, each input read
once and each output written once (tokens and the cotangent; the table,
m and v, whole for the dense strategies, the C touched rows for
hostdedup), over the card's memory rate.

Run: python -m ebnerd_tpu_torch.tools.embed_grad [--batch 512 16384] [--iters 10] [--out FILE]
Prints one line per case, then one JSON object.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

V, E = 250_002, 1_024
SLOTS = (20 + 5) * 30
B1, B2, EPS, LR = 0.9, 0.999, 1e-8, 1e-4
MEM_BPS = 3.35e12  # H100 SXM HBM3; PCIe 2.0e12
STRATEGIES = ("dense", "dense_bf16_mu", "hostdedup")


def zipf_tokens(rng: np.random.Generator, m: int, s: float = 1.07) -> np.ndarray:
    """m token ids with Zipf(s) frequencies over the vocabulary, a shuffled
    rank -> id map (``bench_embed_grad2.py``'s draw)."""
    ranks = rng.zipf(s, size=4 * m)
    ranks = ranks[ranks <= V][:m] - 1
    while len(ranks) < m:
        extra = rng.zipf(s, size=m)
        ranks = np.concatenate([ranks, extra[extra <= V] - 1])[:m]
    return rng.permutation(V).astype(np.int32)[ranks]


def host_dedup(tokens: np.ndarray) -> tuple[np.ndarray, np.ndarray, float]:
    """(unique ids [C], the [V] -> slot remap, host ms)."""
    t0 = time.perf_counter()
    seen = np.zeros(V, bool)
    seen[tokens] = True
    uniq = np.flatnonzero(seen).astype(np.int32)
    remap = np.zeros(V, np.int32)
    remap[uniq] = np.arange(len(uniq), dtype=np.int32)
    return uniq, remap, (time.perf_counter() - t0) * 1e3


def bytes_moved(strategy: str, m: int, c: int) -> float:
    """Bytes each strategy must move: tokens (int64) and the fp32 cotangent
    read once; table, m and v read and written (whole, or the touched rows)."""
    read_in = m * 8 + m * E * 4
    if strategy == "dense":
        return read_in + 2 * 3 * V * E * 4
    if strategy == "dense_bf16_mu":
        return read_in + 2 * V * E * (4 + 2 + 4)
    return read_in + 2 * 3 * c * E * 4 + c * 8


def event_ms(fn, iters: int) -> float:
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def run_case(strategy: str, tokens_np: np.ndarray, g: torch.Tensor, iters: int,
             mem_bps: float) -> dict:
    from ..training.adam import Adam
    from ..training.sparse_embed import rowwise_adam

    dev = g.device
    m = len(tokens_np)
    gen = torch.Generator(device=dev).manual_seed(0)
    table = torch.nn.Parameter(torch.randn(V, E, device=dev, generator=gen) * 0.02)
    emb_bwd = torch.ops.aten.embedding_dense_backward
    rec = {"strategy": strategy, "m": m}
    torch.cuda.reset_peak_memory_stats()
    if strategy == "hostdedup":
        uniq_np, remap_np, host_ms = host_dedup(tokens_np)
        c = len(uniq_np)
        tokens = torch.from_numpy(tokens_np).to(dev, torch.long)
        uniq = torch.from_numpy(uniq_np).to(dev, torch.long)
        remap = torch.from_numpy(remap_np).to(dev, torch.long)
        mom, vel = torch.zeros_like(table), torch.zeros_like(table)
        step = [0]

        def fn():
            with torch.no_grad():
                slots = remap[tokens]
                table.index_select(0, uniq)  # the forward's gather of the rows
                g_rows = emb_bwd(g, slots, c, -1, False)
                step[0] += 1
                rowwise_adam(table, mom, vel, uniq, g_rows, LR, step[0])
        rec.update(rows=c, host_ms=host_ms)
    else:
        c = int(np.count_nonzero(np.bincount(tokens_np, minlength=V)))
        tokens = torch.from_numpy(tokens_np).to(dev, torch.long)
        opt = (torch.optim.Adam([table], lr=LR, betas=(B1, B2), eps=EPS) if strategy == "dense"
               else Adam([table], lr=LR, betas=(B1, B2), eps=EPS, mu_dtype="bfloat16"))

        def fn():
            table.grad = emb_bwd(g, tokens, V, -1, False)
            opt.step()
        rec["rows"] = c
    ms = event_ms(fn, iters)
    nbytes = bytes_moved(strategy, m, c)
    rec.update(ms=ms, bound_ms=nbytes / mem_bps * 1e3, bound_by="bytes", bytes=nbytes,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    return rec


def run(batch_sizes=(512, 16_384), iters: int = 10, log=print) -> dict:
    """Every (batch, token draw, strategy) case on the card; ``log`` gets one
    line per case. Returns ``{"card", "v", "e", "iters", "cases"}``."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    name = torch.cuda.get_device_name(0)
    mem_bps = 2.0e12 if "PCIe" in name else MEM_BPS
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    cases = []
    for bs in batch_sizes:
        m = bs * SLOTS
        g = torch.randn(m, E, device=dev, generator=torch.Generator(device=dev).manual_seed(1))
        for dist in ("uniform", "zipf"):
            tokens = (rng.integers(0, V, m).astype(np.int32) if dist == "uniform"
                      else zipf_tokens(rng, m))
            for strategy in STRATEGIES:
                rec = dict(run_case(strategy, tokens, g, iters, mem_bps), batch=bs, dist=dist)
                cases.append(rec)
                log(f"[embed_grad] bs {bs:>6} {dist:<7} M {m:>10,} rows {rec['rows']:>7,} "
                    f"{strategy:<13} {rec['ms']:9.3f} ms (bound {rec['bound_ms']:.3f}, bytes)"
                    + (f"; host dedup {rec['host_ms']:.1f} ms" if "host_ms" in rec else "")
                    + f"; peak {rec['peak_gb']:.2f} GB")
                torch.cuda.empty_cache()
        del g
        torch.cuda.empty_cache()
    return {"card": smi[0] if smi else name, "v": V, "e": E, "iters": iters, "cases": cases}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[512, 16_384])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("embed_grad: needs a CUDA card", file=sys.stderr)
        return 2
    out = run(args.batch, args.iters, log=lambda line: print(line, flush=True))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

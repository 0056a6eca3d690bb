"""Where the fused news encoder's time goes, on the card.

Builds ``csrc/news_encoder.cu`` several times, with ``-DNE_PHASES``
leaving phases out, and times each variant with CUDA events at the
serving path's two bf16 shapes: the article-tower chunk [4096, 30, 1024]
and the user-tower batch [1024, 20, 400], with 20 x 20 heads and
attention width 200. The weights are packed once, outside the timing. A
variant that leaves a phase out computes a wrong result and is timed
only; the shipped build is held against the plain version. Every variant
is timed twice in one process on one card, in the order listed and then
reversed.

Run: python -m ebnerd_tpu_torch.tools.kernel_phases [--out FILE]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from ..ops import _build
from ..ops import news_encoder as ne

VARIANTS = {
    "shipped": (),
    "qkv_gemm_only": ("-DNE_PHASES=1",),
    "no_attention": ("-DNE_PHASES=5",),
    "no_pooling": ("-DNE_PHASES=3",),
    "no_qkv_gemm": ("-DNE_PHASES=6",),
}
SHAPES = {"article_chunk": (4096, 30, 1024), "user_batch": (1024, 20, 400)}
HEADS, HEAD_DIM, ATT = 20, 20, 200
BF16_REL_TOL = 2e-2  # max|kernel - plain| <= tol * max|plain|, as in chip_smoke.py


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the records to this JSON file")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_phases: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.build_variants([("news_encoder", flags) for flags in VARIANTS.values()])
    print(f"[build] {len(VARIANTS)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
    libs = {name: ne.bind(_build.load("news_encoder", flags)) for name, flags in VARIANTS.items()}

    gen = torch.Generator(device="cuda").manual_seed(0)
    d, cdt = HEADS * HEAD_DIM, torch.bfloat16
    records = []
    for shape, (n, t, din) in SHAPES.items():
        x = torch.randn(n, t, din, generator=gen, device="cuda").to(cdt)
        weights = tuple(torch.randn(*s, generator=gen, device="cuda") * 0.05
                        for s in ((din, d), (din, d), (din, d), (d, ATT), (ATT,), (ATT, 1)))
        ref = ne.news_encoder_reference(x, *weights, num_heads=HEADS, compute_dtype=cdt)
        packed = ne.pack_weights(*weights, num_heads=HEADS, compute_dtype=cdt)
        times = {name: [] for name in VARIANTS}
        for order in (list(VARIANTS), list(VARIANTS)[::-1]):
            for name in order:
                times[name].append(time_ms(
                    lambda: ne.launch(libs[name], x, packed), args.iters))
        for name, flags in VARIANTS.items():
            err = None
            if not flags:  # all phases: the result is checked
                out = ne.launch(libs[name], x, packed)
                err = (out - ref).abs().max().item()
                tol = BF16_REL_TOL * ref.abs().max().item()
                if not err <= tol:
                    raise RuntimeError(f"{name} at {shape}: max|kernel - plain| = {err} > {tol}")
            rec = {"shape": shape, "n_t_din": [n, t, din], "variant": name, "flags": list(flags),
                   "ms": times[name], "max_abs_err": err, "card": card}
            records.append(rec)
            print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

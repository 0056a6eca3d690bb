"""Where the fused news encoder's time goes, on the card.

Builds ``csrc/news_encoder.cu`` (K1, the forward) and
``csrc/news_encoder_bwd.cu`` (K2, whose per-block kernel is timed here)
several times, with ``-DNE_PHASES`` leaving phases out (bits in
``csrc/news_encoder_common.cuh``), and times each variant with CUDA events
at the NRMS training step's two bf16 shapes: the news tower [24,064, 30,
1,024] with n_valid 22,370 (the first batch of ``bench.py``'s step) and
Philox dropout at keep 0.8 on x and on the attention output, and the user
tower [16,384, 20, 400] without dropout, then at history 50 ([16,384, 50,
400]: the kernels' wide instance); 20 x 20 heads, attention width 200. The weights are packed and, with dropout, the x mask drawn once,
outside the timing, as the training step does. A variant that leaves a
phase out computes a wrong result and is timed only; the shipped builds
are held against the plain version (K1's output, and K2's whole backward).
Every variant is timed twice in one process on one card, in the order
listed and then reversed.

``--dtype float32`` times the fp32 instance instead (x, weights and the
kernels' compute dtype in fp32, the stream-0 mask drawn in the kernels),
and ``--shapes`` picks the shapes by name: besides the three above,
``cli_news`` (the CLI's news tower [512, 30, 300], 461 valid, Philox
dropout at keep 0.8) and ``cli_user`` (its user tower [32, 20, 400], no
dropout). Each record also names the route ``route`` takes for the shape
and, as a yardstick, the time of ``torch.matmul`` of the QKV product alone
in the compute dtype (fp32 at ``torch.get_float32_matmul_precision()``
"highest", stated in the record).

Run: python -m ebnerd_tpu_torch.tools.kernel_phases [--out FILE] [--only fwd|bwd]
     [--dtype bfloat16|float32] [--shapes news,user,user_h50,cli_news,cli_user]
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
    "qkv_only": ("-DNE_PHASES=1",),
    "no_attention": ("-DNE_PHASES=5",),
    "no_pooling": ("-DNE_PHASES=3",),
    "no_qkv": ("-DNE_PHASES=6",),
}
BWD_VARIANTS = {
    "shipped": (),
    "qkv_only": ("-DNE_PHASES=1",),
    "no_qkv": ("-DNE_PHASES=30",),
    "no_attention": ("-DNE_PHASES=29",),
    "no_pooling": ("-DNE_PHASES=27",),
    "no_do": ("-DNE_PHASES=23",),
    "no_attention_bwd": ("-DNE_PHASES=15",),
}
SHAPES = {"news": (24_064, 30, 1_024, 22_370, 0.8), "user": (16_384, 20, 400, None, 1.0),
          "user_h50": (16_384, 50, 400, None, 1.0), "cli_news": (512, 30, 300, 461, 0.8),
          "cli_user": (32, 20, 400, None, 1.0)}
DEFAULT_SHAPES = ("news", "user", "user_h50")
HEADS, HEAD_DIM, ATT = 20, 20, 200
SEED = (0x5EED << 32) | 0x1234ABCD
BF16_REL_TOL = 2e-2  # max|kernel - plain| <= tol * max|plain|, as in chip_smoke.py
FP32_ATOL = 1e-4      # fp32: K1's max|kernel - plain|, and K2's gradients relative to their
FP32_GRAD_REL = 1e-4  # scale, as in chip_smoke.py


def time_ms(fn, iters: int, warmup: int = 2) -> float:
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


def _check(name, got, ref, scale=None, rel=BF16_REL_TOL, atol=None):
    """max|got - ref| within ``rel`` of ``scale`` (default max|ref|), or
    within ``atol`` when it is given."""
    err = (got.float() - ref.float()).abs().max().item()
    tol = atol if atol is not None else rel * (
        scale if scale is not None else ref.float().abs().max().item())
    if not err <= tol:
        raise RuntimeError(f"{name}: max|kernel - plain| = {err} > {tol}")
    return err


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the records to this JSON file")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--only", choices=("fwd", "bwd"), help="time one kernel's variants only")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16",
                    help="the kernels' compute dtype (x and the weights in it)")
    ap.add_argument("--shapes", default=",".join(DEFAULT_SHAPES),
                    help=f"comma-separated shape names of {', '.join(SHAPES)}")
    args = ap.parse_args(argv)
    shapes = args.shapes.split(",")
    unknown = [s for s in shapes if s not in SHAPES]
    if unknown:
        ap.error(f"unknown shapes {unknown}; known: {', '.join(SHAPES)}")
    if not torch.cuda.is_available():
        print("kernel_phases: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    print(card, flush=True)
    kinds = {"fwd": ("news_encoder", VARIANTS, ne.bind),
             "bwd": ("news_encoder_bwd", BWD_VARIANTS, ne.bind_bwd)}
    if args.only:
        kinds = {args.only: kinds[args.only]}
    t0 = time.perf_counter()
    _build.build_variants([(src, flags) for src, var, _ in kinds.values() for flags in var.values()])
    print(f"[build] {sum(len(v) for _, v, _ in kinds.values())} variants in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    libs = {(kind, name): bind(_build.load(src, flags))
            for kind, (src, var, bind) in kinds.items() for name, flags in var.items()}

    gen = torch.Generator(device="cuda").manual_seed(0)
    d, cdt = HEADS * HEAD_DIM, getattr(torch, args.dtype)
    fp32 = cdt == torch.float32
    precision = torch.get_float32_matmul_precision()
    records = []
    for shape in shapes:
        n, t, din, n_valid, keep = SHAPES[shape]
        nv = n if n_valid is None else n_valid
        x = torch.randn(n, t, din, generator=gen, device="cuda").to(cdt)
        weights = tuple(torch.randn(*s, generator=gen, device="cuda") * 0.05
                        for s in ((din, d), (din, d), (din, d), (d, ATT), (ATT,), (ATT, 1)))
        kw = dict(num_heads=HEADS, compute_dtype=cdt, n_valid=n_valid)
        if keep < 1.0:
            kw.update(keep_prob=keep, emb_keep_prob=keep, rng_seed=SEED)
        packed = ne.pack_weights(*weights, num_heads=HEADS, compute_dtype=cdt)
        drop = ne.dropout_config(n, t, d, kw.get("keep_prob", 1.0), kw.get("emb_keep_prob", 1.0),
                                 kw.get("rng_seed"), None, x.device)
        xin, _, drop_in = ne.kernel_input(x, nv, drop)
        g = torch.randn(n, d, generator=gen, device="cuda")
        g[nv:] = 0
        route = ne._route(packed, t, xin.shape[1])
        w_cat = torch.nn.functional.pad(torch.cat([w.to(cdt) for w in weights[:3]], 1),
                                        (0, 0, 0, xin.shape[1] - din))
        x_rows = xin[:nv * t]
        qkv_ms = time_ms(lambda: torch.matmul(x_rows, w_cat), args.iters)
        if route == "tiled":  # neither instance takes the shape: nothing of theirs to time
            rec = {"shape": shape, "n_t_din": [n, t, din], "dtype": args.dtype, "route": route,
                   "qkv_matmul_ms": qkv_ms, "matmul_precision": precision, "card": card}
            records.append(rec)
            print(json.dumps(rec), flush=True)
            continue
        for kind in kinds:
            var = kinds[kind][1]
            if kind == "fwd":
                run = lambda name: ne.launch(libs[(kind, name)], xin, packed, nv, drop_in, n=n,
                                             t=t)
            else:
                run = lambda name: ne.launch_bwd_core(libs[(kind, name)], xin, packed, g, nv,
                                                      drop_in, n=n, t=t)
            times = {name: [] for name in var}
            for order in (list(var), list(var)[::-1]):
                for name in order:
                    times[name].append(time_ms(lambda: run(name), args.iters))
            err = None
            if kind == "fwd":  # the shipped build, held against the plain version
                err = _check(f"K1 {shape}", run("shipped"),
                             ne.news_encoder_reference(x, *weights, **kw),
                             atol=FP32_ATOL if fp32 else None)
            else:  # the whole backward on the shipped build
                got = ne.fused_news_encoder_bwd(x, *weights, g, **kw, packed=packed)
                ref = ne.news_encoder_bwd_reference(x, *weights, g, **kw)
                # db and dq cancel over tokens: their scale is at least max|dW| (chip_smoke.py)
                dw_max = ref[4].abs().max().item()
                err = max(_check(f"K2 {shape} {i}", u, v,
                                 max(v.abs().max().item(), dw_max) if i >= 5 else None,
                                 rel=FP32_GRAD_REL if fp32 else BF16_REL_TOL)
                          for i, (u, v) in enumerate(zip(got, ref)))
                del got, ref
            for name, flags in var.items():
                rec = {"kernel": kind, "shape": shape, "n_t_din": [n, t, din], "n_valid": nv,
                       "keep": keep, "dtype": args.dtype, "route": route, "variant": name,
                       "flags": list(flags), "ms": times[name],
                       "max_abs_err": err if name == "shipped" else None,
                       "qkv_matmul_ms": qkv_ms, "matmul_precision": precision, "card": card}
                records.append(rec)
                print(json.dumps(rec), flush=True)
            torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

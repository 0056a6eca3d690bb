"""T2 and T4 of the tiled route timed on one card, from one checkout.

Imports ``ebnerd_tpu_torch`` from ``--tree`` (a checkout; by default the one
that holds this file), builds that checkout's ``csrc/news_encoder_tiled.cu``
and times with CUDA events, in bf16 without dropout: T2
(``tiled_attention``) in its forward mode (o in fp32) and its backward mode
(round(o) and the rows' statistics), and T4 (``tiled_attention_bwd``) on
T2's statistics. SHAPES are the history-100 user tower [16,384, 100, 400]
(20 heads of 20), the history-200 one, and C3b's two wide shapes past T 128
(``chip_smoke.py`` ``C3B_CASES``: T 130 with 2 heads of 80, T 200 with 2
heads of 128) at 4,096 articles. Q|K|V and dO come from a seeded generator.
Each time is printed beside its bound (the bytes the call must move over
3.35 TB/s or its products over 989 TFLOP/s, the longer), the kernel the
wrappers launched ("staged" or "gather", from the launch counts; a
checkout without the staged kernels always gathers), and the card's name
and power limit. The first 256 articles of each output are held against
the checkout's plain version (2e-2 of the scale, as ``chip_smoke.py``).
Two checkouts (a change and its parent) are compared by running this once
for each in one call to the card, in the order parent, change, change,
parent.

Run: python3 ebnerd_tpu_torch/tools/tiled_times.py [--tree DIR] [--iters N] [--out FILE]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

SHAPES = {  # name: N, T, heads, head width
    "user_h100": (16_384, 100, 20, 20),
    "user_h200": (16_384, 200, 20, 20),
    "c3b_t130_2x80": (4_096, 130, 2, 80),
    "c3b_t200_2x128": (4_096, 200, 2, 128),
}
HBM_BYTES_S, BF16_OPS_S = 3.35e12, 989e12
REL_TOL, CHECKED = 2e-2, 256


def bound_ms(flops: float, nbytes: float) -> tuple:
    """The longer of the bytes' and the products' time, in ms, and which."""
    b, f = nbytes / HBM_BYTES_S * 1e3, flops / BF16_OPS_S * 1e3
    return (b, "bytes") if b >= f else (f, "operations")


def time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, after one."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[2]),
                    help="the checkout whose package and kernels are timed")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--out", help="also write the records to this JSON file")
    args = ap.parse_args(argv)
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import torch

    if not torch.cuda.is_available():
        print("tiled_times: needs a CUDA card", file=sys.stderr)
        return 2
    from ebnerd_tpu_torch.ops import _build
    from ebnerd_tpu_torch.ops import news_encoder as ne

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    t0 = time.perf_counter()
    _build.build(["news_encoder_tiled"])
    print(f"[tiled_times] tree {tree}: {card}; build {time.perf_counter() - t0:.1f} s", flush=True)
    staged = {k: getattr(fn, "staged", None) for k, fn in
              (("tiled_attention", ne.tiled_attention), ("tiled_attention_bwd",
                                                          ne.tiled_attention_bwd))}
    gen = torch.Generator(device="cuda").manual_seed(0)
    drop, records = ne.Dropout(), []
    for name, (n, t, heads, hd) in SHAPES.items():
        d, cdt = heads * hd, torch.bfloat16
        ws = [torch.randn(16, d, generator=gen, device="cuda") * 0.1 for _ in range(3)]
        ws += [torch.randn(d, 16, generator=gen, device="cuda") * 0.1,
               torch.zeros(16, device="cuda"), torch.randn(16, 1, generator=gen, device="cuda")]
        packed = ne.pack_weights(*ws, num_heads=heads, compute_dtype=cdt)
        kw, rows = dict(n=n, t=t, nv=n), CHECKED * t
        qkv = torch.randn(n * t, packed.wqkv.shape[1], generator=gen, device="cuda").to(cdt)
        dout = (torch.randn(n * t, d, generator=gen, device="cuda") * 0.1).to(cdt)
        o = ne.tiled_attention(qkv, packed, drop, **kw)[0]
        _, stats = ne.tiled_attention(qkv, packed, drop, backward=True, **kw)
        dqkv = ne.tiled_attention_bwd(qkv, dout, stats, packed, **kw)
        torch.cuda.synchronize()
        k = dict(n=CHECKED, t=t, nv=CHECKED)
        errs = {}
        for kern, got, ref in (
                ("tiled_attention", o[:rows],
                 ne.tiled_attention_reference(qkv[:rows], packed, drop, **k)[0]),
                ("tiled_attention_bwd", dqkv[:rows],
                 ne.tiled_attention_bwd_reference(qkv[:rows], dout[:rows], stats[:, :rows],
                                                  packed, **k))):
            e, sc = (got.float() - ref.float()).abs().max().item(), ref.float().abs().max().item()
            errs[kern] = [e, sc]
            if not (bool(torch.isfinite(got).all()) and e <= REL_TOL * sc):
                print(f"[tiled_times] {name} {kern}: max|kernel - plain| {e} > {REL_TOL} * {sc}",
                      file=sys.stderr)
                return 1
        del o, dqkv
        mm, qkv_b = 2.0 * n * heads * t * t * hd, 3.0 * n * t * d * 2
        runs = {  # name: (call, its wrapper, flops, bytes)
            "tiled_attention": (lambda: ne.tiled_attention(qkv, packed, drop, **kw),
                                "tiled_attention", 2 * mm, qkv_b + n * t * d * 4),
            "tiled_attention_bwd_mode": (
                lambda: ne.tiled_attention(qkv, packed, drop, backward=True, **kw),
                "tiled_attention", 2 * mm, qkv_b + n * t * d * 2 + 2 * n * t * heads * 4),
            "tiled_attention_bwd": (
                lambda: ne.tiled_attention_bwd(qkv, dout, stats, packed, **kw),
                "tiled_attention_bwd", 5 * mm, 2 * qkv_b + n * t * d * 2 + 2 * n * t * heads * 4)}
        for kern, (fn, wrapper, flops, nbytes) in runs.items():
            count = staged[wrapper]
            before = count.launches if count is not None else 0
            ms = time_ms(fn, args.iters)
            variant = "staged" if count is not None and count.launches > before else "gather"
            b_ms, b_by = bound_ms(flops, nbytes)
            rec = {"tree": str(tree), "shape": name, "n_t_heads_hd": [n, t, heads, hd],
                   "kernel": kern, "variant": variant, "ms": ms, "bound_ms": b_ms,
                   "bound_by": b_by, "max_abs_err": errs.get(kern), "card": card}
            records.append(rec)
            print(json.dumps(rec), flush=True)
        del qkv, dout, stats
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

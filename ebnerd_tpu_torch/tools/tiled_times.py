"""T1-T4 of the tiled route timed on one card, from one checkout.

Imports ``ebnerd_tpu_torch`` from ``--tree`` (a checkout; by default the one
that holds this file), builds that checkout's ``csrc/news_encoder_tiled.cu``
and times with CUDA events, in bf16 without dropout: T1 (``tiled_qkv``, x
[N*T, 400]), T2 (``tiled_attention``) in its forward mode (o in fp32) and
its backward mode (round(o) and the rows' statistics), T3 (``tiled_pool``,
``tiled_pool_bwd``) on T2's o and round(o), and T4
(``tiled_attention_bwd``) on T2's statistics. SHAPES are the history-50,
100 and 200 user towers [16,384, H, 400] (20 heads of 20, A 200; history
50 takes the tiled route since ``route`` sends T 33-64 there) and C3b's
two wide shapes past T 128 with their attention widths (``chip_smoke.py``
``C3B_CASES``: T 130 with 2 heads of 80 and A 600; T 200 with 2 heads of
128 and A 1,024) at 4,096 articles. Inputs come from a seeded generator.
Each time is printed beside its bound (the bytes the call must move over
3.35 TB/s or its products over 989 TFLOP/s, the longer), the kernel the
wrapper launched (T1 "tma" or "panel", T2 and T4 "staged", "streamed" or
"gather", T3 "resident", "streamed" or "chunked", from the launch counts;
a checkout without a newer kernel takes the first), and the card's name
and power limit. The first 256 articles of each output are held against the
checkout's plain version (2e-2 of the scale, as ``chip_smoke.py``). Two
checkouts (a change and its parent) are compared by running this once for
each in one call to the card, in the order parent, change, change, parent.

Run: python3 ebnerd_tpu_torch/tools/tiled_times.py [--tree DIR] [--iters N] [--out FILE]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

SHAPES = {  # name: N, T, heads, head width, A
    "user_h50": (16_384, 50, 20, 20, 200),
    "user_h100": (16_384, 100, 20, 20, 200),
    "user_h200": (16_384, 200, 20, 20, 200),
    "c3b_t130_2x80_a600": (4_096, 130, 2, 80, 600),
    "c3b_t200_2x128_a1024": (4_096, 200, 2, 128, 1_024),
}
DIN = 400  # T1's input width: the news vectors the user tower encodes
HBM_BYTES_S, BF16_OPS_S = 3.35e12, 989e12
REL_TOL, CHECKED = 2e-2, 256
# each wrapper's newer kernels (their KernelCount attributes, which name them) and its first one
NEWER = {"tiled_qkv": (("tma", "tf32x3"), "panel"), "tiled_attention": (("staged", "streamed"), "gather"),
         "tiled_pool": (("resident", "streamed"), "chunked"),
         "tiled_pool_bwd": (("resident", "streamed"), "chunked"),
         "tiled_attention_bwd": (("staged", "streamed"), "gather")}


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
    gen = torch.Generator(device="cuda").manual_seed(0)
    drop, records = ne.Dropout(), []
    for name, (n, t, heads, hd, a) in SHAPES.items():
        d, cdt = heads * hd, torch.bfloat16
        ws = [torch.randn(DIN, d, generator=gen, device="cuda") * 0.05 for _ in range(3)]
        ws += [torch.randn(d, a, generator=gen, device="cuda") * 0.05,
               torch.randn(a, generator=gen, device="cuda") * 0.1,
               torch.randn(a, 1, generator=gen, device="cuda") * 0.05]
        packed = ne.pack_weights(*ws, num_heads=heads, compute_dtype=cdt)
        a_pad, ow = packed.w_att.shape[1], ne.o_width(d)
        kw, rows = dict(n=n, t=t, nv=n), CHECKED * t
        x = torch.randn(n * t, DIN, generator=gen, device="cuda").to(cdt)
        qkv = ne.tiled_qkv(x, packed, drop, **kw)
        o = ne.tiled_attention(qkv, packed, drop, **kw)[0]
        oc, stats = ne.tiled_attention(qkv, packed, drop, backward=True, **kw)
        g = torch.randn(n, d, generator=gen, device="cuda") * 1e-2
        pooled = ne.tiled_pool(o, packed, **kw)
        pb = ne.tiled_pool_bwd(oc, packed, g, drop, **kw)
        dqkv = ne.tiled_attention_bwd(qkv, pb[0], stats, packed, **kw)
        torch.cuda.synchronize()
        k = dict(n=CHECKED, t=t, nv=CHECKED)
        rb = ne.tiled_pool_bwd_reference(oc[:rows], packed, g[:CHECKED], drop, **k)
        checks = (
            ("tiled_qkv", qkv[:rows], ne.tiled_qkv_reference(x[:rows], packed, drop, **k)),
            ("tiled_attention", o[:rows],
             ne.tiled_attention_reference(qkv[:rows], packed, drop, **k)[0]),
            ("tiled_pool", pooled[:CHECKED], ne.tiled_pool_reference(o[:rows], packed, **k)),
            ("tiled_pool_bwd", pb[0][:rows], rb[0]), ("tiled_pool_bwd", pb[1][:rows], rb[1]),
            ("tiled_attention_bwd", dqkv[:rows],
             ne.tiled_attention_bwd_reference(qkv[:rows], pb[0][:rows], stats[:, :rows], packed,
                                              **k)))
        errs = {}
        for kern, got, ref in checks:
            e, sc = (got.float() - ref.float()).abs().max().item(), ref.float().abs().max().item()
            prev = errs.get(kern, [0.0, 0.0])
            errs[kern] = [max(prev[0], e), max(prev[1], sc)]
            if not (bool(torch.isfinite(got).all()) and e <= REL_TOL * sc):
                print(f"[tiled_times] {name} {kern}: max|kernel - plain| {e} > {REL_TOL} * {sc}",
                      file=sys.stderr)
                return 1
        del pooled, pb, dqkv
        mm, rows_all = 2.0 * n * heads * t * t * hd, n * t
        qkv_b = 3.0 * rows_all * d * 2
        do = (torch.randn(rows_all, d, generator=gen, device="cuda") * 0.1).to(cdt)
        runs = {  # name: (call, its wrapper, flops, bytes)
            "tiled_qkv": (lambda: ne.tiled_qkv(x, packed, drop, **kw), "tiled_qkv",
                          2.0 * rows_all * DIN * 3 * d,
                          (rows_all * DIN + DIN * 3 * d) * 2 + qkv_b),
            "tiled_attention": (lambda: ne.tiled_attention(qkv, packed, drop, **kw),
                                "tiled_attention", 2 * mm, qkv_b + rows_all * d * 4),
            "tiled_attention_bwd_mode": (
                lambda: ne.tiled_attention(qkv, packed, drop, backward=True, **kw),
                "tiled_attention", 2 * mm, qkv_b + rows_all * d * 2 + 2 * rows_all * heads * 4),
            "tiled_pool": (lambda: ne.tiled_pool(o, packed, **kw), "tiled_pool",
                           n * (2.0 * t * d * a + 2 * t * a + 2 * t * d),
                           rows_all * d * 4 + d * a_pad * 2 + 2 * a * 4 + n * d * 4),
            "tiled_pool_bwd": (lambda: ne.tiled_pool_bwd(oc, packed, g, drop, **kw),
                               "tiled_pool_bwd", n * (4.0 * t * d * a + 4 * t * a + 2 * t * d),
                               rows_all * ow * 2 + n * d * 4 + d * a_pad * 2
                               + rows_all * (a_pad + d) * 2 + 2 * n * a_pad * 4),
            "tiled_attention_bwd": (
                lambda: ne.tiled_attention_bwd(qkv, do, stats, packed, **kw),
                "tiled_attention_bwd", 5 * mm,
                2 * qkv_b + rows_all * d * 2 + 2 * rows_all * heads * 4)}
        for kern, (fn, wrapper, flops, nbytes) in runs.items():
            newer, old = NEWER[wrapper]
            counts = {a: getattr(getattr(ne, wrapper), a) for a in newer
                      if hasattr(getattr(ne, wrapper), a)}
            before = {a: c.launches for a, c in counts.items()}
            ms = time_ms(fn, args.iters)
            ran = [a for a, c in counts.items() if c.launches > before[a]]
            variant = ran[0] if ran else old
            b_ms, b_by = bound_ms(flops, nbytes)
            rec = {"tree": str(tree), "shape": name, "n_t_heads_hd_a": [n, t, heads, hd, a],
                   "kernel": kern, "variant": variant, "ms": ms, "bound_ms": b_ms,
                   "bound_by": b_by, "max_abs_err": errs.get(kern), "card": card}
            records.append(rec)
            print(json.dumps(rec), flush=True)
        del x, qkv, o, oc, stats, g, do
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

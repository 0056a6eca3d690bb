"""T1-T4 of the tiled route timed on one card, from one checkout.

Imports ``ebnerd_tpu_torch`` from ``--tree`` (a checkout; by default the one
that holds this file), builds that checkout's ``csrc/news_encoder_tiled.cu``
and times with CUDA events, without dropout, in the compute ``--dtype``
(bf16 by default; float32 is the JAX package's and the CLI's default): T1
(``tiled_qkv``, x [N*T, 400]), T2 (``tiled_attention``) in its forward mode
(o in fp32) and its backward mode (round(o) and the rows' statistics), T3
(``tiled_pool``, ``tiled_pool_bwd``) on T2's o and round(o), and T4
(``tiled_attention_bwd``) on T2's statistics. SHAPES are the history-50,
100 and 200 user towers [16,384, H, 400] (20 heads of 20, A 200; history
50 takes the tiled route since ``route`` sends T 33-64 there) and C3b's
two wide shapes past T 128 with their attention widths (``chip_smoke.py``
``C3B_CASES``: T 130 with 2 heads of 80 and A 600; T 200 with 2 heads of
128 and A 1,024) at 4,096 articles; ``--shapes`` takes a comma list of
their names, ``--only`` one of the kernels' (each is still held against its
plain version). Inputs come from a seeded generator.

T2 and T4 are each timed in turns with ``scaled_dot_product_attention`` on
inputs of the same shape and dtype (kernel, SDPA, SDPA, kernel): T2's two
modes beside its forward, T4 beside its backward. T3, where its rule gives
another kernel than the first, chunked one (fp32: "tf32x3"; bf16: "resident"
or "streamed"), is timed in turns with the chunked kernel (kernel,
chunked, chunked, kernel; ``pool_variant`` patched to answer it). SDPA
runs on the backend PyTorch picks for the inputs (fp32: the
memory-efficient one; flash does not take fp32), in calls on parts of the
batch small enough for it (``sdpa_parts``). Each time is printed beside its bound (the bytes the
call must move over 3.35 TB/s or its products over the dtype's rate, the
longer: 989 TFLOP/s in bf16, 165 in fp32 for the kernels' 3xTF32 products,
with the FMA rate's bound, 67, beside it), the kernel the wrapper launched
(T1 "tma", "tf32x3" or "panel", T2 and T4 "staged", "streamed" or
"gather", "_tf32x3" added to the fp32 staged and streamed kernels where
the checkout counts them apart, T3 "resident", "streamed", "tf32x3" or
"chunked", from the launch counts; a checkout without a newer kernel
takes the first), and the card's name and power limit. The first 256 articles of
each output are held against the checkout's plain version (2e-2 of the
scale in bf16, 1e-4 in fp32, as ``chip_smoke.py``). T3's records carry the
sha256 of its forward and backward outputs on 256 articles of inputs drawn
apart (``t3_sha256``): two checkouts with the same T3 print the same. Two
checkouts (a change and its parent) are compared by running this once for
each in one call to the card, in the order parent, change, change, parent:
the parent's fp32 T2 and T4 are its FMA branches, so the port keeps no FMA
path for timing.

Run: python3 ebnerd_tpu_torch/tools/tiled_times.py [--tree DIR] [--dtype float32]
     [--shapes user_h50,user_h200] [--only tiled_attention,tiled_attention_bwd] [--iters N]
     [--out FILE]
"""
from __future__ import annotations

import argparse
import hashlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

SHAPES = {  # name: N, T, heads, head width, A
    "user_h50": (16_384, 50, 20, 20, 200),
    "user_h100": (16_384, 100, 20, 20, 200),
    "user_h200": (16_384, 200, 20, 20, 200),
    "c3b_t130_2x80_a600": (4_096, 130, 2, 80, 600),
    "c3b_t200_2x128_a1024": (4_096, 200, 2, 128, 1_024),
}
DIN = 400  # T1's input width: the news vectors the user tower encodes
HBM_BYTES_S, BF16_OPS_S, TF32X3_OPS_S, FP32_OPS_S = 3.35e12, 989e12, 495e12 / 3, 67e12
REL_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
CHECKED = 256
# SDPA's backward stopped with an illegal memory access on the card at
# [16,384, 20, 200, 20] bf16 in one call (2.6 GB a tensor) and ran on halves of it; its forward
# ran whole. The most bytes a tensor of one call takes:
SDPA_BYTES = {"forward": 2_621_440_000, "backward": 1_310_720_000}
KERNELS = ("tiled_qkv", "tiled_pool", "tiled_pool_bwd", "tiled_attention",
           "tiled_attention_bwd_mode", "tiled_attention_bwd")  # as timed, in this order
# each wrapper's newer kernels (their KernelCount attributes, which name them) and its first one
NEWER = {"tiled_qkv": (("tma", "tf32x3"), "panel"),
         "tiled_attention": (("staged_tf32x3", "streamed_tf32x3", "staged", "streamed"), "gather"),
         "tiled_pool": (("resident", "streamed", "tf32x3"), "chunked"),
         "tiled_pool_bwd": (("resident", "streamed", "tf32x3"), "chunked"),
         "tiled_attention_bwd": (("staged_tf32x3", "streamed_tf32x3", "staged", "streamed"),
                                 "gather")}


def bound_ms(flops: float, nbytes: float, rate: float) -> tuple:
    """The longer of the bytes' and the products' time at ``rate``, in ms, and which."""
    b, f = nbytes / HBM_BYTES_S * 1e3, flops / rate * 1e3
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


def sdpa_parts(shape, elem: int, which: str) -> int:
    """Calls on equal parts of the batch that SDPA's ``which`` ("forward" or
    "backward") takes for [N, heads, T, hd] tensors of ``elem`` bytes."""
    n = shape[0]
    parts = max(1, math.ceil(math.prod(shape) * elem / SDPA_BYTES[which]))
    while n % parts:
        parts += 1
    return parts


def sdpa_calls(q, k, v, dout):
    """SDPA's forward and backward on [N, heads, T, hd] q, k, v (the
    backward of o against ``dout``), each a function of no argument that
    runs it in ``sdpa_parts`` calls and keeps no result; the backward's
    graphs are built here (their outputs kept until the functions are
    dropped)."""
    import torch

    sdpa = torch.nn.functional.scaled_dot_product_attention
    elem, n = q.element_size(), q.shape[0]
    pf, pb = sdpa_parts(q.shape, elem, "forward"), sdpa_parts(q.shape, elem, "backward")
    cut = lambda u, i, p: u[i * n // p:(i + 1) * n // p]

    def forward():
        for i in range(pf):
            sdpa(cut(q, i, pf), cut(k, i, pf), cut(v, i, pf))

    leaves = [[cut(u, i, pb).detach().requires_grad_() for u in (q, k, v)] for i in range(pb)]
    outs = [sdpa(*lv) for lv in leaves]

    def backward():
        for lv, o, i in zip(leaves, outs, range(pb)):
            torch.autograd.grad(o, lv, cut(dout, i, pb), retain_graph=True)

    return forward, backward


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[2]),
                    help="the checkout whose package and kernels are timed")
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(REL_TOL),
                    help="the compute dtype")
    ap.add_argument("--shapes", default=",".join(SHAPES), help="comma list of SHAPES' names")
    ap.add_argument("--only", default=",".join(KERNELS), help="comma list of the kernels timed")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--out", help="also write the records to this JSON file")
    args = ap.parse_args(argv)
    wanted, timed = args.shapes.split(","), args.only.split(",")
    unknown = [s for s in wanted if s not in SHAPES] + [k for k in timed if k not in KERNELS]
    if unknown:
        ap.error(f"unknown {unknown}; shapes: {', '.join(SHAPES)}; kernels: {', '.join(KERNELS)}")
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import torch

    if not torch.cuda.is_available():
        print("tiled_times: needs a CUDA card", file=sys.stderr)
        return 2
    from ebnerd_tpu_torch.ops import _build
    from ebnerd_tpu_torch.ops import news_encoder as ne

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    t0 = time.perf_counter()
    _build.build(["news_encoder_tiled"])
    print(f"[tiled_times] tree {tree}: {card}; {args.dtype}; build "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    cdt = getattr(torch, args.dtype)
    e_b, tol = torch.tensor([], dtype=cdt).element_size(), REL_TOL[args.dtype]
    rate = BF16_OPS_S if cdt == torch.bfloat16 else TF32X3_OPS_S
    gen = torch.Generator(device="cuda").manual_seed(0)
    drop, records = ne.Dropout(), []
    for name in wanted:
        n, t, heads, hd, a = SHAPES[name]
        d = heads * hd
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
            ("tiled_attention_bwd_mode", oc[:rows],
             ne.tiled_attention_reference(qkv[:rows], packed, drop, backward=True, **k)[0]),
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
            if not (bool(torch.isfinite(got).all()) and e <= tol * sc):
                print(f"[tiled_times] {name} {kern}: max|kernel - plain| {e} > {tol} * {sc}",
                      file=sys.stderr)
                return 1
        del pooled, pb, dqkv, checks, rb
        # T3 on inputs of its own (seeded apart from the rest): its outputs' bytes, which two
        # checkouts whose T3 is the same give alike
        g3 = torch.Generator(device="cuda").manual_seed(1)
        o3 = torch.randn(CHECKED * t, d, generator=g3, device="cuda")
        oc3 = torch.zeros(CHECKED * t, ow, device="cuda")
        oc3[:, :d] = torch.randn(CHECKED * t, d, generator=g3, device="cuda")
        g3c = torch.randn(CHECKED, d, generator=g3, device="cuda") * 1e-2
        t3 = [ne.tiled_pool(o3, packed, **k)] + list(ne.tiled_pool_bwd(oc3.to(cdt), packed, g3c,
                                                                       drop, **k))
        t3_sha = hashlib.sha256(b"".join(u.contiguous().view(torch.uint8).cpu().numpy().tobytes()
                                         for u in t3)).hexdigest()
        del o3, oc3, g3c, t3
        mm, rows_all = 2.0 * n * heads * t * t * hd, n * t
        qkv_b = 3.0 * rows_all * d * e_b
        runs = {  # name: (call, its wrapper, flops, bytes), in the order timed
            "tiled_qkv": (lambda: ne.tiled_qkv(x, packed, drop, **kw), "tiled_qkv",
                          2.0 * rows_all * DIN * 3 * d,
                          (rows_all * DIN + DIN * 3 * d) * e_b + qkv_b),
            "tiled_pool": (lambda: ne.tiled_pool(o, packed, **kw), "tiled_pool",
                           n * (2.0 * t * d * a + 2 * t * a + 2 * t * d),
                           rows_all * d * 4 + d * a_pad * e_b + 2 * a * 4 + n * d * 4),
            "tiled_pool_bwd": (lambda: ne.tiled_pool_bwd(oc, packed, g, drop, **kw),
                               "tiled_pool_bwd", n * (4.0 * t * d * a + 4 * t * a + 2 * t * d),
                               rows_all * ow * e_b + n * d * 4 + d * a_pad * e_b
                               + rows_all * (a_pad + d) * e_b + 2 * n * a_pad * 4),
            "tiled_attention": (lambda: ne.tiled_attention(qkv, packed, drop, **kw),
                                "tiled_attention", 2 * mm, qkv_b + rows_all * d * 4),
            "tiled_attention_bwd_mode": (
                lambda: ne.tiled_attention(qkv, packed, drop, backward=True, **kw),
                "tiled_attention", 2 * mm, qkv_b + rows_all * d * e_b + 2 * rows_all * heads * 4),
            "tiled_attention_bwd": (
                lambda: ne.tiled_attention_bwd(qkv, do, stats, packed, **kw),
                "tiled_attention_bwd", 5 * mm,
                2 * qkv_b + rows_all * d * e_b + 2 * rows_all * heads * 4)}
        library = {}
        for kern, (fn, wrapper, flops, nbytes) in runs.items():
            if kern == "tiled_attention":  # T1 and T3 are done: their inputs make room for SDPA's
                del x, o, oc, g
                torch.cuda.empty_cache()
                q4 = [torch.randn(n, heads, t, hd, generator=gen, device="cuda").to(cdt)
                      for _ in range(3)]
                do = (torch.randn(rows_all, d, generator=gen, device="cuda") * 0.1).to(cdt)
                fwd, bwd = sdpa_calls(*q4, (torch.randn(n, heads, t, hd, generator=gen,
                                                        device="cuda") * 0.1).to(cdt))
                library = {"tiled_attention": fwd, "tiled_attention_bwd_mode": fwd,
                           "tiled_attention_bwd": bwd}
            if kern not in timed:
                continue
            newer, old = NEWER[wrapper]
            w = getattr(ne, wrapper)
            counts = {v: getattr(w, v) for v in newer if hasattr(w, v)}
            before = {v: c.launches for v, c in counts.items()}
            fn()  # one call names the kernel the wrapper takes
            ran = [v for v, c in counts.items() if c.launches > before[v]]
            variant = ran[0] if ran else old
            lib = library.get(kern)
            if lib is None and wrapper.startswith("tiled_pool") and variant != old:
                def chunked(fn=fn):  # T3 beside the chunked kernel
                    with mock.patch.object(ne, "pool_variant", lambda *a, **k: old):
                        fn()
                lib = chunked
            # in turns with SDPA or the chunked T3: kernel, other, other, kernel
            turns = ([time_ms(f, args.iters) for f in (fn, lib, lib, fn)] if lib
                     else [time_ms(fn, args.iters)])
            b_ms, b_by = bound_ms(flops, nbytes, rate)
            rec = {"tree": str(tree), "dtype": args.dtype, "shape": name,
                   "n_t_heads_hd_a": [n, t, heads, hd, a], "kernel": kern, "variant": variant,
                   "ms": (turns[0] + turns[-1]) / 2, "turns_ms": turns, "bound_ms": b_ms,
                   "bound_by": b_by, "max_abs_err": errs.get(kern), "card": card}
            if cdt == torch.float32:
                rec["fma_bound_ms"] = bound_ms(flops, nbytes, FP32_OPS_S)[0]
            if wrapper.startswith("tiled_pool"):
                rec["t3_sha256"] = t3_sha
            if lib and kern not in library:
                rec["chunked_ms"] = (turns[1] + turns[2]) / 2
            elif lib:
                rec["library_ms"] = (turns[1] + turns[2]) / 2
                rec["library"] = "scaled_dot_product_attention" + (
                    " backward" if kern == "tiled_attention_bwd" else "")
            records.append(rec)
            print(json.dumps(rec), flush=True)
        # the last SDPA function holds its inputs and graphs: drop every name of it
        del qkv, stats, do, q4, library, fwd, bwd, runs, fn, lib
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

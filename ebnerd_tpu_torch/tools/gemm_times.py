"""The fp32 GEMMs of K2 and T1 timed on one card, from one checkout.

Imports ``ebnerd_tpu_torch`` from ``--tree`` (a checkout; by default the one
that holds this file), builds its ``csrc/news_encoder_bwd.cu`` and
``csrc/news_encoder_tiled.cu`` and times with CUDA events, in fp32:

- K2's GEMM (``bwd_gemm``) on its three products: dx = (dqkv Wqkv^T) *
  stream-0 mask, the dWqkv partials of round(x * mask)^T dqkv and the dW
  partials of round(o)^T round(dz) (partials before their reduction), cut
  into the checkout's slices (``gemm_splits_fp32`` where the checkout has
  it, else ``gemm_splits``), at the CLI's news tower (dqkv [15,360, 1,280],
  13,830 valid rows, Din 300) and the fp32 step's two full-width towers
  (``bench.py``: news dqkv [721,920, 1,280] with 671,100 valid rows, Din
  1,024; user [327,680, 1,280], Din 400; round(o) [.., 400], round(dz)
  [.., 208]);
- T1 (``tiled_qkv``: (x * mask) Wqkv, fp32 out) at the history-50 user
  tower [16,384, 50, 400] and the CLI's user tower at history 50 [32, 50,
  400].

Each is timed in turns with torch.matmul of the same product on the same
inputs (fp32, at the precision PyTorch reports, "highest" unless changed):
kernel, torch.matmul, torch.matmul, kernel; where the checkout keeps an
older kernel beside the rule's (the FMA GEMM by ``gemm_variant``, the panel
T1 by ``qkv_variant``), that one is timed in the same turns. Every kernel's
output is held against torch.matmul's within 1e-4 of its scale (the weight
gradients' partials summed first). Records name the kernel that ran (from
the launch counts), the slices, the bound (3xTF32 at 495 TFLOP/s and FMA at
67, or the bytes at 3.35 TB/s), and the card's name and power limit. Two
checkouts are compared by running this once for each in one call to the
card, in the order parent, change, change, parent.

Run: python3 ebnerd_tpu_torch/tools/gemm_times.py [--tree DIR] [--iters N]
     [--shapes cli_news,news,user] [--out FILE]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

# name: (buffer rows, valid rows, Din); P 1,280 (20 heads of 20 in 5 panels), round(o) 400
# wide, round(dz) 208 (A 200 padded to 16)
SHAPES = {"cli_news": (512 * 30, 461 * 30, 300), "news": (24_064 * 30, 22_370 * 30, 1_024),
          "user": (16_384 * 20, 16_384 * 20, 400)}
T1_SHAPES = {"t1_user_h50": (16_384, 50), "t1_cli_user_h50": (32, 50)}
P, D, A_PAD, T1_DIN, KEEP, SEED = 1_280, 400, 208, 400, 0.8, 0x1234_5678_9ABC
HBM_BYTES_S, TF32_OPS_S, FP32_OPS_S = 3.35e12, 495e12, 67e12
REL_TOL = 1e-4


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


def patched(mod, rule: str, answer: str, fn):
    """``fn`` run with ``mod.rule`` answering ``answer``."""
    def run():
        old = getattr(mod, rule)
        setattr(mod, rule, lambda *a, **k: answer)
        try:
            return fn()
        finally:
            setattr(mod, rule, old)
    return run


def in_turns(kernels: dict, lib, iters: int) -> dict:
    """Each kernel and ``lib`` timed as kernel, lib, lib, kernel (every
    kernel in each kernel slot, in order): their two times each."""
    ms = {k: [] for k in kernels}
    ms["torch.matmul"] = []
    for turn in range(4):
        if turn in (0, 3):
            for k, fn in kernels.items():
                ms[k].append(time_ms(fn, iters))
        else:
            ms["torch.matmul"].append(time_ms(lib, iters))
    return ms


def gemm_cases(ne, philox, name: str, rnd, splits_of) -> list:
    """K2's three fp32 products at ``SHAPES[name]`` on operands from
    ``rnd`` (a seeded ``torch.randn`` on the card), one dict each: ``prod``,
    ``kern`` (``bwd_gemm`` as the checkout's rule takes it), ``lib``
    (torch.matmul of the same product), ``ref_of`` (torch.matmul's result
    to the kernel's: the mask applied to dx), ``plain`` (the plain 3xTF32
    version, where the checkout has one: dx's valid rows, the weight
    gradients' partials summed), ``flops``, ``nbytes`` (each input
    read once, the output written once), ``splits`` and ``mn`` (the
    output's [M, N]); ``rows``, ``buffer_rows`` and ``din`` of the shape."""
    k_rows, rows, din = SHAPES[name]
    dqkv, w = rnd(k_rows, P) * 1e-2, rnd(din, P) * 0.05
    x, o_c, dz = rnd(k_rows, din), rnd(k_rows, D), rnd(k_rows, A_PAD) * 1e-2
    drop = ne.dropout_config(k_rows // 30, 30, D, KEEP, KEEP, SEED, device=x.device)
    mask = philox.mask(SEED, philox.STREAM_EMB, rows, din, KEEP, device=x.device)
    xm = x[:rows] * mask
    sp_x, sp_w = splits_of(din, P, rows), splits_of(D, A_PAD, rows)
    ref3 = lambda *a, **k: lambda: ne.bwd_gemm_reference(*a, rows=rows, tf32_passes=3, **k)
    common = {"rows": rows, "buffer_rows": k_rows, "din": din}
    return [
        dict(prod="dx", kern=lambda: ne.bwd_gemm(dqkv, w, dx=True, rows=rows, drop=drop),
             lib=lambda: dqkv[:rows] @ w.T, ref_of=lambda r: r * mask,
             plain=lambda: ref3(dqkv, w, dx=True, drop=drop, seed=SEED, emb_keep=KEEP)()[:rows],
             flops=2.0 * rows * P * din, nbytes=(rows * P + din * P + k_rows * din) * 4,
             splits=1, mn=(k_rows, din), **common),
        dict(prod="dwqkv_mask", kern=lambda: ne.bwd_gemm(x, dqkv, dx=False, rows=rows, drop=drop,
                                                        splits=sp_x),
             lib=lambda: xm.T @ dqkv[:rows], ref_of=lambda r: r,
             plain=ref3(x, dqkv, dx=False, drop=drop, seed=SEED, emb_keep=KEEP, splits=sp_x),
             flops=2.0 * rows * P * din, nbytes=(rows * din + rows * P + din * P) * 4,
             splits=sp_x, mn=(din, P), **common),
        dict(prod="dw", kern=lambda: ne.bwd_gemm(o_c, dz, dx=False, rows=rows, splits=sp_w),
             lib=lambda: o_c[:rows].T @ dz[:rows], ref_of=lambda r: r,
             plain=ref3(o_c, dz, dx=False, splits=sp_w),
             flops=2.0 * rows * D * A_PAD, nbytes=(rows * D + rows * A_PAD + D * A_PAD) * 4,
             splits=sp_w, mn=(D, A_PAD), **common)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[2]),
                    help="the checkout whose package and kernels are timed")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--shapes", default=",".join(list(SHAPES) + list(T1_SHAPES)))
    ap.add_argument("--out", help="also write the records to this JSON file")
    args = ap.parse_args(argv)
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import torch

    if not torch.cuda.is_available():
        print("gemm_times: needs a CUDA card", file=sys.stderr)
        return 2
    from ebnerd_tpu_torch.ops import _build, philox
    from ebnerd_tpu_torch.ops import news_encoder as ne

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    t0 = time.perf_counter()
    _build.build(["news_encoder_bwd", "news_encoder_tiled"])
    print(f"[gemm_times] tree {tree}: {card}; build {time.perf_counter() - t0:.1f} s; torch "
          f"{torch.__version__}, fp32 matmul precision {torch.get_float32_matmul_precision()}",
          flush=True)
    splits_of = getattr(ne, "gemm_splits_fp32", ne.gemm_splits)
    new_gemm = hasattr(ne, "gemm_variant")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    wanted, records = args.shapes.split(","), []

    def record(name, kern_ms, flops, nbytes, err, scale, extra):
        b3, by = bound_ms(3 * flops, nbytes, TF32_OPS_S)
        bf, byf = bound_ms(flops, nbytes, FP32_OPS_S)
        rec = {"tree": str(tree), "case": name, "ms": kern_ms, "max_abs_err": err,
               "scale": scale, "tf32x3_bound_ms": b3, "tf32x3_bound_by": by,
               "fma_bound_ms": bf, "fma_bound_by": byf, "card": card,
               "matmul_precision": torch.get_float32_matmul_precision(), **extra}
        records.append(rec)
        print(json.dumps(rec), flush=True)

    for name in (s for s in wanted if s in SHAPES):
        for c in gemm_cases(ne, philox, name, rnd, splits_of):
            prod, kern, lib, rows = c["prod"], c["kern"], c["lib"], c["rows"]
            kernels = {"rule": kern}
            if new_gemm:
                kernels["fma"] = patched(ne, "gemm_variant", "fma", kern)
            ref = c["ref_of"](lib())
            errs, ran = {}, {}
            for k, fn in kernels.items():
                counts = {v: getattr(ne.bwd_gemm, v).launches for v in ("tf32x3", "fma")
                          if hasattr(ne.bwd_gemm, v)}
                got = fn()
                got = got[:rows] if prod == "dx" else got.sum(0)
                torch.cuda.synchronize()
                ran[k] = next((v for v, n in counts.items()
                               if getattr(ne.bwd_gemm, v).launches > n), "fma")
                errs[k] = (got - ref).abs().max().item()
                del got
            scale = ref.abs().max().item()
            del ref
            bad = {k: e for k, e in errs.items() if not e <= REL_TOL * scale}
            if bad:
                print(f"[gemm_times] {name} {prod}: max|kernel - torch.matmul| {bad} > "
                      f"{REL_TOL} * {scale}", file=sys.stderr)
                return 1
            ms = in_turns(kernels, lib, args.iters)
            record(f"{name}_{prod}", {ran[k]: v for k, v in ms.items() if k in ran},
                   c["flops"], c["nbytes"], {ran[k]: e for k, e in errs.items()}, scale,
                   {"library_ms": ms["torch.matmul"], "rows": rows,
                    "buffer_rows": c["buffer_rows"], "din": c["din"], "splits": c["splits"]})
        torch.cuda.empty_cache()

    for name in (s for s in wanted if s in T1_SHAPES):
        n, t = T1_SHAPES[name]
        ws = [rnd(T1_DIN, D) * 0.05 for _ in range(3)]
        ws += [rnd(D, 200) * 0.05, rnd(200) * 0.1, rnd(200, 1) * 0.05]
        packed = ne.pack_weights(*ws, num_heads=20, compute_dtype=torch.float32)
        x = rnd(n * t, T1_DIN)
        drop = ne.Dropout()
        kern = lambda: ne.tiled_qkv(x, packed, drop, n=n, t=t, nv=n)
        lib = lambda: x @ packed.wqkv
        kernels = {"rule": kern}
        if ne.qkv_variant(torch.float32) != "panel":
            kernels["panel"] = patched(ne, "qkv_variant", "panel", kern)
        ref = lib()
        errs, ran = {}, {}
        for k, fn in kernels.items():
            counts = {v: getattr(ne.tiled_qkv, v).launches for v in ("tf32x3",)
                      if hasattr(ne.tiled_qkv, v)}
            got = fn()
            torch.cuda.synchronize()
            ran[k] = next((v for v, c in counts.items()
                           if getattr(ne.tiled_qkv, v).launches > c), "panel")
            errs[k] = (got - ref).abs().max().item()
            del got
        scale = ref.abs().max().item()
        del ref
        bad = {k: e for k, e in errs.items() if not e <= REL_TOL * scale}
        if bad:
            print(f"[gemm_times] {name}: max|T1 - torch.matmul| {bad} > {REL_TOL} * {scale}",
                  file=sys.stderr)
            return 1
        ms = in_turns(kernels, lib, args.iters)
        p_cols = packed.wqkv.shape[1]
        record(name, {ran[k]: v for k, v in ms.items() if k in ran},
               2.0 * n * t * T1_DIN * 3 * D, (n * t * T1_DIN + T1_DIN * p_cols + n * t * p_cols) * 4,
               {ran[k]: e for k, e in errs.items()}, scale,
               {"library_ms": ms["torch.matmul"], "shape": [n, t, T1_DIN]})
        del x, packed
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

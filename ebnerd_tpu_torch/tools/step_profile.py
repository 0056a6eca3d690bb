"""Where a training step's time goes, on the card.

Builds the step of ``python -m ebnerd_tpu_torch.bench`` for the family in
``BENCH_MODEL`` (nrms, lstur, naml, npa, fastformer or nrms_docvec; the
same data, model, knobs and defaults), runs warm-up steps, then traces a
window of warm steps with ``torch.profiler`` (CPU and CUDA activities) and
sums device time by kernel name into the step's parts: K1
(``news_encoder_fwd_kernel``), the x mask drawn once before it, K2's
per-block kernel, GEMM and reduction, K3 (``dropout_kernel``), cuDNN's
convolutions, cuBLAS's matmuls, Adam, the embedding's gather and scatter,
LayerNorm, softmax, elementwise kernels, and the rest. It also reports the
window's wall time on the synchronised host clock, the device's busy and
idle share (union of kernel intervals over the window) and the host
operators with the most self time.

Run: python -m ebnerd_tpu_torch.tools.step_profile [--steps 5] [--out FILE]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

from .. import bench

# kernel-name substrings -> part of the step (first match wins)
PARTS = (
    ("K1 news_encoder_fwd", ("news_encoder_fwd_kernel",)),
    ("K2 per-block kernel", ("news_encoder_bwd_kernel",)),
    ("x mask (emb_mask, before K1)", ("bwd_mask_x_kernel",)),
    ("K2 GEMM", ("bwd_gemm_",)),
    ("K2 reduction", ("reduce_rows_kernel",)),
    ("K3 prng_dropout", ("::dropout_kernel",)),
    ("Adam", ("adam", "Adam", "multi_tensor_apply", "foreach")),
    ("convolutions (cuDNN)", ("fprop", "dgrad", "wgrad", "cudnn", "implicit_gemm", "convolve")),
    ("matmuls (cuBLAS)", ("gemm", "gemv", "Kernel2", "cutlass", "nvjet")),
    ("embedding scatter (backward)", ("index_put", "indexing_backward", "embedding_backward",
                                      "compute_grad_weight", "scatter", "sort", "Sort", "radix",
                                      "cub::")),
    ("gathers", ("index_select", "gather", "index_elementwise", "IndexKernel", "indexFunc")),
    ("LayerNorm", ("layer_norm", "LayerNorm", "GammaBeta")),
    ("softmax", ("softmax", "Softmax", "SoftMax")),
    ("casts and copies", ("copy", "Copy", "cast", "convert")),
    ("fill / zero", ("fill", "Fill", "zero")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
    ("reductions", ("reduce", "Reduce")),
)


def part_of(name: str) -> str:
    for part, keys in PARTS:
        if any(k in name for k in keys):
            return part
    return "other"


def busy_ms(events) -> float:
    """Union of the device intervals of ``events`` (ms)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3  # us -> ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=5, help="traced warm steps")
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--out", help="also write the record to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("step_profile: needs a CUDA card", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from ..training import Trainer, TrainerConfig, prep_dedup_batch

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    print(card, flush=True)
    name = os.environ.get("BENCH_MODEL", "nrms").lower()
    bs = int(os.environ.get("BENCH_BS", "16384" if name == "nrms" else "4096"))
    dropout = float(os.environ.get("BENCH_DROPOUT", "0.2"))
    model, tables, builder, n_users = bench.make_family(
        name, torch.bfloat16, dropout, prng=os.environ.get("BENCH_PRNGDROP", "1") != "0")
    trainer = Trainer(model, tables, builder, TrainerConfig(learning_rate=1e-4, seed=0),
                      device="cuda")
    n = args.warmup + args.steps
    all_b = bench.batches(2, n, bs, bench.N_ARTICLES + 1, "zipf", n_users)
    staged = [trainer.prepare(prep_dedup_batch({k: v[i] for k, v in all_b.items()}, 512))
              for i in range(n)]
    for i in range(args.warmup):
        trainer.step(staged[i])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(args.warmup, n):
            trainer.step(staged[i])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device kernels only: user-annotation ranges (e.g. Optimizer.step#Adam.step)
    # span kernels that are counted themselves
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False) and "#" not in e.name]
    by_part: dict[str, float] = {}
    by_name: dict[str, float] = {}
    for e in kernels:
        ms = (e.time_range.end - e.time_range.start) / 1e3
        by_part[part_of(e.name)] = by_part.get(part_of(e.name), 0.0) + ms
        by_name[e.name] = by_name.get(e.name, 0.0) + ms
    busy = busy_ms(kernels)
    steps = args.steps
    rec = {"card": card, "model": name, "batch": bs, "steps": steps, "wall_ms_per_step": wall_ms / steps,
           "device_busy_ms_per_step": busy / steps,
           "device_idle_share": max(0.0, 1.0 - busy / wall_ms) if wall_ms else None,
           "parts_ms_per_step": {k: v / steps for k, v in sorted(by_part.items(),
                                                                 key=lambda kv: -kv[1])},
           "top_kernels_ms_per_step": {k[:120]: v / steps for k, v in
                                       sorted(by_name.items(), key=lambda kv: -kv[1])[:25]},
           "top_host_ops_self_ms_per_step": {
               e.key[:120]: e.self_cpu_time_total / 1e3 / steps for e in sorted(
                   prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:15]}}
    print(f"[profile] {steps} traced steps: {rec['wall_ms_per_step']:.2f} ms/step wall (traced), "
          f"device busy {rec['device_busy_ms_per_step']:.2f} ms/step, idle share "
          f"{rec['device_idle_share']:.3f}", flush=True)
    for k, v in rec["parts_ms_per_step"].items():
        print(f"[profile] {k}: {v:.3f} ms/step", flush=True)
    for k, v in rec["top_kernels_ms_per_step"].items():
        print(f"[profile]   {v:8.3f} ms/step  {k}", flush=True)
    for k, v in rec["top_host_ops_self_ms_per_step"].items():
        print(f"[profile]   host {v:8.3f} ms/step self  {k}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

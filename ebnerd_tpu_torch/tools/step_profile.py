"""Where a training step's time goes, on the card.

Builds the step of ``python -m ebnerd_tpu_torch.bench`` for the family in
``BENCH_MODEL`` (nrms, lstur, naml, npa, fastformer or nrms_docvec; the
same data, model, knobs and defaults, ``BENCH_SPARSE`` and
``BENCH_MU_DTYPE`` among them, ``BENCH_DTYPE=float32`` for the fp32
step and ``BENCH_HISTORY`` for a longer history), runs warm-up steps, then
traces a
window of warm steps with ``torch.profiler`` (CPU and CUDA activities) and
sums device time by kernel name into the step's parts: K1
(``news_encoder_fwd_kernel``), the x mask drawn once before it, K2's
per-block kernel, GEMM and reduction, the tiled route's T1-T4 (a user
tower past history 32), K3 (``dropout_kernel``), cuDNN's
convolutions, cuBLAS's matmuls, Adam, the embedding's gather and scatter,
LayerNorm, softmax, elementwise kernels, and the rest. It also reports the
window's wall time on the synchronised host clock, the device's busy and
idle share (union of kernel intervals over the window), the device span of
the optimizer's ``step`` and of the sparse mode's ``rowwise_adam`` (their
annotated ranges, which the part sums split among element-wise kernels,
gathers and scatters), and the host operators with the most self time.
``BENCH_SCAN=N`` traces groups of N steps, each one CUDA-graph replay
(``bench.stage``: two warm-up groups first, the eager one and the
capture; ``--steps`` rounded up to whole groups), and reports each
kernel's launches in the traced window beside the per-step count.

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
    ("T1 tiled_qkv", ("tiled_qkv",)),
    ("T4 tiled_attention_bwd", ("tiled_attention_bwd",)),
    ("T2 tiled_attention", ("tiled_attention",)),
    ("T3 pooling", ("tiled_pool", "pool_logits_tf32x3", "pool_article_kernel", "pool_do_tf32x3")),
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


def gaps(events) -> dict:
    """The device's idle gaps between ``events`` (kernels) in the window:
    their total and count by length (us), and the longest ten with the
    kernels on either side."""
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in events)
    out, end, prev = [], None, None
    for s, e, name in spans:
        if end is not None and s > end:
            out.append((s - end, prev, name))
        if end is None or e > end:
            end, prev = e, name
    edges = (2, 10, 100)
    hist = {f"<{edges[0]}us": 0, **{f"{a}-{b}us": 0 for a, b in zip(edges, edges[1:])},
            f">={edges[-1]}us": 0}
    for g, _, _ in out:
        key = (f"<{edges[0]}us" if g < edges[0] else f">={edges[-1]}us" if g >= edges[-1]
               else next(f"{a}-{b}us" for a, b in zip(edges, edges[1:]) if a <= g < b))
        hist[key] += 1
    by_pair: dict = {}
    for g, a, b in out:
        key = f"{a[:60]} -> {b[:60]}"
        by_pair[key] = by_pair.get(key, 0.0) + g / 1e3
    return {"total_ms": sum(g for g, _, _ in out) / 1e3, "count_by_us": hist,
            "ms_by_neighbours": dict(sorted(by_pair.items(), key=lambda kv: -kv[1])[:12]),
            "longest": [{"us": g, "after": a[:80], "before": b[:80]}
                        for g, a, b in sorted(out, key=lambda x: -x[0])[:10]]}


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

    from ..training import Trainer, TrainerConfig

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    print(card, flush=True)
    name = os.environ.get("BENCH_MODEL", "nrms").lower()
    bs = int(os.environ.get("BENCH_BS", "16384" if name == "nrms" else "4096"))
    dropout = float(os.environ.get("BENCH_DROPOUT", "0.2"))
    sparse, mu_dtype = bench.optimizer_knobs()
    scan = bench.scan_knob()
    bench.HISTORY = bench.history_knob()
    model, tables, builder, n_users = bench.make_family(
        name, bench.dtype_knob(), dropout, prng=os.environ.get("BENCH_PRNGDROP", "1") != "0")
    trainer = Trainer(model, tables, builder,
                      TrainerConfig(learning_rate=1e-4, seed=0, sparse_embedding=sparse,
                                    adam_mu_dtype=mu_dtype, scan_steps=scan), device="cuda")
    warm_items = args.warmup if scan == 1 else max(2, -(-args.warmup // scan))
    steps = args.steps if scan == 1 else -(-args.steps // scan) * scan
    n = warm_items * scan + steps
    all_b = bench.batches(2, n, bs, bench.N_ARTICLES + 1, "zipf", n_users)
    raws = [trainer._prep_host({k: v[i] for k, v in all_b.items()}) for i in range(n)]
    staged = bench.stage(trainer, raws, scan)
    for item in staged[:warm_items]:
        bench.run(trainer, item)
    torch.cuda.synchronize()
    launches = dict(trainer.scan_stats["launches"])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for item in staged[warm_items:]:
            bench.run(trainer, item)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device kernels only: user-annotation ranges (e.g. Optimizer.step#Adam.step)
    # span kernels that are counted themselves
    cuda = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [e for e in cuda if not getattr(e, "is_user_annotation", False) and "#" not in e.name]
    spans: dict[str, float] = {}
    for e in cuda:  # the annotated ranges' device spans
        if e.name == "rowwise_adam" or e.name.startswith("Optimizer.step#"):
            spans[e.name] = spans.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    by_part: dict[str, float] = {}
    by_name: dict[str, float] = {}
    for e in kernels:
        ms = (e.time_range.end - e.time_range.start) / 1e3
        by_part[part_of(e.name)] = by_part.get(part_of(e.name), 0.0) + ms
        by_name[e.name] = by_name.get(e.name, 0.0) + ms
    busy = busy_ms(kernels)
    rec = {"card": card, "model": name, "batch": bs, "dtype": str(bench.dtype_knob()),
           "history": bench.HISTORY,
           "sparse": sparse, "mu_dtype": mu_dtype,
           "scan_steps": scan, "captures": trainer.scan_stats["captures"],
           "capture_s": trainer.scan_stats["capture_s"],
           "replay_launches_per_step": {k: (v - launches.get(k, 0)) / steps for k, v in
                                        trainer.scan_stats["launches"].items()},
           "steps": steps, "wall_ms_per_step": wall_ms / steps,
           "annotated_device_ms_per_step": {k: v / steps for k, v in spans.items()},
           "device_busy_ms_per_step": busy / steps,
           "device_idle_share": max(0.0, 1.0 - busy / wall_ms) if wall_ms else None,
           "kernels_per_step": len(kernels) / steps,
           "idle_gaps": gaps(kernels),
           "parts_ms_per_step": {k: v / steps for k, v in sorted(by_part.items(),
                                                                 key=lambda kv: -kv[1])},
           "top_kernels_ms_per_step": {k[:120]: v / steps for k, v in
                                       sorted(by_name.items(), key=lambda kv: -kv[1])[:25]},
           "top_host_ops_self_ms_per_step": {
               e.key[:120]: e.self_cpu_time_total / 1e3 / steps for e in sorted(
                   prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:15]}}
    print(f"[profile] {steps} traced steps (scan_steps={scan}): "
          f"{rec['wall_ms_per_step']:.2f} ms/step wall (traced), device busy "
          f"{rec['device_busy_ms_per_step']:.2f} ms/step, idle share "
          f"{rec['device_idle_share']:.3f}; replayed kernel launches per step "
          f"{rec['replay_launches_per_step']}", flush=True)
    g = rec["idle_gaps"]
    print(f"[profile] {rec['kernels_per_step']:.0f} device events a step; idle gaps "
          f"{g['total_ms'] / steps:.3f} ms/step, by length {g['count_by_us']}; longest "
          + "; ".join(f"{x['us']:.0f} us after {x['after'][:40]}" for x in g["longest"][:4]),
          flush=True)
    for k, v in g["ms_by_neighbours"].items():
        print(f"[profile]   idle {v / steps:8.3f} ms/step between {k}", flush=True)
    for k, v in rec["parts_ms_per_step"].items():
        print(f"[profile] {k}: {v:.3f} ms/step", flush=True)
    for k, v in rec["annotated_device_ms_per_step"].items():
        print(f"[profile] span {k}: {v:.3f} ms/step", flush=True)
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

"""The fused encoder's instances against its tiled route, timed on one card.

For each shape, the forward and the whole recompute backward (``_forward``
then ``_backward``: K1 and K2's per-block kernel, GEMMs and reductions) on
the route ``_route`` answers, and on the route the other way: the tiled
route forced (``force_tiled``) where the rule answers an instance, and
the wide instance asked for (``instance``) where it answers the tiled
route (T 33-64).
The two run in turns (rule, other, other, rule), each turn the mean of
``--iters`` calls after one. SHAPES are the NRMS user tower at history 20,
50 and 64 [16,384, H, 400] (20 heads of 20, A 200, no dropout, as the
training step's user tower) and the news tower [24,064, 30, 1,024] with
22,370 valid articles and Philox dropout 0.2 on both streams (the training
step's news tower), all bf16, weights N(0, 0.05^2) from a seeded generator.
The second route's output and gradients are held against the first's
(2e-2 of max|first|; the pooling bias's and query's scale at least
max|dW|). Each record names the routes, the means, every turn, and the
card's name and power limit.

Run: python3 -m ebnerd_tpu_torch.tools.route_times [--iters N] [--out FILE]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

SHAPES = {  # name: N, T, Din, n_valid, dropout keep
    "user_h20": (16_384, 20, 400, 16_384, 1.0),
    "user_h50": (16_384, 50, 400, 16_384, 1.0),
    "user_h64": (16_384, 64, 400, 16_384, 1.0),
    "news": (24_064, 30, 1_024, 22_370, 0.8),
}
HEADS, HEAD_DIM, ATT = 20, 20, 200
SEED = (0x5EED << 32) | 0x1234ABCD
REL_TOL = 2e-2
NAMES = ("out", "dx", "dwq", "dwk", "dwv", "dw", "db", "dq")


def time_turn(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, after one (CUDA events)."""
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


def compare(name: str, n: int, t: int, din: int, nv: int, keep: float, iters: int, gen,
            card: str = "") -> dict:
    """One shape (see the module's note): the two routes' outputs and
    gradients against each other, then their times in turns. Raises
    ValueError where the routes taken are not the rule's and the other, or
    where the two disagree."""
    import torch

    from ebnerd_tpu_torch.ops import news_encoder as ne

    cdt, d = torch.bfloat16, HEADS * HEAD_DIM
    x = torch.randn(n, t, din, generator=gen, device="cuda").to(cdt)
    shapes = ((din, d), (din, d), (din, d), (d, ATT), (ATT,), (ATT, 1))
    ws = [torch.randn(*s, generator=gen, device="cuda") * 0.05 for s in shapes]
    packed = ne.pack_weights(*ws, num_heads=HEADS, compute_dtype=cdt)
    g = torch.randn(n, d, generator=gen, device="cuda") * 1e-2
    g[nv:] = 0
    seed = SEED if keep < 1.0 else None
    rule = ne._route(packed, t, ne.padded_din(din, cdt))
    other = "wide" if rule == "tiled" else "tiled"

    def run(force):
        kw = {"force_tiled": force == "tiled", "instance": force == "wide"}
        f = ne._forward(x, ws, packed, HEADS, cdt, nv, keep, keep, seed, None, **kw)
        return (f[0],) + tuple(ne._backward(f[1], f[2], packed, g, n, t, nv, f[4], **kw)), f[7]

    first, tiled_a = run(None)
    second, tiled_b = run(other)
    torch.cuda.synchronize()
    if tiled_a == tiled_b or tiled_a != (rule == "tiled"):
        raise ValueError(f"{name}: the routes taken are not {rule} and {other}")
    scales = {k: v.float().abs().max().item() for k, v in zip(NAMES, first)}
    for k in ("db", "dq"):
        scales[k] = max(scales[k], scales["dw"])
    errs = {}
    for k, u, v in zip(NAMES, second, first):
        e = (u.float() - v.float()).abs().max().item()
        errs[k] = [e, scales[k]]
        if not (bool(torch.isfinite(u).all()) and e <= REL_TOL * scales[k]):
            raise ValueError(f"{name}: {k} {other} vs {rule} {e} > {REL_TOL} * {scales[k]}")
    del first, second
    turns = [time_turn(lambda: run(f), iters) for f in (None, other, other, None)]
    rec = {"shape": name, "n_t_din": [n, t, din], "n_valid": nv, "keep": keep,
           "heads": [HEADS, HEAD_DIM, ATT], "rule": rule, "other": other,
           "rule_ms": (turns[0] + turns[3]) / 2, "other_ms": (turns[1] + turns[2]) / 2,
           "turns_ms": turns, "errors": errs, "card": card}
    del x, ws, packed, g
    torch.cuda.empty_cache()
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--out", help="also write the records to this JSON file")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("route_times: needs a CUDA card", file=sys.stderr)
        return 2
    from ebnerd_tpu_torch.ops import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    _build.build()
    print(f"[route_times] {card}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    records = []
    for name, shape in SHAPES.items():
        try:
            rec = compare(name, *shape, args.iters, gen, card)
        except ValueError as e:
            print(f"[route_times] {e}", file=sys.stderr)
            return 1
        records.append(rec)
        print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

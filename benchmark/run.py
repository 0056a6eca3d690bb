"""Run one cell of ``BENCHMARK.json`` on the card and print its result as
the last line of standard output (a JSON object), the compared numbers
beside their limits as the last lines of standard error.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a ``torch.profiler`` trace of the window. Exits
with 2, printing no result, without a CUDA card or with fewer cards than
the cell asks for, and with 3 if a module of JAX, flax, optax or the JAX
package is loaded once the window has closed.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
sys.path[0] = str(REPO)  # the checkout's root, not this folder: the harness is the package
# the driver's caches stay inside the checkout, at a fixed path
os.environ.setdefault("CUDA_CACHE_PATH", str(REPO / "build" / "cuda_cache"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import core

    cell = core.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        core.log(f"{args.workload} needs {cell.chips} CUDA card(s); this machine has "
                 f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    out = core.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    bad = core.forbidden_modules()
    if bad:
        core.log("loaded in this process, and forbidden: " + ", ".join(bad))
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

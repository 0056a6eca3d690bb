"""The readings that a cell's limits for ``correct`` are set from, over many
seeds in one process (the kernels built once):

- ``--program``: the program's first steps, as a run drives them, against
  the reference (the lower readings);
- ``--control``: the reference in the precision below the configuration's
  (its ``control``: TF32 for fp32, fp8 for bf16) in the program's place;
- ``--faults``: the reference with a fault planted in the program's place:
  the loss over half of the batch ("half"; a state left unchanged reads 1
  by the change's measure and needs no run).

Prints one JSON line a seed and reading; the benchmark's own runs do not
run this.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3 [--program] [--control] [--faults]
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path[0] = str(REPO)
os.environ.setdefault("CUDA_CACHE_PATH", str(REPO / "build" / "cuda_cache"))


def readings(cell, seed: int, device: str, program: bool, control: bool, faults: bool) -> list:
    """[(kind, {number: value}, {weight: [reference's first-gradient norm,
    this run's, reference's change norm, this run's]})] of one seed."""
    from benchmark import core

    data, weights, trainer_seed, feed_seed = core.made(cell, seed, device)
    reference = core.reference_of(cell.cfg)
    out = []
    runs = {}
    if program:
        system = core.system_of(cell.cfg)(cell.cfg, cell.mix, data, weights, trainer_seed,
                                          feed_seed, device)
        runs["program"] = system.first_steps(weights, core.CHECK_STEPS)
        del system
        core.free()

    def ref(**kw):
        return reference.train(cell.cfg, cell.mix, data, weights, trainer_seed, feed_seed,
                               core.CHECK_STEPS, **kw)

    if control:
        runs["control"] = ref(precision=cell.cfg["control"])
    if faults:
        runs["half"] = ref(fault="half")
    base = ref()
    for kind, run in runs.items():
        leaves = {k: [base["grad_norms"][k], run["grad_norms"][k], base["change_norms"][k],
                      run["change_norms"][k]] for k in base["grad_norms"]}
        out.append((kind, core.compare(run, base), leaves))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args(argv)
    import torch

    from benchmark import core

    if not torch.cuda.is_available():
        core.log("readings: needs a CUDA card")
        return 2
    cell = core.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        for kind, gaps, leaves in readings(cell, seed, "cuda", args.program, args.control,
                                           args.faults):
            print(json.dumps({"workload": cell.name, "seed": seed, "kind": kind, **gaps,
                              "leaves": leaves}), flush=True)
        core.log(f"seed {seed}: {time.perf_counter() - t:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())

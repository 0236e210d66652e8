"""The readings that the limits of a cell's check are set from.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 --mode control [--calls N]
    python3 benchmark/control.py --workload <cell> --seeds 1,...,12 --mode program --seconds S

`control`: the plain reference computed in bfloat16, one precision below
the float32 the configurations state, put in the program's place on the
first `--calls` requests of each seed's window, judged by the float64
reference as the program's answers are (no card needed; the benchmark's
runs never run it). `program`: the program on the card, one set-up of the
engine for all seeds, a window of `--seconds` a seed, judged the same way.
Prints one JSON line a seed: {"seed", "mode", "numbers"}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.lib.cell import Cell, free  # noqa: E402
from benchmark.run import resolve  # noqa: E402


def readings(root, name, seeds, mode, seconds=5.0, calls=4, device="cuda", overrides=None):
    """[(seed, {number: value})] of `mode` over `seeds`."""
    _, _, config, workload, driver = resolve(root, name)
    config = dict(config, **(overrides or {}))
    out, engine = [], None
    for seed in seeds:
        cell = Cell(name=name, config=config, workload=workload, seed=seed, device=device)
        if mode == "control":
            run = driver.setup(cell, program=False)
            out.append((seed, driver.control(run, calls)))
            continue
        run = driver.setup(cell, engine=engine)
        engine = run.engine
        driver.window(run, seconds)
        run.engine = None
        out.append((seed, driver.judge(run)))
    if engine is not None:
        free(run)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--mode", choices=("control", "program"), required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--calls", type=int, default=4)
    args = ap.parse_args(argv)
    device = "cuda"
    if args.mode == "control":
        import torch

        device = "cuda" if torch.cuda.is_available() else "cpu"  # the control renders its scans on either
    seeds = [int(s) for s in args.seeds.split(",")]
    for seed, numbers in readings(ROOT, args.workload, seeds, args.mode, args.seconds, args.calls, device):
        print(json.dumps({"seed": seed, "mode": args.mode, "numbers": numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run one cell of the benchmark of `mamri_tpu_torch` once, on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: its entry in `BENCHMARK.json`
(configuration, traffic, chips), `benchmark/workloads/<cell>.json` (driver,
parameters, the limits of its check), `benchmark/configs/<config>.json`,
`benchmark/drivers/<driver>.py` and, with `--trace 1`,
`benchmark/metrics/<metric>.py` for each per-layer metric the cell reports.
A run sets up (builds the engine, makes its inputs from the seed, warms up
every shape it will use), measures for `--seconds` (or, traced, profiles a
few calls and reads its per-layer metrics), frees the program, checks the
answers against the plain reference and prints one JSON line last.

Without a CUDA card, with fewer cards than the cell asks for, or with JAX
or the JAX package loaded, it exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.lib.cell import Cell, free  # noqa: E402
from benchmark.lib.common import card_description, forbidden_modules, set_cache_dirs  # noqa: E402
from benchmark.lib.judge import verdict  # noqa: E402


class Refused(Exception):
    """The run cannot give a result (no card, a forbidden module, ...)."""


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve(root: str, name: str):
    """(manifest, the cell's entry, its configuration, its workload file, its
    driver module) of cell `name`, all found by name under `root`."""
    manifest = load_json(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if entry is None:
        raise Refused(f"no cell {name!r} in BENCHMARK.json")
    conf = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    config = load_json(os.path.join(root, conf["file"]))
    workload = load_json(os.path.join(root, "benchmark", "workloads", f"{name}.json"))
    driver = load_module(os.path.join(root, "benchmark", "drivers", f"{workload['driver']}.py"),
                         f"benchmark_driver_{workload['driver']}")
    return manifest, entry, config, workload, driver


def reported(manifest: dict, name: str, trace: bool) -> list:
    """The metric entries cell `name` reports: end-to-end ones untraced
    (those listing it, or listing no cells), per-layer ones traced (those
    listing it: every per-layer entry lists its cells)."""
    if not trace:
        return [m for m in manifest["end_to_end"] if name in m.get("workloads", [name])]
    return [m for m in manifest["per_layer"] if name in m["workloads"]]


def guard(stage: str) -> None:
    found = forbidden_modules()
    if found:
        raise Refused(f"{stage}: forbidden modules loaded in this process: {', '.join(found)}")


def run_cell(root: str, name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             overrides: dict = None, t_start: float = None):
    """-> (result dict, checks): one run of cell `name`. `device` and
    `overrides` (keys of the configuration replaced) serve the CPU tests of
    the harness; the command line always runs on the card."""
    t_start = T_START if t_start is None else t_start
    manifest, entry, config, workload, driver = resolve(root, name)
    config = dict(config, **(overrides or {}))
    cell = Cell(name=name, config=config, workload=workload, seed=seed, device=device)
    set_cache_dirs(root)
    run = driver.setup(cell)
    guard("after set-up")
    setup_s = time.perf_counter() - t_start
    metrics_wanted = reported(manifest, name, trace)
    values = {}
    if trace:
        driver.trace(run)
        for m in metrics_wanted:
            reader = load_module(os.path.join(root, "benchmark", "metrics", f"{m['name']}.py"),
                                 "benchmark_metric_" + m["name"].replace(".", "_"))
            values[m["name"]] = reader.read(run)
    else:
        driver.window(run, seconds)
        values = dict(driver.end_to_end(run), setup_s=setup_s)
    guard("after the window")
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in metrics_wanted
               if values.get(m["name"]) is not None}
    dev = {"platform": "gpu" if device == "cuda" else device, "count": int(entry["chips"])}
    if device == "cuda":
        import torch

        torch.cuda.synchronize()
        dev["kind"], dev["power_limit"] = card_description()
        dev["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(0))
    prof = run.facts.get("profile")
    if trace and prof:
        dev["busy_s"], dev["window_s"] = prof["busy_s"], prof["window_s"]
    attempted, failed = run.attempted, run.failed
    free(run)
    correct, checks = verdict(driver.judge(run), workload["limits"])
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics, "device": dev}
    if trace and prof:
        result["breakdown"] = prof["breakdown"]
    result["checks"] = checks
    last = t_start
    for step, t in run.phases:
        print(f"set-up {step}: {t - last:.3f} s", file=sys.stderr)
        last = t
    return result, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        import torch

        _, entry, _, _, _ = resolve(ROOT, args.workload)
        if not torch.cuda.is_available():
            raise Refused("torch.cuda.is_available() is False: this benchmark runs on a CUDA card only")
        if torch.cuda.device_count() < int(entry["chips"]):
            raise Refused(f"{torch.cuda.device_count()} CUDA card(s), the cell asks for {entry['chips']}")
        result, checks = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace))
    except Refused as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

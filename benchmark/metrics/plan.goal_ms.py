"""Host-clock ms of the public `plan_trajectory(target, entry)` (layer
`planning`: the goal IK against the collision world, one fetch) for
`probe_reps` further targets of the cell, each with its entry point: the
median."""

import statistics
import time


def read(run):
    eng, d = run.engine, run.data
    times = []
    for _ in range(run.cell.params["probe_reps"]):
        target = d["targets"][d["i"] % len(d["targets"])]
        d["i"] += 1
        ep = eng.find_entry_point(target)
        if not bool(ep.found):
            continue
        t0 = time.perf_counter()
        eng.plan_trajectory(target, ep.point_ras, run.cell.params["safety_mm"])
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times) if times else None

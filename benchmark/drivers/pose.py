"""Scan -> pose: `MamriEngine.estimate_pose` on a fresh host scan each call,
the configuration's bench scenes in a seeded order, one client back to back.

Each call's latency runs on the host clock from the moment the scan (a host
array) is handed to the entry until the pose is back on the host: the upload,
the segmentation, matching, the baseplate fit, the IK and the fetches are
all in it. Work parameters (`params` of the workload file): `mask_samples`
calls whose body mask is kept for the check (the window's first call and a
sample from the seed of the next `mask_calls`, which every window reaches),
`trace_calls` profiled calls.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark.lib import cell as C
from benchmark.lib import judge as J
from benchmark.lib import reference as R
from benchmark.lib import scenes as S


def setup(cell: C.Cell, engine=None, program: bool = True) -> C.Run:
    """The inputs from the seed; with `program`, the engine (or `engine`)
    warmed up on every scene."""
    run = C.Run(cell)
    arm, scenes, spacing, origin = C.bench_grid(cell)
    run.data.update(arm=arm, scenes=scenes, spacing=spacing, origin=origin,
                    scans=C.render_host(cell, scenes, spacing, origin),
                    order=S.seeded_order(cell.rng(1), len(scenes), 100_000))
    p = cell.params
    keep = cell.rng(2).choice(np.arange(1, p["mask_calls"]), size=p["mask_samples"] - 1, replace=False)
    run.data["keep_mask"] = {0} | set(int(i) for i in keep)
    run.data["buffer"] = np.empty_like(run.data["scans"][0])
    run.mark("inputs")
    if not program:
        return run
    C.reset_peak(cell)
    run.engine = engine or C.make_engine(cell)
    run.mark("engine")
    for s in range(len(scenes)):  # every scene once: the one shape, and no escalation left to compile
        call(run, s)
    run.records.clear()
    run.mark("warm-up")
    run.attempted = run.failed = 0
    return run


def call(run: C.Run, s: int, keep_mask: bool = False) -> float:
    """One timed `estimate_pose` of scene `s` from a fresh host buffer;
    -> seconds. The answer is appended to `records`."""
    from mamri_tpu_torch.perception.volume import Volume

    d = run.data
    np.copyto(d["buffer"], d["scans"][s])
    t0 = time.perf_counter()
    est = run.engine.estimate_pose(Volume(data=d["buffer"], spacing=d["spacing"], origin=d["origin"]))
    dt = time.perf_counter() - t0
    seg = run.engine.last_segmentation
    run.records.append(J.pose_record(est, seg, seg["body_mask"] if keep_mask else None, scene=s))
    run.attempted += 1
    run.failed += int(not est.success)
    return dt


def window(run: C.Run, seconds: float) -> None:
    order, keep = run.data["order"], run.data["keep_mask"]
    C.closed_loop(run, seconds, lambda i: call(run, order[i], i in keep))


def end_to_end(run: C.Run) -> dict:
    return C.latency_metrics(run, "pose_ms")


def trace(run: C.Run) -> None:
    from benchmark.lib.trace import profile

    order = run.data["order"]
    n = run.cell.params["trace_calls"]
    it = iter(range(n))
    run.facts["profile"] = profile(lambda: call(run, order[next(it)], True), n)


def judge(run: C.Run) -> dict:
    refs = J.pose_references(run, {r["scene"] for r in run.records})
    return J.worst(J.pose_numbers(run.data["arm"], r, refs[r["scene"]]) for r in run.records)


def control(run: C.Run, calls: int) -> dict:
    """The reference in bfloat16 in the program's place, on the first
    `calls` requests of the window, judged as the program is."""
    order = run.data["order"][:calls]
    low = J.pose_references(run, set(order), R.BF16)
    run.records = [dict(J.reference_record(low[s]), scene=s) for s in order]
    return judge(run)


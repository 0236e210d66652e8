"""Batched re-estimation: `MamriEngine.estimate_pose_batch` of `batch` host
scans (the configuration's bench scenes, each `batch / scenes` times, in a
seeded permutation), one batch after another.

Two host batches with different seeded permutations are assembled in
set-up and alternate, so the window holds no host copying. `vol_per_s` is
the volumes whose pose came back over the whole window.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark.lib import cell as C
from benchmark.lib import judge as J
from benchmark.lib import reference as R

BUFFERS = 2


def setup(cell: C.Cell, engine=None, program: bool = True) -> C.Run:
    """The batches from the seed; with `program`, the engine (or `engine`)
    warmed up on one batch."""
    run = C.Run(cell)
    arm, scenes, spacing, origin = C.bench_grid(cell)
    scans = C.render_host(cell, scenes, spacing, origin)
    b = cell.params["batch"]
    rng = cell.rng(1)
    rows = [rng.permutation(np.arange(b) % len(scenes)) for _ in range(BUFFERS)]
    run.data.update(arm=arm, scenes=scenes, spacing=spacing, origin=origin, scans=scans, rows=rows, k=0,
                    volumes_ok=0)
    run.mark("inputs")
    if not program:
        return run
    run.data["batches"] = [np.stack([scans[s] for s in r]) for r in rows]
    C.reset_peak(cell)
    run.engine = engine or C.make_engine(cell)
    run.mark("engine")
    call(run)
    run.records.clear()
    run.mark("warm-up")
    run.attempted = run.failed = run.data["volumes_ok"] = 0
    return run


def call(run: C.Run) -> float:
    """One timed batch; -> seconds."""
    d = run.data
    i = d["k"] % BUFFERS
    d["k"] += 1
    t0 = time.perf_counter()
    out = run.engine.estimate_pose_batch(d["batches"][i], d["spacing"], d["origin"])
    dt = time.perf_counter() - t0
    recs = J.batch_records(out, d["rows"][i])
    run.records.extend(recs)
    ok = sum(r["success"] for r in recs)
    d["volumes_ok"] += ok
    run.attempted += len(recs)
    run.failed += len(recs) - ok
    return dt


def window(run: C.Run, seconds: float) -> None:
    C.closed_loop(run, seconds, lambda i: call(run))


def end_to_end(run: C.Run) -> dict:
    return {"vol_per_s": run.data["volumes_ok"] / run.elapsed_s}


def trace(run: C.Run) -> None:
    from benchmark.lib.trace import profile

    n = run.cell.params["trace_calls"]
    prof = profile(lambda: call(run), n)
    if prof:
        prof["volumes"] = n * run.cell.params["batch"]
    run.facts["profile"] = prof


def judge(run: C.Run) -> dict:
    refs = J.pose_references(run, {r["scene"] for r in run.records})
    return J.worst(J.pose_numbers(run.data["arm"], r, refs[r["scene"]]) for r in run.records)


def control(run: C.Run, calls: int) -> dict:
    """The reference in bfloat16 in the program's place for the rows of the
    first batch (`calls` is not used: a batch is one request), judged as the
    program is."""
    rows = run.data["rows"][0]
    low = J.pose_references(run, {int(s) for s in rows}, R.BF16)
    run.records = [dict(J.reference_record(low[int(s)]), scene=int(s)) for s in rows]
    return judge(run)

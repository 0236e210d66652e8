"""Target -> plan: after one `estimate_pose` of the configuration's first
bench scene in set-up (which stores the pose and the body segmentation),
each request is a new target drawn from the seed within `target_radius_mm`
of the body centre: `find_entry_point(target)`, then
`plan_heuristic_path(target, entry, safety_mm, start_pose_steps=pose.steps)`
(the goal IK, the 25/25/50 up-over-down path and its collision check on the
card). No scan is uploaded and no segmentation kernel runs in the window.

`plan_ms` is the whole window over the plans completed in it. The check:
the set-up's pose as the pose cells check theirs, and every request's entry,
goal and path; the collision flag of `collision_samples` plans drawn from
the seed against the reference's own check of the same path.
"""

from __future__ import annotations

import math
import time

import numpy as np

from benchmark.lib import cell as C
from benchmark.lib import judge as J
from benchmark.lib import reference as R
from benchmark.lib import scenes as S

TARGETS = 2000


def setup(cell: C.Cell, engine=None, program: bool = True) -> C.Run:
    """The scan and the targets from the seed; with `program`, the engine
    (or `engine`), the set-up's pose and one warm plan."""
    p = cell.params
    run = C.Run(cell)
    arm, scenes, spacing, origin = C.bench_grid(cell)
    scene = scenes[0]
    run.data.update(arm=arm, scene=scene, spacing=spacing, origin=origin,
                    scan=C.render_host(cell, [scene], spacing, origin)[0],
                    targets=S.targets_near(S.BODY_CENTER_RAS, p["target_radius_mm"], TARGETS, cell.rng(1)), i=0)
    run.mark("inputs")
    if not program:
        return run
    from mamri_tpu_torch.perception.volume import Volume

    C.reset_peak(cell)
    run.engine = engine or C.make_engine(cell)
    run.mark("engine")
    est = run.engine.estimate_pose(Volume(data=run.data["scan"], spacing=spacing, origin=origin))
    seg = run.engine.last_segmentation
    run.data["pose"] = J.pose_record(est, seg, seg["body_mask"])
    run.data["start"] = _start(arm, est.steps)
    call(run)  # builds the collision world: set-up a target -> plan needs once per scan
    run.records.clear()
    run.mark("warm-up")
    run.attempted = run.failed = 0
    return run


def _start(arm, steps):
    """The plan's start pose as the planner takes it: steps -> radians (f32)."""
    if steps is None:
        return None
    spr = arm.steps_per_rev.astype(np.float32)
    return (np.asarray(steps, np.float32) * (np.float32(2 * math.pi) / spr)).astype(np.float64)


def next_target(run: C.Run) -> np.ndarray:
    d = run.data
    t = d["targets"][d["i"] % TARGETS]
    d["i"] += 1
    return t


def call(run: C.Run) -> float:
    """One timed request (entry search + plan); -> seconds."""
    d, eng = run.data, run.engine
    safety = run.cell.params["safety_mm"]
    target = next_target(run)
    plan = None
    t0 = time.perf_counter()
    ep = eng.find_entry_point(target)
    if bool(ep.found):
        plan = eng.plan_heuristic_path(target, ep.point_ras, safety, start_pose_steps=d["pose"]["steps"])
    dt = time.perf_counter() - t0
    ok = plan is not None and plan.success
    run.records.append(dict(target=target, found=bool(ep.found), entry=np.asarray(ep.point_ras, np.float64),
                            success=bool(ok), start=d["start"],
                            goal=None if not ok else np.asarray(plan.goal_angles, np.float64),
                            path=None if not ok else np.asarray(plan.path),
                            collision=None if not ok else bool(plan.collision_detected)))
    run.attempted += 1
    run.failed += int(not ok)
    return dt


def window(run: C.Run, seconds: float) -> None:
    C.closed_loop(run, seconds, lambda i: call(run))


def end_to_end(run: C.Run) -> dict:
    done = run.attempted - run.failed
    return {"plan_ms": 1e3 * run.elapsed_s / done} if done else {}


def trace(run: C.Run) -> None:
    from benchmark.lib.trace import profile

    run.facts["profile"] = profile(lambda: call(run), run.cell.params["trace_calls"])


def judge(run: C.Run) -> dict:
    """The numbers of the set-up's pose and of every request."""
    d, p = run.data, run.cell.params
    seg = run.cell.config["segmentation"]
    ref = R.pose(d["arm"], d["scan"], d["spacing"], d["origin"], seg, d["scene"])
    rows = [J.pose_numbers(d["arm"], d["pose"], ref)]
    entry = R.EntrySearch(ref["body_mask"], d["spacing"], d["origin"])
    collider = R.Collider(d["arm"], ref["body_mask"], d["spacing"], d["origin"])
    check = set(run.cell.rng(4).choice(len(run.records), size=min(p["collision_samples"], len(run.records)),
                                       replace=False).tolist()) if run.records else set()
    for i, rec in enumerate(run.records):
        rows.append(J.plan_numbers(d["arm"], rec, ref, entry.point(rec["target"]),
                                   collider if i in check else None, p["safety_mm"]))
    return J.worst(rows)


def control(run: C.Run, calls: int) -> dict:
    """The reference in bfloat16 in the program's place on the set-up's pose
    and the first `calls` requests, judged as the program is."""
    d, p = run.data, run.cell.params
    bf = R.BF16
    low = R.pose(d["arm"], d["scan"], d["spacing"], d["origin"], run.cell.config["segmentation"], d["scene"], bf)
    d["pose"] = J.reference_record(low)
    start = _start(d["arm"], low["steps"])
    entry = R.EntrySearch(low["body_mask"], d["spacing"], d["origin"], bf)
    collider = R.Collider(d["arm"], low["body_mask"], d["spacing"], d["origin"], bf)
    run.records = []
    for _ in range(calls):
        target = next_target(run)
        e = entry.point(target) if start is not None else None
        goal = None if e is None else R.solve_goal(d["arm"], low["base"], target, e, p["safety_mm"],
                                                   [start, np.zeros(6)], dtype=bf)
        path = None if goal is None else R.path(start, goal, dtype=bf)
        run.records.append(dict(target=target, found=e is not None, entry=e, success=goal is not None, start=start,
                                goal=goal, path=path,
                                collision=None if path is None else any(collider.collides(q, low["base"])
                                                                        for q in path)))
    return judge(run)

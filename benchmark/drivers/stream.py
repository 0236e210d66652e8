"""Live tracking: `PoseTracker.step` on each frame of a slow seeded arm
trajectory, one frame after another, on a fresh host buffer each frame.

The trajectory: `frames` poses from the configuration's first bench scene,
each joint drifting at most `step_deg` a frame and staying within
`bound_deg` of the start, the base fixed; frames replayed forth and back so
that no frame jumps. The tracker crops each frame after the anchor to its
ROI window (`roi_margin_mm`) before upload. A frame's latency runs on the
host clock around `step`. The check compares the frames of `ref_frames`
distinct trajectory poses drawn from the seed, full frames to the reference.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark.lib import cell as C
from benchmark.lib import judge as J
from benchmark.lib import reference as R
from benchmark.lib import scenes as S


def setup(cell: C.Cell, engine=None, program: bool = True) -> C.Run:
    """The frames from the seed; with `program`, the engine (or `engine`)
    and a tracker warmed on the full frame and the ROI window."""
    p = cell.params
    run = C.Run(cell)
    arm, scenes, spacing, origin = C.bench_grid(cell)
    first = scenes[0]
    poses = S.drift_poses(arm, first.angles, first.base, p["frames"], p["step_deg"], p["bound_deg"], cell.rng(1))
    run.data.update(arm=arm, scenes=poses, spacing=spacing, origin=origin,
                    scans=C.render_host(cell, poses, spacing, origin), order=S.forth_and_back(p["frames"]), pos=0)
    run.data["buffer"] = np.empty_like(run.data["scans"][0])
    run.mark("inputs")
    if not program:
        return run
    from mamri_tpu_torch.api.streaming import PoseTracker

    C.reset_peak(cell)
    run.engine = engine or C.make_engine(cell)
    run.mark("engine")
    run.data["tracker"] = PoseTracker(run.engine, roi_margin_mm=p["roi_margin_mm"])
    for _ in range(3):  # the anchor (full frame), then the ROI window's shape
        call(run)
    run.records.clear()
    run.mark("warm-up")
    run.attempted = run.failed = 0
    return run


def next_frame(run: C.Run) -> int:
    d = run.data
    f = d["order"][d["pos"] % len(d["order"])]
    d["pos"] += 1
    return f


def call(run: C.Run) -> float:
    """One timed tracker step on the next frame; -> seconds."""
    from mamri_tpu_torch.perception.volume import Volume

    d = run.data
    f = next_frame(run)
    np.copyto(d["buffer"], d["scans"][f])
    tracker = d["tracker"]
    roi_before = tracker.roi_frames
    t0 = time.perf_counter()
    est = tracker.step(Volume(data=d["buffer"], spacing=d["spacing"], origin=d["origin"]))
    dt = time.perf_counter() - t0
    run.records.append(J.pose_record(est, scene=f, roi=tracker.roi_frames > roi_before))
    run.attempted += 1
    run.failed += int(not est.success)
    return dt


def window(run: C.Run, seconds: float) -> None:
    C.closed_loop(run, seconds, lambda i: call(run))


def end_to_end(run: C.Run) -> dict:
    return C.latency_metrics(run, "pose_ms")


def trace(run: C.Run) -> None:
    from benchmark.lib.trace import profile

    run.facts["profile"] = profile(lambda: call(run), run.cell.params["trace_calls"])
    run.facts["stream"] = {"frames": len(run.records), "roi_frames": sum(r["roi"] for r in run.records)}


def _sample(run: C.Run) -> list:
    frames = sorted({r["scene"] for r in run.records})
    k = min(run.cell.params["ref_frames"], len(frames))
    return sorted(int(f) for f in run.cell.rng(3).choice(frames, size=k, replace=False))


def judge(run: C.Run) -> dict:
    refs = J.pose_references(run, _sample(run))
    # an ROI frame's blob count is the window's, not the frame's: not compared
    return J.worst(J.pose_numbers(run.data["arm"], r, refs[r["scene"]], blob_count=False)
                   for r in run.records if r["scene"] in refs)


def control(run: C.Run, calls: int) -> dict:
    """The reference in bfloat16 in the program's place on the first
    `calls` frames of the window, judged as the program is."""
    frames = [next_frame(run) for _ in range(calls)]
    run.records = [dict(scene=f) for f in frames]
    low = J.pose_references(run, _sample(run), R.BF16)
    run.records = [dict(J.reference_record(low[f], counts=False), scene=f) for f in frames if f in low]
    return judge(run)


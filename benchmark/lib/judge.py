"""The comparison that decides `correct`: the program's answers, as the
timed path returned them, against the reference's answers for the same
inputs (`benchmark.lib.reference`), reduced to a few numbers a cell holds
to the limits in its workload file.

Pose numbers (one record a call, the worst over the records judged):
- `count_off`: blobs and components counted differently from the reference,
  plus a failed pose, a marker triplet not found, or a certificate that does
  not hold (exact: 0);
- `mask_off_vox`: body-mask voxels that differ (exact: 0), where the path
  returns the mask;
- `base_gap_mm`: the largest distance between the program's and the
  reference's base transform applied to the baseplate markers and to a
  point 400 mm up the arm;
- `angle_gap_deg`: the largest joint-angle difference (Joint6 modulo a
  turn: its windings are one pose, chosen by the engine's current pose);
- `steps_gap`: the largest motor-step difference (Joint6 likewise);
- `rmse_gap_mm`: the difference of the reported marker RMSE.
Plan numbers: `plan_off` (requests with no entry or no plan: exact 0),
`entry_gap_mm`, `goal_tip_mm` (the reference FK's needle tip from the
standoff), `goal_dir_deg`, `path_gap_rad` (against the up-over-down path
from the plan's start and goal), `collision_off` (plans whose collision
flag the reference's check of the same path contradicts: exact 0).
"""

from __future__ import annotations

import math

import numpy as np

from benchmark.lib import reference as R
from benchmark.lib.arm import Arm

BIG = float("inf")


def pose_record(est, seg=None, body_mask=None, **extra) -> dict:
    """One call's answer from a PoseEstimate (and the engine's segmentation
    of that call, where the path keeps it)."""
    rec = dict(extra)
    rec.update(success=bool(est.success), found_all=all(est.markers_found.values()), num_blobs=int(est.num_blobs),
               angles=None if est.angles_rad is None else np.asarray(est.angles_rad, np.float64),
               steps=None if est.steps is None else np.asarray(est.steps, np.int64),
               base=None if est.baseplate_tf is None else np.asarray(est.baseplate_tf, np.float64),
               rmse=est.rmse_mm)
    if seg is not None:
        rec["num_components"] = int(seg["num_components"])
        rec["certified"] = bool(seg["seg_converged"]) and bool(seg["roots_complete"]) and bool(seg["blobs_complete"])
    if body_mask is not None:
        rec["body_mask"] = body_mask
    return rec


def batch_records(out: dict, scenes) -> list:
    """One record a row of `estimate_pose_batch`'s output."""
    recs = []
    for i, s in enumerate(scenes):
        recs.append(dict(scene=int(s), success=bool(out["success"][i]), found_all=bool(out["markers_found"][i].all()),
                         num_blobs=int(out["num_blobs"][i]), num_components=int(out["num_components"][i]),
                         certified=bool(out["seg_converged"][i] and out["roots_complete"][i]
                                        and out["blobs_complete"][i]),
                         angles=np.asarray(out["angles"][i], np.float64), steps=np.asarray(out["steps"][i], np.int64),
                         base=np.asarray(out["base_tf"][i], np.float64), rmse=float(out["rmse"][i])))
    return recs


def reference_record(ans: dict, counts: bool = True) -> dict:
    """A reference answer in the shape of a program's record (the control
    puts the reference in the program's place); `counts` adds the component
    count, the certificates and the body mask, where the path reports them."""
    found = bool(ans["found"].all())
    rec = dict(success=found, found_all=found, num_blobs=ans["num_blobs"], angles=ans["angles"], steps=ans["steps"],
               base=ans["base"], rmse=ans["rmse"])
    if counts:
        rec.update(num_components=ans["num_components"], certified=True, body_mask=ans["body_mask"])
    return rec


def _wrap(d):
    return (np.asarray(d) + math.pi) % (2 * math.pi) - math.pi


def _probe_points(arm: Arm):
    return np.vstack([arm.markers["Baseplate"], [[0.0, 0.0, 400.0]]])


def pose_numbers(arm: Arm, rec: dict, ref: dict, blob_count: bool = True) -> dict:
    """The pose numbers of one record against its reference."""
    off = int(not rec["success"]) + int(not rec["found_all"]) + int(not rec.get("certified", True))
    if blob_count:
        off += abs(rec["num_blobs"] - ref["num_blobs"])
    if "num_components" in rec:
        off += abs(rec["num_components"] - ref["num_components"])
    out = {"count_off": off}
    if "body_mask" in rec:
        out["mask_off_vox"] = int(np.count_nonzero(rec["body_mask"] != ref["body_mask"]))
    if rec["angles"] is None or ref["angles"] is None or rec["base"] is None:
        out.update(base_gap_mm=BIG, angle_gap_deg=BIG, steps_gap=BIG, rmse_gap_mm=BIG)
        return out
    p = _probe_points(arm)
    moved = [p @ b[:3, :3].T + b[:3, 3] for b in (rec["base"], ref["base"])]
    out["base_gap_mm"] = float(np.linalg.norm(moved[0] - moved[1], axis=1).max())
    d = rec["angles"] - ref["angles"]
    d[5] = _wrap(d[5])
    out["angle_gap_deg"] = float(np.degrees(np.abs(d)).max())
    sd = np.abs(rec["steps"] - ref["steps"])
    turn6 = 2 * math.pi * np.eye(6)[5]
    sd[5] = min(abs(rec["steps"][5] - R.steps_of(arm, ref["angles"] + w * turn6)[5]) for w in (-1, 0, 1))
    out["steps_gap"] = float(sd.max())
    out["rmse_gap_mm"] = float(abs(rec["rmse"] - ref["rmse"]))
    return out


def plan_numbers(arm: Arm, rec: dict, ref_pose: dict, entry_ref, collider, safety_mm: float) -> dict:
    """The plan numbers of one request against the reference. `entry_ref`
    is the reference's entry for the request's target (None: none)."""
    if not rec["found"] or not rec["success"] or entry_ref is None:
        return {"plan_off": 1}
    out = {"plan_off": 0, "entry_gap_mm": float(np.linalg.norm(np.asarray(rec["entry"]) - entry_ref))}
    tip, ang = R.goal_errors(arm, rec["goal"], ref_pose["base"], rec["target"], entry_ref, safety_mm)
    out["goal_tip_mm"], out["goal_dir_deg"] = tip, ang
    expect = R.path(rec["start"], rec["goal"], len(rec["path"]) - 1)
    out["path_gap_rad"] = float(np.abs(np.asarray(rec["path"], np.float64) - expect).max())
    if collider is not None:
        flag = any(collider.collides(q, ref_pose["base"]) for q in rec["path"])
        out["collision_off"] = int(flag != rec["collision"])
    return out


def pose_references(run, keys, dtype=R.F64) -> dict:
    """{key: the reference's answer for run.data's scan and scene `key`}."""
    d = run.data
    seg = run.cell.config["segmentation"]
    return {k: R.pose(d["arm"], d["scans"][k], d["spacing"], d["origin"], seg, d["scenes"][k], dtype) for k in keys}


def worst(rows) -> dict:
    """{number: the largest value over the rows}."""
    out = {}
    for row in rows:
        for k, v in row.items():
            out[k] = max(out.get(k, v), v)
    return out


def verdict(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}): every limit of the workload
    file met by its number. A number with no limit, or a limit whose number
    the run never produced (value None), is never correct."""
    checks, ok = {}, bool(numbers)
    for name in sorted(set(numbers) | set(limits)):
        value, limit = numbers.get(name), limits.get(name)
        checks[name] = {"value": value, "limit": limit}
        ok = ok and value is not None and limit is not None and value <= limit
    return ok, checks

"""The port's streaming tracker and tracer against mamri_tpu's.

`PoseTracker` on tests/test_streaming_roi.py's scene (3 mm grid, the arm at
a0 + 0.02 k, k = 0..3, and the body): that file's assertions on the port's
tracker, and its ROI mode held against JAX's tracker on the same frames (the
same window, ROI and fallback counts; angles within the tolerance of
tests/test_torch_engine.py: J1-J3 1e-3 rad, the TCP 0.05 mm). Both engines run
with `ik_restarts=0` (no random draws). `_crop_roi` is held to the reference's
bit for bit with `last_estimate` set by hand (no pipeline run). The port's
other modes (pipelined, re-planning, int16 frames, a scan from disk) are
checked as the reference's own tests check them.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mamri_tpu.api import MamriEngine as JaxEngine
from mamri_tpu.api.streaming import PoseTracker as JaxTracker
from mamri_tpu.api.types import PoseEstimate as JaxEstimate
from mamri_tpu.core import transforms as jT
from mamri_tpu.core.robot import fk_all_links as j_fk
from mamri_tpu.core.robot import marker_world_positions
from mamri_tpu.perception.volume import synthetic_volume
from mamri_tpu.utils import trace as j_trace
from mamri_tpu_torch.api.engine import MamriEngine
from mamri_tpu_torch.api.streaming import PoseTracker
from mamri_tpu_torch.api.types import PoseEstimate, TrajectoryPlan
from mamri_tpu_torch.perception.dicom import load_dicom_series, save_dicom_series
from mamri_tpu_torch.perception.reference_cpu import segment_reference
from mamri_tpu_torch.perception.segmentation import SegmentationParams, segment_volume
from mamri_tpu_torch.perception.volume import Volume
from mamri_tpu_torch.utils import trace as t_trace
from test_torch_engine import _one_torch_thread  # noqa: F401 (autouse)

LINKS = ("Baseplate", "Joint2", "Joint4", "Joint6")
BODY_CENTER = np.array([-60.0, -40.0, 130.0], np.float32)
A0 = np.array([0.3, -0.7, 0.5, 0.2, -0.4, 0.6], dtype=np.float32)
POSES = [A0, A0 + 0.02, A0 + 0.04, A0 + 0.06]


def _base():
    return np.asarray(jT.translate(jnp.array([-60.0, -120.0, 0.0])) @ jT.rot_x(jnp.float32(-np.pi / 2))
                      @ jT.rot_z(jnp.float32(0.15)))


@pytest.fixture(scope="module")
def jax_engine():
    return JaxEngine(ik_restarts=0)


@pytest.fixture(scope="module")
def engine():
    return MamriEngine(device="cpu", ik_restarts=0, tracer=t_trace.Tracer())


def _markers(model, angles, base):
    return np.concatenate([np.asarray(marker_world_positions(model, jnp.asarray(angles), ln, jnp.asarray(base)))
                           for ln in LINKS])


@pytest.fixture(scope="module")
def grid(jax_engine):
    """tests/test_streaming_roi.py's grid: one full frame that holds the pose
    sequence and the body, 3 mm."""
    base = _base()
    pts = np.concatenate([_markers(jax_engine.model, a, base) for a in POSES])
    lo = np.minimum(pts.min(0) - 40, BODY_CENTER - 70)
    hi = np.maximum(pts.max(0) + 40, BODY_CENTER + 70)
    sp = np.full(3, 3.0, dtype=np.float32)
    lps_lo = np.array([-hi[0], -hi[1], lo[2]], dtype=np.float32)
    shape = tuple(int(np.ceil(e)) for e in (np.array([-lo[0], -lo[1], hi[2]]) - lps_lo) / sp)
    return base, sp, lps_lo, shape


def _frame(model, grid, angles):
    base, sp, lps_lo, shape = grid
    return synthetic_volume(shape=shape, spacing=sp, origin=lps_lo, fiducials_ras=_markers(model, angles, base),
                            fiducial_radius_mm=4.0, body_center_ras=BODY_CENTER, body_radii_mm=[45.0, 55.0, 65.0])


@pytest.fixture(scope="module")
def frames(jax_engine, grid):
    """[(mamri_tpu Volume, the port's Volume of the same arrays)] per pose."""
    out = []
    for a in POSES:
        v = _frame(jax_engine.model, grid, a)
        out.append((v, Volume(v.data, v.spacing, v.origin)))
    return out


def _ports(frames):
    return [t for _, t in frames]


def _deg(a, b):
    return float(np.degrees(np.abs(np.asarray(a) - np.asarray(b))).max())


# ------------------------------------------------------------------ the tracer
def _record(trace_mod):
    t = trace_mod.Tracer()
    for name, xs in (("frame", [0.012, 0.0305, 0.0071, 0.5]), ("replan", [1.25]), ("estimate_pose", [0.3, 0.2])):
        t.spans[name].extend(xs)
    return t


def test_tracer_matches_reference():
    """The same recorded spans give the same `stats` and `report`; spans
    time a block, `sync=True` waits on a tensor result, a disabled tracer
    records nothing, `reset` clears, and the module-level `span` records into
    `global_tracer()`."""
    ours, theirs = _record(t_trace), _record(j_trace)
    for name in ("frame", "replan", "estimate_pose", "missing"):
        assert ours.stats(name) == theirs.stats(name), name
    assert ours.report() == theirs.report()

    t = t_trace.Tracer()
    with t.span("work", sync=True, result={"x": torch.ones(3), "y": (torch.zeros(2),)}):
        pass
    assert t.stats("work")["count"] == 1 and t.stats("work")["min_s"] >= 0.0
    off = t_trace.Tracer(enabled=False)
    with off.span("work"):
        pass
    assert not off.spans
    t.reset()
    assert t.report() == "" and t.stats("work") == {}
    before = t_trace.global_tracer().stats("module-span").get("count", 0)
    with t_trace.span("module-span"):
        pass
    assert t_trace.global_tracer().stats("module-span")["count"] == before + 1


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with t_trace.device_trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    (name,) = [p.name for p in (tmp_path / "trace").iterdir()]
    assert name.endswith(".json") and (tmp_path / "trace" / name).read_text().lstrip().startswith("{")
    with t_trace.device_trace(None):  # no log dir: no profiler
        pass


# ------------------------------------------------------------------ the constructor
REFUSALS = {
    "depth": dict(pipelined=True, depth=0),
    "replan_every": dict(replan_every=0),
    "no_entry": dict(target_ras=np.zeros(3)),
    "replan_pipelined": dict(pipelined=True, target_ras=np.zeros(3), entry_ras=np.zeros(3)),
    "roi_replan": dict(roi_margin_mm=40.0, target_ras=np.zeros(3), entry_ras=np.zeros(3)),
    "roi_pipelined": dict(pipelined=True, roi_margin_mm=40.0),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_constructor_refusals_match_reference(case, engine, jax_engine):
    with pytest.raises(ValueError) as ours:
        PoseTracker(engine, **REFUSALS[case])
    with pytest.raises(ValueError) as theirs:
        JaxTracker(jax_engine, **REFUSALS[case])
    assert str(ours.value) == str(theirs.value)


# ------------------------------------------------------------------ the ROI window
CROPS = ["pose0", "pose1", "pose3", "jump", "fov_shrink", "whole_frame", "no_anchor"]


@pytest.mark.parametrize("case", CROPS)
def test_crop_roi_matches_reference(case, engine, jax_engine, frames):
    """Start, shape and origin of the window bit for bit, and the refusals:
    a frame smaller than the frozen window, a window of >= 90 % of the
    frame, no successful previous estimate."""
    margin = 400.0 if case == "whole_frame" else 40.0
    ours, theirs = PoseTracker(engine, roi_margin_mm=margin), JaxTracker(jax_engine, roi_margin_mm=margin)
    j_vol, t_vol = frames[1]
    angles = {"pose0": POSES[0], "pose3": POSES[3], "jump": A0 + np.float32(0.35)}.get(case, POSES[1])
    ok = case != "no_anchor"
    ours.last_estimate = PoseEstimate(success=ok, angles_rad=angles, baseplate_tf=_base())
    theirs.last_estimate = JaxEstimate(success=ok, angles_rad=angles, baseplate_tf=_base())
    if case == "fov_shrink":
        assert ours._crop_roi(t_vol) is not None and theirs._crop_roi(j_vol) is not None  # freezes the window
        cut = ours._roi_shape[0] - 1
        j_vol = type(j_vol)(np.asarray(j_vol.data)[:cut], j_vol.spacing, j_vol.origin)
        t_vol = Volume(t_vol.data[:cut], t_vol.spacing, t_vol.origin)
    got, want = ours._crop_roi(t_vol), theirs._crop_roi(j_vol)
    assert ours._roi_shape == theirs._roi_shape
    if case in ("fov_shrink", "whole_frame", "no_anchor"):
        assert got is None and want is None
        return
    assert got.shape == want.shape == ours._roi_shape
    assert got.origin.tobytes() == want.origin.tobytes() and got.spacing.tobytes() == want.spacing.tobytes()
    np.testing.assert_array_equal(got.data, np.asarray(want.data))  # the same start
    assert got.shape[1] % 8 == 0 or got.shape[1] == t_vol.shape[1]


# ------------------------------------------------------------------ the streams
def _tcp(model, angles, base):
    return np.asarray(j_fk(model, jnp.asarray(angles), jnp.asarray(base)))[-1][:3, 3]


@pytest.fixture(scope="module")
def roi_streams(engine, jax_engine, frames):
    """Full frames, then the ROI stream, through the port; the ROI stream
    through JAX's tracker."""
    full = PoseTracker(engine)
    full_res = [full.step(f) for f in _ports(frames)]
    engine.set_pose(np.zeros(6, dtype=np.float32))  # cold again
    roi = PoseTracker(engine, roi_margin_mm=40.0)
    roi_res = [roi.step(f) for f in _ports(frames)]
    jax_engine.set_pose(np.zeros(6, dtype=np.float32))
    jroi = JaxTracker(jax_engine, roi_margin_mm=40.0)
    jroi_res = [jroi.step(j) for j, _ in frames]
    return full_res, (roi, roi_res), (jroi, jroi_res)


def test_roi_stream_matches_full_frames(roi_streams, frames):
    """tests/test_streaming_roi.py's assertions on the port's tracker."""
    full_res, (roi, roi_res), _ = roi_streams
    for a, est in zip(POSES, full_res):
        assert est.success and _deg(est.angles_rad, a) < 4.0
    assert all(r.success for r in roi_res)
    st = roi.stats()
    assert st["roi_frames"] == len(frames) - 1 and st["roi_fallbacks"] == 0, st
    vol_shape = frames[0][1].shape
    assert all(s <= v for s, v in zip(st["roi_shape"], vol_shape))
    assert np.prod(st["roi_shape"]) < 0.75 * np.prod(vol_shape), st
    for r, f in zip(roi_res[1:], full_res[1:]):
        assert _deg(r.angles_rad, f.angles_rad) < 0.2


def test_roi_stream_matches_jax(roi_streams, jax_engine):
    _, (roi, roi_res), (jroi, jroi_res) = roi_streams
    ours, theirs = roi.stats(), jroi.stats()
    for key in ("frames", "failures", "roi_frames", "roi_fallbacks", "roi_shape"):
        assert ours[key] == theirs[key], key
    base = _base()
    for t, j in zip(roi_res, jroi_res):
        assert t.success == j.success and t.markers_found == j.markers_found and t.num_blobs == j.num_blobs
        np.testing.assert_allclose(t.baseplate_tf, j.baseplate_tf, atol=1e-4)
        np.testing.assert_allclose(t.angles_rad[:3], j.angles_rad[:3], atol=1e-3)
        tcp_gap = np.linalg.norm(_tcp(jax_engine.model, t.angles_rad, base) - _tcp(jax_engine.model, j.angles_rad, base))
        assert tcp_gap < 0.05, tcp_gap


def test_roi_fallback_on_pose_jump(engine, jax_engine, grid, frames):
    """tests/test_streaming_roi.py: a jump past a 25 mm margin misses in the
    window and the same step recovers on the full frame."""
    jump = A0 + np.array([0.7, 0.3, -0.4, 0.3, 0.3, 0.5], dtype=np.float32)
    j = _frame(jax_engine.model, grid, jump)
    engine.set_pose(np.zeros(6, dtype=np.float32))
    tr = PoseTracker(engine, roi_margin_mm=25.0)
    assert tr.step(frames[0][1]).success
    r1 = tr.step(Volume(j.data, j.spacing, j.origin))
    assert r1.success, r1.message
    assert _deg(r1.angles_rad, jump) < 4.0
    st = tr.stats()
    assert st["roi_fallbacks"] == 1 and st["roi_frames"] == 0 and st["failures"] == 0, st


def test_roi_fov_shrink_falls_back_to_full_frame(engine, frames):
    tr = PoseTracker(engine, roi_margin_mm=40.0)
    f0, f1 = _ports(frames)[:2]
    assert tr.step(f0).success
    assert tr.step(f1).success and tr.roi_frames == 1
    cut = tr._roi_shape[0] - 1
    small = Volume(data=f1.data[:cut], spacing=f1.spacing, origin=f1.origin)
    r2 = tr.step(small)
    assert r2.success and tr.roi_frames == 1 and tr.roi_fallbacks == 0
    assert tr._crop_roi(small) is None


def test_pipelined_matches_sync_one_frame_late(engine, frames):
    """tests/test_engine.py's pipelined check: dispatch N / collect N-1 gives
    the synchronous estimate, one frame late; the host frame may be
    overwritten as soon as `step` returns."""
    vol = frames[0][1]
    engine.set_pose(np.zeros(6, dtype=np.float32))
    ref = PoseTracker(engine).step(vol)
    engine.set_pose(np.zeros(6, dtype=np.float32))
    t = PoseTracker(engine, pipelined=True, depth=1)
    scratch = Volume(vol.data.copy(), vol.spacing, vol.origin)
    assert t.step(scratch) is None  # the pipeline fills
    scratch.data[...] = 0  # the dispatched frame's upload was taken before step returned
    r1 = t.step(vol)
    assert r1 is not None and r1.success
    rest = t.flush()
    assert len(rest) == 1 and rest[0].success
    assert t.frames == 2 and t.failures == 0 and t.flush() == []
    np.testing.assert_allclose(r1.angles_rad, ref.angles_rad, atol=1e-4)


def test_int16_frames_equal_float32(frames):
    """Scanner-native int16 frames give bit-identical results (the
    segmentation casts on the device; tests/test_engine.py holds the
    reference to the same)."""
    vol = frames[0][1]
    v16 = Volume(vol.data.astype(np.int16), vol.spacing, vol.origin)
    assert v16.data.dtype == np.int16
    a = PoseTracker(MamriEngine(device="cpu", ik_restarts=0)).step(vol)
    b = PoseTracker(MamriEngine(device="cpu", ik_restarts=0)).step(v16)
    assert a.success and b.success
    for field in ("angles_rad", "steps", "baseplate_tf"):
        np.testing.assert_array_equal(getattr(b, field), getattr(a, field), err_msg=field)
    assert (b.rmse_mm, b.markers_found, b.num_blobs) == (a.rmse_mm, a.markers_found, a.num_blobs)


# ------------------------------------------------------------------ re-planning and spans
@pytest.fixture(scope="module")
def replanned(frames):
    """tests/test_engine.py's re-planning loop with `replan_every=2` over 2
    frames: one goal solved. The engine records its tracer spans."""
    eng = MamriEngine(device="cpu", ik_restarts=0, tracer=t_trace.Tracer())
    vol = frames[0][1]
    assert eng.estimate_pose(vol).success
    ep = eng.find_entry_point(BODY_CENTER)
    assert bool(ep.found)
    solved = []
    solve = eng._solve_goal

    def solve_once(*args):
        # the one goal of this stream; later planning calls in this module
        # (which test only their spans) reuse it instead of solving again
        if not solved:
            solved.append(solve(*args))
        return solved[0]

    eng._solve_goal = solve_once
    t = PoseTracker(eng, target_ras=BODY_CENTER, entry_ras=ep.point_ras, safety_mm=5.0, replan_every=2)
    results = [t.step(vol) for _ in range(2)]
    return eng, t, results, ep


def test_tracker_replans(replanned):
    eng, t, results, _ = replanned
    assert all(r.success for r in results)
    assert t.last_plan is not None and t.last_plan.success, t.last_plan.message
    assert t.last_plan.path.shape == (101, 6)
    st = t.stats()
    assert st["frames"] == 2 and "replan_p50_ms" in st and t.tracer.stats("replan")["count"] == 1
    # a re-plan frame keeps its body, so the plan's collision world is this frame's
    assert eng.last_collision_world is not None


def _reference_span_names():
    with open(JaxEngine.__init__.__code__.co_filename) as f:
        return set(re.findall(r'self\.tracer\.span\("(\w+)"', f.read()))


# the port's own spans inside the scan -> pose path (utils/trace.py, tests/test_torch_trace.py)
POSE_PATH_SPANS = {"pose.upload", "pose.segment", "pose.ik", "ik.lm.solve", "pose.fetch"}


def test_engine_records_the_reference_spans(replanned):
    """Every span name of mamri_tpu's engine is recorded by the port's engine
    across the calls that record them, and the names beyond the reference's
    are exactly the port's pose-path spans and the trajectory LM's."""
    eng, _, _, ep = replanned
    eng.plan_trajectory(BODY_CENTER, ep.point_ras)
    eng.plan_trajectory_sweep(BODY_CENTER, ep.point_ras, [5.0])
    eng.validate_plan_exact(TrajectoryPlan(success=True, path=eng.trajectory_path[:2], collision_detected=False))
    reference = _reference_span_names()
    assert reference == {
        "estimate_pose", "build_collision_world", "find_entry_point", "plan_trajectory", "plan_trajectory_sweep",
        "plan_heuristic_path", "validate_plan_exact",
    }
    assert reference <= set(eng.tracer.spans)
    # and the generic LM's Jacobian, which the trajectory goal IK of planning runs
    assert set(eng.tracer.spans) - reference == POSE_PATH_SPANS | {"ik.lm.jacobian"}
    assert eng.tracer.stats("estimate_pose")["count"] == 3
    assert MamriEngine(device="cpu").tracer.enabled is False


# ------------------------------------------------------------------ from disk
def test_scan_from_disk_to_pose(engine, frames, tmp_path):
    """A DICOM series written by the port and loaded back goes through the
    port's tracker; its segmentation centroids are held to the port's
    `reference_cpu.segment_reference` (the SciPy oracle), as
    tests/test_reference_pipeline_parity.py holds the reference's."""
    vol = frames[2][1]
    save_dicom_series(str(tmp_path), vol)
    loaded = load_dicom_series(str(tmp_path))
    np.testing.assert_array_equal(np.asarray(loaded.data, np.float32), vol.data)
    assert loaded.spacing.tobytes() == vol.spacing.tobytes() and loaded.origin.tobytes() == vol.origin.tobytes()

    engine.set_pose(np.zeros(6, dtype=np.float32))
    est = PoseTracker(engine).step(loaded)
    assert est.success and all(est.markers_found.values()) and _deg(est.angles_rad, POSES[2]) < 4.0

    oracle = segment_reference(loaded)
    seg = segment_volume(torch.as_tensor(loaded.data), torch.as_tensor(loaded.spacing),
                         torch.as_tensor(loaded.origin), SegmentationParams(max_sweeps=2, passes=3, max_roots=128))
    got = seg.centroids_ras[seg.blob_valid].numpy()
    assert got.shape == oracle.centroids_ras.shape == (12, 3)
    np.testing.assert_allclose(got, oracle.centroids_ras, atol=1e-3)
    np.testing.assert_array_equal(seg.body_mask.numpy(), oracle.body_mask)

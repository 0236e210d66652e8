"""The port's engine planning methods against mamri_tpu's engine on
tests/test_planning_exact.py's scene (estimate -> entry -> plan -> exact
validation), with the state carried across by `load_state_from_numpy` and
`set_body_segmentation(mask, spacing, origin)`.

Entry points, collision worlds and keyframes that do not depend on the goal
are held exact, normals at 1e-5, paths at 1e-6 and position errors at
1e-2 mm. The goal is one of several exact answers (tests/test_torch_planning.py
says why): the port's is held to the reference's residual, to JAX's goal up
to the chain's exact twins (`mamri_tpu.ik.residuals.ik_branch_family`)
within 1e-3 rad, and its path and flags to what the reference's own
functions make of that goal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mamri_tpu import planning as JP
from mamri_tpu.api import MamriEngine as JaxEngine
from mamri_tpu.core import transforms as jT
from mamri_tpu.core.robot import marker_world_positions
from mamri_tpu.ik.residuals import ik_branch_family
from mamri_tpu.ik.residuals import trajectory_pose_residual as j_traj_res
from mamri_tpu.perception.volume import synthetic_volume
from mamri_tpu_torch.api.engine import MamriEngine
from mamri_tpu_torch.api.types import TrajectoryPlan
from mamri_tpu_torch.perception.volume import Volume
from test_torch_engine import _one_torch_thread  # noqa: F401 (autouse)

BODY_CENTER = np.array([-60.0, -40.0, 130.0], np.float32)


def _scene(model, body_center=BODY_CENTER):
    """tests/test_planning_exact.py's `planned_engine` scan (3 mm)."""
    base = np.asarray(jT.translate(jnp.array([-60.0, -120.0, 0.0])) @ jT.rot_x(jnp.float32(-np.pi / 2))
                      @ jT.rot_z(jnp.float32(0.15)))
    angles = np.array([0.3, -0.7, 0.5, 0.2, -0.4, 0.6], dtype=np.float32)
    pts = np.concatenate([np.asarray(marker_world_positions(model, jnp.asarray(angles), ln, jnp.asarray(base)))
                          for ln in ("Baseplate", "Joint2", "Joint4", "Joint6")])
    lo = np.minimum(pts.min(0) - 40, BODY_CENTER - 70)
    hi = np.maximum(pts.max(0) + 40, BODY_CENTER + 70)
    sp = np.full(3, 3.0, dtype=np.float32)
    lps_lo = np.array([-hi[0], -hi[1], lo[2]], dtype=np.float32)
    shape = tuple(int(np.ceil(e)) for e in (np.array([-lo[0], -lo[1], hi[2]]) - lps_lo) / sp)
    return synthetic_volume(shape=shape, spacing=sp, origin=lps_lo, fiducials_ras=pts, fiducial_radius_mm=4.0,
                            body_center_ras=body_center, body_radii_mm=[45.0, 55.0, 65.0])


def _port_volume(vol):
    return Volume(vol.data, vol.spacing, vol.origin)


@pytest.fixture(scope="module")
def planned():
    """The reference's estimate -> entry -> plan, and a CPU port engine
    carrying its state, planned the same way."""
    jeng = JaxEngine()
    est = jeng.estimate_pose(_scene(jeng.model))
    assert est.success, est.message
    j_entry = jeng.find_entry_point(BODY_CENTER)
    j_plan = jeng.plan_heuristic_path(BODY_CENTER, np.asarray(j_entry.point_ras), 5.0, start_pose_steps=est.steps)
    assert j_plan.success, j_plan.message

    teng = MamriEngine(device="cpu")
    teng.load_state_from_numpy(baseplate_tf=jeng.baseplate_tf, current_angles=jeng.current_angles)
    teng.set_body_segmentation(jeng.last_segmentation["body_mask"], *jeng.last_volume_geom)
    t_entry = teng.find_entry_point(BODY_CENTER)
    t_plan = teng.plan_heuristic_path(BODY_CENTER, t_entry.point_ras, 5.0, start_pose_steps=est.steps)
    return jeng, teng, est, (j_entry, j_plan), (t_entry, t_plan)


def test_entry_point_and_world_match_jax(planned):
    jeng, teng, _, (j_entry, _), (t_entry, _) = planned
    assert bool(t_entry.found) and bool(j_entry.found)
    np.testing.assert_array_equal(t_entry.point_ras, np.asarray(j_entry.point_ras))
    np.testing.assert_array_equal(t_entry.distance_mm, np.asarray(j_entry.distance_mm))
    np.testing.assert_allclose(t_entry.normal_ras, np.asarray(j_entry.normal_ras), atol=1e-5)
    assert isinstance(t_entry.point_ras, np.ndarray)  # host arrays, as the reference's device_get
    jw, tw = jeng.last_collision_world, teng.last_collision_world
    np.testing.assert_array_equal(tw.occupancy.numpy(), np.asarray(jw.occupancy))
    np.testing.assert_array_equal(tw.inside_depth.numpy(), np.asarray(jw.inside_depth))


def test_heuristic_plan_against_jax(planned):
    jeng, teng, est, (_, j_plan), (t_entry, t_plan) = planned
    assert t_plan.success and isinstance(t_plan, TrajectoryPlan)
    assert t_plan.path.shape == j_plan.path.shape == (101, 6) and t_plan.keyframes.shape == (4, 6)
    assert t_plan.collision_detected == j_plan.collision_detected
    assert abs(t_plan.position_error_mm - j_plan.position_error_mm) < 1e-2
    # start and "up" do not depend on the goal
    np.testing.assert_allclose(t_plan.keyframes[:2], j_plan.keyframes[:2], atol=1e-6)
    np.testing.assert_allclose(t_plan.path[0], jeng.convert_steps_to_angles(est.steps), atol=1e-6)

    goal = jnp.asarray(t_plan.goal_angles)
    target_tf = JP.needle_target_frame(jnp.asarray(BODY_CENTER), jnp.asarray(t_entry.point_ras), 5.0)
    res = np.asarray(j_traj_res(jeng.model, goal, jnp.asarray(jeng.baseplate_tf), target_tf))
    assert np.linalg.norm(res[:3]) < 1e-2
    twins = np.asarray(ik_branch_family(jnp.asarray(j_plan.goal_angles)))
    assert np.abs(twins - t_plan.goal_angles[None]).max(axis=1).min() < 1e-3
    np.testing.assert_array_equal(t_plan.goal_steps, jeng.convert_angles_to_steps(t_plan.goal_angles))

    # the path and its flags are what the reference's functions make of this goal
    start = jnp.asarray(jeng.convert_steps_to_angles(est.steps))
    j_path = JP.interpolate_path(JP.heuristic_keyframes(start, goal), 100)
    np.testing.assert_allclose(t_plan.path, np.asarray(j_path), atol=1e-6)
    flags = np.asarray(JP.check_path_collisions(jeng.model, jeng.geometry, jnp.asarray(t_plan.path),
                                                jnp.asarray(jeng.baseplate_tf), jeng.last_collision_world))
    assert t_plan.collision_detected == bool(flags.any())
    np.testing.assert_array_equal(teng.trajectory_path, t_plan.path)
    np.testing.assert_array_equal(teng.trajectory_keyframes, t_plan.keyframes)


def test_validate_plan_exact_matches_jax(planned):
    """The exact validator's dict on the port's plan, from both engines."""
    jeng, teng, _, _, (_, t_plan) = planned
    want = jeng.validate_plan_exact(t_plan)
    got = teng.validate_plan_exact(t_plan)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    assert got["checked_samples"] == 101 and got["fast_checker_flagged"] == t_plan.collision_detected
    again = teng.validate_plan_exact()  # the engine's stored path
    assert again["checked_samples"] == 101 and again["fast_checker_flagged"] is None


def test_sweep_rows_equal_single_plans(planned):
    """Each distance of a sweep equals `plan_trajectory` at it, and the tip
    stands farther off the entry as the distance grows."""
    _, teng, _, _, (t_entry, _) = planned
    distances = [2.0, 5.0, 10.0]
    sweep = teng.plan_trajectory_sweep(BODY_CENTER, t_entry.point_ras, distances)
    assert sweep.angles.shape == (3, 6) and sweep.target_tf.shape == (3, 4, 4)
    for i, d in enumerate(distances):
        one = teng.plan_trajectory(BODY_CENTER, t_entry.point_ras, d)
        for field in one._fields:
            np.testing.assert_array_equal(getattr(sweep, field)[i], getattr(one, field), err_msg=f"{d} {field}")
    assert np.all(sweep.position_error_mm < 1e-2) and sweep.success.all()
    d_entry = np.linalg.norm(sweep.target_tf[:, :3, 3] - t_entry.point_ras, axis=1)
    assert np.all(np.diff(d_entry) > 0)


def test_plan_after_a_second_scan_uses_the_new_body(planned):
    """A new estimate keeps a new body: the collision world built from the
    first scan is dropped, and the next plan checks against the second."""
    jeng, _, _, _, _ = planned
    eng = MamriEngine(device="cpu")
    assert eng.estimate_pose(_port_volume(_scene(jeng.model))).success
    first = eng.plan_trajectory(BODY_CENTER, eng.find_entry_point(BODY_CENTER).point_ras)
    world_1 = eng.last_collision_world
    assert world_1 is not None and bool(first.success)

    moved = BODY_CENTER + np.array([0.0, 0.0, 25.0], np.float32)
    assert eng.estimate_pose(_port_volume(_scene(jeng.model, body_center=moved))).success
    assert eng.last_collision_world is None
    eng.plan_trajectory(moved, eng.find_entry_point(moved).point_ras)
    world_2 = eng.last_collision_world
    assert world_2 is not None and not torch.equal(world_2.occupancy, world_1.occupancy)
    want = JP.build_collision_world(jnp.asarray(eng.body_mask()), *eng.last_volume_geom)
    np.testing.assert_array_equal(world_2.occupancy.numpy(), np.asarray(want.occupancy))


def test_conversions_and_base_frame_match_jax(planned):
    jeng, teng, est, _, _ = planned
    rng = np.random.default_rng(5)
    angles = rng.uniform(-3.0, 3.0, size=(20, 6)).astype(np.float32)
    np.testing.assert_array_equal(teng.convert_angles_to_steps(angles), jeng.convert_angles_to_steps(angles))
    steps = rng.integers(-2000, 2000, size=(20, 6))
    np.testing.assert_array_equal(teng.convert_steps_to_angles(steps), jeng.convert_steps_to_angles(steps))
    target = rng.normal(size=3) * 100
    np.testing.assert_array_equal(teng.target_in_base_frame(target), jeng.target_in_base_frame(target))
    np.testing.assert_array_equal(teng.body_mask(), jeng.body_mask())


def test_planning_needs_state():
    eng = MamriEngine(device="cpu")
    with pytest.raises(RuntimeError, match="no planned path"):
        eng.validate_plan_exact()
    with pytest.raises(RuntimeError, match="no body segmentation"):
        eng.find_entry_point(BODY_CENTER)
    with pytest.raises(RuntimeError, match="robot base unknown"):
        eng.plan_trajectory(BODY_CENTER, BODY_CENTER + 40.0)
    with pytest.raises(RuntimeError, match="robot base unknown"):
        eng.target_in_base_frame(BODY_CENTER)
    assert eng.body_mask() is None
    eng.trajectory_path = np.zeros((3, 6), np.float32)
    with pytest.raises(RuntimeError, match="no body segmentation"):
        eng.validate_plan_exact()
    with pytest.raises(FileNotFoundError):
        eng.set_body_segmentation("body.seg.nrrd")  # a path is read as a .seg.nrrd file
    with pytest.raises(ValueError, match="spacing and origin"):
        eng.set_body_segmentation(np.ones((4, 4, 4), bool))
    with pytest.raises(ValueError, match="non-empty"):
        eng.set_body_segmentation(np.zeros((4, 4, 4), bool), (1.0, 1.0, 1.0), (0.0, 0.0, 0.0))
    eng.set_body_segmentation(np.ones((4, 4, 4), bool), (1.0, 1.0, 1.0), (0.0, 0.0, 0.0))
    with pytest.raises(RuntimeError, match="robot base unknown"):
        eng.validate_plan_exact()
    assert eng.find_entry_point(np.zeros(3, np.float32)).found.dtype == np.bool_

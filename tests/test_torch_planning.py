"""The port's planning layer (`mamri_tpu_torch/planning/`, `utils/stl.py`)
against mamri_tpu's on the same numpy inputs.

Tolerances: collision worlds, path flags, entry points and part clouds
exact; entry normals 1e-5; `sample_grid` values 1e-6 and its derivative
1e-5; frames, keyframes and paths 1e-6; analytic seeds 1e-4; trajectory
angles 1e-3 rad and position errors 1e-2 mm.

The trajectory goal has many exact answers: every closed-form branch at
every roll about the needle reaches a reachable goal, and the chain's
shoulder and wrist twins reach it with the same cost. The reference's pick
among them is decided by the last bits of its arithmetic, and the port's
resolves near-ties in a fixed order (`planning/trajectory.py`). So the
angles are held to JAX's where the answer is unique (the strict
{current, zeros} search from the zero pose, whose two guesses are one
point); where it is not, the port's goal is held to the reference's own
residual and collision check, and its error, success and contact flags to
JAX's. JAX compiles each trajectory solve (~15 s here): it solves three
times, shared through module fixtures, on 256 points a part.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mamri_tpu import planning as JP
from mamri_tpu.core.robot import fk_all_links as j_fk
from mamri_tpu.core.robot import load_robot_model as j_load
from mamri_tpu.ik.residuals import trajectory_pose_residual as j_traj_res
from mamri_tpu.perception.volume import synthetic_volume
from mamri_tpu.planning import collision as jcoll
from mamri_tpu.planning import exact as jexact
from mamri_tpu.planning import trajectory as jtraj
from mamri_tpu_torch import planning as TP
from mamri_tpu_torch.core.robot import load_robot_model as t_load
from mamri_tpu_torch.planning import collision as tcoll
from mamri_tpu_torch.planning import exact as texact
from mamri_tpu_torch.planning import trajectory as ttraj
from mamri_tpu_torch.utils import stl as tstl
from test_torch_engine import _one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BODY_CENTER = [0.0, 50.0, 150.0]  # a ball the zero-pose arm runs into
BALL_TARGET = np.array([0.0, 60.0, 150.0], np.float32)
BALL_ENTRY = np.array([0.0, 110.0, 150.0], np.float32)


@pytest.fixture(scope="module")
def models():
    return j_load(), t_load(device="cpu")


@pytest.fixture(scope="module")
def geometries(models):
    jm, tm = models
    return JP.build_arm_geometry(jm, points_per_part=256), TP.build_arm_geometry(tm, points_per_part=256)


def _ball_mask(center_ras, radius, shape=(64, 64, 64), spacing=(2.0, 2.0, 2.0)):
    """tests/test_planning.py's `_ball_world` mask."""
    v = synthetic_volume(shape=shape, spacing=spacing, body_center_ras=center_ras, body_radii_mm=[radius] * 3)
    return v.data >= 65.0, np.asarray(v.spacing), np.asarray(v.origin)


def _worlds(mask, spacing, origin):
    return (JP.build_collision_world(jnp.asarray(mask), spacing, origin),
            TP.build_collision_world(torch.as_tensor(mask), spacing, origin))


@pytest.fixture(scope="module")
def ball_worlds():
    """A 40 mm ball 50 mm off the arm's zero-pose column (96^3 at 4 mm): the
    arm starts inside its dilated shell, so the LM's penetration term acts."""
    return _worlds(*_ball_mask(BODY_CENTER, 40.0, shape=(96, 96, 96), spacing=(4.0, 4.0, 4.0)))


def _needle_goal(jm, angles):
    """(target, entry) whose 5 mm standoff pose FK reaches at `angles`."""
    needle = j_fk(jm, jnp.asarray(angles, jnp.float32), jnp.eye(4))[jm.link_index("Needle")]
    tip, direction = np.asarray(needle[:3, 3]), -np.asarray(needle[:3, 0])
    entry = tip + 5.0 * direction
    return (entry + 40.0 * direction).astype(np.float32), entry.astype(np.float32)


@pytest.mark.parametrize("center, radius", [([0.0, 0.0, 30.0], 30.0), ([-50.0, 20.0, -40.0], 30.0)],
                         ids=["ball", "clipped-by-border"])
def test_collision_world_matches_jax(center, radius):
    """Occupancy and inside depth exact, also where the body runs off the
    grid (the dilation must not wrap, the chamfer step wraps as jnp.roll)."""
    mask, spacing, origin = _ball_mask(center, radius)
    if center[0] < 0:
        assert mask[-1].any() and mask[:, :, 0].any()  # touches two borders
    jw, tw = _worlds(mask, spacing, origin)
    np.testing.assert_array_equal(tw.occupancy.numpy(), np.asarray(jw.occupancy))
    np.testing.assert_array_equal(tw.inside_depth.numpy(), np.asarray(jw.inside_depth))
    np.testing.assert_array_equal(tw.spacing.numpy(), np.asarray(jw.spacing))
    np.testing.assert_array_equal(tw.origin.numpy(), np.asarray(jw.origin))
    assert tw.dilation_vox == jw.dilation_vox


def test_sample_grid_and_its_derivative_match_jax(ball_worlds):
    """Trilinear values at 1e-6 and d(value)/d(index) at 1e-5 at random
    points, out of bounds, and on the exact borders 0 and n - 1 (where the
    clip's derivative splits the tie in half, as jnp.clip's does)."""
    jw, tw = ball_worlds
    rng = np.random.default_rng(2)
    n = np.asarray(jw.inside_depth.shape, np.float32)
    idx = rng.uniform(-2.0, n + 1.0, size=(400, 3)).astype(np.float32)
    idx[100:] = np.array([47.5, 35.0, 85.0], np.float32) + rng.uniform(-14.0, 14.0, size=(300, 3))  # the ball
    idx[:8] = [[0, 40, 50], [95, 40, 50], [30, 0, 47], [30, 95, 47], [30, 50, 0], [30, 50, 95], [0, 0, 0],
               [95, 95, 95]]
    idx[8:16] = rng.uniform(20.0, 70.0, size=(8, 3)).round()  # integer points inside
    want = np.asarray(jcoll.sample_grid(jw.inside_depth, jnp.asarray(idx)))
    got = tcoll.sample_grid(tw.inside_depth, torch.as_tensor(idx)).numpy()
    assert np.count_nonzero(want) > 50
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)

    j_grad = np.asarray(jax.jacfwd(lambda p: jnp.sum(jcoll.sample_grid(jw.inside_depth, p)))(jnp.asarray(idx)))
    t_grad = torch.func.jacfwd(lambda p: tcoll.sample_grid(tw.inside_depth, p).sum())(torch.as_tensor(idx))
    np.testing.assert_allclose(t_grad.numpy(), j_grad, rtol=1e-5, atol=1e-5)


def test_config_checks_match_jax(models, geometries, ball_worlds):
    jm, tm = models
    jg, tg = geometries
    jw, tw = ball_worlds
    rng = np.random.default_rng(4)
    lo, hi = np.asarray(jm.limits_rad[:, 0]) * 0.8, np.asarray(jm.limits_rad[:, 1]) * 0.8
    configs = rng.uniform(lo, hi, size=(12, 6)).astype(np.float32)
    hits = []
    for a in configs:
        ja = (jm, jg.part_points, jg.part_link_idx, jnp.asarray(a), jnp.eye(4), jw)
        ta = (tm, tg.part_points, tg.part_link_idx, torch.as_tensor(a), torch.eye(4), tw)
        hits.append(bool(jcoll.config_collides(*ja)))
        assert bool(tcoll.config_collides(*ta)) == hits[-1]
        np.testing.assert_allclose(float(tcoll.config_penetration(*ta)), float(jcoll.config_penetration(*ja)),
                                   rtol=1e-4, atol=1e-4)
    assert any(hits) and not all(hits)


def test_path_collision_flags_match_jax(models, geometries, ball_worlds):
    """A 101-sample up-over-down path from a pose clear of the body down
    into the zero pose, which runs into it: the same flags, some set and
    some clear."""
    jm, tm = models
    jg, tg = geometries
    jw, tw = ball_worlds
    start = np.array([1.2, 0.9, 0.3, 0.0, 0.2, 0.0], np.float32)
    goal = np.zeros(6, np.float32)
    j_path = JP.interpolate_path(JP.heuristic_keyframes(jnp.asarray(start), jnp.asarray(goal)))
    t_path = TP.interpolate_path(TP.heuristic_keyframes(torch.as_tensor(start), torch.as_tensor(goal)))
    want = np.asarray(JP.check_path_collisions(jm, jg, j_path, jnp.eye(4), jw))
    got = TP.check_path_collisions(tm, tg, t_path, torch.eye(4), tw).numpy()
    assert got.shape == (101,) and want.any() and not want.all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["lateral", "not-found", "at-border"])
def test_entry_point_matches_jax(case):
    """The same entry voxel and `found`, the same distance, normals within
    1e-5; the body at the border exercises the wrapping rolls."""
    if case == "lateral":
        mask, spacing, origin = _ball_mask([0.0, 0.0, 0.0], 40.0)
        target = np.array([10.0, 0.0, 0.0], np.float32)
    elif case == "not-found":
        mask, spacing, origin = _ball_mask([0.0, 0.0, 0.0], 20.0, shape=(96, 96, 96))
        target = np.array([90.0, 90.0, 90.0], np.float32)
    else:
        mask, spacing, origin = _ball_mask([-50.0, 20.0, -40.0], 30.0)
        target = np.array([-55.0, 25.0, -45.0], np.float32)
    want = JP.find_entry_point(jnp.asarray(mask), spacing, origin, jnp.asarray(target))
    got = TP.find_entry_point(torch.as_tensor(mask), spacing, origin, torch.as_tensor(target))
    assert bool(got.found) == bool(want.found) == (case != "not-found")
    np.testing.assert_array_equal(got.point_ras.numpy(), np.asarray(want.point_ras))
    np.testing.assert_array_equal(got.distance_mm.numpy(), np.asarray(want.distance_mm))
    np.testing.assert_allclose(got.normal_ras.numpy(), np.asarray(want.normal_ras), atol=1e-5)


def test_frames_keyframes_and_path_match_jax():
    rng = np.random.default_rng(6)
    cases = [([0.0, 0.0, 0.0], [30.0, 0.0, 0.0], 5.0), ([0.0, 0.0, -10.0], [0.0, 0.0, 40.0], 5.0),
             ([0.0, 0.3, -10.0], [0.1, 0.0, 40.0], 2.0)]  # the last two: the 0.99-parallel fallback
    cases += [(rng.normal(size=3) * 50, rng.normal(size=3) * 50, 10.0) for _ in range(3)]
    for target, entry, safety in cases:
        target, entry = np.asarray(target, np.float32), np.asarray(entry, np.float32)
        want = np.asarray(JP.needle_target_frame(jnp.asarray(target), jnp.asarray(entry), safety))
        got = TP.needle_target_frame(torch.as_tensor(target), torch.as_tensor(entry), safety).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6)
    for _ in range(3):
        start, goal = rng.uniform(-1.5, 1.5, size=(2, 6)).astype(np.float32)
        j_kf = JP.heuristic_keyframes(jnp.asarray(start), jnp.asarray(goal))
        t_kf = TP.heuristic_keyframes(torch.as_tensor(start), torch.as_tensor(goal))
        np.testing.assert_allclose(t_kf.numpy(), np.asarray(j_kf), atol=1e-6)
        for steps in (100, 40):
            np.testing.assert_allclose(TP.interpolate_path(t_kf, steps).numpy(),
                                       np.asarray(JP.interpolate_path(j_kf, steps)), atol=1e-6)


def test_analytic_seeds_match_jax(models):
    jm, tm = models
    for angles in ([0.4, -0.5, 0.7, 0.3, -0.6, 0.2], [-1.1, 0.3, 0.9, -0.8, 1.2, 2.0]):
        target, entry = _needle_goal(jm, angles)
        jtf = jtraj.needle_target_frame(jnp.asarray(target), jnp.asarray(entry), 5.0)
        want = np.asarray(jtraj.analytic_trajectory_seeds(jm, jtf, jnp.eye(4)))
        got = ttraj.analytic_trajectory_seeds(tm, torch.as_tensor(np.array(jtf)), torch.eye(4)).numpy()
        assert got.shape == want.shape == (32, 6)
        np.testing.assert_allclose(got, want, atol=1e-4)


def test_top_seeds_tie_order_matches_lax_top_k(models):
    """Equal costs keep the lower index first, as `lax.top_k` does: on
    synthetic costs with ties, and on the clipped seeds of an unreachable
    goal, where clipping to the joint limits makes several candidates one
    point with one cost."""
    rng = np.random.default_rng(9)
    for _ in range(20):
        costs = rng.integers(1, 6, size=32).astype(np.float32) * 0.25
        want = np.asarray(jax.lax.top_k(-jnp.asarray(costs), 4)[1])
        np.testing.assert_array_equal(ttraj.top_seeds(torch.as_tensor(costs), 4).numpy(), want)

    jm, tm = models
    target = np.array([109.56935, -184.17062, -367.2212], np.float32)  # below the base: out of reach
    entry = np.array([113.76536, -205.5974, -352.7574], np.float32)
    jtf = jtraj.needle_target_frame(jnp.asarray(target), jnp.asarray(entry), 5.0)
    lo, hi = jm.limits_rad[:, 0], jm.limits_rad[:, 1]
    cand = jnp.clip(jtraj.analytic_trajectory_seeds(jm, jtf, jnp.eye(4)), lo[None], hi[None])
    costs = jax.vmap(lambda x: jnp.sum(j_traj_res(jm, x, jnp.eye(4), jtf) ** 2))(cand)
    top = np.asarray(jax.lax.top_k(-costs, 4)[1])
    sorted_costs = np.sort(np.asarray(costs))
    assert sorted_costs[0] == sorted_costs[1] and sorted_costs[0] > ttraj.EXACT_SEED_COST  # a real tie
    np.testing.assert_array_equal(ttraj.top_seeds(torch.as_tensor(np.asarray(costs)), 4).numpy(), top)


@pytest.fixture(scope="module")
def jax_solves(models, geometries, ball_worlds):
    """The reference's three trajectory solves (host arrays)."""
    jm, _ = models
    jg, _ = geometries
    jw, _ = ball_worlds
    target, entry = _needle_goal(jm, [0.3, 0.4, -0.6, 0.1, 0.5, -0.2])
    lower, upper = jm.limits_rad[:, 0], jm.limits_rad[:, 1]
    draws = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (6, 6), minval=lower * 0.8, maxval=upper * 0.8))

    def solve(*args, **kw):
        return jax.device_get(JP.solve_trajectory_ik(jm, jg, *args, **kw))

    return {
        "strict_world": solve(jnp.asarray(BALL_TARGET), jnp.asarray(BALL_ENTRY), 5.0, jnp.eye(4), jw,
                              num_random_restarts=0),
        "default_world": solve(jnp.asarray(BALL_TARGET), jnp.asarray(BALL_ENTRY), 5.0, jnp.eye(4), jw),
        "unseeded": solve(jnp.asarray(target), jnp.asarray(entry), 5.0, jnp.eye(4), None, analytic_seeds=False),
        "goal": (target, entry),
        "draws": draws,
    }


def _same_outcome(got, want):
    assert bool(got.success) == bool(want.success)
    assert bool(got.collides) == bool(want.collides)
    assert abs(float(got.position_error_mm) - float(want.position_error_mm)) < 1e-2
    np.testing.assert_allclose(got.target_tf.numpy(), np.asarray(want.target_tf), atol=1e-5)


def _solves_reference_problem(jm, jg, jw, got, target_tf):
    """The port's goal is an answer of the reference's problem: JAX's
    residual puts the needle on the goal and JAX's contact check agrees."""
    res = np.asarray(j_traj_res(jm, jnp.asarray(got.angles.numpy()), jnp.eye(4), jnp.asarray(target_tf)))
    assert np.linalg.norm(res[:3]) < 1e-2
    assert abs(np.linalg.norm(res[3:]) - float(got.orientation_error)) < 1e-3
    if jw is not None:
        hit = jcoll.config_collides(jm, jg.part_points, jg.part_link_idx, jnp.asarray(got.angles.numpy()),
                                    jnp.eye(4), jw)
        assert bool(hit) == bool(got.collides)


def test_trajectory_ik_strict_search_matches_jax(models, geometries, ball_worlds, jax_solves):
    """{current, zeros} from the zero pose (one point twice, a unique
    answer), 100 iterations, the arm in contact with the body all along
    (the penetration term in the LM residual, through `jacfwd` of
    `sample_grid`): the same angles."""
    _, tm = models
    _, tg = geometries
    _, tw = ball_worlds
    want = jax_solves["strict_world"]
    got = TP.solve_trajectory_ik(tm, tg, torch.as_tensor(BALL_TARGET), torch.as_tensor(BALL_ENTRY), 5.0,
                                 torch.eye(4), tw, num_random_restarts=0)
    assert bool(want.collides) and float(tcoll.config_penetration(
        tm, tg.part_points, tg.part_link_idx, got.angles, torch.eye(4), tw)) > 0.1
    _same_outcome(got, want)
    np.testing.assert_allclose(got.angles.numpy(), np.asarray(want.angles), atol=1e-3)


def test_trajectory_ik_analytic_seeds_with_body(models, geometries, ball_worlds, jax_solves):
    jm, tm = models
    jg, tg = geometries
    jw, tw = ball_worlds
    want = jax_solves["default_world"]
    got = TP.solve_trajectory_ik(tm, tg, torch.as_tensor(BALL_TARGET), torch.as_tensor(BALL_ENTRY), 5.0,
                                 torch.eye(4), tw)
    assert bool(got.success) and not bool(got.collides)
    _same_outcome(got, want)
    _solves_reference_problem(jm, jg, jw, got, want.target_tf)


def test_trajectory_ik_unseeded_with_jax_restart_draws(models, geometries, jax_solves):
    """{current, zeros, 6 random} x 100 iterations, the port given JAX's
    uniform draws through `restart_guesses`."""
    jm, tm = models
    jg, tg = geometries
    want = jax_solves["unseeded"]
    target, entry = jax_solves["goal"]
    got = TP.solve_trajectory_ik(tm, tg, torch.as_tensor(target), torch.as_tensor(entry), 5.0, torch.eye(4), None,
                                 analytic_seeds=False, restart_guesses=torch.as_tensor(jax_solves["draws"]))
    assert bool(got.success) and float(got.position_error_mm) < 1e-2
    _same_outcome(got, want)
    _solves_reference_problem(jm, jg, None, got, want.target_tf)


def test_trajectory_ik_resolves_ties_in_a_fixed_order(models):
    """A 1e-4 mm change of the target moves every exact answer by rounding
    only: the port keeps its pick (an exact seed, which stays where it
    starts) to 1e-4 rad, where the reference's may jump between branches
    ~pi apart."""
    _, tm = models
    picks = [
        TP.solve_trajectory_ik(tm, None, torch.as_tensor(BALL_TARGET + eps), torch.as_tensor(BALL_ENTRY), 5.0,
                               torch.eye(4), None).angles.numpy()
        for eps in (0.0, 1e-4, -1e-4)
    ]
    assert max(np.abs(p - picks[0]).max() for p in picks) < 1e-4


@pytest.mark.parametrize("from_stl", [False, True], ids=["capsules", "stl"])
def test_arm_geometry_bit_equal(models, tmp_path, monkeypatch, from_stl):
    """The part clouds bit-equal, from capsules and from an STL written with
    `save_stl` (Joint2's collision hull; Joint3 falls back to its visual
    mesh). The JAX side reads the file with its numpy parser, which gives
    the native parser's floats, so the test starts no `g++` build."""
    jm, tm = models
    mesh_dir = None
    if from_stl:
        from mamri_tpu import native

        monkeypatch.setattr(native, "parse_stl_native", lambda path: None)
        rng = np.random.default_rng(12)
        for link, kind in (("Joint2", "collision_mesh"), ("Joint3", "visual_mesh")):
            name = getattr(tm.spec(link), kind)
            assert name, (link, kind)
            tris = rng.normal(size=(40, 3, 3)).astype(np.float32) * 20.0
            tstl.save_stl(str(tmp_path / name), tris)
        mesh_dir = str(tmp_path)
    want = JP.build_arm_geometry(jm, mesh_dir, points_per_part=256)
    got = TP.build_arm_geometry(tm, mesh_dir, points_per_part=256)
    assert got.part_link_idx == want.part_link_idx and got.part_names == want.part_names
    np.testing.assert_array_equal(got.part_points.numpy(), np.asarray(want.part_points))
    if from_stl:
        capsules = TP.build_arm_geometry(tm, None, points_per_part=256).part_points.numpy()
        assert not np.array_equal(got.part_points.numpy()[1:3], capsules[1:3])


def _cube_mask(shape, spacing, origin, center_lps, half):
    """tests/test_planning_exact.py's cube body."""
    gi, gj, gk = np.mgrid[: shape[0], : shape[1], : shape[2]]
    lx, ly, lz = (origin[a] + spacing[a] * g for a, g in enumerate((gi, gj, gk)))
    return (np.abs(lx - center_lps[0]) < half) & (np.abs(ly - center_lps[1]) < half) & (np.abs(lz - center_lps[2]) < half)


def _clear_of_half_voxel(model, parts, configs, base, mask, spacing, origin, margin=1e-4):
    """No dense point within `margin` voxel of a rounding edge of `np.round`
    has its two candidate voxels on either side of the body's border, where
    an FK difference of ~1e-5 mm between the packages could flip a hit."""
    from mamri_tpu.core.robot import fk_all_links_host

    shape = np.asarray(mask.shape)
    for a in configs:
        tfs = fk_all_links_host(model, a, base)
        for cloud, li in zip(parts.clouds, parts.link_idx):
            lps = (cloud.astype(np.float64) @ tfs[li][:3, :3].T + tfs[li][:3, 3]) * np.array([-1.0, -1.0, 1.0])
            f = (lps - origin) / spacing
            edge = np.abs(f % 1.0 - 0.5) < margin
            for axis in range(3):
                lo = np.floor(f[edge[:, axis]]).astype(np.int64)
                hi = lo.copy()
                hi[:, axis] += 1
                inside = [np.where(np.all((v >= 0) & (v < shape), axis=1), 0, -1) for v in (lo, hi)]
                for v, ok in zip((lo, hi), inside):
                    v[ok < 0] = 0
                hit_lo = (inside[0] == 0) & mask[lo[:, 0], lo[:, 1], lo[:, 2]]
                hit_hi = (inside[1] == 0) & mask[hi[:, 0], hi[:, 1], hi[:, 2]]
                if np.any(hit_lo != hit_hi):
                    return False
    return True


def test_validate_path_exact_matches_jax(models):
    """The reference's dicts on test_planning_exact.py's scenes: a cube on
    the arm and 500 mm away, and 24 random configurations beside a cube.
    The scenes are checked clear of the half-voxel edge of `np.round`."""
    jm, tm = models
    jparts, tparts = jexact.build_exact_parts(jm, capsule_points=4000), texact.build_exact_parts(tm, capsule_points=4000)
    for a, b in zip(tparts.clouds, jparts.clouds):
        np.testing.assert_array_equal(a, b)
    assert (tparts.link_idx, tparts.names, tparts.mode) == (jparts.link_idx, jparts.names, jparts.mode)

    spacing = np.full(3, 3.0, dtype=np.float32)
    rng = np.random.default_rng(3)
    lo, hi = np.asarray(jm.limits_rad[:, 0]) * 0.8, np.asarray(jm.limits_rad[:, 1]) * 0.8
    far = np.eye(4, dtype=np.float32)
    far[0, 3] = 500.0
    scenes = [
        ((64, 64, 64), np.array([-96.0, -96.0, 100.0], np.float32), (0.0, 0.0, 200.0), 30.0, base, np.zeros((1, 6)))
        for base in (np.eye(4, dtype=np.float32), far)
    ]
    scenes.append(((48, 48, 48), np.array([-72.0, -72.0, 60.0], np.float32), (-60.0, 0.0, 160.0), 40.0,
                   np.eye(4, dtype=np.float32), rng.uniform(lo, hi, size=(24, 6)).astype(np.float32)))
    outcomes = []
    for shape, origin, center, half, base, path in scenes:
        mask = _cube_mask(shape, spacing, origin, center, half)
        assert _clear_of_half_voxel(jm, jparts, path, base, mask, spacing, origin)
        want = jexact.validate_path_exact(jm, jparts, mask, spacing, origin, base, path)
        got = texact.validate_path_exact(tm, tparts, mask, spacing, origin, base, path)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
        outcomes.append(want["collision_free"])
    assert outcomes[:2] == [False, True]


def test_densify_triangles_matches_jax():
    tris = np.random.default_rng(1).normal(size=(6, 3, 3)).astype(np.float32) * 4.0
    np.testing.assert_array_equal(texact.densify_triangles(tris, 1.0), jexact.densify_triangles(tris, 1.0))


def test_stl_copy_matches_the_original(tmp_path):
    """`mamri_tpu_torch/utils/stl.py` is `mamri_tpu/utils/stl.py` with the
    package renamed, the native parser's fast path included: nothing else may
    drift. It reads what it writes, through the native parser where it is
    built and through the Python one, to the same triangles."""
    original = open(os.path.join(REPO, "mamri_tpu", "utils", "stl.py")).read()
    copy = open(os.path.join(REPO, "mamri_tpu_torch", "utils", "stl.py")).read()
    assert copy == original.replace("mamri_tpu", "mamri_tpu_torch")
    tris = np.random.default_rng(0).normal(size=(7, 3, 3)).astype(np.float32)
    tstl.save_stl(str(tmp_path / "t.stl"), tris)
    np.testing.assert_array_equal(tstl.load_stl(str(tmp_path / "t.stl")), tris)
    from mamri_tpu_torch import native

    fast = native.parse_stl_native(str(tmp_path / "t.stl"))
    assert fast is None or np.array_equal(fast, tris)

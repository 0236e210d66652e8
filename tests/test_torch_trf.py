"""The port's SciPy-TRF oracle (`mamri_tpu_torch.ik.trf`) and its helpers
against mamri_tpu's, on the CPU.

- `symmetry_twin`, `wrist_twin` and `ik_branch_family` on seeded angles
  (with +-pi wraps) within 1e-6 rad of the reference's;
  `rasterized_sphere_centroids` bit-equal.
- The Jacobian handed to SciPy (`torch.func.jacfwd` of the port's
  residuals) within 1e-4 of `jax.jacfwd`'s, relative to its largest entry.
- `solve_full_chain_trf` on the two poses of tests/test_ik_trf_oracle.py,
  exact and voxel-quantized, from the same inputs and three guesses each:
  every per-guess solution within 5e-4 rad, every per-guess cost within
  1e-4 relative + 1e-8, the same winning guess wherever the two lowest
  costs differ by more than 1e-3. `solve_trajectory_trf` within 1e-3 rad.
  The residual runs in float32 in both packages and SciPy in float64, so a
  solution moves by float32's rounding of the residual (2.1e-4 rad seen).
- The three claims of tests/test_ik_trf_oracle.py restated on the port
  alone (its FK, quantization, Kabsch, LM and TRF).

The JAX references are computed once per module.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mamri_tpu.core.robot import load_robot_model as j_load_robot_model
from mamri_tpu.ik import residuals as jres
from mamri_tpu.ik import trf as jtrf
from mamri_tpu.perception.volume import rasterized_sphere_centroids as j_rasterized
from mamri_tpu_torch.core.robot import fk_all_links, load_robot_model, marker_world_positions
from mamri_tpu_torch.ik import residuals as tres
from mamri_tpu_torch.ik import trf as ttrf
from mamri_tpu_torch.perception.volume import rasterized_sphere_centroids
from mamri_tpu_torch.registration.kabsch import kabsch_rigid_transform
from test_ik_trf_oracle import _POSES, ORIGIN, SPACING, _base
from test_ik_trf_oracle import _scene as _jax_scene
from test_torch_engine import _one_torch_thread  # noqa: F401 (autouse)

pytest.importorskip("scipy")

ENGINE_IK_ITERS = 24  # MamriEngine's defaults
ENGINE_IK_RESTARTS = 2
CASES = [(p, q) for p in range(len(_POSES)) for q in (False, True)]
CASE_IDS = [f"{name}-{'quantized' if q else 'exact'}" for name in ("bench0", "random") for q in (False, True)]


@pytest.fixture(scope="module")
def models():
    return j_load_robot_model(), load_robot_model(device="cpu")


def _extra_guess(pose, quantized):
    """The third guess: the truth for quantized markers (TRF from the truth),
    the truth + 0.05 rad for exact ones (tests/test_ik_trf_oracle.py's)."""
    truth = np.asarray(_POSES[pose], dtype=np.float64)
    return truth if quantized else truth + 0.05


@pytest.fixture(scope="module")
def jax_trf(models):
    """{case: (inputs, the reference's TRFResult)} for every pose x quantization."""
    jm, _ = models
    out = {}
    for pose, quantized in CASES:
        base_est, j6, j4, _ = _jax_scene(jm, _POSES[pose], _base(), quantize=quantized)
        res = jtrf.solve_full_chain_trf(
            jm, j6, base_est, joint4_targets=j4, joint4_found=True,
            extra_guesses=[_extra_guess(pose, quantized)],
        )
        out[(pose, quantized)] = ((base_est, j6, j4), res)
    return out


def _angles(seed, n=64):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-np.pi, np.pi, size=(n, 6)).astype(np.float32)
    # rows whose J1 / J4 + pi wrap past +pi, land on it, or stay just inside
    a[0, [0, 3]] = np.float32(np.pi)
    a[1, [0, 3]] = np.float32(-np.pi)
    a[2, [0, 3]] = np.float32(1e-4)
    a[3, [0, 3]] = np.float32(-1e-4)
    a[4, [0, 3, 5]] = np.float32(np.pi - 1e-3)
    a[5, [0, 3, 5]] = np.float32(-np.pi + 1e-3)
    return a


@pytest.mark.parametrize("name", ["symmetry_twin", "wrist_twin", "ik_branch_family"])
def test_symmetry_helpers_match_reference(name):
    for row in _angles(5):
        got = getattr(tres, name)(torch.from_numpy(row)).numpy()
        want = np.asarray(getattr(jres, name)(jnp.asarray(row)))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_symmetry_twins_preserve_joint6_markers(models):
    """The port's family reaches the same Joint6 markers (the reference's
    claim, checked on the port's FK)."""
    _, tm = models
    base = torch.tensor(_base())
    for row in _angles(6, n=6):
        a = torch.from_numpy(row)
        want = marker_world_positions(tm, a, "Joint6", base)
        for member in tres.ik_branch_family(a):
            np.testing.assert_allclose(marker_world_positions(tm, member, "Joint6", base).numpy(),
                                       want.numpy(), atol=2e-3)


def test_rasterized_sphere_centroids_bit_equal():
    rng = np.random.default_rng(9)
    pts = rng.uniform(-150.0, 150.0, size=(12, 3))
    for radius, spacing in ((4.0, SPACING), (3.0, np.array([1.7, 2.3, 2.9], np.float32))):
        got = rasterized_sphere_centroids(pts, radius, spacing, ORIGIN)
        np.testing.assert_array_equal(got, j_rasterized(pts, radius, spacing, ORIGIN))


@pytest.mark.parametrize("residual", ["full_chain", "trajectory"])
def test_jacobian_matches_jax(models, residual):
    jm, tm = models
    rng = np.random.default_rng(3)
    base = np.array(_base())
    j6 = rng.uniform(-200, 200, size=(3, 3)).astype(np.float32)
    j4 = rng.uniform(-200, 200, size=(3, 3)).astype(np.float32)
    target = np.eye(4, dtype=np.float32)
    target[:3, 3] = [40.0, -80.0, 250.0]
    t = torch.from_numpy
    if residual == "full_chain":
        want_fn = jax.jit(jax.jacfwd(lambda x: jres.full_chain_residual(
            jm, x, jnp.asarray(base), jnp.asarray(j6), False, jnp.asarray(j4), True)))
        got_fn = torch.func.jacfwd(lambda x: tres.full_chain_residual(
            tm, x, t(base), t(j6), torch.tensor(False), t(j4), torch.tensor(True)))
    else:
        want_fn = jax.jit(jax.jacfwd(lambda x: jres.trajectory_pose_residual(
            jm, x, jnp.asarray(base), jnp.asarray(target))))
        got_fn = torch.func.jacfwd(lambda x: tres.trajectory_pose_residual(tm, x, t(base), t(target)))
    for row in _angles(4, n=8):
        got, want = got_fn(t(row)), want_fn(jnp.asarray(row))
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_full_chain_trf_matches_reference(models, jax_trf, case):
    _, tm = models
    (base_est, j6, j4), want = jax_trf[case]
    got = ttrf.solve_full_chain_trf(
        tm, j6, base_est, joint4_targets=j4, joint4_found=True, extra_guesses=[_extra_guess(*case)],
    )
    assert got.per_guess.shape == want.per_guess.shape == (3, 6)
    np.testing.assert_allclose(got.per_guess, want.per_guess, rtol=0, atol=5e-4)
    np.testing.assert_allclose(got.per_guess_cost, want.per_guess_cost, rtol=1e-4, atol=1e-8)
    lowest = np.sort(want.per_guess_cost)
    if lowest[1] - lowest[0] > 1e-3:
        assert got.best_guess == want.best_guess
    np.testing.assert_allclose(got.angles, got.per_guess[got.best_guess])
    assert abs(got.cost - got.per_guess_cost[got.best_guess]) == 0
    assert abs(got.rmse - want.rmse) <= 1e-4 * want.rmse + 1e-5
    assert got.nfev > 0


def test_trajectory_trf_matches_reference(models):
    """tests/test_ik_trf_oracle.py's trajectory case on both packages."""
    jm, tm = models
    true_angles = np.array([0.4, 0.3, -0.5, 0.2, 0.6, -0.3], np.float32)
    base = np.eye(4, dtype=np.float32)
    needle = fk_all_links(tm, torch.from_numpy(true_angles), torch.from_numpy(base))[tm.link_index("Needle")].numpy()
    target = needle.copy()
    target[:3, 0] = -needle[:3, 0]  # the target's x is the needle's direction (its frame's -X)
    want = jtrf.solve_trajectory_trf(jm, target, base, current_angles=true_angles + 0.3)
    got = ttrf.solve_trajectory_trf(tm, target, base, current_angles=true_angles + 0.3)
    np.testing.assert_allclose(got.per_guess, want.per_guess, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.per_guess_cost, want.per_guess_cost, rtol=1e-4, atol=1e-8)
    # both guesses reach the pose (costs at float32's floor): the pick among
    # tied guesses is rounding, so the winner is held only past a tie
    lowest = np.sort(want.per_guess_cost)
    if lowest[1] - lowest[0] > 1e-3:
        assert got.best_guess == want.best_guess
    np.testing.assert_allclose(got.angles, want.per_guess[got.best_guess], rtol=0, atol=1e-3)
    assert got.rmse < 1.0, got.rmse


# ------------------------------ tests/test_ik_trf_oracle.py's claims on the port
def _port_scene(tm, true_angles, quantize):
    """(base_est, j6, j4, j2) from the port's FK, quantization and Kabsch."""
    base = torch.tensor(_base())
    a = torch.from_numpy(true_angles)
    pts = {ln: marker_world_positions(tm, a, ln, base).numpy() for ln in ("Baseplate", "Joint2", "Joint4", "Joint6")}
    if quantize:
        pts = {ln: rasterized_sphere_centroids(p, 4.0, SPACING, ORIGIN) for ln, p in pts.items()}
    bp = pts["Baseplate"].astype(np.float32)
    bp[:, 1] = bp[:, 1].mean()
    base_est = kabsch_rigid_transform(tm.marker_local[tm.link_index("Baseplate")], torch.from_numpy(bp)).numpy()
    return (base_est,) + tuple(pts[ln].astype(np.float32) for ln in ("Joint6", "Joint4", "Joint2"))


def _port_lm(tm, base_est, j6, j4, j2):
    t, found = torch.from_numpy, torch.tensor(True)
    return tres.solve_full_chain_ik(
        tm, t(j6), t(base_est), joint4_targets=t(j4), joint4_found=found, joint2_targets=t(j2),
        joint2_found=found, num_iters=ENGINE_IK_ITERS, num_random_restarts=ENGINE_IK_RESTARTS,
    )


@pytest.mark.parametrize("true_angles", _POSES, ids=["bench0", "random"])
def test_port_exact_markers_both_solvers_recover_truth(models, true_angles):
    _, tm = models
    base_est, j6, j4, j2 = _port_scene(tm, true_angles, quantize=False)
    lm = _port_lm(tm, base_est, j6, j4, j2)
    trf = ttrf.solve_full_chain_trf(tm, j6, base_est, joint4_targets=j4, joint4_found=True,
                                    extra_guesses=[np.asarray(true_angles) + 0.05])
    assert np.degrees(np.abs(lm.angles.numpy() - true_angles)).max() < 0.1
    assert np.degrees(np.abs(trf.angles - true_angles)).max() < 0.1


@pytest.mark.parametrize("true_angles", _POSES, ids=["bench0", "random"])
def test_port_quantized_lm_matches_trf_from_truth(models, true_angles):
    _, tm = models
    base_est, j6, j4, j2 = _port_scene(tm, true_angles, quantize=True)
    lm = _port_lm(tm, base_est, j6, j4, j2)
    trf_truth = ttrf.solve_full_chain_trf(tm, j6, base_est, joint4_targets=j4, joint4_found=True,
                                          extra_guesses=[np.asarray(true_angles)])
    diff_deg = np.degrees(np.abs(lm.angles.numpy() - trf_truth.angles)).max()
    assert diff_deg < 0.05, (diff_deg, lm.angles, trf_truth.angles)
    assert float(lm.cost) <= trf_truth.cost * 1.001 + 1e-9


def test_port_lm_cost_never_worse_than_reference_guess_trf(models):
    _, tm = models
    base_est, j6, j4, j2 = _port_scene(tm, _POSES[0], quantize=True)
    lm = _port_lm(tm, base_est, j6, j4, j2)
    trf_ref = ttrf.solve_full_chain_trf(tm, j6, base_est, joint4_targets=j4, joint4_found=True)
    assert float(lm.cost) <= trf_ref.cost * 1.001 + 1e-9, (float(lm.cost), trf_ref.cost)

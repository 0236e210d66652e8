"""The port's core (transforms, robot, units) and Volume against mamri_tpu.

Inputs are made with numpy from a seed and handed to both packages.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mamri_tpu.core import robot as jrobot
from mamri_tpu.core import transforms as jT
from mamri_tpu.core.units import angles_to_steps as j_angles_to_steps
from mamri_tpu.perception import volume as jvolume
from mamri_tpu_torch.core import robot as trobot
from mamri_tpu_torch.core import transforms as tT
from mamri_tpu_torch.core.units import angles_to_steps as t_angles_to_steps
from mamri_tpu_torch.perception import volume as tvolume
from test_torch_engine import _one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def models():
    return jrobot.load_robot_model(), trobot.load_robot_model(device="cpu")


def test_robot_model_defaults_to_the_card():
    """Without a `device` the model is built on the card, or refused where
    there is none; the CPU is used only when asked for."""
    if torch.cuda.is_available():
        assert trobot.load_robot_model().fixed_offsets.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            trobot.load_robot_model()
        with pytest.raises(RuntimeError, match="cuda"):
            trobot.robot_model_from_numpy(*[np.zeros(1)] * 6, specs=())
    model = trobot.load_robot_model(device="cpu")
    assert model.fixed_offsets.device.type == "cpu"
    heights = trobot.fk_all_links(model, torch.zeros(6))[:, 2, 3].tolist()
    assert heights == [0.0, 20.0, 50.0, 200.0, 200.0, 355.0, 368.0, 439.0]


def test_zero_pose_link_heights(models):
    _, model = models
    tfs = trobot.fk_all_links(model, torch.zeros(6))
    assert tfs[:, 2, 3].tolist() == [0.0, 20.0, 50.0, 200.0, 200.0, 355.0, 368.0, 439.0]


@pytest.mark.parametrize("batch", [None, "angles", "angles_and_base"])
def test_fk_matches_jax_for_random_angles(models, batch):
    """Pose by pose; or (G, J) angles in one call, from one base or from a
    (G, 4, 4) batch of them, against the reference's FK row by row."""
    jm, tm = models
    rng = np.random.default_rng(0)
    limits = np.asarray(jm.limits_rad)
    base = (
        np.asarray(jT.translate(jnp.asarray([-60.0, -120.0, 5.0])) @ jT.rot_x(-np.pi / 2) @ jT.rot_z(0.3))
    ).astype(np.float32)
    angles = rng.uniform(limits[:, 0], limits[:, 1], (8, len(limits))).astype(np.float32)
    bases = np.stack([base] * 8)
    if batch == "angles_and_base":
        bases = np.stack([np.asarray(jT.rot_z(0.2 * g) @ jnp.asarray(base)) for g in range(8)]).astype(np.float32)
    want = np.stack([np.asarray(jrobot.fk_all_links(jm, jnp.asarray(a), jnp.asarray(b)))
                     for a, b in zip(angles, bases)])
    if batch is not None:
        got_base = bases if batch == "angles_and_base" else base
        got = trobot.fk_all_links(tm, torch.as_tensor(angles), torch.as_tensor(got_base))
        assert got.shape == want.shape == (8, tm.num_links, 4, 4)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4)  # mm and unitless rotation entries
        return
    for a, w in zip(angles, want):
        got = trobot.fk_all_links(tm, torch.as_tensor(a), torch.as_tensor(base)).numpy()
        np.testing.assert_allclose(got, w, atol=1e-4)
        for ln in ("Baseplate", "Joint2", "Joint4", "Joint6"):
            want_m = np.asarray(jrobot.marker_world_positions(jm, jnp.asarray(a), ln, jnp.asarray(base)))
            got_m = trobot.marker_world_positions(tm, torch.as_tensor(a), ln, torch.as_tensor(base)).numpy()
            np.testing.assert_allclose(got_m, want_m, atol=1e-4)


def test_transforms_match_jax():
    rng = np.random.default_rng(1)
    thetas = rng.uniform(-np.pi, np.pi, 5).astype(np.float32)
    for jf, tf in ((jT.rot_x, tT.rot_x), (jT.rot_y, tT.rot_y), (jT.rot_z, tT.rot_z)):
        np.testing.assert_allclose(tf(torch.as_tensor(thetas)).numpy(), np.asarray(jf(jnp.asarray(thetas))), atol=1e-6)
    v = rng.normal(size=(4, 3)).astype(np.float32) * 100
    np.testing.assert_array_equal(tT.translate(torch.as_tensor(v)).numpy(), np.asarray(jT.translate(jnp.asarray(v))))
    for code in (tT.AXIS_NONE, tT.AXIS_IS, tT.AXIS_PA, tT.AXIS_LR):
        np.testing.assert_allclose(
            tT.articulation_matrix(code, torch.tensor(0.7)).numpy(),
            np.asarray(jT.articulation_matrix(code, jnp.float32(0.7))), atol=1e-6,
        )


def test_robot_model_from_numpy_equals_loaded(models):
    jm, tm = models
    crossed = trobot.robot_model_from_numpy(
        np.asarray(jm.fixed_offsets), np.asarray(jm.limits_rad), np.asarray(jm.steps_per_rev),
        np.asarray(jm.marker_local), np.asarray(jm.needle_tip), np.asarray(jm.needle_axis), jm.specs,
        device="cpu",
    )
    for name in ("fixed_offsets", "limits_rad", "steps_per_rev", "marker_local", "needle_tip", "needle_axis"):
        assert torch.equal(getattr(crossed, name), getattr(tm, name)), name
    assert crossed.specs == tm.specs
    assert tm.link_names == jm.link_names and tm.articulated_links == jm.articulated_links


def test_angles_to_steps_bit_equal(models):
    jm, tm = models
    rng = np.random.default_rng(2)
    a = rng.uniform(-4.0, 4.0, (512, 6)).astype(np.float32)
    a[:6] = 0.0
    a[6, 0] = 2 * np.pi / 3332 * 7  # near an exact step boundary
    want = np.asarray(j_angles_to_steps(jnp.asarray(a), jm.steps_per_rev))
    got = t_angles_to_steps(torch.as_tensor(a), tm.steps_per_rev)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("noise", [0.0, 7.5])
def test_synthetic_volume_bit_equal(noise):
    kw = dict(
        shape=(23, 17, 30), spacing=(1.5, 2.0, 1.25), fiducials_ras=np.array([[3.0, -2.0, 4.0], [-8.0, 5.0, -6.0]]),
        fiducial_radius_mm=4.0, body_center_ras=[1.0, 2.0, -3.0], body_radii_mm=[9.0, 7.0, 11.0],
        noise_sigma=noise, seed=3,
    )
    want = jvolume.synthetic_volume(**kw)
    got = tvolume.synthetic_volume(**kw)
    assert got.data.dtype == want.data.dtype
    np.testing.assert_array_equal(got.data, want.data)
    np.testing.assert_array_equal(got.spacing, want.spacing)
    np.testing.assert_array_equal(got.origin, want.origin)


def test_volume_keeps_compact_dtypes():
    data = np.arange(24, dtype=">i2").reshape(2, 3, 4)
    v = tvolume.Volume(data, (1, 1, 1), (0, 0, 0))
    assert v.data.dtype == np.dtype("int16") and v.shape == (2, 3, 4)
    assert tvolume.Volume(data.astype(np.float64), (1, 1, 1), (0, 0, 0)).data.dtype == np.float32


def test_host_conversions_bit_equal(models):
    """The host twins of the step conversions and the torch
    `steps_to_angles` against mamri_tpu's."""
    from mamri_tpu.core import units as junits
    from mamri_tpu_torch.core import units as tunits

    jm, tm = models
    rng = np.random.default_rng(7)
    a = rng.uniform(-4.0, 4.0, (256, 6)).astype(np.float32)
    steps = rng.integers(-5000, 5000, (256, 6)).astype(np.int32)
    spr = np.asarray(jm.steps_per_rev)
    np.testing.assert_array_equal(tunits.angles_to_steps_host(a, spr), junits.angles_to_steps_host(a, spr))
    np.testing.assert_array_equal(tunits.steps_to_angles_host(steps, spr), junits.steps_to_angles_host(steps, spr))
    got = tunits.steps_to_angles(torch.as_tensor(steps), tm.steps_per_rev)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(junits.steps_to_angles(jnp.asarray(steps), jm.steps_per_rev)))


def test_host_fk_matches_jax(models):
    """`fk_all_links_host` (float64 numpy) against mamri_tpu's twin, and
    within 1e-3 mm of the port's device FK."""
    jm, tm = models
    rng = np.random.default_rng(8)
    limits = np.asarray(jm.limits_rad)
    base = np.asarray(jT.translate(jnp.asarray([-60.0, -120.0, 5.0])) @ jT.rot_x(-np.pi / 2)).astype(np.float32)
    for _ in range(6):
        a = rng.uniform(limits[:, 0], limits[:, 1]).astype(np.float32)
        got = trobot.fk_all_links_host(tm, a, base)
        assert got.dtype == np.float64
        np.testing.assert_allclose(got, jrobot.fk_all_links_host(jm, a, base), rtol=0, atol=1e-9)
        device = trobot.fk_all_links(tm, torch.as_tensor(a), torch.as_tensor(base)).numpy()
        np.testing.assert_allclose(got, device, atol=1e-3)
    with pytest.raises(ValueError):
        trobot.fk_all_links_host(tm, np.zeros(5))

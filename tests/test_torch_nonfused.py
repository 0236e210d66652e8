"""The non-fused segmentation branch (closing_radius != 2) against mamri_tpu.

JAX runs the branch on the CPU with its Pallas kernels in interpret mode
(`use_pallas=True`) or its jnp path (`use_pallas=False`). Exact: closing
masks, labels, body mask, blob validity, volumes, component counts, roots,
counts, coordinate sums (all below 2^24 here) and every certificate;
centroids within 1e-4 mm (f32 arithmetic in another order). Stats rows whose
root is the sentinel are the port's zeros and are not compared (the
reference counts background there; every caller masks them).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mamri_tpu.perception import segmentation as jseg
from mamri_tpu.perception.volume import synthetic_volume
from mamri_tpu_torch import _build
from mamri_tpu_torch.perception import segmentation as tseg
from test_torch_engine import _one_torch_thread  # noqa: F401 (autouse)

FIDUCIALS = np.array([[6.0, 4.0, 5.0], [-9.0, 3.0, 1.0], [2.0, -12.0, -8.0], [-4.0, -5.0, 12.0]])
CERTS = ("ccl_converged", "roots_complete", "blobs_complete", "count_ok", "cand_ok", "runs_ok", "compact_ok")
BIG = 2**31 - 1


def _volume(shape, seed):
    vol = synthetic_volume(
        shape=shape, spacing=(1.0, 1.0, 1.0), fiducials_ras=FIDUCIALS, fiducial_radius_mm=3.0,
        body_center_ras=[13.0, 14.0, -12.0], body_radii_mm=[8.0, 7.0, 9.0], noise_sigma=12.0, seed=seed,
    )
    data = np.array(vol.data)
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, np.array(shape)[None, :], size=(12, 3))
    data[idx[:, 0], idx[:, 1], idx[:, 2]] = 100.0  # lone speckles: extra tiny components
    return data, vol.spacing, vol.origin


@pytest.mark.parametrize("radius", [0, 1, 2, 3])
def test_binary_close_matches_jax(radius):
    rng = np.random.default_rng(radius)
    x, y, z = np.mgrid[:20, :18, :22]
    mask = (((x - 9) ** 2 + (y - 8) ** 2 + (z - 12) ** 2) < 30) & (rng.random(x.shape) > 0.15)
    mask |= rng.random(x.shape) < 0.04
    mask[0, :, 3:9] = True  # touches the border: the safe-border rule
    want = np.asarray(jseg.binary_close(jnp.asarray(mask), radius))
    got = tseg.binary_close(torch.as_tensor(mask), radius)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("radius", [0, 1, 3])
@pytest.mark.parametrize("shape", [(48, 48, 48), (80, 48, 48)])
def test_nonfused_segment_volume_matches_jax_kernels(shape, radius):
    data, spacing, origin = _volume(shape, seed=shape[0] + radius)
    kw = dict(closing_radius=radius, max_sweeps=2, passes=3, max_roots=128)
    jres = jseg.segment_volume(jnp.asarray(data), spacing, origin, jseg.SegmentationParams(use_pallas=True, **kw))
    _build.reset_launch_counts()
    tres = tseg.segment_volume(torch.as_tensor(data), spacing, origin, tseg.SegmentationParams(**kw))
    for name in CERTS + ("body_found",):
        assert bool(getattr(tres, name)) == bool(getattr(jres, name)), name
    for name in ("num_components", "num_blobs"):
        assert int(getattr(tres, name)) == int(getattr(jres, name)), name
    for name in ("labels", "body_mask", "blob_valid", "volumes_mm3", "body_volume_mm3"):
        np.testing.assert_array_equal(getattr(tres, name).numpy(), np.asarray(getattr(jres, name)), err_msg=name)
    np.testing.assert_allclose(tres.centroids_ras.numpy(), np.asarray(jres.centroids_ras), atol=1e-4)
    assert int(tres.num_blobs) >= 4
    assert all(v == 0 for v in _build.LAUNCHES.values())  # CPU tensors run the twins


def _overflowing_labels():
    """(128, 128, 64) = 2^20 voxels: a blob, plus 96 lone voxels in the
    first 512 flat positions (x = 0, y < 8): one top-k block of the 2048
    holds more than its 64 roots, while the volume holds <= 128."""
    shape = (128, 128, 64)
    x, y, z = np.mgrid[: shape[0], : shape[1], : shape[2]]
    mask = ((x - 60) ** 2 + (y - 70) ** 2 + (z - 30) ** 2) < 100
    for line in (0, 2, 4):
        mask[0, line, ::2] = True
    labels, _ = jseg._ccl_sweeps_jnp(jseg._init_labels(jnp.asarray(mask)), jnp.asarray(~mask), 4)
    return mask, labels


@pytest.mark.parametrize("exhaustive", [False, True])
def test_component_stats_blocked_and_exhaustive_match_jax(exhaustive):
    mask, jlab = _overflowing_labels()
    want = jseg._component_stats(jlab, jnp.asarray(mask), 128, use_pallas=False, exhaustive=exhaustive)
    got = tseg._component_stats(torch.as_tensor(np.asarray(jlab)), 128, exhaustive=exhaustive)
    roots = got[0].numpy()
    np.testing.assert_array_equal(roots, np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    valid = roots != BIG
    assert valid.sum() == (97 if exhaustive else 64 + 1)  # the overflowing block keeps its 64 smallest
    for g, w in ((got[2], want[2]), (got[3], want[3])):
        np.testing.assert_array_equal(g.numpy()[valid], np.asarray(w)[valid])
        assert (g.numpy()[~valid] == 0).all()
    assert int(got[4]) == int(want[4]) == 97
    assert bool(got[5]) == bool(want[5]) == exhaustive


def test_nonfused_segment_volume_escalates_like_jax_on_cpu():
    """Starved roots on the non-fused branch: the certificates fail exactly
    as the reference's jnp path's (count_ok carries `complete`)."""
    data, spacing, origin = _volume((48, 48, 48), seed=2)
    kw = dict(closing_radius=1, max_sweeps=1, passes=1, max_roots=4, max_blobs=2)
    jres = jseg.segment_volume(jnp.asarray(data), spacing, origin, jseg.SegmentationParams(use_pallas=False, **kw))
    tres = tseg.segment_volume(torch.as_tensor(data), spacing, origin, tseg.SegmentationParams(**kw))
    assert not bool(tres.roots_complete) and not bool(tres.count_ok) and bool(tres.cand_ok)
    for name in CERTS:
        assert bool(getattr(tres, name)) == bool(getattr(jres, name)), name
    assert int(tres.num_components) == int(jres.num_components)
    np.testing.assert_array_equal(tres.labels.numpy(), np.asarray(jres.labels))
    np.testing.assert_array_equal(tres.volumes_mm3.numpy(), np.asarray(jres.volumes_mm3))


def test_connected_components_matches_jax():
    mask = np.random.default_rng(6).random((20, 12, 30)) < 0.35
    want = jseg.connected_components(jnp.asarray(mask), max_sweeps=12, use_pallas=True)
    got = tseg.connected_components(torch.as_tensor(mask), max_sweeps=12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

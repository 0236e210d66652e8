"""The port's segment_volume against mamri_tpu's, on the same numpy volumes.

JAX runs both of its branches on the CPU: the Pallas kernels in interpret
mode (`use_pallas=True`) and the jnp path (`use_pallas=False`); the port
takes its fused and its non-fused branch for the same values. Exact:
labels, body mask, blob validity, volumes, component counts and every
certificate; centroids within 1e-4 mm (f32 arithmetic in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mamri_tpu.perception import segmentation as jseg
from mamri_tpu.perception.pallas_ops import compute_reset_distances
from mamri_tpu.perception.volume import synthetic_volume
from mamri_tpu_torch.perception import gpu_ops as G
from mamri_tpu_torch.perception import segmentation as tseg
from test_torch_engine import _one_torch_thread  # noqa: F401 (autouse)

FIDUCIALS = np.array([[6.0, 4.0, 5.0], [-9.0, 3.0, 1.0], [2.0, -12.0, -8.0], [-4.0, -5.0, 12.0]])
CERTS = ("ccl_converged", "roots_complete", "blobs_complete", "count_ok", "cand_ok", "runs_ok", "compact_ok")


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


def _compare(tres, jres):
    for name in CERTS + ("body_found",):
        assert bool(getattr(tres, name)) == bool(getattr(jres, name)), name
    for name in ("num_components", "num_blobs"):
        assert int(getattr(tres, name)) == int(getattr(jres, name)), name
    np.testing.assert_array_equal(tres.labels.numpy(), np.asarray(jres.labels))
    np.testing.assert_array_equal(tres.body_mask.numpy(), np.asarray(jres.body_mask))
    np.testing.assert_array_equal(tres.blob_valid.numpy(), np.asarray(jres.blob_valid))
    np.testing.assert_array_equal(tres.volumes_mm3.numpy(), np.asarray(jres.volumes_mm3))
    np.testing.assert_array_equal(tres.body_volume_mm3.numpy(), np.asarray(jres.body_volume_mm3))
    np.testing.assert_allclose(tres.centroids_ras.numpy(), np.asarray(jres.centroids_ras), atol=1e-4)


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("shape", [(48, 48, 48), (80, 48, 48)])
def test_segment_volume_matches_jax(shape, use_pallas):
    data, spacing, origin = _volume(shape, seed=shape[0])
    jp = jseg.SegmentationParams(max_sweeps=2, passes=3, max_roots=128, use_pallas=use_pallas)
    tp = tseg.SegmentationParams(max_sweeps=2, passes=3, max_roots=128, use_pallas=use_pallas)
    jres = jseg.segment_volume(jnp.asarray(data), spacing, origin, jp)
    tres = tseg.segment_volume(torch.as_tensor(data), spacing, origin, tp)
    assert bool(tres.ccl_converged) and bool(tres.roots_complete) and int(tres.num_blobs) >= 4
    _compare(tres, jres)


def test_uncertified_budgets_match_jax_kernels():
    """Starved budgets: every sub-certificate fails the same way as the
    Pallas branch's (and the labels, counts and blobs still agree)."""
    data, spacing, origin = _volume((48, 48, 48), seed=5)
    kw = dict(max_sweeps=1, passes=1, max_roots=8, cand_k=2, run_k=2, max_blobs=2)
    jres = jseg.segment_volume(jnp.asarray(data), spacing, origin, jseg.SegmentationParams(use_pallas=True, **kw))
    tres = tseg.segment_volume(torch.as_tensor(data), spacing, origin, tseg.SegmentationParams(**kw))
    assert not any(bool(getattr(tres, c)) for c in ("roots_complete", "count_ok", "cand_ok", "runs_ok"))
    _compare(tres, jres)


def test_component_stats_match_jax_kernels():
    """Roots, counts and coordinate sums of the stats stage, dense and compact."""
    data, _, _ = _volume((48, 48, 48), seed=7)
    mask = np.asarray(jseg.binary_close(jnp.asarray((data >= 65.0) & (data <= 65535.0))))
    lab0, reset, _ = jseg._pad_for_kernels(jseg._init_labels(jnp.asarray(mask)), jnp.asarray(~mask))
    jd = compute_reset_distances(reset.astype(jnp.int8), interpret=True)
    jlab, _ = jseg._ccl_sweeps_pallas_from_dists(lab0, jd, 4, interpret=True)
    tlab = torch.as_tensor(np.array(jlab))
    td = tuple(torch.as_tensor(np.array(d)) for d in jd)
    for compact in (False, True):
        want = jseg._component_stats_fast(jlab, jd, mask.shape, 300, compact=compact, interpret=True)
        got = tseg._component_stats_fast(tlab, td, mask.shape, 300, compact=compact)
        for name, g, w in zip(
            ("labels", "roots", "root_valid", "counts", "sums_ijk", "num_components", "complete",
             "count_ok", "cand_ok", "runs_ok", "compact_ok"), got, want,
        ):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_integer_volume_is_cast_on_device():
    data, spacing, origin = _volume((48, 48, 48), seed=9)
    as_i16 = np.round(data).astype(np.int16)
    a = tseg.segment_volume(torch.as_tensor(as_i16), spacing, origin)
    b = tseg.segment_volume(torch.as_tensor(as_i16.astype(np.float32)), spacing, origin)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_thresholds_are_checked():
    data, spacing, origin = _volume((48, 48, 48), seed=1)
    with pytest.raises(ValueError, match="finite"):
        tseg.segment_volume(torch.as_tensor(data), spacing, origin, tseg.SegmentationParams(intensity_high=np.inf))
    assert G.BIG == jseg._BIG

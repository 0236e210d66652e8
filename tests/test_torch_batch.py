"""The port's batched and asynchronous pose estimation
(`MamriEngine.estimate_pose_batch`, `estimate_pose_async` /
`estimate_pose_collect`).

A batch row runs the same per-volume program as `estimate_pose` on the
same device, so against the port's own single calls every output must be
equal bit for bit. Against mamri_tpu's batch (one call, two volumes of
tests/test_engine.py's scene at 3 mm): equal markers, blob counts,
baseplate sources and certificates; base_tf within 1e-4, J1-J3 within
1e-3 rad, RMSE within 1e-3 mm, motor steps within +-1.
"""

import logging

import numpy as np
import pytest

from mamri_tpu.api import MamriEngine as JaxEngine
from mamri_tpu_torch.api.engine import MamriEngine
from mamri_tpu_torch.perception.segmentation import SegmentationParams
from mamri_tpu_torch.perception.volume import Volume
from test_torch_engine import CERTS, PIPELINE_KEYS, TRUE_ANGLES, _scene
from test_torch_engine import _one_torch_thread  # noqa: F401 (autouse)

BATCH_KEYS = sorted(k for k in PIPELINE_KEYS if k != "body_mask")
ENGINE_LOG = "mamri_tpu_torch.api.engine"


@pytest.fixture(scope="module")
def scene():
    return _scene(JaxEngine(ik_restarts=0).model, 3.0)


@pytest.fixture(scope="module")
def volumes(scene):
    """Three distinct clean scans: the scene, the scene with seeded noise,
    and the scene moved by one voxel in x."""
    vol, _ = scene
    data = np.asarray(vol.data)
    noisy = data + np.random.default_rng(3).normal(0.0, 2.0, data.shape).astype(np.float32)
    return [data, noisy, np.roll(data, 1, axis=0)]


def _speckled(data, n=1200, seed=11):
    """tests/test_engine.py:577-586: lone bright voxels away from the
    fiducials and body, which overflow the default 128 roots."""
    rng = np.random.default_rng(seed)
    out = data.copy()
    bright = data > 60.0
    for i, j, k in rng.integers(0, np.array(data.shape)[None, :], size=(n, 3)):
        if not bright[max(i - 2, 0):i + 3, max(j - 2, 0):j + 3, max(k - 2, 0):k + 3].any():
            out[i, j, k] = 100.0
    return out


def _count_fetches(monkeypatch):
    fetched = []
    fetch = MamriEngine._fetch

    def spy(self, dev_out):
        fetched.append(sorted(dev_out))
        return fetch(self, dev_out)

    monkeypatch.setattr(MamriEngine, "_fetch", spy)
    return fetched


def test_batch_rows_equal_single_calls(scene, volumes, monkeypatch):
    """Each row equals `estimate_pose` of that volume on a fresh engine (no
    saved baseplate, zero current angles), key for key and bit for bit; the
    batch is fetched once, and reads and writes no engine state."""
    vol, _ = scene
    eng = MamriEngine(ik_restarts=0, device="cpu")
    eng.current_angles = np.full(6, 0.5, np.float32)  # the batch must not warm-start from these
    eng.load_state_from_numpy(saved_baseplate=np.eye(4) * 2)
    fetched = _count_fetches(monkeypatch)
    out = eng.estimate_pose_batch(np.stack(volumes), vol.spacing, vol.origin)
    assert fetched == [BATCH_KEYS]
    assert sorted(out) == BATCH_KEYS
    assert eng.last_segmentation is None and eng.baseplate_tf is None
    np.testing.assert_array_equal(eng.current_angles, np.full(6, 0.5, np.float32))
    assert out["success"].all() and out["roots_complete"].all()

    for row, data in enumerate(volumes):
        single = MamriEngine(ik_restarts=0, device="cpu")
        res = single.estimate_pose(Volume(data, vol.spacing, vol.origin))
        assert res.success
        for k in BATCH_KEYS:
            want = single.last_segmentation[k]
            assert out[k][row].dtype == want.dtype, k
            np.testing.assert_array_equal(out[k][row], want, err_msg=f"row {row} {k}")


def test_batch_matches_jax(scene):
    vol, base = scene
    batch = np.stack([np.asarray(vol.data)] * 2)
    want = JaxEngine(ik_restarts=0).estimate_pose_batch(batch, vol.spacing, vol.origin)
    got = MamriEngine(ik_restarts=0, device="cpu").estimate_pose_batch(batch, vol.spacing, vol.origin)
    assert sorted(got) == sorted(want)
    for k in ("success", "base_ok", "base_source", "markers_found", "num_blobs", "body_found", "num_components",
              *CERTS):
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    assert got["success"].all()
    np.testing.assert_allclose(got["base_tf"], np.asarray(want["base_tf"]), atol=1e-4)
    np.testing.assert_allclose(got["angles"][:, :3], np.asarray(want["angles"])[:, :3], atol=1e-3)
    np.testing.assert_allclose(got["rmse"], np.asarray(want["rmse"]), atol=1e-3)
    assert np.abs(got["steps"].astype(np.int64) - np.asarray(want["steps"]).astype(np.int64)).max() <= 1
    assert np.rad2deg(np.abs(got["angles"][:, :3] - TRUE_ANGLES[:3])).max() < 1.0


def test_batch_escalates_only_the_failing_volume(caplog, monkeypatch):
    """tests/test_engine.py's mixed clean/noisy batch at 2.5 mm: only the
    noisy row reruns (the reference's "1/3 volumes" line, letter for
    letter), one fetch per round, and the clean rows equal the all-clean
    batch's."""
    eng = MamriEngine(ik_restarts=0, device="cpu")
    vol, _ = _scene(JaxEngine(ik_restarts=0).model, 2.5)
    clean = np.asarray(vol.data)
    noisy = _speckled(clean)
    fetched = _count_fetches(monkeypatch)
    with caplog.at_level(logging.WARNING, logger=ENGINE_LOG):
        out = eng.estimate_pose_batch(np.stack([clean, noisy, clean]), vol.spacing, vol.origin)
    said = [r.getMessage() for r in caplog.records if r.name == ENGINE_LOG]
    assert said and said[0] == ("batched segmentation escalation for 1/3 volumes -> passes=3 max_sweeps=2 "
                                "max_roots=1024 max_blobs=32 exhaustive=False")
    assert all("for 1/3 volumes" in m for m in said)
    assert len(fetched) == 1 + len(said)
    for k in ("seg_converged", "roots_complete", "blobs_complete", "success"):
        assert out[k].all(), k
    assert int(out["num_components"][1]) > 128 >= int(out["num_components"][0])

    ref = eng.estimate_pose_batch(np.stack([clean] * 3), vol.spacing, vol.origin)
    for k in BATCH_KEYS:
        np.testing.assert_array_equal(out[k][[0, 2]], ref[k][[0, 2]], err_msg=k)
    assert np.rad2deg(np.abs(out["angles"][1, :3] - TRUE_ANGLES[:3])).max() < 1.0


def test_batch_microbatch(scene, monkeypatch):
    """`microbatch` must divide the batch; it fetches once per chunk and
    changes no result."""
    vol, _ = scene
    batch = np.stack([np.asarray(vol.data)] * 4)
    eng = MamriEngine(ik_restarts=0, device="cpu")
    with pytest.raises(ValueError, match="microbatch 3 must divide batch 4"):
        eng.estimate_pose_batch(batch, vol.spacing, vol.origin, microbatch=3)
    fetched = _count_fetches(monkeypatch)
    flat = eng.estimate_pose_batch(batch, vol.spacing, vol.origin)
    chunked = eng.estimate_pose_batch(batch, vol.spacing, vol.origin, microbatch=2, donate=False)
    assert len(fetched) == 1 + 2
    for k in BATCH_KEYS:
        np.testing.assert_array_equal(chunked[k], flat[k], err_msg=k)


def test_async_collect_equals_estimate_pose(scene):
    """Dispatch, then collect: the same result and state as `estimate_pose`
    without the segmentation; the IK warm-starts from the angles at
    dispatch, not at collect."""
    vol, _ = scene
    volume = Volume(vol.data, vol.spacing, vol.origin)
    start = np.array([0.1, -0.2, 0.1, 0.0, 0.3, -0.1], np.float32)
    eng = MamriEngine(ik_restarts=0, device="cpu")
    eng.current_angles = start.copy()
    handle = eng.estimate_pose_async(volume)
    eng.current_angles = np.zeros(6, np.float32)  # after dispatch: must not reach the IK
    got = eng.estimate_pose_collect(handle)

    ref = MamriEngine(ik_restarts=0, device="cpu")
    ref.current_angles = start.copy()
    want = ref.estimate_pose(volume, keep_segmentation=False)
    assert got.success and want.success
    for field in ("angles_rad", "steps", "baseplate_tf"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
    assert (got.rmse_mm, got.markers_found, got.num_blobs, got.baseplate_source) == (
        want.rmse_mm, want.markers_found, want.num_blobs, want.baseplate_source)
    np.testing.assert_array_equal(eng.current_angles, ref.current_angles)
    assert eng.last_segmentation is None

    # store_state=False leaves the engine alone
    before = eng.current_angles.copy()
    eng.estimate_pose_collect(eng.estimate_pose_async(volume), store_state=False)
    np.testing.assert_array_equal(eng.current_angles, before)


def test_async_uncertified_falls_back_to_the_sync_path(scene, caplog):
    """A starved budget (8 roots for 13 components) leaves the dispatched
    result uncertified: collect warns and reruns the escalating
    synchronous path, whose result it returns."""
    vol, _ = scene
    volume = Volume(vol.data, vol.spacing, vol.origin)
    starved = SegmentationParams(max_roots=8, max_blobs=8)
    eng = MamriEngine(seg_params=starved, ik_restarts=0, device="cpu")
    handle = eng.estimate_pose_async(volume)
    assert not bool(handle["dev"]["roots_complete"])
    with caplog.at_level(logging.WARNING, logger=ENGINE_LOG):
        got = eng.estimate_pose_collect(handle)
    said = [r.getMessage() for r in caplog.records if r.name == ENGINE_LOG]
    assert said[0] == "async estimation uncertified; re-running synchronously"
    assert any("segmentation escalation" in m for m in said[1:])
    want = MamriEngine(seg_params=starved, ik_restarts=0, device="cpu").estimate_pose(volume, keep_segmentation=False)
    assert got.success and want.success
    np.testing.assert_array_equal(got.angles_rad, want.angles_rad)
    np.testing.assert_array_equal(got.steps, want.steps)

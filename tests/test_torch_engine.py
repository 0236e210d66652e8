"""The slice as a whole: the port's MamriEngine.estimate_pose against
mamri_tpu's on the same synthetic scans (tests/test_engine.py's scene).

Both engines run with `ik_restarts=0` (no random draws) unless a test hands
the port JAX's exact draws. Tolerances: equal markers, blob counts, baseplate
source and certificates; base_tf within 1e-4; J1-J3 within 1e-3 rad; the
TCP within 0.05 mm (the wrist is bounded only by gauge freedom,
docs/ARCHITECTURE.md section 4a); motor steps within +-1.
"""

import itertools
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mamri_tpu.api import MamriEngine as JaxEngine
from mamri_tpu.api.engine import _LRUCache as JaxLRUCache
from mamri_tpu.core import transforms as jT
from mamri_tpu.core.robot import fk_all_links as j_fk
from mamri_tpu.core.robot import marker_world_positions
from mamri_tpu.ik.residuals import solve_full_chain_ik as j_solve
from mamri_tpu.perception.segmentation import SegmentationParams as JaxSegParams
from mamri_tpu.perception.volume import synthetic_volume
from mamri_tpu_torch.api.engine import MamriEngine, _LRUCache
from mamri_tpu_torch.core.robot import load_robot_model
from mamri_tpu_torch.ik.residuals import solve_full_chain_ik as t_solve
from mamri_tpu_torch.perception.segmentation import SegmentationParams
from mamri_tpu_torch.perception.volume import Volume

TRUE_ANGLES = np.array([0.3, -0.7, 0.5, 0.2, -0.4, 0.6], dtype=np.float32)
MARKER_LINKS = ["Baseplate", "Joint2", "Joint4", "Joint6"]
PIPELINE_KEYS = ("success", "angles", "steps", "rmse", "base_tf", "base_ok", "base_source", "markers_found",
                 "num_blobs", "body_mask", "body_found", "num_components", "seg_converged", "roots_complete",
                 "blobs_complete", "seg_count_ok", "seg_cand_ok", "seg_runs_ok", "seg_compact_ok")
CERTS = ("seg_converged", "roots_complete", "blobs_complete", "seg_count_ok", "seg_cand_ok", "seg_runs_ok",
         "seg_compact_ok")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs on several workers at
    once, and a thread per core each oversubscribes the machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _base_tf():
    return np.array(
        jT.translate(jnp.asarray([-60.0, -120.0, 0.0])) @ jT.rot_x(jnp.float32(-np.pi / 2)) @ jT.rot_z(jnp.float32(0.15))
    )


def _scene(model, spacing):
    """tests/test_engine.py's `_make_scene`: the arm on the bed, fiducial
    spheres at the FK marker positions, an ellipsoid body beside it."""
    base = _base_tf()
    pts = np.concatenate(
        [np.asarray(marker_world_positions(model, jnp.asarray(TRUE_ANGLES), ln, jnp.asarray(base))) for ln in MARKER_LINKS]
    )
    body_center = np.array([-60.0, -40.0, 130.0])
    lo = np.minimum(pts.min(0) - 40, body_center - 75)
    hi = np.maximum(pts.max(0) + 40, body_center + 75)
    lps_lo = np.array([-hi[0], -hi[1], lo[2]])
    lps_hi = np.array([-lo[0], -lo[1], hi[2]])
    sp = np.array([spacing] * 3, dtype=np.float32)
    shape = tuple(int(np.ceil(e)) for e in (lps_hi - lps_lo) / sp)
    vol = synthetic_volume(
        shape=shape, spacing=sp, origin=lps_lo, fiducials_ras=pts, fiducial_radius_mm=4.0,
        body_center_ras=body_center, body_radii_mm=[45.0, 55.0, 65.0],
    )
    return vol, base


@pytest.fixture(scope="module")
def jax_engine():
    return JaxEngine(ik_restarts=0)


@pytest.fixture(scope="module")
def scene(jax_engine):
    return _scene(jax_engine.model, 3.0)


def _tcp(model, angles, base):
    return np.asarray(j_fk(model, jnp.asarray(angles), jnp.asarray(base)))[-1][:3, 3]


def _compare(jeng, jres, teng, tres, base):
    assert tres.success == jres.success
    assert tres.markers_found == jres.markers_found
    assert tres.num_blobs == jres.num_blobs
    assert tres.baseplate_source == jres.baseplate_source
    for c in CERTS:
        assert bool(teng.last_segmentation[c]) == bool(jeng.last_segmentation[c]), c
    assert int(teng.last_segmentation["num_components"]) == int(jeng.last_segmentation["num_components"])
    np.testing.assert_array_equal(teng.last_segmentation["body_mask"], jeng.last_segmentation["body_mask"])
    np.testing.assert_allclose(tres.baseplate_tf, jres.baseplate_tf, atol=1e-4)
    if not jres.success:
        return
    np.testing.assert_allclose(tres.angles_rad[:3], jres.angles_rad[:3], atol=1e-3)
    tcp_gap = np.linalg.norm(_tcp(jeng.model, tres.angles_rad, base) - _tcp(jeng.model, jres.angles_rad, base))
    assert tcp_gap < 0.05, tcp_gap
    assert np.abs(tres.steps.astype(np.int64) - jres.steps.astype(np.int64)).max() <= 1
    assert abs(tres.rmse_mm - jres.rmse_mm) < 1e-3


def test_estimate_pose_matches_jax(jax_engine, scene):
    vol, base = scene
    jres = jax_engine.estimate_pose(vol)
    teng = MamriEngine(ik_restarts=0, device="cpu")
    tres = teng.estimate_pose(Volume(vol.data, vol.spacing, vol.origin))
    assert tres.success and tres.baseplate_source == "detected" and all(tres.markers_found.values())
    assert np.rad2deg(np.abs(tres.angles_rad[:3] - TRUE_ANGLES[:3])).max() < 1.0
    _compare(jax_engine, jres, teng, tres, base)
    assert tres.steps.dtype == np.int32 and tres.angles_rad.dtype == np.float32


def test_nonfinite_voxels_match_jax(jax_engine, scene):
    vol, base = scene
    data = np.array(vol.data, copy=True)
    rng = np.random.default_rng(0)
    for i, (a, b, c) in enumerate(rng.integers(0, min(data.shape), size=(200, 3))):
        data[a, b, c] = np.nan if i % 2 else np.inf
    jres = jax_engine.estimate_pose(type(vol)(data=data, spacing=vol.spacing, origin=vol.origin))
    teng = MamriEngine(ik_restarts=0, device="cpu")
    tres = teng.estimate_pose(Volume(data, vol.spacing, vol.origin))
    assert tres.success and tres.rmse_mm < 1.5
    _compare(jax_engine, jres, teng, tres, base)


def test_roots_escalation_matches_jax(jax_engine, scene, caplog):
    """300 lone speckles overflow the default 128 roots: both engines
    escalate (the port to the compact run-stats path) and agree, down to
    the escalation warnings they log."""
    vol, base = scene
    data = np.array(vol.data, copy=True)
    rng = np.random.default_rng(11)
    bright = data > 60.0
    for i, j, k in rng.integers(0, np.array(data.shape)[None, :], size=(300, 3)):
        if not bright[max(i - 2, 0):i + 3, max(j - 2, 0):j + 3, max(k - 2, 0):k + 3].any():
            data[i, j, k] = 100.0

    def warnings_of(engine_module, run):
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            result = run()
        return result, [r.getMessage() for r in caplog.records if r.name == engine_module]

    jres, jax_said = warnings_of(
        "mamri_tpu.api.engine", lambda: jax_engine.estimate_pose(type(vol)(data=data, spacing=vol.spacing, origin=vol.origin))
    )
    teng = MamriEngine(ik_restarts=0, device="cpu")
    tres, port_said = warnings_of("mamri_tpu_torch.api.engine", lambda: teng.estimate_pose(Volume(data, vol.spacing, vol.origin)))
    assert any("escalation" in m for m in port_said)
    assert int(teng.last_segmentation["num_components"]) > 128
    assert tres.success and all(tres.markers_found.values())
    _compare(jax_engine, jres, teng, tres, base)

    # on the CPU the reference takes its jnp path, whose failed top-k also
    # turns on `exhaustive_roots`; the port's `use_pallas=False` is that path,
    # and it logs the reference's lines letter for letter
    assert jax_said and all("exhaustive=True" in m for m in jax_said if "escalation" in m)
    jnp_params = SegmentationParams(max_sweeps=2, passes=3, max_roots=128, use_pallas=False)
    jnp_eng = MamriEngine(seg_params=jnp_params, ik_restarts=0, device="cpu")
    jnp_res, jnp_said = warnings_of("mamri_tpu_torch.api.engine",
                                    lambda: jnp_eng.estimate_pose(Volume(data, vol.spacing, vol.origin)))
    assert jnp_said == jax_said
    _compare(jax_engine, jres, jnp_eng, jnp_res, base)
    # the kernel path, as the reference's on its accelerator, leaves it off
    assert port_said == [m.replace("exhaustive=True", "exhaustive=False") for m in jax_said]


def test_nonfused_radius1_matches_jax(jax_engine):
    """`closing_radius=1` takes the non-fused branch in both engines (JAX's
    jnp path on the CPU, whose outputs equal its kernels' on a certified
    scene), on the 2.5 mm scene."""
    vol, base = _scene(jax_engine.model, 2.5)
    params = dict(closing_radius=1, max_sweeps=2, passes=3, max_roots=128)
    jeng = JaxEngine(seg_params=JaxSegParams(**params), ik_restarts=0)
    jres = jeng.estimate_pose(vol)
    teng = MamriEngine(seg_params=SegmentationParams(**params), ik_restarts=0, device="cpu")
    tres = teng.estimate_pose(Volume(vol.data, vol.spacing, vol.origin))
    assert tres.success and all(tres.markers_found.values())
    assert np.rad2deg(np.abs(tres.angles_rad[:3] - TRUE_ANGLES[:3])).max() < 1.0
    _compare(jeng, jres, teng, tres, base)


@pytest.mark.parametrize("use_pallas", [None, False])
def test_escalation_steps_match_jax(use_pallas, scene, monkeypatch):
    """Every escalation step equals the reference's from the same
    certificates, and the engine takes the reference's jnp-path rule
    (a failed blocked top-k turns on `exhaustive_roots`) exactly when
    `use_pallas` is False."""
    jnp_path = use_pallas is False
    start = dict(max_sweeps=2, passes=3, max_roots=128, use_pallas=use_pallas)
    for converged, complete, blobs, count_ok, cand_ok in itertools.product((False, True), repeat=5):
        certs = dict(count_ok=count_ok, cand_ok=cand_ok, runs_ok=True, compact_ok=True, jnp_path=jnp_path)
        want = JaxEngine._escalate_seg_params(JaxSegParams(**start), converged, complete, blobs, **certs)
        got = MamriEngine._escalate_seg_params(SegmentationParams(**start), converged, complete, blobs, **certs)
        assert (got is None) == (want is None)
        if got is not None:
            assert got._asdict() == want._asdict()

    seen = []
    escalate = MamriEngine._escalate_seg_params

    def spy(params, *args, **kwargs):
        seen.append(kwargs["jnp_path"])
        return escalate(params, *args, **kwargs)

    fetched = []
    fetch = MamriEngine._fetch

    def fetch_spy(self, dev_out):
        fetched.append(sorted(dev_out))
        return fetch(self, dev_out)

    monkeypatch.setattr(MamriEngine, "_escalate_seg_params", staticmethod(spy))
    monkeypatch.setattr(MamriEngine, "_fetch", fetch_spy)
    vol, _ = scene
    starved = SegmentationParams(max_roots=8, max_blobs=8, use_pallas=use_pallas)  # 13 components
    teng = MamriEngine(seg_params=starved, ik_restarts=0, device="cpu")
    assert teng.estimate_pose(Volume(vol.data, vol.spacing, vol.origin)).success
    assert seen and all(s == jnp_path for s in seen)
    assert bool(teng.last_segmentation["roots_complete"])
    # one fetch of every result and certificate per attempt (each escalation
    # is one more attempt), then the body mask once
    per_attempt = sorted(k for k in PIPELINE_KEYS if k != "body_mask")
    assert fetched == [per_attempt] * (len(seen) + 1) + [["body_mask"]]


def test_full_chain_ik_with_jax_restart_draws():
    """`num_random_restarts=2` at the engine's 24 iterations, the port fed
    JAX's exact uniform draws through `restart_guesses`."""
    from mamri_tpu.core.robot import load_robot_model as j_load

    jm, tm = j_load(), load_robot_model(device="cpu")
    base = _base_tf()
    rng = np.random.default_rng(5)
    pts = {
        ln: np.asarray(marker_world_positions(jm, jnp.asarray(TRUE_ANGLES), ln, jnp.asarray(base)))
        + rng.normal(size=(3, 3)).astype(np.float32) * 0.3
        for ln in MARKER_LINKS
    }
    current = np.array([0.1, -0.2, 0.1, 0.0, 0.3, -0.1], np.float32)
    want = j_solve(
        jm, jnp.asarray(pts["Joint6"]), jnp.asarray(base), current_angles=jnp.asarray(current),
        joint4_targets=jnp.asarray(pts["Joint4"]), joint4_found=True, num_iters=24,
        num_random_restarts=2, joint2_targets=jnp.asarray(pts["Joint2"]), joint2_found=True,
    )
    lower, upper = jm.limits_rad[:, 0], jm.limits_rad[:, 1]
    draws = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (2, 6), minval=lower * 0.8, maxval=upper * 0.8))
    yes = torch.tensor(True)
    got = t_solve(
        tm, torch.as_tensor(pts["Joint6"]), torch.as_tensor(base), current_angles=torch.as_tensor(current),
        joint4_targets=torch.as_tensor(pts["Joint4"]), joint4_found=yes, num_iters=24,
        joint2_targets=torch.as_tensor(pts["Joint2"]), joint2_found=yes, restart_guesses=torch.tensor(draws),
    )
    np.testing.assert_allclose(got.angles[:3].numpy(), np.asarray(want.angles)[:3], atol=1e-3)
    tcp_gap = np.linalg.norm(_tcp(jm, got.angles.numpy(), base) - _tcp(jm, np.asarray(want.angles), base))
    assert tcp_gap < 0.05, tcp_gap
    assert abs(float(got.rmse) - float(want.rmse)) < 1e-3
    # the seeded generator gives the same guesses on every call
    a = t_solve(tm, torch.as_tensor(pts["Joint6"]), torch.as_tensor(base), num_iters=4, num_random_restarts=2)
    b = t_solve(tm, torch.as_tensor(pts["Joint6"]), torch.as_tensor(base), num_iters=4, num_random_restarts=2)
    assert torch.equal(a.angles, b.angles)


def test_global_match_mode_end_to_end(scene):
    """`match_mode="global"` solves the scene with all four triplets, and
    its angles equal the default mode's: the assignment there is unique
    (the reference's `test_global_match_mode_end_to_end`)."""
    vol, _ = scene
    volume = Volume(vol.data, vol.spacing, vol.origin)
    glob = MamriEngine(match_mode="global", ik_restarts=0, device="cpu")
    res = glob.estimate_pose(volume)
    assert res.success and all(res.markers_found.values()) and res.baseplate_source == "detected"
    default = MamriEngine(ik_restarts=0, device="cpu").estimate_pose(volume)
    np.testing.assert_array_equal(res.angles_rad, default.angles_rad)
    np.testing.assert_array_equal(res.steps, default.steps)
    np.testing.assert_array_equal(res.baseplate_tf, default.baseplate_tf)


def test_saved_baseplate_and_failures(jax_engine, scene):
    vol, base = scene
    teng = MamriEngine(ik_restarts=0, device="cpu")
    empty = synthetic_volume(shape=(48, 48, 48))
    res = teng.estimate_pose(Volume(empty.data, empty.spacing, empty.origin))
    assert not res.success and "baseplate" in res.message.lower()

    teng.load_state_from_numpy(saved_baseplate=base, current_angles=TRUE_ANGLES)
    res = teng.estimate_pose(Volume(empty.data, empty.spacing, empty.origin))
    assert not res.success and res.baseplate_source == "saved_fallback" and "Joint6" in res.message
    res = teng.estimate_pose(Volume(vol.data, vol.spacing, vol.origin), use_saved_baseplate=True)
    assert res.success and res.baseplate_source == "saved"
    np.testing.assert_allclose(res.baseplate_tf, base, atol=1e-6)


def test_engine_options():
    eng = MamriEngine(jit_cache_size=3, device="cpu")
    assert eng._pipeline_cache.maxsize == 3 and len(eng._pipeline_cache) == 0
    assert MamriEngine(device="cpu")._pipeline_cache.maxsize == 32  # the reference's default
    assert MamriEngine(match_mode="global", device="cpu").match_mode == "global"
    with pytest.raises(ValueError) as port_err:
        MamriEngine(match_mode="first", device="cpu")
    with pytest.raises(ValueError) as jax_err:
        JaxEngine(match_mode="first")
    assert str(port_err.value) == str(jax_err.value)  # the reference's text, letter for letter
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            MamriEngine(device="cuda")


def test_pipeline_cache_lru_bound():
    """tests/test_engine.py's `test_jit_cache_lru_bound` on the port: the
    pipeline cache is bounded, a hit refreshes recency and returns the same
    object, and `clear_caches` empties it."""
    eng = MamriEngine(jit_cache_size=4, device="cpu")
    params = eng.seg_params
    first_key = ((16, 16, 16), params)
    for n in range(16, 40, 2):  # 12 distinct shapes
        eng._get_pipeline((n, n, n), params)
    assert len(eng._pipeline_cache) <= 4
    assert first_key not in eng._pipeline_cache  # oldest evicted

    surviving = list(eng._pipeline_cache._d.keys())
    eng._get_pipeline(surviving[0][0], params)
    eng._get_pipeline((96, 96, 96), params)
    assert surviving[0] in eng._pipeline_cache

    a = eng._get_pipeline((96, 96, 96), params)
    b = eng._get_pipeline((96, 96, 96))  # the engine's own params are the default key
    assert a is b
    assert eng._get_pipeline((96, 96, 96), params._replace(max_roots=1024)) is not a

    eng.clear_caches()
    assert len(eng._pipeline_cache) == 0


def test_lru_cache_matches_reference():
    """The port's `_LRUCache` against mamri_tpu's on one seeded sequence of
    sets, gets and get_or_sets: the same values, lengths and keys in order."""
    rng = np.random.default_rng(8)
    ours, theirs = _LRUCache(5), JaxLRUCache(5)
    for step in range(400):
        op, key = int(rng.integers(0, 3)), int(rng.integers(0, 9))
        if op == 0:
            ours[key] = theirs[key] = step
        elif op == 1 and key in theirs:
            assert key in ours
            assert ours[key] == theirs[key]
        elif op == 2:
            assert ours.get_or_set(key, lambda: step) == theirs.get_or_set(key, lambda: step)
        assert len(ours) == len(theirs) <= 5
        assert list(ours._d.items()) == list(theirs._d.items())
    ours.clear()
    assert len(ours) == 0 and 0 not in ours


def test_fetch_equals_per_key_copies(scene):
    """`_fetch` of one attempt's outputs equals the per-key `.cpu().numpy()`
    dict it replaced: the same keys, dtypes, shapes and values."""
    vol, _ = scene
    eng = MamriEngine(ik_restarts=0, device="cpu")
    dev_out = eng._get_pipeline(vol.shape)(
        torch.as_tensor(np.asarray(vol.data)), torch.as_tensor(vol.spacing, dtype=torch.float32),
        torch.as_tensor(vol.origin, dtype=torch.float32), torch.eye(4), torch.tensor(False), torch.tensor(False),
        torch.tensor(False), torch.zeros(6),
    )
    assert set(dev_out) == set(PIPELINE_KEYS)
    got = eng._fetch(dev_out)
    want = {k: v.cpu().numpy() for k, v in dev_out.items()}
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["steps"].dtype == np.int32 and got["angles"].dtype == np.float32
    assert got["markers_found"].dtype == np.bool_ and got["markers_found"].shape == (4,)
    assert got["base_tf"].dtype == np.float32 and got["base_tf"].shape == (4, 4)
    assert bool(got["seg_converged"]) and bool(got["success"])


def test_port_imports_without_jax():
    """With jax made unimportable, the port's package, engine, kernels'
    module, parity harness, planning layer, tracker, tracer, readers,
    hardware loop, playback and scene writers import, a CPU `estimate_pose`
    in the `global` mode solves a scene, the scene exports as glTF, a
    simulated rig attaches, a CPU `plan_trajectory` finds a needle goal, a
    `PoseTracker.step` solves the scene read back by `load_volume`, a
    `MamriServer` answers a `/estimate` over loopback, `main(["info",
    "--platform", "cpu"])` runs, the sharded segmentation on a ThreadAxis
    equals `segment_volume` and `run_sharded_batched` certifies on a 2 x 2
    CPU mesh, and no module of jax or of the JAX package `mamri_tpu` was
    loaded."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import numpy as np, torch\n"
        "import mamri_tpu_torch\n"
        "from mamri_tpu_torch.api.engine import MamriEngine\n"
        "from mamri_tpu_torch.core import transforms as T\n"
        "from mamri_tpu_torch.core.robot import marker_world_positions\n"
        "from mamri_tpu_torch.perception import gpu_ops, parity, segmentation\n"
        "from mamri_tpu_torch.perception.volume import synthetic_volume\n"
        "from mamri_tpu_torch.api.streaming import PoseTracker\n"
        "from mamri_tpu_torch.perception import dicom, formats\n"
        "from mamri_tpu_torch.utils import trace\n"
        "from mamri_tpu_torch import hw\n"
        "from mamri_tpu_torch.hw import devices, executor, sim, stream, sync, transport\n"
        "from mamri_tpu_torch.api import playback\n"
        "from mamri_tpu_torch.utils import glb, html_viewer, render, scene\n"
        "from mamri_tpu_torch.registration.lshape import match_l_shaped_triplets_global\n"
        "e = MamriEngine(device='cpu', ik_restarts=0, match_mode='global')\n"
        "assert e.model.num_joints == 6\n"
        "truth = torch.tensor([0.3, -0.7, 0.5, 0.2, -0.4, 0.6])\n"
        "base = T.translate(torch.tensor([-60.0, -120.0, 0.0])) @ T.rot_x(-np.pi / 2) @ T.rot_z(0.15)\n"
        "pts = torch.cat([marker_world_positions(e.model, truth, ln, base)\n"
        "                 for ln in ('Baseplate', 'Joint2', 'Joint4', 'Joint6')]).numpy()\n"
        "lo, hi = pts.min(0) - 30, pts.max(0) + 30\n"
        "origin = np.array([-hi[0], -hi[1], lo[2]], np.float32)\n"
        "shape = tuple(int(np.ceil(x)) for x in (hi - lo) / 3.0)\n"
        "vol = synthetic_volume(shape=shape, spacing=(3.0, 3.0, 3.0), origin=origin, fiducials_ras=pts,\n"
        "                       fiducial_radius_mm=4.0)\n"
        "res = e.estimate_pose(vol)\n"
        "assert res.success and all(res.markers_found.values()), res\n"
        "assert float(abs(res.angles_rad[0] - 0.3)) < 0.02, res.angles_rad\n"
        "assert type(res).__module__ == 'mamri_tpu_torch.api.types'\n"
        "import os, tempfile\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    assert e.export_scene(os.path.join(d, 'scene.glb'))['Needle'] > 0\n"
        "stack, robot, shutdown = sim.simulated_hardware(e)\n"
        "try:\n"
        "    assert e.available_actions()['return_to_zero'] and stack.status()['tcp_world'] is not None\n"
        "finally:\n"
        "    shutdown()\n"
        "import mamri_tpu_torch.planning, mamri_tpu_torch.planning.exact, mamri_tpu_torch.utils.stl\n"
        "goal = e.plan_trajectory(pts[-1] + np.float32(30.0), pts[-1])\n"
        "assert goal.angles.shape == (6,) and np.isfinite(goal.angles).all() and goal.position_error_mm < 1.0, goal\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    formats.save_volume(os.path.join(d, 'scan.nrrd'), vol)\n"
        "    back = formats.load_volume(os.path.join(d, 'scan.nrrd'))\n"
        "assert np.array_equal(back.data, vol.data) and back.data.dtype == vol.data.dtype\n"
        "step = PoseTracker(e).step(back)\n"
        "assert step.success and float(abs(step.angles_rad[0] - 0.3)) < 0.02, step\n"
        "import contextlib, io, json, threading, urllib.request\n"
        "from mamri_tpu_torch.api.server import MamriServer, make_http_server\n"
        "from mamri_tpu_torch.__main__ import main\n"
        "httpd = make_http_server(MamriServer(engine=e), port=0)\n"
        "threading.Thread(target=httpd.serve_forever, daemon=True).start()\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    formats.save_volume(os.path.join(d, 'scan.nrrd'), vol)\n"
        "    req = urllib.request.Request('http://%s:%d/estimate' % httpd.server_address[:2],\n"
        "                                 data=json.dumps({'path': os.path.join(d, 'scan.nrrd')}).encode(),\n"
        "                                 headers={'Content-Type': 'application/json'})\n"
        "    with urllib.request.urlopen(req, timeout=300) as r:\n"
        "        served = json.loads(r.read())\n"
        "httpd.shutdown()\n"
        "httpd.server_close()\n"
        "assert served['success'] and abs(served['angles_deg'][0] - np.rad2deg(0.3)) < 1.0, served\n"
        "with contextlib.redirect_stdout(io.StringIO()) as info:\n"
        "    assert main(['info', '--platform', 'cpu']) == 0\n"
        "assert json.loads(info.getvalue())['motor_letters'] == ['A', 'B', 'C', 'D', 'E', 'F']\n"
        "import mamri_tpu_torch.parallel\n"
        "from mamri_tpu_torch.parallel import collectives, dryrun, make_mesh, mesh, run_sharded_batched, shard_seg\n"
        "cpu_mesh = make_mesh(4, axes=('dp', 'sp'), shape=(2, 2), devices=['cpu'] * 4)\n"
        "params = segmentation.SegmentationParams(max_sweeps=2, passes=3, max_roots=128)\n"
        "pad = (-vol.data.shape[0]) % 16\n"
        "data = np.pad(vol.data, ((0, pad), (0, 0), (0, 0)))\n"
        "seg = shard_seg.segment_volume_threads(torch.as_tensor(data), vol.spacing, vol.origin, params, ['cpu'] * 2)\n"
        "want = segmentation.segment_volume(torch.as_tensor(data), vol.spacing, vol.origin, params)\n"
        "assert all(torch.equal(getattr(seg, f), getattr(want, f)) for f in seg._fields)\n"
        "out, _, certified = run_sharded_batched(e, cpu_mesh, np.stack([data] * 2), vol.spacing, vol.origin, sp_axis='sp')\n"
        "assert certified and out['success'].all(), out\n"
        "loaded = [m for m, v in sys.modules.items() if v is not None]\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in loaded)\n"
        "assert not any(m == 'mamri_tpu' or m.startswith('mamri_tpu.') for m in loaded), loaded\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr

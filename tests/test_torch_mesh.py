"""The port's device mesh and mesh-batched pipeline
(`mamri_tpu_torch.parallel.mesh`, `dryrun`) on virtual CPU meshes, against
mamri_tpu's `run_sharded_batched` on the 8-device virtual CPU mesh; and the
repairs that came with them: the reference's public names, the
synchronization-free Kabsch eigenvector, the `seg_fn` hook, thread-safe
launch counts and a build before any shard thread.

Tolerances: angles within 1e-4 rad of the reference's own mesh run (as
`tests/test_parallel.py` holds the reference's mesh to its single device);
success, blob and component counts and certificates equal. The port's own
mesh runs are held bit-equal to its single-device pipeline.
"""

import logging
import sys
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mamri_tpu.api import MamriEngine as JaxEngine
from mamri_tpu.api.demo import build_demo_scene
from mamri_tpu.parallel import make_mesh as j_make_mesh
from mamri_tpu.parallel import run_sharded_batched as j_run
from mamri_tpu.parallel import sharded_batched_pipeline as j_pipeline
from mamri_tpu.perception.segmentation import SegmentationParams as JaxSegParams
from mamri_tpu_torch.api.engine import MamriEngine
from mamri_tpu_torch.parallel import collectives, dryrun, make_mesh, run_sharded_batched, sharded_batched_pipeline
from mamri_tpu_torch.perception.segmentation import SegmentationParams
from test_parallel import _lattice_clutter
from test_torch_engine import _one_torch_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")
KERNEL_PARAMS = dict(max_sweeps=2, passes=3, max_roots=128, use_pallas=True)


@pytest.fixture(scope="module")
def jax_engine():
    return JaxEngine(ik_iters=10, ik_restarts=0, seg_params=JaxSegParams(**KERNEL_PARAMS))


@pytest.fixture(scope="module")
def engine():
    return MamriEngine(ik_iters=10, ik_restarts=0, seg_params=SegmentationParams(**KERNEL_PARAMS), device="cpu")


@pytest.fixture(scope="module")
def scene(jax_engine):
    """The reference's dry-run scene (the demo scene at 6 mm), x padded to a
    multiple of 32 (4 sp shards of the kernels' 8-row tiles)."""
    vol = build_demo_scene(jax_engine, spacing=6.0)[0]
    data = np.asarray(vol.data)
    data = np.pad(data, ((0, (-data.shape[0]) % 32), (0, 0), (0, 0)), constant_values=10.0)
    return data, np.asarray(vol.spacing), np.asarray(vol.origin)


def _mesh(n, shape=None, axes=("dp", "sp")):
    return make_mesh(n, axes=axes, shape=shape, devices=[CPU] * n)


def _single(engine, data, spacing, origin):
    """The port's single-device `estimate_pose_batch` rows (zero state)."""
    return engine.estimate_pose_batch(data, spacing, origin)


# ------------------------------------------------------------------------ the mesh
def test_mesh_shapes():
    assert _mesh(8, axes=("dp",)).devices.shape == (8,)
    assert _mesh(8).devices.shape == (2, 4)
    assert _mesh(4).shape == {"dp": 2, "sp": 2}
    assert _mesh(4, shape=(1, 4)).shape == {"dp": 1, "sp": 4}
    assert all(d == CPU for d in _mesh(6).devices.reshape(-1))


def test_mesh_fails_loudly_without_devices():
    """The default is the CUDA devices; a virtual mesh must name its own."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match=f"need {have + 1} devices, have {have} on platform 'cuda'"):
        make_mesh(have + 1)
    with pytest.raises(ValueError, match="need 4 devices, have 2"):
        make_mesh(4, devices=[CPU] * 2)


# ------------------------------------------------------------ against the reference
@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_run_sharded_batched_matches_jax(engine, jax_engine, scene, shape):
    data, spacing, origin = scene
    batch = np.stack([data, data])
    n = shape[0] * shape[1]
    want, want_params, want_cert = j_run(jax_engine, j_make_mesh(n, axes=("dp", "sp"), shape=shape), batch,
                                         spacing, origin, sp_axis="sp")
    got, got_params, got_cert = run_sharded_batched(engine, _mesh(n, shape), batch, spacing, origin, sp_axis="sp")
    assert got_cert and want_cert and got_params.passes == want_params.passes
    np.testing.assert_allclose(got["angles"], np.asarray(want["angles"]), atol=1e-4)
    for key in ("success", "num_blobs", "num_components", "markers_found", "seg_converged", "roots_complete",
                "blobs_complete"):
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
    single = _single(engine, batch[:1], spacing, origin)
    for key, v in got.items():
        np.testing.assert_array_equal(v, np.broadcast_to(single[key], v.shape), err_msg=key)


@pytest.mark.parametrize("microbatch", [0, -2, 3])
def test_microbatch_validation_messages(engine, jax_engine, microbatch):
    with pytest.raises(ValueError) as want:
        j_pipeline(jax_engine, j_make_mesh(2, axes=("dp",)), microbatch=microbatch)
    with pytest.raises(ValueError) as got:
        sharded_batched_pipeline(engine, _mesh(2, axes=("dp",)), microbatch=microbatch)
    assert str(got.value) == str(want.value)


def test_microbatch_must_divide_the_batch(engine, scene):
    data, spacing, origin = scene
    batch = np.stack([data] * 6)
    with pytest.raises(ValueError, match=r"^microbatch 4 must divide batch 6$"):
        sharded_batched_pipeline(engine, _mesh(2, axes=("dp",)), microbatch=4)(batch, spacing, origin, False)
    with pytest.raises(ValueError, match=r"^microbatch 4 must divide the local batch 3 \(x dp 2\)$"):
        sharded_batched_pipeline(engine, _mesh(4), sp_axis="sp", microbatch=4)(batch, spacing, origin, False)


# ------------------------------------------------------------ the port's own runs
def test_microbatch_chunking(engine, scene):
    data, spacing, origin = scene
    batch = np.stack([data] * 4)
    for mesh, sp_axis in ((_mesh(2, axes=("dp",)), None), (_mesh(4), "sp")):
        flat, _, c1 = run_sharded_batched(engine, mesh, batch, spacing, origin, sp_axis=sp_axis)
        chunked, _, c2 = run_sharded_batched(engine, mesh, batch, spacing, origin, sp_axis=sp_axis, microbatch=2)
        assert c1 and c2
        for key in flat:
            np.testing.assert_array_equal(flat[key], chunked[key], err_msg=key)


def test_per_volume_escalation(engine, scene, caplog):
    """One cluttered volume among clean ones: only it escalates (max_roots),
    and the clean rows keep their first-pass results."""
    data, spacing, origin = scene
    noisy = _lattice_clutter(data)
    mesh = _mesh(4, axes=("dp",))
    cache = {}
    with caplog.at_level(logging.WARNING, logger="mamri_tpu_torch.parallel.mesh"):
        out, final, certified = run_sharded_batched(engine, mesh, np.stack([data, noisy, data, data]), spacing,
                                                    origin, _fn_cache=cache)
    assert certified and final.max_roots > 128
    assert any("escalation for 1/4 volumes" in r.message for r in caplog.records)
    ref, _, ref_cert = run_sharded_batched(engine, mesh, np.stack([data] * 4), spacing, origin, _fn_cache=cache)
    assert ref_cert and out["success"].all()
    for row in (0, 2, 3):
        np.testing.assert_array_equal(out["angles"][row], ref["angles"][row])


def test_sharded_escalation_loop(scene):
    """A starved budget (passes=1: x is never swept) fails the psum'd
    certificate on a 2 x 2 mesh and certifies after the escalation, with
    the single device's answer."""
    data, spacing, origin = scene
    eng = MamriEngine(ik_iters=10, ik_restarts=0, device="cpu",
                      seg_params=SegmentationParams(passes=1, max_sweeps=1, max_roots=128, use_pallas=True))
    first = sharded_batched_pipeline(eng, _mesh(4), sp_axis="sp")(np.stack([data] * 2), spacing, origin, False)
    assert not first["seg_converged"].any()
    out, final, certified = run_sharded_batched(eng, _mesh(4), np.stack([data] * 2), spacing, origin, sp_axis="sp")
    assert certified and final.passes > 1 and out["seg_converged"].all()
    single = MamriEngine(ik_iters=10, ik_restarts=0, device="cpu", seg_params=SegmentationParams(**KERNEL_PARAMS))
    np.testing.assert_array_equal(out["angles"][0], _single(single, data[None], spacing, origin)["angles"][0])


def test_dryrun_multichip_cpu(capsys):
    shapes = dryrun.dryrun_multichip(4, device="cpu")
    assert [(s["dp"], s["sp"]) for s in shapes] == [(4, 1), (2, 2), (1, 4)]
    assert all(s["certified"] and s["bitexact"] for s in shapes)
    assert capsys.readouterr().out.count("bitexact_vs_single_device=True") == 3


def test_pipeline_seg_fn_hook(engine, scene):
    """`seg_fn` replaces the segmentation stage only."""
    from mamri_tpu_torch.perception.segmentation import segment_volume

    data, spacing, origin = scene
    calls = []

    def seg_fn(*args):
        calls.append(args[3])
        return segment_volume(*args)

    args = [engine._upload(v) for v in (data, spacing, origin, np.eye(4, dtype=np.float32), False, False, False,
                                        np.zeros(6, np.float32))]
    want = engine._fetch(engine.pipeline_fn()(*args))
    got = engine._fetch(engine.pipeline_fn(seg_fn=seg_fn)(*args))
    assert calls == [engine.seg_params]
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


# ------------------------------------------------------------------ the repairs
def test_reference_public_names():
    import importlib

    for pkg in ("core", "ik", "registration", "utils", "parallel"):
        ref = importlib.import_module(f"mamri_tpu.{pkg}")
        port = importlib.import_module(f"mamri_tpu_torch.{pkg}")
        assert list(port.__all__) == list(ref.__all__), pkg
        for name in ref.__all__:
            assert getattr(port, name) is not None, f"{pkg}.{name}"
    from mamri_tpu.core import load_robot_model as j_load
    from mamri_tpu.core import transforms as jT
    from mamri_tpu_torch.core import load_robot_model, transforms as T

    jm, tm = j_load(), load_robot_model(device="cpu")
    assert (tm.num_links, tm.marker_links) == (jm.num_links, jm.marker_links)
    rng = np.random.default_rng(0)
    a, b, c = (rng.normal(size=(4, 4)).astype(np.float32) for _ in range(3))
    np.testing.assert_allclose(T.chain(*map(torch.as_tensor, (a, b, c))).numpy(), np.asarray(jT.chain(a, b, c)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(T.matmul(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
                                  (torch.as_tensor(a) @ torch.as_tensor(b)).numpy())
    assert torch.equal(T.identity(), torch.eye(4))
    for code in (0, 1, 2, 3):
        m = np.asarray(jT.articulation_matrix(code, jnp.float32(0.7)))
        np.testing.assert_allclose(T.angle_about_axis(torch.as_tensor(m), code).numpy(),
                                   np.asarray(jT.angle_about_axis(jnp.asarray(m), code)), atol=1e-6)


def test_kabsch_eigenvector_without_eigh():
    """The Jacobi eigenvector of the 4x4 Horn matrix against float64 eigh
    (up to sign), and the zero matrix (no points) gives the identity."""
    from mamri_tpu_torch.registration.kabsch import _top_eigenvector

    rng = np.random.default_rng(1)
    mats = []
    while len(mats) < 64:
        m = rng.normal(size=(4, 4)) * rng.uniform(1, 1e4)
        m = m + m.T
        w = np.linalg.eigvalsh(m)
        if (w[-1] - w[-2]) > 1e-2 * np.abs(w).max():
            mats.append(m)
    mats = np.stack(mats)
    got = _top_eigenvector(torch.as_tensor(mats, dtype=torch.float32)).double().numpy()
    want = np.linalg.eigh(mats)[1][..., -1]
    err = np.minimum(np.abs(got - want).max(-1), np.abs(got + want).max(-1))
    assert err.max() < 1e-5, err.max()
    assert _top_eigenvector(torch.zeros(4, 4)).tolist() == [1.0, 0.0, 0.0, 0.0]


def test_kabsch_with_jacobi_matches_jax(monkeypatch):
    """The whole fit through the card's eigenvector (forced here on the CPU)
    within tests/test_torch_registration.py's tolerance of the reference."""
    from mamri_tpu.registration.kabsch import kabsch_rigid_transform as j_kabsch
    from mamri_tpu_torch.registration import kabsch
    from test_torch_registration import _random_rotation

    rng = np.random.default_rng(0)
    src = rng.normal(size=(6, 3, 3)).astype(np.float32) * 30
    tgt = np.stack([s @ _random_rotation(rng).T + rng.normal(size=3) * 50 for s in src]).astype(np.float32)
    tgt += rng.normal(size=tgt.shape).astype(np.float32) * 0.2
    want = np.asarray(j_kabsch(jnp.asarray(src), jnp.asarray(tgt)))
    jacobi = []

    def top_only(n):
        jacobi.append(n.shape)
        return None, kabsch._top_eigenvector(n)[..., None].expand(n.shape)

    monkeypatch.setattr(torch.linalg, "eigh", top_only)
    got = kabsch.kabsch_rigid_transform(torch.as_tensor(src), torch.as_tensor(tgt)).numpy()
    assert jacobi == [(6, 4, 4)]
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_launch_counts_are_exact_across_threads(monkeypatch):
    """Shard threads count their launches under one lock."""
    from mamri_tpu_torch import _build

    class _Lib:
        @staticmethod
        def mamri_noop(stream):
            return 0

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(_build, "library", lambda: _Lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream)
    before = _build.LAUNCHES["scan_lines"]

    def hammer():
        for _ in range(2000):
            _build.launch("scan_lines", "mamri_noop", None)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads often: a lost update would show
    try:
        threads = [threading.Thread(target=hammer) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert _build.LAUNCHES["scan_lines"] - before == 32000
    _build.LAUNCHES["scan_lines"] = before


def test_kernels_built_before_shard_threads(monkeypatch):
    from mamri_tpu_torch import _build

    seen = []
    monkeypatch.setattr(_build, "library", lambda: seen.append(threading.current_thread().name))
    started = []
    with pytest.raises(Exception):  # this CPU build of torch has no card to enter
        collectives.run_threads(lambda axis: started.append(axis.axis_index()), [()] * 3, devices=["cuda"] * 3,
                                timeout=30)
    assert seen == [threading.main_thread().name] and started == []

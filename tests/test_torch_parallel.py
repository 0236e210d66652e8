"""The port's sharded segmentation (`mamri_tpu_torch.parallel.shard_seg`) on
a `ThreadAxis` virtual mesh of CPU threads, against mamri_tpu's
`segment_volume_sharded` under `shard_map` on the 8-device virtual CPU mesh
(Pallas kernels in interpret mode, as `tests/test_shard_seg.py` runs them),
and against the port's own `segment_volume`.

Tolerances, against JAX: labels, body mask, blob validity, component and
blob counts and every certificate exact; centroids within 1e-4 mm and
volumes within rtol 1e-6 (JAX adds `x_off * count` to its f32 sums, the
port to exact int64 sums). Against the port's `segment_volume`: every
field bit-equal. Also: `close_init`'s twin with `label_dims` against
`fused_threshold_close_init(label_dims=...)`, the collectives of both
axes (`DistAxis` on 2 gloo processes), and a failing shard.
"""

import datetime
import os
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mamri_tpu.perception import segmentation as jseg
from mamri_tpu.perception.pallas_ops import fused_threshold_close_init
from mamri_tpu.perception.volume import synthetic_volume
from mamri_tpu_torch.parallel import collectives, shard_seg
from mamri_tpu_torch.parallel.shard_seg import segment_volume_sharded, segment_volume_threads
from mamri_tpu_torch.perception import gpu_ops as G
from mamri_tpu_torch.perception import segmentation as tseg
from test_shard_seg import _run_sharded
from test_torch_engine import _one_torch_thread  # noqa: F401 (autouse)

CERTS = ("ccl_converged", "roots_complete", "blobs_complete", "count_ok", "cand_ok", "runs_ok", "compact_ok")
FAST = dict(max_sweeps=2, passes=5)  # the reference's fast-path cases: this scene certifies at 5 half-sweeps
GENERAL = dict(max_sweeps=8, use_pallas=False)


class _Vol:
    def __init__(self, data, spacing, origin):
        self.data, self.spacing, self.origin = data, spacing, origin


@pytest.fixture(scope="module")
def scene():
    """tests/test_shard_seg.py's 64x48x56 scene: 12 fiducial spheres and a body."""
    rng = np.random.default_rng(5)
    pts = np.stack(
        [rng.uniform(-60, 60, 12), rng.uniform(-60, 60, 12), rng.uniform(20, 100, 12)], axis=1
    ).astype(np.float32)
    return synthetic_volume(
        shape=(64, 48, 56), spacing=np.array([2.5, 2.5, 2.5], np.float32),
        origin=np.array([-80.0, -80.0, -10.0], np.float32), fiducials_ras=pts, fiducial_radius_mm=4.0,
        body_center_ras=[0.0, 0.0, 60.0], body_radii_mm=[35.0, 40.0, 45.0],
    )


def _bar():
    """A bar along the whole x extent (it crosses every shard boundary) and a small blob."""
    data = np.zeros((64, 16, 136), np.float32)
    data[:, 6:9, 6:9] = 100.0
    data[10:12, 12:14, 100:102] = 100.0
    return _Vol(data, np.array([1.0, 2.0, 1.5], np.float32), np.zeros(3, np.float32))


def _halo():
    """A blob straddling the 8-shard boundary at x=24, and a 1-voxel gap at
    the boundary x=32 that the closing bridges."""
    data = np.zeros((64, 24, 136), np.float32)
    data[22:27, 8:13, 60:65] = 100.0
    data[30:32, 8:11, 10:13] = 100.0
    data[33:35, 8:11, 10:13] = 100.0
    return _Vol(data, np.ones(3, np.float32), np.zeros(3, np.float32))


def _port(vol, params, n_sp, **kw):
    return segment_volume_threads(torch.as_tensor(np.asarray(vol.data)), vol.spacing, vol.origin, params,
                                  [torch.device("cpu")] * n_sp, timeout=120, **kw)


def _single(vol, params):
    return tseg.segment_volume(torch.as_tensor(np.asarray(vol.data)), vol.spacing, vol.origin, params)


def _matches_jax(got, ref):
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(ref.labels))
    np.testing.assert_array_equal(got.body_mask.numpy(), np.asarray(ref.body_mask))
    np.testing.assert_array_equal(got.blob_valid.numpy(), np.asarray(ref.blob_valid))
    np.testing.assert_allclose(got.centroids_ras.numpy(), np.asarray(ref.centroids_ras), atol=1e-4)
    np.testing.assert_allclose(got.volumes_mm3.numpy(), np.asarray(ref.volumes_mm3), rtol=1e-6)
    np.testing.assert_allclose(got.body_volume_mm3.numpy(), np.asarray(ref.body_volume_mm3), rtol=1e-6)
    for name in ("num_components", "num_blobs"):
        assert int(getattr(got, name)) == int(getattr(ref, name)), name
    for name in CERTS + ("body_found",):
        assert bool(getattr(got, name)) == bool(getattr(ref, name)), name


def _bit_equal(got, want):
    for name in want._fields:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name


# ------------------------------------------------------------- JAX references, once each
@pytest.fixture(scope="module")
def jax_fast(scene):
    p = jseg.SegmentationParams(use_pallas=True, **FAST)
    return {n: _run_sharded(scene, p, n_shards=n, interpret=True) for n in (2, 4, 8)}


@pytest.fixture(scope="module")
def jax_general(scene):
    return _run_sharded(scene, jseg.SegmentationParams(**GENERAL))


@pytest.fixture(scope="module")
def jax_unaligned(scene):
    """60 wide at sp = 4: nxl = 15 is no multiple of 8, so the general path
    runs, its y/z scans through the line-scan kernel."""
    vol = _Vol(np.asarray(scene.data)[:60], scene.spacing, scene.origin)
    return vol, _run_sharded(vol, jseg.SegmentationParams(use_pallas=True, **FAST), n_shards=4, interpret=True)


# ------------------------------------------------------------------------ the kernel
@pytest.mark.parametrize("shape, label_dims", [((16, 20, 40), (32, 20)), ((24, 12, 33), (96, 40))])
def test_close_init_label_dims_matches_jax(shape, label_dims):
    """The twin's labels with other raster multipliers (a halo-extended
    shard: nxl + 8 planes, the whole volume's (nx, ny)), and the same mask."""
    rng = np.random.default_rng(shape[0])
    data = np.where(rng.random(shape) < 0.35, 100.0, 0.0).astype(np.float32)
    want_mask, want_lab = fused_threshold_close_init(jnp.asarray(data), 65.0, 65535.0, interpret=True,
                                                      label_dims=label_dims)
    mask, lab = G.close_init(torch.as_tensor(data), 65.0, 65535.0, label_dims=label_dims)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(want_lab))
    own_mask, _ = G.close_init(torch.as_tensor(data), 65.0, 65535.0)
    assert torch.equal(own_mask, mask)


# ----------------------------------------------------------------- the fast path
@pytest.mark.parametrize("n_sp", [2, 4, 8])
def test_fast_path_matches_jax(scene, jax_fast, n_sp):
    params = tseg.SegmentationParams(**FAST)
    got = _port(scene, params, n_sp)
    _matches_jax(got, jax_fast[n_sp])
    _bit_equal(got, _single(scene, params))
    assert int(got.num_blobs) >= 6 and bool(got.body_found)


# -------------------------------------------------------------- the general path
def test_general_path_jnp_scans_match_jax(scene, jax_general):
    params = tseg.SegmentationParams(**GENERAL)
    got = _port(scene, params, 8)
    _matches_jax(got, jax_general)
    _bit_equal(got, _single(scene, params))


def test_general_path_unaligned_shards_match_jax(jax_unaligned):
    vol, ref = jax_unaligned
    params = tseg.SegmentationParams(**FAST)
    got = _port(vol, params, 4)
    _matches_jax(got, ref)
    _bit_equal(got, _single(vol, params))


def test_general_path_radius_1(scene):
    params = tseg.SegmentationParams(closing_radius=1, **FAST)
    got = _port(scene, params, 4)
    _bit_equal(got, _single(scene, params))
    assert bool(got.ccl_converged) and int(got.num_blobs) >= 6


def test_segmented_min_scan_matches_jax():
    rng = np.random.default_rng(3)
    lab = rng.integers(0, 5000, (6, 10, 17)).astype(np.int32)
    reset = rng.random((6, 10, 17)) < 0.3
    for axis in range(3):
        for reverse in (False, True):
            want = jseg._segmented_min_scan(jnp.asarray(lab), jnp.asarray(reset), axis, reverse)
            got = tseg._segmented_min_scan(torch.as_tensor(lab), torch.as_tensor(reset), axis, reverse)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_labels_consistent_matches_jax(scene):
    params = tseg.SegmentationParams(closing_radius=1, max_sweeps=8, use_pallas=False)
    labels = _single(scene, params).labels
    reset = labels == G.BIG
    i, j, k = torch.nonzero(~reset[1:] & ~reset[:-1])[0].tolist()  # a foreground pair along x
    broken = labels.clone()
    broken[i + 1, j, k] += 1
    for lab in (labels, broken):
        want = jseg._labels_consistent_jnp(jnp.asarray(lab.numpy()), jnp.asarray(reset.numpy()))
        assert bool(tseg._labels_consistent(lab, reset)) == bool(want)
    assert bool(tseg._labels_consistent(labels, reset)) and not bool(tseg._labels_consistent(broken, reset))


# ---------------------------------------------------------------- the reference's cases
@pytest.mark.parametrize("path", ["fast", "general"])
def test_component_spanning_all_shards(path):
    vol = _bar()
    extra = dict(min_volume_mm3=2.0, max_volume_mm3=50.0)
    if path == "fast":
        jp, tp = jseg.SegmentationParams(passes=3, max_sweeps=2, use_pallas=True, **extra), \
            tseg.SegmentationParams(passes=3, max_sweeps=2, **extra)
    else:
        jp, tp = jseg.SegmentationParams(**GENERAL, **extra), tseg.SegmentationParams(**GENERAL, **extra)
    ref = _run_sharded(vol, jp, interpret=path == "fast")
    got = _port(vol, tp, 8)
    _matches_jax(got, ref)
    _bit_equal(got, _single(vol, tp))
    assert int(got.num_components) == 2 and bool(got.body_found)


def test_closing_halo_exactness():
    vol = _halo()
    extra = dict(min_volume_mm3=1.0, max_volume_mm3=1e5)
    ref = _run_sharded(vol, jseg.SegmentationParams(**GENERAL, **extra))
    for params in (tseg.SegmentationParams(**GENERAL, **extra), tseg.SegmentationParams(passes=5, **extra)):
        got = _port(vol, params, 8)
        _matches_jax(got, ref)
        _bit_equal(got, _single(vol, params))
    assert int(got.num_components) == 2  # the gap was bridged


def test_int16_input_bit_identical(scene, jax_general):
    vol16 = _Vol(np.asarray(scene.data).astype(np.int16), scene.spacing, scene.origin)
    assert np.array_equal(vol16.data, np.asarray(scene.data))
    for params, n_sp in ((tseg.SegmentationParams(**GENERAL), 8), (tseg.SegmentationParams(**FAST), 4)):
        got = _port(vol16, params, n_sp)
        _bit_equal(got, _port(scene, params, n_sp))
    _matches_jax(_port(vol16, tseg.SegmentationParams(**GENERAL), 8), jax_general)


@pytest.mark.parametrize("use_pallas, radius, width", [(False, 2, 16), (True, 2, 16), (None, 3, 32)])
def test_thin_shards_raise_the_reference_error(scene, use_pallas, radius, width):
    thin = _Vol(np.asarray(scene.data)[:width], scene.spacing, scene.origin)
    with pytest.raises(ValueError) as want:
        _run_sharded(thin, jseg.SegmentationParams(use_pallas=use_pallas, closing_radius=radius), interpret=True)
    with pytest.raises(ValueError) as got:
        _port(thin, tseg.SegmentationParams(use_pallas=use_pallas, closing_radius=radius), 8)
    assert str(got.value) == str(want.value)
    assert "thinner than the closing halo" in str(got.value)


def test_sp1_routes_to_segment_volume(scene, jax_fast, monkeypatch):
    params = tseg.SegmentationParams(**FAST)
    want = _single(scene, params)
    calls = []
    real = shard_seg.segment_volume
    monkeypatch.setattr(shard_seg, "segment_volume", lambda *a: calls.append(1) or real(*a))
    routed = _port(scene, params, 1)
    assert calls == [1]
    general = _port(scene, params, 1, force_general=True)
    assert calls == [1]  # force_general keeps the sharded formulation
    for got in (routed, general):
        _bit_equal(got, want)
        _matches_jax(got, jax_fast[2])


def test_starved_passes_fail_then_certify():
    """A maze of corridors needs several sweeps: passes=1 fails the global
    certificate, and doubling `passes` (the engine's escalation) certifies,
    bit-equal to the single card at the same budget."""
    rng = np.random.default_rng(3)
    data = np.zeros((64, 40, 136), np.float32)
    occ = rng.random((32, 20, 68)) < 0.62
    data[::2, ::2, ::2] = np.where(occ, 100.0, 0.0)
    data[1::2, ::2, ::2] = np.where(occ, 100.0, 0.0)
    vol = _Vol(data, np.ones(3, np.float32), np.zeros(3, np.float32))
    starved = tseg.SegmentationParams(passes=1, max_sweeps=1, max_roots=2048, cand_k=64, run_k=64)
    assert not bool(_port(vol, starved, 4).ccl_converged)
    for p in (2, 4, 8, 16, 32):
        got = _port(vol, starved._replace(passes=p), 4)
        if bool(got.ccl_converged):
            break
    assert bool(got.ccl_converged), "escalated passes never certified"
    _bit_equal(got, _single(vol, starved._replace(passes=p)))


def test_validate_thresholds_message():
    with pytest.raises(ValueError) as want:
        jseg._validate_thresholds(jseg.SegmentationParams(intensity_low=-np.inf))
    for fn in (tseg._validate_thresholds, lambda p: tseg.segment_volume(torch.zeros(8, 8, 8), [1.0] * 3, [0.0] * 3, p),
               lambda p: segment_volume_sharded(torch.zeros(8, 8, 8), [1.0] * 3, [0.0] * 3, p,
                                                collectives.ThreadAxis(1))):
        with pytest.raises(ValueError) as got:
            fn(tseg.SegmentationParams(intensity_low=-np.inf))
        assert str(got.value) == str(want.value)


# ------------------------------------------------------------------------ collectives
def test_thread_axis_collectives():
    def shard(axis, x):
        fwd, bwd = collectives.ring_perms(axis.axis_size())
        return (axis.ppermute(x, fwd), axis.ppermute(x, bwd), axis.all_gather(x), axis.psum(x), axis.pmax(x))

    xs = [(torch.tensor([10 * i + 1, -i], dtype=torch.int32),) for i in range(3)]
    out = collectives.run_threads(shard, xs, timeout=30)
    for i, (left, right, gathered, total, biggest) in enumerate(out):
        assert left.tolist() == ([0, 0] if i == 0 else xs[i - 1][0].tolist())
        assert right.tolist() == ([0, 0] if i == 2 else xs[i + 1][0].tolist())
        assert gathered.tolist() == [x[0].tolist() for x in xs]
        assert total.tolist() == [33, -3] and biggest.tolist() == [21, 0]


def test_failing_shard_aborts_the_others():
    """One shard raises before the first collective while the others wait
    in it: the barrier breaks, every thread ends, and the caller gets the
    shard's own error, well inside the time limit."""
    def shard(axis, x):
        if axis.axis_index() == 2:
            raise ValueError("shard 2 fails")
        return axis.psum(x)

    result = {}

    def call():
        try:
            collectives.run_threads(shard, [(torch.ones(3),)] * 4, timeout=60)
        except BaseException as exc:  # noqa: BLE001
            result["error"] = exc

    t0 = time.perf_counter()
    caller = threading.Thread(target=call, daemon=True)
    caller.start()
    caller.join(20)
    assert not caller.is_alive(), "run_threads hung after a shard failed"
    assert isinstance(result.get("error"), ValueError) and str(result["error"]) == "shard 2 fails"
    assert time.perf_counter() - t0 < 20


def _dist_worker(rank, world, init, out_dir, data, spacing, origin):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        axis = collectives.DistAxis()
        slab = torch.as_tensor(data).split(data.shape[0] // world)[rank]
        for name, params in (("fast", tseg.SegmentationParams(**FAST)), ("general", tseg.SegmentationParams(**GENERAL))):
            res = segment_volume_sharded(slab, spacing, origin, params, axis)
            torch.save({f: getattr(res, f) for f in res._fields}, os.path.join(out_dir, f"{name}{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_dist_axis_on_two_gloo_processes_equals_thread_axis(scene, tmp_path):
    import torch.multiprocessing as mp

    data = np.ascontiguousarray(scene.data)
    init = f"file://{tmp_path / 'rendezvous'}"
    ctx = mp.spawn(_dist_worker, args=(2, init, str(tmp_path), data, scene.spacing, scene.origin), nprocs=2,
                   join=False)
    deadline = time.monotonic() + 150
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the gloo processes did not finish within 150 s")
    for name, params in (("fast", tseg.SegmentationParams(**FAST)), ("general", tseg.SegmentationParams(**GENERAL))):
        want = _port(scene, params, 2)
        parts = [tseg.SegmentationResult(**torch.load(tmp_path / f"{name}{r}.pt")) for r in range(2)]
        _bit_equal(shard_seg.gather_result(parts), want)

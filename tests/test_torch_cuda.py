"""The CUDA kernels against their plain twins, on an NVIDIA GPU.

Marked `cuda`; every test skips where `torch.cuda.is_available()` is False
(the decision is made in the fixture, never at import). On a card, where
jax is not installed (tests/conftest.py imports it, hence --noconftest):

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda
"""

import numpy as np
import pytest
import torch

from mamri_tpu_torch.perception import gpu_ops as G
from mamri_tpu_torch.perception import segmentation as S
from mamri_tpu_torch.perception.volume import synthetic_volume

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _volume(shape, seed):
    vol = synthetic_volume(
        shape=shape, fiducials_ras=np.array([[5.0, 3.0, 2.0], [-9.0, 4.0, -6.0], [2.0, -11.0, 7.0]]),
        body_center_ras=[0.0, 6.0, -3.0], body_radii_mm=[12.0, 9.0, 14.0], noise_sigma=20.0, seed=seed,
    )
    data = np.array(vol.data)
    data[np.random.default_rng(seed).random(shape) < 0.002] = np.nan
    return data


def _same(a, b):
    if isinstance(a, (tuple, list)):
        for x, y in zip(a, b):
            _same(x, y)
        return
    torch.cuda.synchronize()
    assert a.shape == b.shape and a.dtype == b.dtype
    assert torch.equal(a, b)


@pytest.mark.parametrize("shape", [(16, 24, 20), (40, 33, 50), (64, 64, 64)])
def test_kernels_equal_their_twins(cuda, shape):
    data = torch.as_tensor(_volume(shape, seed=shape[0])).to(cuda)
    nx, ny, _ = shape
    G.reset_launch_counts()
    mask, lab0 = G.close_init(data, 65.0, 65535.0)
    _same((mask, lab0), G.close_init_plain(data, 65.0, 65535.0))
    lab0, reset = S._pad_for_kernels(lab0, (mask == 0).to(torch.int8))
    dists = []
    for axis in (0, 1, 2):
        got = G.reset_distances(reset, axis)
        _same(got, G.reset_distances_plain(reset, axis))
        dists.extend(got)
    lab = lab0.clone()
    for axis in (1, 2, 0, 1, 2):
        df, db = dists[2 * axis], dists[2 * axis + 1]
        a, fa, b, fb = lab.clone(), G.new_flag(cuda), lab.clone(), G.new_flag(cuda)
        G.run_min(a, df, db, axis, fa)
        G.run_min_plain(b, df, db, axis, fb)
        _same((a, fa), (b, fb))
        lab = a
    for labels in (lab0, lab):
        for axis in (0, 1, 2):
            fa, fb = G.new_flag(cuda), G.new_flag(cuda)
            _same(G.check(labels, dists[2 * axis], axis, fa), G.check_plain(labels, dists[2 * axis], axis, fb))
    for k, cand_k, x_off in ((8, 8, 0), (2, 2, 3)):
        args = (lab, dists[4], dists[5], nx + x_off, ny, k, cand_k, x_off)
        _same(G.z_runs(*args), G.z_runs_plain(*args))
    run_lab, run_z0, run_len, cands = G.z_runs(lab, dists[4], dists[5], nx, ny, 8, 8)[:4]
    roots = torch.topk(cands, min(64, cands.numel()), largest=False).values.contiguous()
    _same(G.run_stats(run_lab, run_len, run_z0, roots), G.run_stats_plain(run_lab, run_len, run_z0, roots))
    cols = S.compact_runs(run_lab, run_len, run_z0, 4096)[:5]
    _same(G.run_stats_compact(*cols, roots), G.run_stats_compact_plain(*cols, roots))
    assert all(n > 0 for n in G.LAUNCHES.values()), G.LAUNCHES


def test_segment_volume_cuda_equals_cpu(cuda):
    data = _volume((80, 80, 80), seed=3)
    params = S.SegmentationParams(max_sweeps=2, passes=3, max_roots=128)
    spacing, origin = np.ones(3, np.float32), np.zeros(3, np.float32)
    on_card = S.segment_volume(torch.as_tensor(data).to(cuda), spacing, origin, params)
    on_cpu = S.segment_volume(torch.as_tensor(data), spacing, origin, params)
    for name, a, b in zip(on_cpu._fields, on_card, on_cpu):
        assert torch.equal(a.cpu(), b), name


def test_cuda_tensors_never_reach_a_twin(cuda, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain twin")

    for name in ("close_init_plain", "reset_distances_plain", "run_min_plain", "check_plain", "z_runs_plain",
                 "run_stats_plain", "run_stats_compact_plain"):
        monkeypatch.setattr(G, name, refuse)
    data = torch.as_tensor(_volume((40, 40, 40), seed=4)).to(cuda)
    S.segment_volume(data, np.ones(3, np.float32), np.zeros(3, np.float32), S.SegmentationParams(max_roots=512))
    torch.cuda.synchronize()

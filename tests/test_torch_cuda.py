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

    # the non-fused branch's and the parity harness's kernels
    lab_u = lab0[:nx, :ny, : shape[2]].contiguous()
    reset_u = (lab_u == G.BIG).to(torch.int32)
    for axis in (2, 1, 0):
        lines = lab_u.movedim(axis, -1).contiguous().reshape(-1, shape[axis])
        r_lines = reset_u.movedim(axis, -1).contiguous().reshape(-1, shape[axis])
        _same(G.scan_lines(lines, r_lines), G.scan_lines_plain(lines, r_lines))
    mixed = torch.randint(0, 1 << 20, (37, 333), dtype=torch.int32, device=cuda)
    r_mixed = (torch.rand((37, 333), device=cuda) < 0.3).to(torch.int32)
    _same(G.scan_lines(mixed, r_mixed), G.scan_lines_plain(mixed, r_mixed))
    for k in (1, 8, 16):
        _same(G.root_candidates(lab, nx, ny, k), G.root_candidates_plain(lab, nx, ny, k))
    lab_c = lab[:nx, :ny, : shape[2]].contiguous()
    repeated = torch.cat([roots[:1], roots, torch.full((3,), G.BIG, dtype=torch.int32, device=cuda)])
    flat = lab_c.reshape(-1)
    _same(G.component_stats_xyz(flat, repeated, *shape), G.component_stats_xyz_plain(flat, repeated, *shape))
    raster = lab_c.permute(2, 1, 0).contiguous().reshape(-1)
    _same(G.component_stats_raster(raster, repeated, nx, ny), G.component_stats_raster_plain(raster, repeated, nx, ny))
    assert all(n > 0 for n in G.LAUNCHES.values()), G.LAUNCHES


# z lengths on both sides of close_init's 32-voxel words
WORD_EDGE_SHAPES = [(9, 10, 31), (8, 8, 33), (6, 7, 64), (5, 6, 65), (3, 4, 1)]


def _faces_volume(shape, seed):
    """An in-band body touching all six faces, with NaN and +-inf voxels."""
    rng = np.random.default_rng(seed)
    data = np.where(rng.random(shape) < 0.5, 100.0, 10.0).astype(np.float32)
    for face in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0], np.s_[:, :, -1]):
        data[face] = 100.0
    data[rng.random(shape) < 0.05] = np.nan
    data[rng.random(shape) < 0.03] = np.inf
    data[rng.random(shape) < 0.03] = -np.inf
    return data


@pytest.mark.parametrize("shape", WORD_EDGE_SHAPES + [(17, 18, 300), (40, 33, 50)])
def test_close_init_word_edges_equal_twin(cuda, shape):
    data = torch.as_tensor(_faces_volume(shape, seed=sum(shape))).to(cuda)
    for lo, hi in ((65.0, 65535.0), (-1.0, 50.0)):  # the body, then its complement
        _same(G.close_init(data, lo, hi), G.close_init_plain(data, lo, hi))


def _reset_lines(shape, seed):
    """int8 reset volume whose z lines cycle through: all reset, never reset,
    alternating, only index 0, only index n - 1, sparse and dense noise."""
    rng = np.random.default_rng(seed)
    reset = np.zeros(shape, np.int8)
    for line, (i, j) in enumerate(np.ndindex(*shape[:2])):
        pattern = line % 7
        if pattern == 0:
            reset[i, j] = 1
        elif pattern == 2:
            reset[i, j, ::2] = 1
        elif pattern == 3:
            reset[i, j, 0] = 1
        elif pattern == 4:
            reset[i, j, -1] = 1
        elif pattern >= 5:
            reset[i, j] = rng.random(shape[2]) < (0.02 if pattern == 5 else 0.5)
    return reset


@pytest.mark.parametrize(
    "shape",
    WORD_EDGE_SHAPES
    + [(8, 8, 384)]
    + [(4, 3, n) for n in (1, 31, 32, 33, 129, 4097)]  # z lines within, at and past a warp's chunk
    + [(130, 6, 8), (3, 140, 12), (3000, 2, 4), (12800, 1, 3)],  # long strided lines, both lane widths
)
def test_reset_distances_equal_twin(cuda, shape):
    reset = torch.as_tensor(_reset_lines(shape, seed=sum(shape))).to(cuda)
    for axis in (0, 1, 2):
        _same(G.reset_distances(reset, axis), G.reset_distances_plain(reset, axis))


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("shape", [(4, 4, 8), (8, 8, 384)])
def test_reset_distances_of_an_unaligned_view(cuda, shape, offset):
    """A contiguous view that starts off a 4-byte boundary takes the byte-wide path."""
    n = int(np.prod(shape))
    buf = torch.zeros(n + 4, dtype=torch.int8, device=cuda)
    reset = buf[offset:offset + n].view(shape)
    reset.copy_(torch.as_tensor(_reset_lines(shape, seed=offset)))
    assert reset.data_ptr() % 4 == offset
    for axis in (0, 1, 2):
        _same(G.reset_distances(reset, axis), G.reset_distances_plain(reset, axis))


def _run_lines(shape, seed):
    """(labels, reset) whose lines cycle through: one run, alternating
    1-voxel runs, background, sparse and dense noise; labels are random, so
    a run's minimum falls on its first, its last or an interior voxel."""
    rng = np.random.default_rng(seed)
    reset = _reset_lines(shape, seed)
    reset[0, 0] = 0  # one run over the whole line
    reset[-1, -1] = 0
    reset[-1, -1, 1::2] = 1  # 1-voxel runs
    lab = rng.integers(0, 1 << 20, shape).astype(np.int32)
    lab[reset != 0] = G.BIG
    return lab, reset


def _run_min_equals_twin(lab, reset):
    for axis in (0, 1, 2):
        df, db = G.reset_distances_plain(reset, axis)
        a, fa, b, fb = lab.clone(), G.new_flag(lab.device), lab.clone(), G.new_flag(lab.device)
        G.run_min(a, df, db, axis, fa)
        G.run_min_plain(b, df, db, axis, fb)
        _same((a, fa), (b, fb))
        before, again = a.clone(), G.new_flag(lab.device)
        G.run_min(a, df, db, axis, again)  # already minimal: nothing changes, the flag stays down
        _same((a, again), (before, G.new_flag(lab.device)))


@pytest.mark.parametrize(
    "shape",
    WORD_EDGE_SHAPES
    + [(8, 8, 384), (16, 16, 256), (256, 8, 128), (8, 512, 8)]  # 4 and 2 labels a lane, one and two chunks a warp
    + [(4, 3, n) for n in (1, 31, 32, 33, 127, 129, 255, 257, 4097)]  # z lines around a warp's chunk, 1 label a lane
    + [(4, 6, n) for n in (30, 34, 130, 1030)]  # 2 labels a lane
    + [(33, 5, 8), (257, 6, 4), (3, 140, 12), (545, 2, 6)]  # strided lines across segments, each lane width
    + [(3000, 2, 4), (2, 4097, 2), (12800, 1, 3)],  # strided lines over the shared-memory strip limit
)
def test_run_min_equals_twin(cuda, shape):
    lab, reset = _run_lines(shape, seed=sum(shape))
    _run_min_equals_twin(torch.as_tensor(lab).to(cuda), torch.as_tensor(reset).to(cuda))
    # no background at all: every line is one run along every axis
    whole = np.random.default_rng(1).integers(0, 1 << 20, shape).astype(np.int32)
    _run_min_equals_twin(torch.as_tensor(whole).to(cuda), torch.zeros(shape, dtype=torch.int8, device=cuda))


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("shape", [(4, 4, 8), (8, 8, 384)])
def test_run_min_of_an_unaligned_view(cuda, shape, offset):
    """Labels that start off a 16-byte boundary take the narrower lanes."""
    lab_np, reset = _run_lines(shape, seed=offset)
    n = int(np.prod(shape))
    buf = torch.zeros(n + 4, dtype=torch.int32, device=cuda)
    lab = buf[offset:offset + n].view(shape)
    lab.copy_(torch.as_tensor(lab_np))
    assert lab.data_ptr() % 16 == 4 * offset
    _run_min_equals_twin(lab, torch.as_tensor(reset).to(cuda))


@pytest.mark.parametrize(
    "shape,k,cand_k,x_off,converge",
    [
        ((8, 8, 128), 8, 8, 0, True),
        ((16, 16, 384), 4, 3, 5, True),
        ((16, 256, 128), 2, 2, 3, True),  # two y blocks, two x blocks
        ((16, 256, 128), 8, 32, 0, False),  # raw labels: every run is a root
        ((8, 136, 256), 4, 16, 0, False),  # y padded from 136 to 256
        ((8, 128, 128), 72, 16, 0, False),  # more roots in a block than its shared-memory list holds
        ((8, 128, 128), 72, 9000, 0, False),
    ],
)
def test_z_runs_equals_twin(cuda, shape, k, cand_k, x_off, converge):
    rng = np.random.default_rng(sum(shape) + k)
    nx, ny, _ = shape
    mask = rng.random(shape) < (0.3 if converge else 0.5)
    mask[0, 0] = True  # a run from z = 0 to nz - 1
    mask[1, 1, :3] = True
    mask[1, 1, -3:] = True
    i, j, kk = np.indices(shape)
    gx = nx + x_off
    lab = torch.as_tensor(np.where(mask, kk * gx * ny + j * gx + i + x_off, G.BIG).astype(np.int32)).to(cuda)
    dists = G.compute_reset_distances(torch.as_tensor(~mask).to(torch.int8).to(cuda))
    if converge:
        lab, _ = S._ccl_sweeps_from_dists(lab, dists, max_sweeps=64)
    args = (lab, dists[4], dists[5], gx, ny, k, cand_k, x_off)
    G.reset_launch_counts()
    got = G.z_runs(*args)
    assert G.LAUNCHES["z_runs"] == 1
    _same(got, G.z_runs_plain(*args))


def _root_labels(case, seed=0):
    """(padded labels, nx, ny) for root_candidates: raster-index labels of
    which a random part are roots, or every voxel a root, sentinel padding."""
    shape, pad = {
        "sparse": ((24, 40, 300), (24, 40, 300)),  # 16-byte loads, 12 chunks a slab
        "bench-like": ((250, 250, 250), (256, 256, 256)),  # 32 slabs of 64 chunks, few roots
        "every-root": ((14, 9, 12), (16, 16, 12)),
        "nzp-odd": ((16, 8, 37), (16, 8, 37)),  # 4-byte loads
        "one-slab": ((8, 10, 40), (8, 10, 40)),
        "all-sentinel": ((16, 8, 128), (16, 8, 128)),
        "many-chunks": ((8, 64, 128), (8, 64, 128)),  # every chunk's list full, the slab's merge long
        "list-overflow": ((8, 1, 8196), (8, 1, 8196)),  # a chunk of one row longer than the list
        "list-overflow-odd": ((8, 2, 9001), (8, 2, 9001)),
    }[case]
    nx, ny, nz = shape
    rng = np.random.default_rng(seed)
    i, j, k = np.indices(shape)
    lin = (k * nx * ny + j * nx + i).astype(np.int64)
    if case in ("sparse", "nzp-odd", "one-slab"):
        lin = np.where(rng.random(shape) < 0.5, lin, lin + 1)
        lin = np.where(rng.random(shape) < 0.3, G.BIG, lin)
    elif case == "bench-like":
        lin = np.where(rng.random(shape) < 1e-4, lin, np.where(rng.random(shape) < 0.9, G.BIG, 0))
    elif case == "all-sentinel":
        lin = np.full(shape, G.BIG)
    lab = np.full(pad, G.BIG, np.int32)
    lab[:nx, :ny, :nz] = np.minimum(lin, G.BIG)
    return lab, nx, ny


@pytest.mark.parametrize("k", [1, 8, 64])
@pytest.mark.parametrize("case", ["sparse", "bench-like", "every-root", "nzp-odd", "one-slab", "all-sentinel",
                                  "many-chunks", "list-overflow", "list-overflow-odd"])
def test_root_candidates_equals_twin(cuda, case, k):
    lab, nx, ny = _root_labels(case, seed=k)
    lab = torch.as_tensor(lab).to(cuda)
    G.reset_launch_counts()
    for _ in range(2):  # and again: the tickets are cleared for every call
        _same(G.root_candidates(lab, nx, ny, k), G.root_candidates_plain(lab, nx, ny, k))
    assert G.LAUNCHES["root_candidates"] == 2


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("case", ["sparse", "every-root"])
def test_root_candidates_of_an_unaligned_view(cuda, case, offset):
    """Labels that start off a 16-byte boundary take the 4-byte loads."""
    lab_np, nx, ny = _root_labels(case, seed=offset)
    buf = torch.zeros(lab_np.size + 4, dtype=torch.int32, device=cuda)
    lab = buf[offset:offset + lab_np.size].view(lab_np.shape)
    lab.copy_(torch.as_tensor(lab_np))
    assert lab.data_ptr() % 16 == 4 * offset
    for k in (8, 64):
        _same(G.root_candidates(lab, nx, ny, k), G.root_candidates_plain(lab, nx, ny, k))


def _stretch_labels(n, pool, seed, background=0.4):
    """n labels in flat order: stretches of 1 to 400 equal values drawn from
    `pool` or the sentinel, laid without regard to where lines end."""
    rng = np.random.default_rng(seed)
    lengths = np.where(rng.random(n // 8 + 2) < 0.7, rng.integers(1, 40, n // 8 + 2), rng.integers(40, 400, n // 8 + 2))
    lengths = lengths[: int(np.searchsorted(np.cumsum(lengths), n)) + 1]
    values = np.where(rng.random(lengths.size) < background, G.BIG, rng.choice(pool, lengths.size))
    return np.repeat(values, lengths)[:n].astype(np.int32)


def _stats_roots(num_roots, seed):
    """(pool of label values, roots): unsorted, one repeated, the sentinel in
    the middle, a third of them absent from the pool."""
    rng = np.random.default_rng(seed)
    pool = rng.permutation(3 * num_roots + 8)[: num_roots + 4].astype(np.int32)
    roots = np.concatenate([pool[: 2 * num_roots // 3 + 1], 4 * num_roots + 16 + np.arange(num_roots, dtype=np.int32)])
    roots = rng.permutation(roots[:num_roots])
    if num_roots > 2:
        roots[num_roots // 2] = G.BIG
        roots[-1] = roots[0]
    return pool, roots.astype(np.int32)


def _component_stats_pair(order, flat, roots, shape):
    nx, ny, nz = shape
    if order == "xyz":
        return G.component_stats_xyz(flat, roots, nx, ny, nz), G.component_stats_xyz_plain(flat, roots, nx, ny, nz)
    return G.component_stats_raster(flat, roots, nx, ny), G.component_stats_raster_plain(flat, roots, nx, ny)


@pytest.mark.parametrize("num_roots", [1, 128, 1024, 4096, 7168])
@pytest.mark.parametrize("line", [1, 3, 31, 33, 128, 513])
@pytest.mark.parametrize("order", ["xyz", "raster"])
def test_component_stats_equals_twin(cuda, order, line, num_roots):
    """Lines (z for xyz, x for raster) shorter than, at and past a warp's
    128-label segment, at every table size; the labels' stretches cross the
    ends of lines."""
    rows = (12, 20) if line >= 128 else (64, 60)
    shape = (*rows, line) if order == "xyz" else (line, *rows[::-1])
    pool, roots = _stats_roots(num_roots, seed=line + num_roots)
    flat = torch.as_tensor(_stretch_labels(int(np.prod(shape)), pool, seed=line)).to(cuda)
    roots = torch.as_tensor(roots).to(cuda)
    G.reset_launch_counts()
    got, want = _component_stats_pair(order, flat, roots, shape)
    _same(got, want)
    assert G.LAUNCHES[f"component_stats_{order}"] == 1
    assert float(got[:, 0].max()) > 0
    assert torch.equal(got[-1], got[0])  # the repeated root


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("order", ["xyz", "raster"])
def test_component_stats_of_an_unaligned_view(cuda, order, offset):
    """Flat labels that start off a 16-byte boundary take the 4-byte loads."""
    shape = (9, 10, 260) if order == "xyz" else (260, 10, 9)
    n = int(np.prod(shape))
    pool, roots = _stats_roots(64, seed=offset)
    buf = torch.zeros(n + 4, dtype=torch.int32, device=cuda)
    flat = buf[offset:offset + n]
    flat.copy_(torch.as_tensor(_stretch_labels(n, pool, seed=offset)))
    assert flat.data_ptr() % 16 == 4 * offset
    _same(*_component_stats_pair(order, flat, torch.as_tensor(roots).to(cuda), shape))


@pytest.mark.parametrize("order", ["xyz", "raster"])
def test_component_stats_of_one_component(cuda, order):
    """512x512x192 filled by one label: every update lands on one row, and
    every sum passes 2^32."""
    shape = (512, 512, 192)
    flat = torch.full((int(np.prod(shape)),), 77, dtype=torch.int32, device=cuda)
    roots = torch.tensor([G.BIG, 3, 77, 77, 500], dtype=torch.int32, device=cuda)
    got, want = _component_stats_pair(order, flat, roots, shape)
    _same(got, want)
    assert float(got[2, 1:].min()) > 2**32 and float(got[2, 0]) == 512 * 512 * 192 and float(got[0].max()) == 0.0


def test_component_stats_called_again(cuda):
    """Nothing of one call is left for the next: the same call twice, then
    another table size, then the first again."""
    shape = (16, 24, 200)
    n = int(np.prod(shape))
    cases = []
    for num_roots in (128, 4096, 1):
        pool, roots = _stats_roots(num_roots, seed=num_roots)
        cases.append((torch.as_tensor(_stretch_labels(n, pool, seed=num_roots)).to(cuda), torch.as_tensor(roots).to(cuda)))
    for i in (0, 0, 1, 0, 2, 1):
        for order in ("xyz", "raster"):
            _same(*_component_stats_pair(order, *cases[i], shape))


def _run_tables(shape, num_roots, kind, seed):
    """(labels, lengths, z0, roots) of a dense (nxp, k, nyq) run table."""
    rng = np.random.default_rng(seed)
    roots = np.unique(rng.integers(0, 4 * num_roots + 8, num_roots)).astype(np.int32)
    roots = np.concatenate([roots, np.full(num_roots - roots.size, G.BIG, np.int32)])
    if num_roots > 2:
        roots[1] = roots[0]  # a repeated root reads its first row
    m = int(np.prod(shape))
    lab = np.repeat(rng.integers(0, 4 * num_roots + 8, m // 3 + 1), 3)[:m].astype(np.int32)
    lens = rng.integers(1, 3000, m).astype(np.int32)
    if kind == "sparse":
        lens[rng.random(m) < 0.98] = 0
    elif kind == "empty":
        lens[:] = 0
    elif kind == "body":  # one component through every line
        lab[:] = roots[0]
        lens[:] = 32000
    lab[lens == 0] = G.BIG
    z0 = np.where(lens > 0, rng.integers(0, 700, m), 0).astype(np.int32)
    return tuple(a.reshape(shape) for a in (lab, lens, z0)) + (roots,)


@pytest.mark.parametrize("kind", ["sparse", "mixed", "empty", "body"])
@pytest.mark.parametrize("k,num_roots", [(8, 1), (8, 128), (16, 256), (8, 4096), (16, 6000)])
def test_run_stats_equals_twin(cuda, k, num_roots, kind):
    """Dense tables at both run depths, compacted ones at both caps; roots
    kept in shared memory (<= 4096) and searched in global memory (6000)."""
    lab, lens, z0, roots = (torch.as_tensor(a).to(cuda) for a in _run_tables((40, k, 256), num_roots, kind, seed=k + num_roots))
    G.reset_launch_counts()
    for _ in range(2):  # and again: nothing is left of the first call
        _same(G.run_stats(lab, lens, z0, roots), G.run_stats_plain(lab, lens, z0, roots))
    for cap in (32768, 131072):
        cols = S.compact_runs(lab, lens, z0, cap)[:5]
        assert cols[0].numel() == cap
        _same(G.run_stats_compact(*cols, roots), G.run_stats_compact_plain(*cols, roots))
    odd = [c[1:] for c in cols]  # columns that start off a 16-byte boundary
    _same(G.run_stats_compact(*odd, roots), G.run_stats_compact_plain(*odd, roots))
    assert G.LAUNCHES["run_stats"] == 2 and G.LAUNCHES["run_stats_compact"] == 3


def test_stats_large_sums_and_many_roots(cuda):
    """A body whose coordinate sums pass 2^24 beside 960 single-voxel roots."""
    shape = (160, 160, 96)
    nx, ny, nz = shape
    lab = torch.full(shape, G.BIG, dtype=torch.int32, device=cuda)
    lab[8:, 8:, :] = 8 * nx + 8
    i = torch.arange(64, device=cuda).repeat_interleave(64)
    j = torch.arange(64, device=cuda).repeat(64)
    keep = (i < 8) | (j < 8)
    lab[i[keep], j[keep], 0] = (j[keep] * nx + i[keep]).to(torch.int32)
    roots = torch.unique(lab[lab != G.BIG]).to(torch.int32)
    flat = lab.reshape(-1)
    got = G.component_stats_xyz(flat, roots, *shape)
    _same(got, G.component_stats_xyz_plain(flat, roots, *shape))
    assert float(got[:, 1].max()) > 2**24


def test_nonfused_segment_volume_cuda_equals_cpu(cuda):
    data = _volume((80, 80, 80), seed=6)
    params = S.SegmentationParams(closing_radius=1, max_sweeps=2, passes=3, max_roots=128)
    spacing, origin = np.ones(3, np.float32), np.zeros(3, np.float32)
    G.reset_launch_counts()
    on_card = S.segment_volume(torch.as_tensor(data).to(cuda), spacing, origin, params)
    on_cpu = S.segment_volume(torch.as_tensor(data), spacing, origin, params)
    for name, a, b in zip(on_cpu._fields, on_card, on_cpu):
        assert torch.equal(a.cpu(), b), name
    assert G.LAUNCHES["component_stats_xyz"] == 1 and G.LAUNCHES["close_init"] == 0


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
                 "run_stats_plain", "run_stats_compact_plain", "scan_lines_plain", "root_candidates_plain",
                 "component_stats_xyz_plain", "component_stats_raster_plain"):
        monkeypatch.setattr(G, name, refuse)
    data = torch.as_tensor(_volume((40, 40, 40), seed=4)).to(cuda)
    S.segment_volume(data, np.ones(3, np.float32), np.zeros(3, np.float32), S.SegmentationParams(max_roots=512))
    S.segment_volume(data, np.ones(3, np.float32), np.zeros(3, np.float32), S.SegmentationParams(closing_radius=3))
    lab = S.connected_components(data > 65.0, max_sweeps=4)
    G.extract_root_candidates(S._pad_for_kernels(lab, (lab == G.BIG).to(torch.int8))[0], 40, 40)
    G.ccl_sweep_pallas(lab, (lab == G.BIG).to(torch.int32))
    G.component_stats_matmul(lab.permute(2, 1, 0).contiguous().reshape(-1), lab.reshape(-1)[:8].contiguous(), 40, 40)
    torch.cuda.synchronize()


def test_engine_fetch_and_host_syncs(cuda):
    """The engine's `_fetch` on the card equals the per-key `.cpu().numpy()`
    dict (keys, dtypes, shapes, values) and hands out arrays of their own;
    a warm `estimate_pose` under the sync debug mode reports no synchronizing
    call from `api/engine.py`."""
    import warnings

    from mamri_tpu_torch.api import engine as E
    from mamri_tpu_torch.core import transforms as T
    from mamri_tpu_torch.core.robot import load_robot_model, marker_world_positions

    eng = E.MamriEngine(device=cuda, ik_restarts=0)
    truth = torch.tensor([0.3, -0.7, 0.5, 0.2, -0.4, 0.6])
    base = T.translate(torch.tensor([-60.0, -120.0, 0.0])) @ T.rot_x(-np.pi / 2) @ T.rot_z(0.15)
    model_cpu = load_robot_model(device="cpu")
    pts = torch.cat([marker_world_positions(model_cpu, truth, ln, base) for ln in E.MARKER_LINKS]).numpy()
    lo, hi = pts.min(0) - 30, pts.max(0) + 30
    origin = np.array([-hi[0], -hi[1], lo[2]], np.float32)
    shape = tuple(int(np.ceil(x)) for x in (hi - lo) / 3.0)
    vol = synthetic_volume(shape=shape, spacing=(3.0, 3.0, 3.0), origin=origin, fiducials_ras=pts, fiducial_radius_mm=4.0)
    args = (torch.as_tensor(vol.data).to(cuda), torch.tensor(vol.spacing, device=cuda), torch.tensor(origin, device=cuda),
            torch.eye(4, device=cuda), *(torch.tensor(False, device=cuda) for _ in range(3)), torch.zeros(6, device=cuda))
    dev_out = eng._get_pipeline(vol.shape)(*args)
    got = eng._fetch(dev_out)
    want = {k: v.cpu().numpy() for k, v in dev_out.items()}
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].base is None, k  # copied out of the pinned buffer
    assert eng.estimate_pose(vol).success
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            assert eng.estimate_pose(vol).success
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [f"{w.filename}:{w.lineno}" for w in caught if "synchroniz" in str(w.message)]
    assert not [s for s in syncs if "api/engine.py" in s.replace("\\", "/")], syncs


@pytest.mark.parametrize("dtype", [np.int16, np.float32])
def test_upload_of_a_strided_window_is_staged_before_it_returns(cuda, dtype):
    """The engine's upload of a ROI window (a strided view of the host frame,
    as `PoseTracker._crop_roi` makes it) holds the frame's values even when
    the host frame is overwritten as soon as `_upload` returns."""
    from mamri_tpu_torch.api import engine as E

    eng = E.MamriEngine(device=cuda, ik_restarts=0)
    frame = np.random.default_rng(7).integers(0, 2000, size=(300, 280, 96)).astype(dtype)
    window = frame[13:213, 40:240, 8:88]
    want = window.copy()
    got = eng._upload(window)
    frame[...] = 0
    torch.cuda.synchronize()
    assert got.dtype == torch.from_numpy(want).dtype and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.parametrize("k", [32, 64, 128])
def test_global_matcher_cuda_equals_cpu(cuda, k):
    """The global matcher on the card against the CPU: the four triplets
    (and a tied twin of the last) among stray blobs, every slot valid."""
    from mamri_tpu_torch.registration.lshape import match_l_shaped_triplets_global

    arms = [(40.0, 20.0), (70.0, 25.0), (70.0, 20.0), (45.0, 20.0)]
    rng = np.random.default_rng(k)
    pts = rng.uniform(-400, 400, (k, 3)).astype(np.float32)
    tris = [np.array([[0, 0, 0], [0, b, 0], [a, 0, 0]], np.float32) + np.float32(rng.integers(-150, 150, 3))
            for a, b in arms]
    tris.append(tris[-1] + np.float32([0, 300, 0]))
    pts[rng.permutation(k)[:15]] = np.concatenate(tris)
    valid = torch.ones(k, dtype=torch.bool)
    want = match_l_shaped_triplets_global(torch.as_tensor(pts), valid, arms)
    got = match_l_shaped_triplets_global(torch.as_tensor(pts).to(cuda), valid.to(cuda), arms)
    assert bool(want.found.all())
    assert torch.equal(got.found.cpu(), want.found) and torch.equal(got.member_ids.cpu(), want.member_ids)
    assert float((got.points.cpu() - want.points).abs().max()) <= 1e-4


def test_engine_fk_methods_cuda_equal_cpu(cuda):
    """`link_world_transforms`, `needle_tcp` and the path FK of the
    trajectory export on the card against a CPU engine with the same
    state, within 1e-4 mm."""
    from mamri_tpu_torch.api.engine import MamriEngine

    engines = [MamriEngine(device=cuda), MamriEngine(device="cpu")]
    base = np.eye(4, dtype=np.float32)
    base[:3, 3] = [-60.0, -120.0, 5.0]
    path = np.linspace(np.zeros(6), [0.3, -0.7, 0.5, 0.2, -0.4, 0.6], 17).astype(np.float32)
    for eng in engines:
        eng.load_state_from_numpy(baseplate_tf=base, current_angles=path[-1])
        eng.trajectory_path = path
    gpu, cpu = engines
    np.testing.assert_allclose(gpu.link_world_transforms(), cpu.link_world_transforms(), atol=1e-4)
    np.testing.assert_allclose(gpu.needle_tcp(path[3]), cpu.needle_tcp(path[3]), atol=1e-4)
    for a, b in zip(gpu._path_fk(), cpu._path_fk()):
        np.testing.assert_allclose(a, b, atol=1e-4)

"""Each kernel's plain twin (what a CPU tensor runs) against its Pallas
function in interpret mode, exactly, at small shapes and edge cases.

The CUDA kernels themselves are held against these twins on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mamri_tpu.perception import pallas_ops as P
from mamri_tpu.perception import segmentation as jseg
from mamri_tpu_torch.perception import gpu_ops as G
from mamri_tpu_torch.perception import segmentation as tseg
from test_torch_engine import _one_torch_thread  # noqa: F401 (autouse)

BIG = 2**31 - 1


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy() if isinstance(got, torch.Tensor) else got, np.asarray(want))


def _blob_mask(shape, seed, density=0.01):
    rng = np.random.default_rng(seed)
    x, y, z = np.mgrid[: shape[0], : shape[1], : shape[2]]
    mask = np.zeros(shape, bool)
    for _ in range(5):
        c = rng.uniform(0, shape)
        mask |= ((x - c[0]) ** 2 + (y - c[1]) ** 2 + ((z - c[2]) / 3) ** 2) < 12
    mask |= (x > shape[0] - 5) & (z < shape[2] // 3)  # a slab touching the border
    mask |= (y == 5) & (z % 7 < 4)  # a comb: several runs per z line
    mask |= rng.random(shape) < density
    return mask


def _init_labels(mask):
    nx, ny, _ = mask.shape
    i, j, k = np.indices(mask.shape)
    return np.where(mask, k * nx * ny + j * nx + i, BIG).astype(np.int32)


def _line_patterns_mask(shape=(8, 8, 384)):
    """z lines (several 128-voxel chunks each) that are all reset, never
    reset, alternating, reset only at index 0, reset only at index n - 1."""
    reset = np.zeros(shape, bool)
    for i in range(shape[0]):
        for j in range(shape[1]):
            pattern = (i * shape[1] + j) % 5
            if pattern == 0:
                reset[i, j] = True
            elif pattern == 2:
                reset[i, j, ::2] = True
            elif pattern == 3:
                reset[i, j, 0] = True
            elif pattern == 4:
                reset[i, j, -1] = True
    return ~reset


TILE = (16, 16, 128)
MASKS = {
    "blobs": lambda: _blob_mask(TILE, 3),
    "background": lambda: np.zeros(TILE, bool),
    "full": lambda: np.ones(TILE, bool),
    "lines": _line_patterns_mask,
}
# z lengths on both sides of the 32-voxel words close_init packs z into
WORD_EDGE_SHAPES = [(9, 10, 31), (8, 8, 33), (6, 7, 64), (5, 6, 65), (3, 4, 1)]


def _close_data(case, shape, seed=2):
    rng = np.random.default_rng(seed)
    data = (rng.random(shape) * 100).astype(np.float32)
    if case in ("faces", "faces-nan"):  # an in-band body touching all six faces
        data = np.where(rng.random(shape) < 0.5, 100.0, 10.0).astype(np.float32)
        for face in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0], np.s_[:, :, -1]):
            data[face] = 100.0
    if case in ("nan", "faces-nan"):
        data[rng.random(shape) < 0.05] = np.nan
        data[rng.random(shape) < 0.03] = np.inf
        data[rng.random(shape) < 0.03] = -np.inf
        data[(0,) * 3] = np.inf
    elif case == "background":
        data[:] = 10.0
    elif case == "full":
        data[:] = 100.0
    return data


# ----------------------------------------------------------------- close_init
@pytest.mark.parametrize(
    "case,shape",
    [pytest.param(c, (16, 24, 20), id=c) for c in ("random", "nan", "background", "full")]  # off the tiles
    + [pytest.param(c, s, id=f"{c}-{'x'.join(map(str, s))}") for s in WORD_EDGE_SHAPES for c in ("faces", "faces-nan")],
)
def test_close_init_matches_pallas(case, shape):
    data = _close_data(case, shape)
    want_mask, want_lab = P.fused_threshold_close_init(jnp.asarray(data), 65.0, 65535.0, interpret=True)
    mask, lab = G.close_init(_t(data), 65.0, 65535.0)
    assert mask.dtype == torch.int8 and lab.dtype == torch.int32
    _eq(mask, want_mask)
    _eq(lab, want_lab)


# --------------------------------------------------------------- reset + CCL
@pytest.fixture(scope="module", params=list(MASKS))
def ccl_case(request):
    mask = MASKS[request.param]()
    reset = (~mask).astype(np.int8)
    jd = P.compute_reset_distances(jnp.asarray(reset), interpret=True)
    return mask, reset, jd


def test_reset_distances_match_pallas(ccl_case):
    _, reset, jd = ccl_case
    td = G.compute_reset_distances(_t(reset))
    for got, want in zip(td, jd):
        assert got.dtype == torch.int16
        _eq(got, want)


def test_sweeps_and_checks_match_pallas(ccl_case):
    mask, reset, jd = ccl_case
    td = G.compute_reset_distances(_t(reset))
    jlab = jnp.asarray(_init_labels(mask))
    tlab = _t(_init_labels(mask))
    for step in range(3):  # [yz, x] twice, then the fused final yz + check
        if step < 2:
            jlab, jchg = P.ccl_half_sweep_yz(jlab, jd, interpret=True)
            tlab, tchg = G.ccl_half_sweep_yz(tlab, td)
            _eq(tlab, jlab)
            assert int(tchg[0]) == int(jchg)
            _eq(G.ccl_check_consistency(tlab, td)[0], P.ccl_check_consistency(jlab, jd, interpret=True))
            jlab, jchg = P.ccl_half_sweep_x(jlab, jd, interpret=True)
            tlab, tchg = G.ccl_half_sweep_x(tlab, td)
            _eq(tlab, jlab)
            assert int(tchg[0]) == int(jchg)
            _eq(G.ccl_check_consistency_x(tlab, td)[0], P.ccl_check_consistency_x(jlab, jd, interpret=True))
        else:
            jlab, jbad = P.ccl_half_sweep_yz(jlab, jd, interpret=True, with_check=True)
            tlab, tbad = G.ccl_half_sweep_yz(tlab, td, with_check=True)
            _eq(tlab, jlab)
            assert int(tbad[0]) == int(jbad)


def test_full_sweep_converges_to_the_jnp_fixed_point():
    mask = _blob_mask(TILE, 4, density=0.03)
    lab0 = _init_labels(mask)
    ref, conv = jseg._ccl_sweeps_jnp(jnp.asarray(lab0), jnp.asarray(~mask), 8)
    assert bool(conv)
    td = G.compute_reset_distances(_t((~mask).astype(np.int8)))
    lab, converged = tseg._ccl_sweeps_from_dists(_t(lab0), td, max_sweeps=8)
    assert bool(converged)
    _eq(lab, ref)


# run lengths on both sides of a warp's 32 rows, of a 128-voxel chunk and of
# the segments a block splits a line into
RUN_LENGTHS = (31, 32, 33, 255, 257, 384)
LINE_SHAPES = {0: (384, 8, 128), 1: (8, 384, 128), 2: (8, 8, 384)}


def _planted_lines(axis, pattern):
    """(labels, reset) over lines of 384 along `axis`. `spans`: one run per
    line, its length from RUN_LENGTHS, its offset moving from line to line,
    its minimum planted at the first, the last or an interior voxel.
    `one-run`: the whole line is one run. `alternating`: 1-voxel runs."""
    shape = LINE_SHAPES[axis]
    rng = np.random.default_rng(axis)
    lines = int(np.prod(shape)) // 384
    fg = np.zeros((lines, 384), bool)
    lab = rng.integers(1 << 20, 1 << 21, (lines, 384)).astype(np.int32)
    for n in range(lines):
        if pattern == "alternating":
            fg[n, n % 2::2] = True
            continue
        length = 384 if pattern == "one-run" else RUN_LENGTHS[n % 6]
        start = (n // 6 * 7) % (384 - length + 1)
        fg[n, start:start + length] = True
        lab[n, start + (0, length - 1, length // 3)[(n // 6) % 3]] = n
    lab[~fg] = BIG
    to_volume = lambda a: np.ascontiguousarray(np.moveaxis(a.reshape(*np.delete(shape, axis), 384), -1, axis))
    return to_volume(lab), to_volume(~fg).astype(np.int8)


@pytest.mark.parametrize("pattern", ["spans", "one-run", "alternating"])
@pytest.mark.parametrize("axis", [0, 1, 2], ids=["x", "y", "z"])
def test_run_min_lines_match_pallas(axis, pattern):
    lab, reset = _planted_lines(axis, pattern)
    jd = P.compute_reset_distances(jnp.asarray(reset), interpret=True)
    td = G.compute_reset_distances(_t(reset))
    if axis == 0:
        want, want_chg = P.ccl_half_sweep_x(jnp.asarray(lab), jd, interpret=True)
        got, chg = G.ccl_half_sweep_x(_t(lab.copy()), td)  # in place: not on jax's input
    else:
        want, want_chg = P.ccl_half_sweep_yz(jnp.asarray(lab), jd, interpret=True)
        got, chg = G.ccl_half_sweep_yz(_t(lab.copy()), td)
    _eq(got, want)
    assert int(chg[0]) == int(want_chg) == (pattern != "alternating")
    if pattern != "alternating" and axis == 0:  # (the yz pair also joins runs of neighbouring lines)
        lines = np.moveaxis(got.numpy(), 0, -1).reshape(-1, 384)
        fg = lines != BIG
        assert all((lines[n][fg[n]] == n).all() for n in range(len(lines)))


# --------------------------------------------------------------------- z_runs
def _converged(mask):
    td = G.compute_reset_distances(_t((~mask).astype(np.int8)))
    lab, _ = tseg._ccl_sweeps_from_dists(_t(_init_labels(mask)), td, max_sweeps=8)
    return lab, td


@pytest.mark.parametrize(
    "case,k,cand_k,x_off",
    [
        ("blobs", 8, 8, 0),
        ("blobs", 2, 2, 0),  # lines beyond run_k, blocks beyond cand_k
        ("blobs", 4, 3, 5),  # roots against a shifted global x
        ("background", 4, 8, 0),
        ("full", 4, 8, 0),
    ],
)
def test_z_runs_match_pallas(case, k, cand_k, x_off):
    mask = MASKS[case]()
    lab, td = _converged(mask)
    nx, ny = (TILE[0] + x_off, TILE[1]) if x_off else TILE[:2]
    want = P.extract_z_runs(
        jnp.asarray(lab.numpy()), jnp.asarray(td[4].numpy()), jnp.asarray(td[5].numpy()),
        nx, ny, k=k, cand_k=cand_k, interpret=True, x_off=x_off,
    )
    got = G.z_runs(lab, td[4], td[5], nx, ny, k=k, cand_k=cand_k, x_off=x_off)
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        _eq(g, w)


def test_z_runs_unconverged_labels_match_pallas():
    """Raw initial labels (no sweep): every foreground voxel is its own root."""
    mask = _blob_mask(TILE, 6)
    td = G.compute_reset_distances(_t((~mask).astype(np.int8)))
    lab0 = _init_labels(mask)
    want = P.extract_z_runs(
        jnp.asarray(lab0), jnp.asarray(td[4].numpy()), jnp.asarray(td[5].numpy()),
        TILE[0], TILE[1], k=4, cand_k=16, interpret=True,
    )
    for g, w in zip(G.z_runs(_t(lab0), td[4], td[5], TILE[0], TILE[1], k=4, cand_k=16), want):
        _eq(g, w)


def _z_edge_mask(case):
    mask = np.zeros(TILE, bool)
    if case == "over-k":  # 1-voxel runs: 64 a line
        mask[2:6, 3:9, ::2] = True
    elif case == "touching-ends":  # runs from z = 0, runs to nz - 1, one over the whole line
        mask[1, 2, :5] = True
        mask[1, 4, -7:] = True
        mask[3, 3, :] = True
        mask[9, 9, :1] = True
        mask[9, 11, -1:] = True
    else:  # lone voxels, each its own root: 16 lines of one, one line of four
        mask[::4, ::4, 60] = True
        mask[5, 5, ::32] = True
    return mask


@pytest.mark.parametrize(
    "case,k,cand_k,x_off",
    [("over-k", 4, 8, 0), ("over-k", 8, 2, 3), ("touching-ends", 4, 8, 0), ("touching-ends", 2, 4, 7),
     ("over-cand-k", 8, 4, 0), ("over-cand-k", 2, 16, 5)],
)
def test_z_runs_edge_cases_match_pallas(case, k, cand_k, x_off):
    mask = _z_edge_mask(case)
    gx = TILE[0] + x_off  # the block's labels in a volume that is x_off wider
    i, j, kk = np.indices(TILE)
    lab0 = np.where(mask, kk * gx * TILE[1] + j * gx + i + x_off, BIG).astype(np.int32)
    td = G.compute_reset_distances(_t((~mask).astype(np.int8)))
    lab, _ = tseg._ccl_sweeps_from_dists(_t(lab0), td, max_sweeps=8)
    want = P.extract_z_runs(
        jnp.asarray(lab.numpy()), jnp.asarray(td[4].numpy()), jnp.asarray(td[5].numpy()),
        gx, TILE[1], k=k, cand_k=cand_k, interpret=True, x_off=x_off,
    )
    got = G.z_runs(lab, td[4], td[5], gx, TILE[1], k=k, cand_k=cand_k, x_off=x_off)
    for g, w in zip(got, want):
        _eq(g, w)
    num_components, max_runs = int(got[5]), int(got[6])
    if case == "over-k":
        assert max_runs == 64 > k
    elif case == "touching-ends":
        assert max_runs == 1 and num_components == 5
    else:
        assert num_components == 16 + min(4, k)  # line (5, 5) has 4 runs
        assert int(got[4][0]) == 8 + min(4, k)  # the first of the two x blocks
        assert (int(got[4][0]) > cand_k) == (cand_k == 4)


# ------------------------------------------------------------------ run_stats
def _assert_stats(got, want):
    """Exact where the f32 sums are exact (below 2^24), else rtol 1e-5: the
    port sums in int64, the Pallas kernel accumulates in f32."""
    got, want = got.numpy(), np.asarray(want)
    small = np.abs(want) < 2**24
    np.testing.assert_array_equal(got[small], want[small])
    np.testing.assert_allclose(got[~small], want[~small], rtol=1e-5)


def test_run_stats_dense_and_compact_match_pallas():
    mask = _blob_mask(TILE, 7, density=0.02)
    lab, td = _converged(mask)
    run_lab, run_z0, run_len, cands = G.z_runs(lab, td[4], td[5], TILE[0], TILE[1], k=8, cand_k=32)[:4]
    roots = torch.topk(cands, 48, largest=False).values.contiguous()
    assert int((roots != BIG).sum()) > 5
    jtabs = [jnp.asarray(a.numpy()) for a in (run_lab, run_len, run_z0)]
    want = P.run_stats_matmul(*jtabs, jnp.asarray(roots.numpy()), interpret=True)
    _assert_stats(G.run_stats(run_lab, run_len, run_z0, roots), want)

    jcols = jseg.compact_runs(jtabs[0], jtabs[1], jtabs[2], 512)
    tcols = tseg.compact_runs(run_lab, run_len, run_z0, 512)
    for g, w in zip(tcols, jcols):
        _eq(g, w)
    want = P.run_stats_matmul_compact(*jcols[:5], jnp.asarray(roots.numpy()), interpret=True)
    _assert_stats(G.run_stats_compact(*tcols[:5], roots), want)


def _run_table_case(case):
    """(labels, lengths, z0, roots) of a dense (8, 4, 128) run table."""
    shape = (8, 4, 128)
    rng = np.random.default_rng(len(case))
    roots = np.array([3, 8, 8, 21, 300, BIG, BIG, BIG], np.int32)
    labels = rng.choice(np.array([3, 8, 21, 55, 300], np.int32), size=shape)
    lens = rng.integers(1, 60, shape).astype(np.int32)
    z0 = rng.integers(0, 60, shape).astype(np.int32)
    if case == "empty":
        labels[:], lens[:], z0[:] = BIG, 0, 0
    elif case == "full":  # every line of a 128-deep volume is one run of one component
        labels[:], lens[:], z0[:] = 3, 128, 0
    elif case == "single-root":
        roots = np.array([21], np.int32)
    elif case == "roots-all-sentinel":
        roots = np.full(8, BIG, np.int32)
    return labels, lens, z0, roots


def _int64_run_stats(labels, lens, z0, gi, gj, roots):
    """The exact sums, in numpy int64."""
    n = lens.reshape(-1).astype(np.int64)
    feats = np.stack([n, gi.reshape(-1) * n, gj.reshape(-1) * n, z0.reshape(-1) * n + n * (n - 1) // 2], axis=1)
    hit = (labels.reshape(-1)[None, :] == roots[:, None]) & (n > 0)[None, :]
    return np.stack([feats[h].sum(0) for h in hit])


@pytest.mark.parametrize("table", ["dense", "compact"])
@pytest.mark.parametrize("case", ["empty", "full", "single-root", "roots-all-sentinel"])
def test_run_stats_edge_cases_match_pallas(case, table):
    labels, lens, z0, roots = _run_table_case(case)
    if table == "dense":
        p = np.arange(labels.size, dtype=np.int64)
        gi, gj = p // (4 * 128), p % 128
        want = P.run_stats_matmul(*(jnp.asarray(a) for a in (labels, lens, z0, roots)), interpret=True)
        got = G.run_stats(_t(labels), _t(lens), _t(z0), _t(roots))
    else:
        jcols = jseg.compact_runs(*(jnp.asarray(a) for a in (labels, lens, z0)), 4096)[:5]
        cols = tseg.compact_runs(_t(labels), _t(lens), _t(z0), 4096)[:5]
        for g, w in zip(cols, jcols):
            _eq(g, w)
        labels, lens, z0, gi, gj = (c.numpy() for c in cols)
        gi, gj = gi.astype(np.int64), gj.astype(np.int64)
        want = P.run_stats_matmul_compact(*jcols, jnp.asarray(roots), interpret=True)
        got = G.run_stats_compact(*cols, _t(roots))
    exact = _int64_run_stats(labels, lens, z0, gi, gj, roots)
    _eq(got, exact.astype(np.float32))  # f32 of the exact integer, whatever its size
    _assert_stats(got, want)
    assert (exact.max() > 2**24) == (case == "full")
    assert (exact.max() == 0) == (case in ("empty", "roots-all-sentinel"))


def test_compact_runs_overflowing_cap_matches_jax():
    mask = _blob_mask(TILE, 8, density=0.05)
    lab, td = _converged(mask)
    run_lab, run_z0, run_len = G.z_runs(lab, td[4], td[5], TILE[0], TILE[1], k=8, cand_k=8)[:3]
    j = jseg.compact_runs(*(jnp.asarray(a.numpy()) for a in (run_lab, run_len, run_z0)), 64)
    t = tseg.compact_runs(run_lab, run_len, run_z0, 64)
    assert int(t[5]) > 64
    for g, w in zip(t, j):
        _eq(g, w)


def test_run_stats_large_sums_and_repeated_roots():
    """Synthetic tables with sums far above 2^24 and a repeated root."""
    rng = np.random.default_rng(9)
    shape = (8, 4, 128)
    labels = rng.choice(np.array([5, 9, 40, 77, BIG], np.int32), size=shape)
    lens = np.where(labels == BIG, 0, rng.integers(1, 3000, shape)).astype(np.int32)
    z0 = np.where(labels == BIG, 0, rng.integers(0, 20000, shape)).astype(np.int32)
    roots = np.array([5, 9, 9, 40, 77, 1000, BIG, BIG], np.int32)
    want = P.run_stats_matmul(*(jnp.asarray(a) for a in (labels, lens, z0, roots)), interpret=True)
    got = G.run_stats(_t(labels), _t(lens), _t(z0), _t(roots))
    assert (np.abs(np.asarray(want)) >= 2**24).any()
    _assert_stats(got, want)
    np.testing.assert_array_equal(got[1].numpy(), got[2].numpy())


# ------------------------------------------------------------ wrapper contract
def test_wrappers_check_their_inputs():
    with pytest.raises(TypeError):
        G.close_init(torch.zeros((4, 4, 4), dtype=torch.float64), 1.0, 2.0)
    with pytest.raises(ValueError, match="multiples"):
        G.z_runs(torch.zeros((8, 8, 100), dtype=torch.int32), torch.zeros((8, 8, 100), dtype=torch.int16),
                 torch.zeros((8, 8, 100), dtype=torch.int16), 8, 8)
    with pytest.raises(ValueError, match="contiguous"):
        G.reset_distances(torch.zeros((8, 8, 8), dtype=torch.int8).transpose(0, 2), 0)
    with pytest.raises(ValueError, match="unsupported device"):
        G.reset_distances(torch.zeros((8, 8, 8), dtype=torch.int8, device="meta"), 0)


def test_cpu_tensors_never_launch():
    G.reset_launch_counts()
    mask = _blob_mask(TILE, 10)
    data = np.where(mask, 100.0, 10.0).astype(np.float32)
    tseg.segment_volume(_t(data), np.ones(3, np.float32), np.zeros(3, np.float32))
    assert all(v == 0 for v in G.LAUNCHES.values()), G.LAUNCHES

"""The twins of the four kernels of the non-fused branch and the parity
harness against their Pallas functions in interpret mode (and the jnp
`_reference` functions), on numpy-seeded inputs.

Tolerances: scan lines, sweeps and root candidates exact. Stats exact where
the reference's f32 sums are exact (every entry below 2^24), rtol 2e-6
(mamri_tpu/perception/parity.py's own) above: the port sums in int64 and
rounds once, the Pallas kernels accumulate in f32. Rows whose root is the
sentinel are compared to zero in the port, never to the reference, whose
sentinel rows count background and padding.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mamri_tpu.perception import pallas_ops as P
from mamri_tpu.perception import segmentation as jseg
from mamri_tpu_torch.perception import gpu_ops as G
from test_torch_engine import _one_torch_thread  # noqa: F401 (autouse)

BIG = 2**31 - 1


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy() if isinstance(got, torch.Tensor) else got, np.asarray(want))


def _blob_mask(shape, seed, n_blobs=5, density=0.01):
    rng = np.random.default_rng(seed)
    x, y, z = np.mgrid[: shape[0], : shape[1], : shape[2]]
    mask = np.zeros(shape, bool)
    for _ in range(n_blobs):
        c = rng.uniform(0, shape)
        mask |= ((x - c[0]) ** 2 + (y - c[1]) ** 2 + ((z - c[2]) / 2) ** 2) < 10
    mask |= (x > shape[0] - 4) & (z < shape[2] // 3)  # a slab touching the border
    mask |= rng.random(shape) < density
    return mask


def _converged_labels(mask, sweeps=8):
    lab, conv = jseg._ccl_sweeps_jnp(jseg._init_labels(jnp.asarray(mask)), jnp.asarray(~mask), sweeps)
    assert bool(conv)
    return np.asarray(lab)


# ----------------------------------------------------------------- scan_lines
def _scan_case(case, shape, seed):
    rng = np.random.default_rng(seed)
    if case == "background":
        return np.full(shape, BIG, np.int32), np.ones(shape, np.int32)
    if case == "foreground":
        return (np.arange(shape[1], dtype=np.int32)[None, :] + 5 + np.zeros(shape, np.int32)), np.zeros(shape, np.int32)
    mask = rng.random(shape) > 0.5
    lab = rng.integers(0, 1 << 24, shape).astype(np.int32)
    if case == "masked":  # the CCL callers: background holds the sentinel
        lab = np.where(mask, lab, BIG).astype(np.int32)
    return lab, (~mask).astype(np.int32)  # "mixed": reset cells carry values too


@pytest.mark.parametrize("case", ["masked", "mixed", "background", "foreground"])
@pytest.mark.parametrize("shape", [(16, 128), (8, 256), (24, 165), (5, 37)])
def test_scan_lines_matches_pallas(case, shape):
    lab, reset = _scan_case(case, shape, seed=shape[1])
    want = P.segmented_min_scan_lines(jnp.asarray(lab), jnp.asarray(reset), block_lines=8, interpret=True)
    np.testing.assert_array_equal(np.asarray(want),
                                  np.asarray(P.segmented_min_scan_lines_reference(jnp.asarray(lab), jnp.asarray(reset))))
    got = G.segmented_min_scan_lines(_t(lab), _t(reset))
    assert got.dtype == torch.int32
    _eq(got, want)


def test_ccl_sweep_pallas_matches_pallas():
    shape = (24, 16, 40)
    mask = _blob_mask(shape, 2)
    reset = (~mask).astype(np.int32)
    jlab = jseg._init_labels(jnp.asarray(mask))
    tlab = _t(np.asarray(jlab))
    for _ in range(3):
        jlab = P.ccl_sweep_pallas(jlab, jnp.asarray(reset), interpret=True)
        tlab = G.ccl_sweep_pallas(tlab, _t(reset))
        _eq(tlab, jlab)
    assert tlab.is_contiguous()


# ------------------------------------------------------------ root_candidates
def _roots_case(case):
    """(padded labels, nx, ny) of one root_candidates case."""
    if case == "blobs":  # (20, 12, 40) padded with the sentinel to (24, 16, 40); 20 lone voxels at x = 9
        nx, ny, nz = 20, 12, 40
        mask = _blob_mask((nx, ny, nz), 4, n_blobs=6, density=0.0)
        mask[8:11, 0:3, :] = False
        mask[9, 1, ::2] = True
        lab = np.full((24, 16, nz), BIG, np.int32)
        lab[:nx, :ny] = _converged_labels(mask)
        return lab, nx, ny
    if case == "every-root":  # close_init's labels of a volume all in band
        nx, ny, nz = 14, 9, 12
        i, j, k = np.indices((nx, ny, nz))
        lab = np.full((16, 16, nz), BIG, np.int32)
        lab[:nx, :ny] = k * nx * ny + j * nx + i
        return lab, nx, ny
    if case == "all-sentinel":
        return np.full((16, 8, 128), BIG, np.int32), 16, 8
    shape = {"nzp-odd": (16, 8, 37), "one-slab": (8, 10, 40)}[case]
    return _converged_labels(_blob_mask(shape, len(case), n_blobs=3)), shape[0], shape[1]


@pytest.mark.parametrize(
    "case,k",
    [("blobs", 8), ("blobs", 16), ("blobs", 1), ("blobs", 64), ("every-root", 8), ("nzp-odd", 8),
     ("one-slab", 16), ("all-sentinel", 8)],
    ids=["8", "16", "k1", "k64", "every-root", "nzp-odd", "one-slab", "all-sentinel"],
)
def test_extract_root_candidates_matches_pallas(case, k):
    """The twin against the Pallas kernel in interpret mode: blob labels in
    which a slab overflows k, every voxel a root, a z length that is not a
    multiple of 4, a single slab, no root at all."""
    lab, nx, ny = _roots_case(case)
    want = P.extract_root_candidates(jnp.asarray(lab), nx, ny, k=k, interpret=True)
    got = G.extract_root_candidates(_t(lab), nx, ny, k=k)
    most = int(np.asarray(want[1]).max())  # the most roots in a slab
    if case == "blobs":
        assert most > 16  # a slab overflows k
    elif case in ("every-root", "all-sentinel"):
        assert most == (8 * 9 * 12 if case == "every-root" else 0)
    for g, w in zip(got, want):
        _eq(g, w)


# ------------------------------------------------------------ component_stats
def _assert_stats(got, want, roots):
    got, want = got.numpy(), np.asarray(want)
    valid = roots != BIG
    assert (got[~valid] == 0).all()
    got, want = got[valid], want[valid]
    small = np.abs(want) < 2**24
    np.testing.assert_array_equal(got[small], want[small])
    np.testing.assert_allclose(got[~small], want[~small], rtol=2e-6)


def _stats_inputs(shape, seed):
    """Converged labels of a blob scene and its roots, in ascending order
    with one root repeated, one absent value, and the sentinel padding."""
    lab = _converged_labels(_blob_mask(shape, seed))
    nx, ny, _ = shape
    flat_r = lab.transpose(2, 1, 0).reshape(-1)
    lin = np.arange(flat_r.size)
    roots = np.sort(lin[(flat_r == lin) & (flat_r != BIG)])
    assert roots.size > 4
    roots = np.concatenate([roots[:1], roots, [roots[-1] + 1], np.full(5, BIG)]).astype(np.int32)
    return lab, roots


@pytest.mark.parametrize("shape", [(24, 20, 16), (300, 4, 8)])  # the second is JAX's f32 branch
def test_component_stats_xyz_matches_pallas(shape):
    lab, roots = _stats_inputs(shape, seed=shape[0])
    flat = lab.reshape(-1)
    args = (jnp.asarray(flat), jnp.asarray(roots), *shape)
    got = G.component_stats_matmul_xyz(_t(flat), _t(roots), *shape)
    _assert_stats(got, P.component_stats_matmul_xyz(*args, interpret=True), roots)
    _assert_stats(got, P.component_stats_matmul_xyz_reference(*args), roots)
    _eq(got[0], got[1])  # the repeated root gets its value's stats in both rows


@pytest.mark.parametrize("shape", [(24, 20, 16), (300, 4, 8)])
def test_component_stats_raster_matches_pallas(shape):
    lab, roots = _stats_inputs(shape, seed=shape[0] + 1)
    flat = lab.transpose(2, 1, 0).reshape(-1).copy()
    args = (jnp.asarray(flat), jnp.asarray(roots), shape[0], shape[1])
    got = G.component_stats_matmul(_t(flat), _t(roots), shape[0], shape[1])
    _assert_stats(got, P.component_stats_matmul(*args, interpret=True), roots)
    _assert_stats(got, P.component_stats_matmul_reference(*args), roots)


def _stats_edge_case(case, order):
    """(flat labels in `order`'s flat order, roots, (nx, ny, nz)). The cases a
    per-line, per-stretch sum can get wrong: a label that runs over the end
    of a line, roots in any order, sizes off every power of two."""
    shape = (5, 7, 3) if case == "odd-size" else (6, 5, 40)
    nx, ny, nz = shape
    line = nz if order == "xyz" else nx  # the flat order's fastest axis
    n = nx * ny * nz
    flat = np.full(n, BIG, np.int32)
    if case == "line-ends":
        flat[3 * line - 2:3 * line + 3] = 11  # over the end of a line
        flat[2 * line * ny - 3:2 * line * ny + 2] = 12  # and over the end of a plane
        flat[5 * line:7 * line] = 13  # two whole lines
        flat[n - 2:] = 14
        roots = np.array([11, 12, 13, 14, BIG, BIG], np.int32)
    elif case == "one-component":
        flat[:] = 0
        roots = np.array([0, 7, BIG], np.int32)
    else:
        rng = np.random.default_rng(len(case))
        lengths = rng.integers(1, 12, n)
        values = np.where(rng.random(n) < 0.4, BIG, rng.integers(0, 30, n))
        flat = np.repeat(values, lengths)[:n].astype(np.int32)
        present = np.unique(flat[flat != BIG])
        roots = {
            "roots-any-order": np.concatenate([present[::-1][:6], [BIG, BIG], present[:3], present[:1], [1000]]),
            "roots-all-sentinel": np.full(8, BIG),
            "single-root": present[2:3],
            "odd-size": present,
        }[case].astype(np.int32)
    return flat, roots, shape


def _int64_stats(flat, roots, shape, order):
    """The exact sums, in numpy int64."""
    nx, ny, nz = shape
    f = np.arange(flat.size, dtype=np.int64)
    ijk = (f // (ny * nz), f // nz % ny, f % nz) if order == "xyz" else (f % nx, f // nx % ny, f // (nx * ny))
    feats = np.stack([np.ones_like(f), *ijk], axis=1)
    return np.stack([feats[flat == r].sum(0) if r != BIG else np.zeros(4, np.int64) for r in roots])


@pytest.mark.parametrize("order", ["xyz", "raster"])
@pytest.mark.parametrize(
    "case", ["line-ends", "roots-any-order", "roots-all-sentinel", "odd-size", "one-component", "single-root"]
)
def test_component_stats_edge_cases_match_pallas(case, order):
    flat, roots, (nx, ny, nz) = _stats_edge_case(case, order)
    if order == "xyz":
        want = P.component_stats_matmul_xyz(jnp.asarray(flat), jnp.asarray(roots), nx, ny, nz, interpret=True)
        got = G.component_stats_matmul_xyz(_t(flat), _t(roots), nx, ny, nz)
    else:
        want = P.component_stats_matmul(jnp.asarray(flat), jnp.asarray(roots), nx, ny, interpret=True)
        got = G.component_stats_matmul(_t(flat), _t(roots), nx, ny)
    exact = _int64_stats(flat, roots, (nx, ny, nz), order)
    assert exact.max() < 2**24  # so the f32 sums of the reference are exact too
    _eq(got, exact.astype(np.float32))
    valid = roots != BIG
    _eq(got[valid], np.asarray(want)[valid])
    if case != "roots-all-sentinel":
        assert exact[:, 0].max() > 0


@pytest.mark.parametrize("order", ["xyz", "raster"])
def test_component_stats_sums_beyond_f32(order):
    """A (128, 128, 64) body whose coordinate sums pass 2^24, plus small
    components: exact below 2^24, rtol 2e-6 above."""
    shape = (128, 128, 64)
    nx, ny, nz = shape
    i, j, k = np.indices(shape)
    raster = (k * nx * ny + j * nx + i).astype(np.int32)
    lab = np.full(shape, BIG, np.int32)
    body = (i >= 4) & (j >= 2)
    lab[body] = raster[4, 2, 0]
    rng = np.random.default_rng(3)
    for c in rng.integers(0, 4, size=(6, 3)) * np.array([1, 1, 16]):
        lab[c[0], c[1], c[2]] = raster[c[0], c[1], c[2]]
    roots = np.unique(lab[lab != BIG])
    roots = np.concatenate([roots, np.full(3, BIG)]).astype(np.int32)
    if order == "xyz":
        flat = lab.reshape(-1)
        args = (jnp.asarray(flat), jnp.asarray(roots), nx, ny, nz)
        got = G.component_stats_matmul_xyz(_t(flat), _t(roots), nx, ny, nz)
        wants = (P.component_stats_matmul_xyz(*args, interpret=True), P.component_stats_matmul_xyz_reference(*args))
    else:
        flat = lab.transpose(2, 1, 0).reshape(-1).copy()
        args = (jnp.asarray(flat), jnp.asarray(roots), nx, ny)
        got = G.component_stats_matmul(_t(flat), _t(roots), nx, ny)
        wants = (P.component_stats_matmul(*args, interpret=True), P.component_stats_matmul_reference(*args))
    assert (np.abs(np.asarray(wants[0])) >= 2**24).any()
    for want in wants:
        _assert_stats(got, want, roots)
    # the port's sums are the exact integers
    assert int(got[list(roots).index(raster[4, 2, 0]), 1]) == int(np.float32(i[body].sum()))


def test_new_wrappers_check_their_inputs():
    with pytest.raises(TypeError):
        G.scan_lines(torch.zeros((4, 4), dtype=torch.int64), torch.zeros((4, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="8"):
        G.root_candidates(torch.zeros((12, 8, 8), dtype=torch.int32), 12, 8)
    with pytest.raises(ValueError, match="k must"):
        G.root_candidates(torch.zeros((8, 8, 8), dtype=torch.int32), 8, 8, k=G.ROOTS_MAX_K + 1)
    with pytest.raises(ValueError, match="roots"):
        G.component_stats_xyz(torch.zeros(64, dtype=torch.int32),
                              torch.zeros(G.STATS_MAX_ROOTS + 1, dtype=torch.int32), 4, 4, 4)
    G.reset_launch_counts()
    G.scan_lines(torch.zeros((4, 4), dtype=torch.int32), torch.ones((4, 4), dtype=torch.int32))
    G.component_stats_raster(torch.zeros(64, dtype=torch.int32), torch.zeros(2, dtype=torch.int32), 4, 4)
    assert all(v == 0 for v in G.LAUNCHES.values()), G.LAUNCHES

"""The segmentation kernels: CUDA wrappers, their plain-torch twins, counters.

Counterpart of `mamri_tpu/perception/pallas_ops.py`. Every Pallas kernel is
a hand-written CUDA kernel in `mamri_tpu_torch/csrc/` (built by
`_build.library()` at first use):

  close_init       csrc/close_init.cu  <- fused_threshold_close_init
  reset_distances  csrc/ccl.cu         <- compute_reset_distances
  run_min          csrc/ccl.cu         <- ccl_half_sweep_yz / ccl_half_sweep_x
  check            csrc/ccl.cu         <- ccl_check_consistency[_x], with_check
  z_runs           csrc/runs.cu        <- extract_z_runs
  run_stats        csrc/runs.cu        <- run_stats_matmul
  run_stats_compact csrc/runs.cu       <- run_stats_matmul_compact
  scan_lines       csrc/scan_lines.cu  <- segmented_min_scan_lines (and
                                          ccl_sweep_pallas, three of them)
  root_candidates  csrc/roots.cu       <- extract_root_candidates
  component_stats_xyz    csrc/stats.cu <- component_stats_matmul_xyz
  component_stats_raster csrc/stats.cu <- component_stats_matmul

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs, and then either launches its kernel on the current CUDA stream
(CUDA tensors) or runs its plain twin (CPU tensors). There is no fallback:
a CUDA tensor reaches the kernel or an error. `LAUNCHES` counts kernel
launches per wrapper, so a run can show which kernels it went through.

The Pallas-named helpers below the wrappers (`ccl_half_sweep_yz`, ...)
compose the wrappers the way segmentation calls the TPU kernels.
"""

from __future__ import annotations

import torch

BIG = 2**31 - 1  # background label sentinel

LAUNCHES = {
    "close_init": 0,
    "reset_distances": 0,
    "run_min": 0,
    "check": 0,
    "z_runs": 0,
    "run_stats": 0,
    "run_stats_compact": 0,
    "scan_lines": 0,
    "root_candidates": 0,
    "component_stats_xyz": 0,
    "component_stats_raster": 0,
}
ROOTS_MAX_K = 64  # csrc/roots.cu: the picks of a chunk of rows, and of a slab, are rows of k + 1 words
ROOTS_LIST_CAP = 8192  # csrc/roots.cu: the roots a block lists in shared memory; a chunk holds at most this many cells
STATS_MAX_ROOTS = 7168  # csrc/stats.cu: the roots a block ranks and keeps (20 B each) in shared memory


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cuda(*tensors) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors (the
    twin); anything else, or a mix of devices, is an error."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"tensors on different devices: {[str(t.device) for t in tensors]}")
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"unsupported device {dev}")


def _check(t, name, dtype, shape=None):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_volume(t, name, dtype, tile=False):
    _check(t, name, dtype)
    if t.dim() != 3 or min(t.shape) < 1:
        raise ValueError(f"{name}: expected a non-empty 3-D volume, got {tuple(t.shape)}")
    if max(t.shape) >= 32767:
        raise ValueError(f"{name}: int16 run lengths need every side < 32767, got {tuple(t.shape)}")
    if tile and (t.shape[0] % 8 or t.shape[1] % 8 or t.shape[2] % 128):
        raise ValueError(f"{name}: dims must be multiples of (8, 8, 128), got {tuple(t.shape)}")


def _launch(name: str, entry: str, *args) -> None:
    from mamri_tpu_torch import _build

    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib, entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} ({lib.mamri_error_string(err).decode()})")
    LAUNCHES[name] += 1


def new_flag(device):
    """A (1,) int32 zero flag on `device` for run_min / check to OR into."""
    return torch.zeros(1, dtype=torch.int32, device=device)


# ----------------------------------------------------------------- close_init
def close_init(data, lo: float, hi: float):
    """f32 (nx, ny, nz) -> (closed mask int8, initial labels int32).

    Threshold [lo, hi] (NaN out of band), exact ball(2) closing with safe
    borders (every voxel outside the volume is out of band), label =
    (z, y, x) raster index k*nx*ny + j*nx + i, INT32_MAX for background."""
    _check_volume(data, "close_init data", torch.float32)
    nx, ny, nz = data.shape
    lo, hi = float(torch.tensor(lo, dtype=torch.float32)), float(torch.tensor(hi, dtype=torch.float32))
    if not _on_cuda(data):
        return close_init_plain(data, lo, hi)
    band = torch.empty((nx, ny, -(-nz // 32)), dtype=torch.int32, device=data.device)  # z packed 32 a word
    mask = torch.empty(data.shape, dtype=torch.int8, device=data.device)
    lab = torch.empty(data.shape, dtype=torch.int32, device=data.device)
    _launch(
        "close_init", "mamri_close_init",
        data.data_ptr(), band.data_ptr(), mask.data_ptr(), lab.data_ptr(), nx, ny, nz, lo, hi,
    )
    return mask, lab


def _shift(a, s: int, axis: int):
    """out[i] = a[i - s] along `axis`, zero-filled."""
    n = a.shape[axis]
    out = torch.zeros_like(a)
    if abs(s) < n:
        if s >= 0:
            out.narrow(axis, s, n - s).copy_(a.narrow(axis, 0, n - s))
        else:
            out.narrow(axis, 0, n + s).copy_(a.narrow(axis, -s, n + s))
    return out


def _ball2(p, combine):
    """Ball(2) pass: separable 3x3x3 box, then the six +-2 axis points."""
    box = p
    for axis in range(3):
        box = combine(box, combine(_shift(box, 1, axis), _shift(box, -1, axis)))
    out = box
    for axis in range(3):
        out = combine(out, combine(_shift(p, 2, axis), _shift(p, -2, axis)))
    return out


def close_init_plain(data, lo: float, hi: float):
    """Plain twin of `close_init`: OR/AND of zero-filled shifts."""
    nx, ny, nz = data.shape
    dev = data.device
    m = torch.nn.functional.pad(((data >= lo) & (data <= hi)).to(torch.uint8), (4,) * 6).bool()
    dil = _ball2(m, torch.logical_or)
    # zero fill reaches only the outer 2 shells, which the crop drops
    ero = _ball2(dil, torch.logical_and)[4:-4, 4:-4, 4:-4]
    i = torch.arange(nx, dtype=torch.int32, device=dev)[:, None, None]
    j = torch.arange(ny, dtype=torch.int32, device=dev)[None, :, None]
    k = torch.arange(nz, dtype=torch.int32, device=dev)[None, None, :]
    lin = k * (nx * ny) + j * nx + i
    return ero.to(torch.int8), torch.where(ero, lin, BIG)


# ------------------------------------------------------------ reset_distances
def reset_distances(reset, axis: int):
    """int8 0/1 reset volume -> (df, db) int16 along `axis`: the distance to
    the last reset at or before each voxel (i + 1 where none) and to the next
    reset at or after it (n - i where none)."""
    _check_volume(reset, "reset_distances reset", torch.int8)
    if not _on_cuda(reset):
        return reset_distances_plain(reset, axis)
    df = torch.empty(reset.shape, dtype=torch.int16, device=reset.device)
    db = torch.empty(reset.shape, dtype=torch.int16, device=reset.device)
    _launch(
        "reset_distances", "mamri_reset_distances",
        reset.data_ptr(), df.data_ptr(), db.data_ptr(), *reset.shape, axis,
    )
    return df, db


def reset_distances_plain(reset, axis: int):
    """Plain twin of `reset_distances`: cummax of reset positions, both ways."""
    r = reset.movedim(axis, -1) != 0
    idx = torch.arange(r.shape[-1], dtype=torch.int32, device=r.device).expand(r.shape)
    last = torch.where(r, idx, -1).cummax(-1).values
    nxt = torch.where(r.flip(-1), idx, -1).cummax(-1).values  # in flipped coordinates
    df = (idx - last).to(torch.int16)
    db = (idx - nxt).flip(-1).to(torch.int16)
    return df.movedim(-1, axis).contiguous(), db.movedim(-1, axis).contiguous()


# -------------------------------------------------------------------- run_min
def run_min(lab, df, db, axis: int, changed):
    """In place: every voxel of each maximal foreground run along `axis`
    (bounded by df/db) gets the run's minimum label; ORs 1 into the int32
    `changed` flag if any label changed. Returns `lab`."""
    _check_volume(lab, "run_min lab", torch.int32)
    _check(df, "run_min df", torch.int16, lab.shape)
    _check(db, "run_min db", torch.int16, lab.shape)
    _check(changed, "run_min changed", torch.int32, (1,))
    if not _on_cuda(lab, df, db, changed):
        return run_min_plain(lab, df, db, axis, changed)
    _launch(
        "run_min", "mamri_run_min",
        lab.data_ptr(), df.data_ptr(), db.data_ptr(), *lab.shape, axis, changed.data_ptr(),
    )
    return lab


def run_min_plain(lab, df, db, axis: int, changed):
    """Plain twin of `run_min` (in place): runs numbered by a cumsum of
    their starts (df == 1), minimum per run by scatter_reduce, gathered back."""
    lab_l = lab.movedim(axis, -1).contiguous()
    d = df.movedim(axis, -1).contiguous()
    fg = d > 0
    # a run starts where df == 1, so numbering the starts numbers the runs
    ids = torch.cumsum((d == 1).reshape(-1), 0).reshape(d.shape) - 1
    mins = torch.full((int(ids.max()) + 2,), BIG, dtype=torch.int32, device=lab.device)
    mins = mins.scatter_reduce(0, ids[fg], lab_l[fg], "amin")
    new = torch.where(fg, mins[ids.clamp(min=0)], lab_l).movedim(-1, axis)
    changed |= (new != lab).any().to(torch.int32)
    return lab.copy_(new)


# ---------------------------------------------------------------------- check
def check(lab, df, axis: int, bad):
    """ORs 1 into the int32 `bad` flag iff some voxel with df >= 2 (its -axis
    neighbour in the same run) has a label different from that neighbour."""
    _check_volume(lab, "check lab", torch.int32)
    _check(df, "check df", torch.int16, lab.shape)
    _check(bad, "check bad", torch.int32, (1,))
    if not _on_cuda(lab, df, bad):
        return check_plain(lab, df, axis, bad)
    _launch("check", "mamri_check", lab.data_ptr(), df.data_ptr(), *lab.shape, axis, bad.data_ptr())
    return bad


def check_plain(lab, df, axis: int, bad):
    """Plain twin of `check`: a shifted compare."""
    n = lab.shape[axis]
    same_run = df.narrow(axis, 1, n - 1) >= 2
    bad |= (same_run & (lab.narrow(axis, 1, n - 1) != lab.narrow(axis, 0, n - 1))).any().to(torch.int32)
    return bad


# --------------------------------------------------------------------- z_runs
def z_runs(labels, dfz, dbz, nx: int, ny: int, k: int = 16, cand_k: int = 8, x_off: int = 0):
    """(run_labels, run_z0, run_len, root_cands, block_counts, num_components,
    max_runs_per_line), the contract of `extract_z_runs`.

    `labels` is the (8, 8, 128)-padded label volume, `dfz`/`dbz` its z run
    lengths; `nx`/`ny` the original dims the labels encode. Tables are
    (nxp, k, nyq) int32 with nyq = nyp padded to 128: slot r of line (x, y)
    holds the line's r-th maximal z-run (label BIG, z0 0, len 0 where the
    line has fewer). Roots: the cand_k smallest of every (8 x, 128 y)-line
    block, and each block's root count, over runs of rank <= k."""
    _check_volume(labels, "z_runs labels", torch.int32, tile=True)
    _check(dfz, "z_runs dfz", torch.int16, labels.shape)
    _check(dbz, "z_runs dbz", torch.int16, labels.shape)
    if not 1 <= cand_k <= 8 * 128 * k:
        raise ValueError(f"cand_k must lie in [1, {8 * 128 * k}], got {cand_k}")
    nxp, nyp, nz = labels.shape
    nyq = -(-nyp // 128) * 128
    if not _on_cuda(labels, dfz, dbz):
        return z_runs_plain(labels, dfz, dbz, nx, ny, k, cand_k, x_off)
    dev = labels.device
    lab_t = torch.empty((nxp, k, nyq), dtype=torch.int32, device=dev)
    z0_t = torch.empty_like(lab_t)
    len_t = torch.empty_like(lab_t)
    nblocks = (nxp // 8) * (nyq // 128)
    root_tab = torch.empty(nblocks * (cand_k + 1), dtype=torch.int32, device=dev)  # candidates, then counts
    totals = torch.zeros(2, dtype=torch.int32, device=dev)  # max runs per line, number of roots
    _launch(
        "z_runs", "mamri_z_runs",
        labels.data_ptr(), dfz.data_ptr(), dbz.data_ptr(), lab_t.data_ptr(), z0_t.data_ptr(),
        len_t.data_ptr(), root_tab.data_ptr(), totals.data_ptr(),
        nxp, nyp, nz, nyq, k, cand_k, nx, ny, x_off,
    )
    return (lab_t, z0_t, len_t, root_tab[:nblocks * cand_k], root_tab[nblocks * cand_k:], totals[1], totals[0])


def z_runs_plain(labels, dfz, dbz, nx: int, ny: int, k: int = 16, cand_k: int = 8, x_off: int = 0):
    """Plain twin of `z_runs`: a cumsum rank per line, a scatter into the
    tables, a sort per block for the root candidates."""
    nxp, nyp, nz = labels.shape
    dev = labels.device
    nyq = -(-nyp // 128) * 128
    start = dfz == 1
    rank = torch.cumsum(start, dim=2, dtype=torch.int32)  # 1-based run rank at starts
    max_runs = rank[:, :, -1].max()
    xi, yi, zi = torch.nonzero(start & (rank <= k), as_tuple=True)
    ri = rank[xi, yi, zi].long() - 1
    lab_t = torch.full((nxp, k, nyq), BIG, dtype=torch.int32, device=dev)
    z0_t = torch.zeros((nxp, k, nyq), dtype=torch.int32, device=dev)
    len_t = torch.zeros((nxp, k, nyq), dtype=torch.int32, device=dev)
    lab_t[xi, ri, yi] = labels[xi, yi, zi]
    z0_t[xi, ri, yi] = zi.to(torch.int32)
    len_t[xi, ri, yi] = dbz[xi, yi, zi].to(torch.int32)

    gi = torch.arange(nxp, dtype=torch.int64, device=dev)[:, None, None] + x_off
    gj = torch.arange(nyq, dtype=torch.int64, device=dev)[None, None, :]
    is_root = (lab_t != BIG) & (lab_t.long() == z0_t.long() * (nx * ny) + gj * nx + gi)
    v = torch.where(is_root, lab_t, BIG)

    def by_block(a):  # (nxp, k, nyq) -> (nblocks, 8*k*128), row = bx * nby + by
        a = a.reshape(nxp // 8, 8, k, nyq // 128, 128).permute(0, 3, 1, 2, 4)
        return a.reshape((nxp // 8) * (nyq // 128), -1)

    cands = torch.sort(by_block(v), dim=1).values[:, :cand_k]
    counts = by_block(is_root).sum(1, dtype=torch.int32)
    return (lab_t, z0_t, len_t, cands.reshape(-1), counts, counts.sum(dtype=torch.int32),
            max_runs)


# ------------------------------------------------------------------ run_stats
def run_stats(run_lab, run_len, run_z0, roots):
    """(R, 4) f32 [count, sum_i, sum_j, sum_k] per root over the dense
    (nxp, k, nyq) run tables of `z_runs`. `roots` (R,) int32 must be
    ascending (BIG padding last); sums are exact int64, rounded to f32."""
    _check(run_lab, "run_stats run_lab", torch.int32)
    if run_lab.dim() != 3:
        raise ValueError(f"run_stats: expected (nxp, k, nyq) tables, got {tuple(run_lab.shape)}")
    _check(run_len, "run_stats run_len", torch.int32, run_lab.shape)
    _check(run_z0, "run_stats run_z0", torch.int32, run_lab.shape)
    _check(roots, "run_stats roots", torch.int32)
    _, k, nyq = run_lab.shape
    if not _on_cuda(run_lab, run_len, run_z0, roots):
        return run_stats_plain(run_lab, run_len, run_z0, roots)
    return _run_stats_launch("run_stats", run_lab, run_len, run_z0, None, None, k * nyq, nyq, roots)


def run_stats_compact(lab_c, len_c, z0_c, gi_c, gj_c, roots):
    """`run_stats` over a compacted 1-D run table whose x / y coordinates
    come as data (`segmentation.compact_runs`)."""
    cols = {"lab_c": lab_c, "len_c": len_c, "z0_c": z0_c, "gi_c": gi_c, "gj_c": gj_c}
    for name, col in cols.items():
        _check(col, f"run_stats_compact {name}", torch.int32, (lab_c.numel(),))
    _check(roots, "run_stats_compact roots", torch.int32)
    if not _on_cuda(*cols.values(), roots):
        return run_stats_compact_plain(lab_c, len_c, z0_c, gi_c, gj_c, roots)
    return _run_stats_launch("run_stats_compact", lab_c, len_c, z0_c, gi_c, gj_c, 1, 1, roots)


def _run_stats_launch(name, lab, ln, z0, gi, gj, kny, nyq, roots):
    r = roots.numel()
    if r < 1 or lab.numel() < 1:
        raise ValueError(f"{name}: needs at least one root and one run slot")
    acc = torch.empty(4 * r + 1, dtype=torch.int64, device=lab.device)  # sums and a ticket, cleared by the entry
    out = torch.empty((r, 4), dtype=torch.float32, device=lab.device)
    _launch(
        name, "mamri_run_stats",
        lab.data_ptr(), ln.data_ptr(), z0.data_ptr(),
        None if gi is None else gi.data_ptr(), None if gj is None else gj.data_ptr(),
        lab.numel(), kny, nyq, roots.data_ptr(), r, acc.data_ptr(), out.data_ptr(),
    )
    return out


def run_stats_plain(run_lab, run_len, run_z0, roots):
    """Plain twin of `run_stats`: searchsorted + index_add_ in int64."""
    _, k, nyq = run_lab.shape
    p = torch.arange(run_lab.numel(), dtype=torch.int64, device=run_lab.device)
    return _run_stats_sums(run_lab, run_len, run_z0, p // (k * nyq), p % nyq, roots)


def run_stats_compact_plain(lab_c, len_c, z0_c, gi_c, gj_c, roots):
    """Plain twin of `run_stats_compact`."""
    return _run_stats_sums(lab_c, len_c, z0_c, gi_c.long(), gj_c.long(), roots)


def _run_stats_sums(lab, ln, z0, gi, gj, roots):
    lab = lab.reshape(-1)
    ln = ln.reshape(-1).long()
    z0 = z0.reshape(-1).long()
    r = roots.numel()
    idx = torch.searchsorted(roots, lab)
    hit = (idx < r) & (roots[idx.clamp(max=r - 1)] == lab) & (ln > 0)
    feats = torch.stack([ln, gi * ln, gj * ln, z0 * ln + ln * (ln - 1) // 2], dim=1)
    acc = torch.zeros((r, 4), dtype=torch.int64, device=lab.device).index_add_(0, idx[hit], feats[hit])
    return acc[torch.searchsorted(roots, roots)].to(torch.float32)


# ----------------------------------------------------------------- scan_lines
def scan_lines(lab, reset):
    """(L, N) int32 labels, (L, N) int32 0/1 reset -> (L, N) int32: the
    bidirectional segmented min along the last axis. A reset cell starts a
    segment and keeps its own value; every other cell gets the minimum over
    its segment, the reset cells bounding it included."""
    _check(lab, "scan_lines lab", torch.int32)
    if lab.dim() != 2 or min(lab.shape) < 1:
        raise ValueError(f"scan_lines: expected a non-empty (L, N) array, got {tuple(lab.shape)}")
    _check(reset, "scan_lines reset", torch.int32, lab.shape)
    if not _on_cuda(lab, reset):
        return scan_lines_plain(lab, reset)
    out = torch.empty_like(lab)
    _launch("scan_lines", "mamri_scan_lines", lab.data_ptr(), reset.data_ptr(), out.data_ptr(), *lab.shape)
    return out


def scan_lines_plain(lab, reset):
    """Plain twin of `scan_lines`: forward segments numbered by a cumsum of
    the resets, their minimum by scatter_reduce, then the next reset cell's
    value (which closes the backward segment) folded in."""
    nl, n = lab.shape
    dev = lab.device
    r = reset != 0
    seg = torch.cumsum(r, 1) + torch.arange(nl, device=dev)[:, None] * (n + 1)
    mins = torch.full((nl * (n + 1),), BIG, dtype=torch.int32, device=dev)
    mins = mins.scatter_reduce(0, seg.reshape(-1), lab.reshape(-1), "amin")
    idx = torch.arange(n, device=dev).expand(nl, n)
    nxt = torch.where(r, idx, n).flip(1).cummin(1).values.flip(1)  # first reset at or after
    at_next = torch.where(nxt < n, lab.gather(1, nxt.clamp(max=n - 1)), BIG)
    return torch.where(r, lab, torch.minimum(mins[seg], at_next))


# ------------------------------------------------------------ root_candidates
def root_candidates(labels, nx: int, ny: int, k: int = 8):
    """(nblocks, k + 1) int32, one row per 8-x slab of the padded labels:
    the slab's k smallest roots ascending (BIG where it has fewer), then its
    exact root count (which may exceed k). A root is a voxel whose label is
    its own (z, y, x) raster index in the UNPADDED (nx, ny) grid."""
    _check(labels, "root_candidates labels", torch.int32)
    if labels.dim() != 3 or min(labels.shape) < 1 or labels.shape[0] % 8:
        raise ValueError(f"root_candidates: expected (8*s, ny, nz) labels, got {tuple(labels.shape)}")
    if not 1 <= k <= ROOTS_MAX_K:
        raise ValueError(f"root_candidates: k must lie in [1, {ROOTS_MAX_K}], got {k}")
    if not _on_cuda(labels):
        return root_candidates_plain(labels, nx, ny, k)
    nxp, nyp, nzp = labels.shape
    slabs = nxp // 8
    rows = max(1, min(64, ROOTS_LIST_CAP // nzp))  # rows of a block's chunk: its cells fit the list
    chunks = -(-8 * nyp // rows)
    out = torch.empty((slabs, k + 1), dtype=torch.int32, device=labels.device)
    # each chunk's picks and count, then a ticket a slab (cleared by the entry)
    scratch = torch.empty(slabs * chunks * (k + 1) + slabs if chunks > 1 else 1, dtype=torch.int32,
                          device=labels.device)
    _launch("root_candidates", "mamri_root_candidates", labels.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            slabs, nyp, nzp, nx, ny, k, rows)
    return out


def root_candidates_plain(labels, nx: int, ny: int, k: int = 8):
    """Plain twin of `root_candidates`: a root mask, then top-k per slab."""
    nxp, nyp, nzp = labels.shape
    dev = labels.device
    i = torch.arange(nxp, dtype=torch.int64, device=dev)[:, None, None]
    j = torch.arange(nyp, dtype=torch.int64, device=dev)[None, :, None]
    kk = torch.arange(nzp, dtype=torch.int64, device=dev)[None, None, :]
    is_root = (labels != BIG) & (labels.long() == kk * (nx * ny) + j * nx + i)
    v = torch.where(is_root, labels, BIG).reshape(nxp // 8, -1)
    take = min(k, v.shape[1])
    cands = torch.topk(v, take, dim=1, largest=False, sorted=True).values
    if take < k:
        cands = torch.nn.functional.pad(cands, (0, k - take), value=BIG)
    counts = is_root.reshape(nxp // 8, -1).sum(1, dtype=torch.int32)
    return torch.cat([cands, counts[:, None]], dim=1)


# ------------------------------------------------------------ component_stats
def _check_stats(name, flat_labels, roots):
    _check(flat_labels, f"{name} flat_labels", torch.int32)
    _check(roots, f"{name} roots", torch.int32)
    if flat_labels.dim() != 1 or roots.dim() != 1 or flat_labels.numel() < 1:
        raise ValueError(f"{name}: expected 1-D labels and roots, got {tuple(flat_labels.shape)}, "
                         f"{tuple(roots.shape)}")
    if not 1 <= roots.numel() <= STATS_MAX_ROOTS:
        raise ValueError(f"{name}: needs 1 to {STATS_MAX_ROOTS} roots, got {roots.numel()}")


def component_stats_xyz(flat_labels, roots, nx: int, ny: int, nz: int):
    """(R, 4) f32 [count, sum_i, sum_j, sum_k] per root over labels flattened
    in the volume's (x, y, z) C-order (the label values are (z, y, x) raster
    indices). Roots may come in any order and repeat; sums are exact int64
    rounded to f32. Rows whose root is BIG are zero: on the TPU they count
    background and a block-size-dependent padding, and every caller masks
    them (`root_valid`)."""
    _check_stats("component_stats_xyz", flat_labels, roots)
    if not _on_cuda(flat_labels, roots):
        return component_stats_xyz_plain(flat_labels, roots, nx, ny, nz)
    return _stats_launch("component_stats_xyz", flat_labels, roots, nx, ny, nz, 0)


def component_stats_raster(flat_labels, roots, nx: int, ny: int):
    """`component_stats_xyz` over labels flattened in (z, y, x) raster order."""
    _check_stats("component_stats_raster", flat_labels, roots)
    if not _on_cuda(flat_labels, roots):
        return component_stats_raster_plain(flat_labels, roots, nx, ny)
    return _stats_launch("component_stats_raster", flat_labels, roots, nx, ny, 1, 1)


def _stats_launch(name, flat, roots, nx, ny, nz, order):
    r = roots.numel()
    # (r, 4) int64 sums, a ticket and the r sorted roots (int32): all written by the entry and its kernels
    scratch = torch.empty(4 * r + 1 + (r + 1) // 2, dtype=torch.int64, device=flat.device)
    out = torch.empty((r, 4), dtype=torch.float32, device=flat.device)
    _launch(name, "mamri_component_stats", flat.data_ptr(), flat.numel(), roots.data_ptr(),
            r, nx, ny, nz, order, scratch.data_ptr(), out.data_ptr())
    return out


def component_stats_xyz_plain(flat_labels, roots, nx: int, ny: int, nz: int):
    """Plain twin of `component_stats_xyz`."""
    def decode(f):
        gi = f // (ny * nz)
        rem = f - gi * (ny * nz)
        return gi, rem // nz, rem % nz

    return _component_stats_sums(flat_labels, roots, decode)


def component_stats_raster_plain(flat_labels, roots, nx: int, ny: int):
    """Plain twin of `component_stats_raster`."""
    return _component_stats_sums(flat_labels, roots, lambda f: (f % nx, (f // nx) % ny, f // (nx * ny)))


def _component_stats_sums(lab, roots, decode):
    """searchsorted into the sorted roots + index_add_ in int64."""
    srt = torch.sort(roots).values
    r = roots.numel()
    idx = torch.searchsorted(srt, lab)
    hit = (lab != BIG) & (idx < r) & (srt[idx.clamp(max=r - 1)] == lab)
    pos = torch.nonzero(hit).squeeze(1)
    gi, gj, gk = decode(pos)
    feats = torch.stack([torch.ones_like(pos), gi, gj, gk], dim=1)
    acc = torch.zeros((r, 4), dtype=torch.int64, device=lab.device).index_add_(0, idx[pos], feats)
    out = acc[torch.searchsorted(srt, roots)].to(torch.float32)
    return torch.where((roots == BIG)[:, None], 0.0, out)


# --------------------------------------------- the Pallas functions' contracts
def compute_reset_distances(reset):
    """int8 0/1 (nx, ny, nz) -> (dfx, dbx, dfy, dby, dfz, dbz)."""
    out = []
    for axis in (0, 1, 2):
        out.extend(reset_distances(reset, axis))
    return tuple(out)


def ccl_half_sweep_yz(lab, dists, with_check: bool = False):
    """In place: run_min along y, then z. Returns (lab, changed) -- or
    (lab, bad_yz), the y/z part of the fixed-point check on the result, when
    `with_check` is set. Flags are (1,) int32 device tensors."""
    _, _, dfy, dby, dfz, dbz = dists
    changed = new_flag(lab.device)
    run_min(lab, dfy, dby, 1, changed)
    run_min(lab, dfz, dbz, 2, changed)
    if not with_check:
        return lab, changed
    bad = new_flag(lab.device)
    check(lab, dfy, 1, bad)
    check(lab, dfz, 2, bad)
    return lab, bad


def ccl_half_sweep_x(lab, dists):
    """In place: run_min along x. Returns (lab, changed)."""
    changed = new_flag(lab.device)
    run_min(lab, dists[0], dists[1], 0, changed)
    return lab, changed


def ccl_sweep_dist(lab, dists):
    """In place: one full sweep (y, z, then x). Returns (lab, changed)."""
    lab, chg_yz = ccl_half_sweep_yz(lab, dists)
    lab, chg_x = ccl_half_sweep_x(lab, dists)
    return lab, chg_yz | chg_x


def ccl_check_consistency(lab, dists):
    """(1,) int32: 1 iff any within-run adjacent pair of labels differs along
    any axis; 0 certifies the exact CCL fixed point."""
    bad = new_flag(lab.device)
    for axis, df in ((1, dists[2]), (2, dists[4]), (0, dists[0])):
        check(lab, df, axis, bad)
    return bad


def ccl_check_consistency_x(lab, dists):
    """The x part of the fixed-point check only."""
    return check(lab, dists[0], 0, new_flag(lab.device))


def segmented_min_scan_lines(lab, reset):
    """Bidirectional segmented min over the last axis of (L, N) int32."""
    return scan_lines(lab, reset)


def ccl_sweep_pallas(lab, reset_i32):
    """One full sweep (z, then y, then x; both directions) of the line-scan
    kernel over (nx, ny, nz) int32 labels, with transposes bringing each axis
    last. `reset_i32` is int32 0/1. Returns new labels."""
    nx, ny, nz = lab.shape
    lab = scan_lines(lab.contiguous().view(nx * ny, nz), reset_i32.contiguous().view(nx * ny, nz))
    lab = lab.view(nx, ny, nz)
    for perm, back in (((0, 2, 1), (0, 2, 1)), ((1, 2, 0), (2, 0, 1))):
        lab_t = lab.permute(perm).contiguous()
        reset_t = reset_i32.permute(perm).contiguous()
        shape_t = lab_t.shape
        lab = scan_lines(lab_t.reshape(-1, shape_t[2]), reset_t.reshape(-1, shape_t[2]))
        lab = lab.reshape(shape_t).permute(back)
    return lab.contiguous()


def extract_root_candidates(labels, nx: int, ny: int, k: int = 8):
    """(candidates (nblocks*k,), block_counts (nblocks,), num_components ())."""
    tab = root_candidates(labels, nx, ny, k)
    counts = tab[:, k]
    return tab[:, :k].reshape(-1), counts, counts.sum(dtype=torch.int32)


def component_stats_matmul(flat_labels, roots, nx: int, ny: int):
    """(R, 4) stats over the (z, y, x)-raster flattening of the labels."""
    return component_stats_raster(flat_labels, roots, nx, ny)


def component_stats_matmul_xyz(flat_labels, roots, nx: int, ny: int, nz: int):
    """(R, 4) stats over labels flattened in their (x, y, z) C-order."""
    return component_stats_xyz(flat_labels, roots, nx, ny, nz)

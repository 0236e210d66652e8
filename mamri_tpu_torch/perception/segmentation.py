"""Fiducial + body segmentation: threshold -> ball closing -> CCL -> stats.

Port of the kernel branches of `mamri_tpu.perception.segmentation`
(`segment_volume`, segmentation.py:591-666): every kernel step runs through
the wrappers of `gpu_ops` (CUDA kernels on the card, plain twins on the CPU).

- The fused branch (`closing_radius == 2`, the engine's default): one
  threshold + ball(2) closing + label-init kernel, the run-length sweeps,
  and stats over the volume's z-run decomposition.
- The non-fused branch (any other radius): `binary_close` in plain torch,
  the same run-length sweeps, then root detection and a two-level blocked
  top-k over the whole volume and voxel stats (`component_stats_xyz`).

Labels are each component's minimum (z, y, x) raster index, so component
order is ITK's raster-scan label order. Every budget is certified, with the
same sub-certificates as the reference (`count_ok`, `cand_ok`, `runs_ok`,
`compact_ok`), so the engine's escalation reads them unchanged. The geometry
of the certificates is the TPU's: (8, 8, 128) padding, y padded to 128 in
the run tables, root candidates per (8 x, 128 y)-line block, 2048 top-k
blocks in the non-fused branch.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch

from mamri_tpu_torch.core.transforms import flip_xy
from mamri_tpu_torch.perception import gpu_ops
from mamri_tpu_torch.perception.gpu_ops import BIG

MAX_BLOBS = 32
MAX_ROOTS = 256


class SegmentationParams(NamedTuple):
    """Same fields and defaults as mamri_tpu's SegmentationParams.

    The branch is chosen as the reference chooses it on its accelerator:
    fused iff `closing_radius == 2` and `use_pallas` is not False. Both
    branches run the port's kernels; `use_pallas=False` takes the non-fused
    one, whose outputs are those of the reference's jnp path. In it,
    `exhaustive_roots` takes one flat top-k over the volume in place of the
    blocked one."""

    intensity_low: float = 65.0  # must be finite
    intensity_high: float = 65535.0
    min_volume_mm3: float = 50.0
    max_volume_mm3: float = 1500.0
    closing_radius: int = 2
    max_sweeps: int = 16
    max_blobs: int = MAX_BLOBS
    max_roots: int = MAX_ROOTS
    use_pallas: Optional[bool] = None
    exhaustive_roots: bool = False
    cand_k: int = 8  # root candidates per (8 x, 128 y)-line block
    run_k: int = 8  # z-runs kept per (x, y) line
    passes: Optional[int] = None  # half-sweeps [yz, x, yz, ...]; None = 2*max_sweeps
    compact_stats: Optional[bool] = None  # None = on when max_roots > 256


class SegmentationResult(NamedTuple):
    centroids_ras: torch.Tensor  # (max_blobs, 3) f32, RAS mm (zeros where invalid)
    volumes_mm3: torch.Tensor  # (max_blobs,) f32
    blob_valid: torch.Tensor  # (max_blobs,) bool
    num_blobs: torch.Tensor  # () int32
    body_mask: torch.Tensor  # (nx, ny, nz) bool
    body_volume_mm3: torch.Tensor  # () f32
    body_found: torch.Tensor  # () bool
    num_components: torch.Tensor  # () int32, exact when roots_complete
    labels: torch.Tensor  # (nx, ny, nz) int32 (BIG = background)
    ccl_converged: torch.Tensor  # () bool: labels are the exact CCL fixed point
    roots_complete: torch.Tensor  # () bool: every component's stats were taken
    blobs_complete: torch.Tensor  # () bool: every in-band component got a slot
    count_ok: torch.Tensor  # num_components <= max_roots
    cand_ok: torch.Tensor  # no block exceeded cand_k roots
    runs_ok: torch.Tensor  # no line exceeded run_k z-runs
    compact_ok: torch.Tensor  # compact stats: n_runs <= cap


def _ball_offsets(radius: int):
    r = int(radius)
    rng = range(-r, r + 1)
    return tuple((dx, dy, dz) for dx in rng for dy in rng for dz in rng if dx * dx + dy * dy + dz * dz <= r * r)


def _shift3(a, off):
    """Shift a 3-D array by `off`. `torch.roll` wraps around exactly as
    `jnp.roll` does; the wrapped voxels land in the 2r margin that
    `binary_close` pads and crops, which is what makes it exact."""
    return torch.roll(a, shifts=(-off[0], -off[1], -off[2]), dims=(-3, -2, -1))


def binary_close(mask, radius: int = 2):
    """Morphological closing of a bool volume with a Euclidean ball, safe
    borders: padded by 2r so the dilation never clips and the wraparound of
    the shifts stays in the cropped margin. (The reference decomposes
    radius 2 into separable passes for speed; the full offset reduction
    gives the same mask, and the engine's radius 2 runs `close_init`.)"""
    if radius <= 0:
        return mask
    pad = 2 * radius
    p = torch.nn.functional.pad(mask.to(torch.uint8), (pad,) * 6).bool()
    offs = _ball_offsets(radius)
    dil = functools.reduce(torch.logical_or, (_shift3(p, o) for o in offs))
    ero = functools.reduce(torch.logical_and, (_shift3(dil, o) for o in offs))
    return ero[pad:-pad, pad:-pad, pad:-pad]


def _segmented_min_scan(lab, reset, axis: int, reverse: bool):
    """Running minimum along `axis` that restarts at reset voxels (a reset
    keeps its own value). The scan of the semiring element (reset, value)
    under combine((fa, va), (fb, vb)) = (fa | fb, vb if fb else min(va, vb)),
    which is associative, as a log-step doubling ladder (Hillis-Steele): the
    reference's `lax.associative_scan` (segmentation.py:190-204)."""
    n = lab.shape[axis]
    f, v = reset.clone(), lab.clone()
    d = 1
    while d < n:
        # combine each element with the one d before it (after it when reverse)
        if reverse:
            fs = torch.cat([f.narrow(axis, d, n - d), torch.zeros_like(f.narrow(axis, 0, d))], dim=axis)
            vs = torch.cat([v.narrow(axis, d, n - d), torch.full_like(v.narrow(axis, 0, d), BIG)], dim=axis)
        else:
            fs = torch.cat([torch.zeros_like(f.narrow(axis, 0, d)), f.narrow(axis, 0, n - d)], dim=axis)
            vs = torch.cat([torch.full_like(v.narrow(axis, 0, d), BIG), v.narrow(axis, 0, n - d)], dim=axis)
        v = torch.where(f, v, torch.minimum(vs, v))
        f = f | fs
        d *= 2
    return v


def _labels_consistent(lab, reset):
    """() bool: True iff every within-run adjacent label pair is equal along
    every axis, i.e. `lab` is the exact CCL fixed point (the reference's
    `_labels_consistent_jnp`)."""
    fg = ~reset
    bad = torch.zeros((), dtype=torch.bool, device=lab.device)
    for axis in range(3):
        n = lab.shape[axis]
        pair = fg.narrow(axis, 1, n - 1) & fg.narrow(axis, 0, n - 1)
        diff = lab.narrow(axis, 1, n - 1) != lab.narrow(axis, 0, n - 1)
        bad = bad | (pair & diff).any()
    return ~bad


def _init_labels(mask):
    """(z, y, x) raster index k*nx*ny + j*nx + i where `mask`, BIG elsewhere."""
    nx, ny, nz = mask.shape
    dev = mask.device
    i = torch.arange(nx, dtype=torch.int32, device=dev)[:, None, None]
    j = torch.arange(ny, dtype=torch.int32, device=dev)[None, :, None]
    k = torch.arange(nz, dtype=torch.int32, device=dev)[None, None, :]
    return torch.where(mask, k * (nx * ny) + j * nx + i, BIG)


def _pad_for_kernels(lab0, reset):
    """Pad to the (8, 8, 128) multiples the certificates are defined on.
    Padding is background (label BIG, reset 1): inert under every pass."""
    pads = [(-s) % m for s, m in zip(lab0.shape, (8, 8, 128))]
    if any(pads):
        cfg = (0, pads[2], 0, pads[1], 0, pads[0])
        lab0 = torch.nn.functional.pad(lab0, cfg, value=BIG)
        reset = torch.nn.functional.pad(reset, cfg, value=1)
    return lab0, reset.contiguous()


def _ccl_sweeps_from_dists(lab0, dists, max_sweeps: int, passes: Optional[int] = None):
    """Half-sweeps [yz, x, yz, ...] on padded arrays (labels updated in
    place), then the local-consistency certificate: labels decrease
    monotonically, so equal labels within every run along every axis hold
    iff they are the exact CCL fixed point. Returns (labels, converged)."""
    if passes is None:
        passes = 2 * max_sweeps
    lab = lab0
    for _ in range(passes // 2):
        lab, _ = gpu_ops.ccl_sweep_dist(lab, dists)
    if passes % 2:
        # the final yz half-sweep checks y/z itself; x is checked separately
        lab, bad = gpu_ops.ccl_half_sweep_yz(lab, dists, with_check=True)
        bad = bad | gpu_ops.ccl_check_consistency_x(lab, dists)
    else:
        bad = gpu_ops.ccl_check_consistency(lab, dists)
    return lab, bad[0] == 0


_ccl_sweeps_pallas_from_dists = _ccl_sweeps_from_dists  # the reference's name


def _ccl_sweeps_pallas(lab0, reset, max_sweeps: int, passes: Optional[int] = None):
    """Sweeps over padded arrays from their reset volume (labels updated in
    place). Returns (labels, converged)."""
    dists = gpu_ops.compute_reset_distances(reset.to(torch.int8).contiguous())
    return _ccl_sweeps_from_dists(lab0, dists, max_sweeps, passes)


def connected_components(mask, max_sweeps: int = 8):
    """6-connectivity CCL of a bool volume: label = the component's minimum
    (z, y, x) raster index, BIG for background."""
    lab0, reset = _pad_for_kernels(_init_labels(mask), (~mask).to(torch.int8))
    labels, _ = _ccl_sweeps_pallas(lab0, reset, max_sweeps)
    nx, ny, nz = mask.shape
    return labels[:nx, :ny, :nz]


def _component_stats(labels, max_roots: int, exhaustive: bool = False):
    """Roots, counts and index-coordinate sums of up to `max_roots`
    components, over the unpadded labels in their (x, y, z) C-order.

    A voxel is its component's root iff its label is its own raster index;
    the `max_roots` smallest roots are taken by a two-level top-k (2048
    blocks, `min(max_roots, 64)` per block) when the volume has >= 2^20
    voxels, else (or when `exhaustive`) by one flat top-k. Returns (roots,
    root_valid, counts, sums_ijk, num_components, complete): `complete` is
    False when num_components > max_roots or a block held more roots than
    its share."""
    nx, ny, nz = labels.shape
    n = nx * ny * nz
    dev = labels.device
    flat = labels.reshape(n).contiguous()
    f = torch.arange(n, dtype=torch.int32, device=dev)
    gi = f // (ny * nz)
    rem = f - gi * (ny * nz)
    gj = rem // nz
    gk = rem - gj * nz
    lin = gi + nx * (gj + ny * gk)
    is_root = (flat == lin) & (flat != BIG)
    num_components = is_root.sum(dtype=torch.int32)
    complete = num_components <= max_roots

    root_keys = torch.where(is_root, -lin, -BIG)
    if n >= (1 << 20) and not exhaustive:
        nblocks = 2048
        per_block = min(max_roots, 64)
        pad = (-n) % nblocks
        if pad:
            root_keys = torch.cat([root_keys, root_keys.new_full((pad,), -BIG)])
            is_root = torch.cat([is_root, is_root.new_zeros(pad)])
        block_counts = is_root.reshape(nblocks, -1).sum(1)
        complete = complete & (block_counts <= per_block).all()
        blk = torch.topk(root_keys.reshape(nblocks, -1), per_block, dim=1).values
        keys = torch.topk(blk.reshape(-1), max_roots).values
    else:
        keys = torch.topk(root_keys, max_roots).values
    roots = -keys  # ascending root indices, BIG where there is no component
    stats = gpu_ops.component_stats_matmul_xyz(flat, roots, nx, ny, nz)
    return roots, roots != BIG, stats[:, 0], stats[:, 1:4], num_components, complete


def _pow2ceil(v: int) -> int:
    return 1 << max(int(v) - 1, 1).bit_length()


def compact_runs(run_lab, run_len, run_z0, cap: int):
    """Compact the dense (nxp, k, nyq) run table to its `cap` lowest-indexed
    occupied slots, in ascending slot order (a stream compaction, with no
    host sync). Returns (lab_c, len_c, z0_c, gi_c, gj_c, n_runs): label BIG /
    len 0 in unused slots, x / y decoded from the slot position, and the
    true occupied count (exact iff n_runs <= cap: `compact_ok`)."""
    nxp, kk, nyq = run_lab.shape
    m = nxp * kk * nyq
    occupied = run_len.reshape(-1) > 0
    n_runs = occupied.sum(dtype=torch.int32)
    rank = torch.cumsum(occupied, 0) - 1
    keep = occupied & (rank < cap)
    dest = torch.where(keep, rank, torch.full_like(rank, cap))  # slot `cap` is a dump
    pos = torch.full((cap + 1,), m, dtype=torch.int64, device=run_lab.device)
    pos = pos.scatter(0, dest, torch.arange(m, device=run_lab.device))[:cap]
    real = pos < m
    safe = torch.where(real, pos, torch.zeros_like(pos))

    def take(a, fill):
        return torch.where(real, a.reshape(-1)[safe], fill).to(torch.int32)

    return (
        take(run_lab, BIG),
        take(run_len, 0),
        take(run_z0, 0),
        torch.where(real, pos // (kk * nyq), 0).to(torch.int32),
        torch.where(real, pos % nyq, 0).to(torch.int32),
        n_runs,
    )


def _component_stats_fast(labels_padded, dists, shape, max_roots: int, cand_k: int = 8, run_k: int = 8,
                          compact: Optional[bool] = None):
    """Root candidates + run-length stats over the padded labels. Returns
    (labels, roots, root_valid, counts, sums_ijk, num_components, complete,
    count_ok, cand_ok, runs_ok, compact_ok), as the reference does."""
    nx, ny, nz = shape
    dev = labels_padded.device
    run_lab, run_z0, run_len, cands, block_counts, num_components, max_runs = gpu_ops.z_runs(
        labels_padded, dists[4], dists[5], nx, ny, k=run_k, cand_k=cand_k
    )
    r_eff = min(max_roots, cands.shape[0])
    roots = torch.topk(cands, r_eff, largest=False, sorted=True).values.contiguous()
    if r_eff < max_roots:
        roots = torch.cat([roots, torch.full((max_roots - r_eff,), BIG, dtype=torch.int32, device=dev)])
    root_valid = roots != BIG

    count_ok = num_components <= max_roots
    cand_ok = (block_counts <= cand_k).all()
    runs_ok = max_runs <= run_k

    use_compact = compact if compact is not None else (max_roots > 256)
    nxp, kk, nyq = run_lab.shape
    m = nxp * kk * nyq
    if use_compact:
        cap = min(m, max(32768, _pow2ceil((nx * ny) // 2)))
        lab_c, len_c, z0_c, gi_c, gj_c, n_runs = compact_runs(run_lab, run_len, run_z0, cap)
        compact_ok = n_runs <= cap
        stats = gpu_ops.run_stats_compact(lab_c, len_c, z0_c, gi_c, gj_c, roots)
    else:
        compact_ok = torch.ones((), dtype=torch.bool, device=dev)
        stats = gpu_ops.run_stats(run_lab, run_len, run_z0, roots)

    complete = count_ok & cand_ok & runs_ok & compact_ok
    labels = labels_padded[:nx, :ny, :nz]
    return (labels, roots, root_valid, stats[:, 0], stats[:, 1:4], num_components, complete,
            count_ok, cand_ok, runs_ok, compact_ok)


def _validate_thresholds(params: SegmentationParams):
    if not (math.isfinite(params.intensity_low) and math.isfinite(params.intensity_high)):
        raise ValueError(
            "intensity thresholds must be finite (the kernels pad volume "
            "borders with -inf as the out-of-band fill)"
        )


def segment_volume(data, spacing, origin, params: SegmentationParams = SegmentationParams()) -> SegmentationResult:
    """Full fiducial + body segmentation of one (nx, ny, nz) volume tensor,
    on the volume's device. Integer scanner volumes are cast to f32 there."""
    _validate_thresholds(params)
    fused = params.closing_radius == 2 and params.use_pallas is not False
    dev = data.device
    data = data.to(torch.float32).contiguous()
    spacing = torch.as_tensor(spacing, dtype=torch.float32, device=dev)
    origin = torch.as_tensor(origin, dtype=torch.float32, device=dev)

    if fused:
        mask, lab0 = gpu_ops.close_init(data, params.intensity_low, params.intensity_high)
        lab0, reset = _pad_for_kernels(lab0, (mask == 0).to(torch.int8))
        dists = gpu_ops.compute_reset_distances(reset)
        labels_padded, converged = _ccl_sweeps_from_dists(lab0, dists, params.max_sweeps, params.passes)
        (labels, roots, root_valid, counts, sums_ijk, num_components, complete,
         count_ok, cand_ok, runs_ok, compact_ok) = _component_stats_fast(
            labels_padded, dists, data.shape, params.max_roots,
            cand_k=params.cand_k, run_k=params.run_k, compact=params.compact_stats,
        )
    else:
        closed = binary_close((data >= params.intensity_low) & (data <= params.intensity_high),
                              params.closing_radius)
        lab0, reset = _pad_for_kernels(_init_labels(closed), (~closed).to(torch.int8))
        labels_padded, converged = _ccl_sweeps_pallas(lab0, reset, params.max_sweeps, params.passes)
        nx, ny, nz = data.shape
        labels = labels_padded[:nx, :ny, :nz]
        roots, root_valid, counts, sums_ijk, num_components, complete = _component_stats(
            labels, params.max_roots, exhaustive=params.exhaustive_roots
        )
        # only the count and blocked top-k budgets exist here, and `complete`
        # covers both: count_ok carries it, so the engine raises max_roots
        count_ok = complete
        cand_ok = runs_ok = compact_ok = torch.ones((), dtype=torch.bool, device=dev)
    return finalize_segmentation(
        labels, roots, root_valid, counts, sums_ijk, num_components, complete, converged,
        spacing, origin, params, count_ok, cand_ok, runs_ok, compact_ok,
    )


def finalize_segmentation(labels, roots, root_valid, counts, sums_ijk, num_components, complete,
                          converged, spacing, origin, params: SegmentationParams,
                          count_ok=None, cand_ok=None, runs_ok=None, compact_ok=None) -> SegmentationResult:
    """Blob-band selection + body extraction from per-component stats.

    Shared tail of `segment_volume` and the sharded path
    (`parallel/shard_seg.py`): the stats are whole-volume; `labels` may be
    one shard's (the body mask is then that shard's). A sub-certificate
    left None is the reference's default: `count_ok` takes `complete`, the
    others hold."""
    true = torch.ones((), dtype=torch.bool, device=roots.device)
    count_ok = complete if count_ok is None else count_ok
    cand_ok, runs_ok, compact_ok = (true if c is None else c for c in (cand_ok, runs_ok, compact_ok))
    voxvol = spacing[0] * spacing[1] * spacing[2]
    vols = counts * voxvol
    in_band = root_valid & (vols >= params.min_volume_mm3) & (vols <= params.max_volume_mm3)

    # fiducial blobs: smallest root first among in-band components
    num_in_band = in_band.sum(dtype=torch.int32)
    blobs_complete = num_in_band <= params.max_blobs
    blob_keys = torch.where(in_band, -roots.long(), -BIG)
    bkeys, bidx = torch.topk(blob_keys, params.max_blobs, sorted=True)
    blob_valid = bkeys != -BIG
    blob_counts = counts[bidx]
    centroid_idx = sums_ijk[bidx] / torch.clamp(blob_counts[:, None], min=1.0)
    centroid_lps = origin[None, :] + spacing[None, :] * centroid_idx
    centroid_ras = torch.where(blob_valid[:, None], flip_xy(centroid_lps), 0.0)
    blob_vols = torch.where(blob_valid, vols[bidx], 0.0)
    num_blobs = blob_valid.sum(dtype=torch.int32)

    # body: the largest component outside the fiducial band
    body_counts = torch.where(root_valid & ~in_band, counts, -1.0)
    body_slot = torch.argmax(body_counts).reshape(1)  # index_select: no host read of the slot
    body_found = body_counts.index_select(0, body_slot)[0] > 0
    body_root = torch.where(body_found, roots.index_select(0, body_slot)[0], -1)
    body_volume = torch.where(body_found, counts.index_select(0, body_slot)[0] * voxvol, 0.0)

    return SegmentationResult(
        centroids_ras=centroid_ras,
        volumes_mm3=blob_vols,
        blob_valid=blob_valid,
        num_blobs=num_blobs,
        body_mask=labels == body_root,
        body_volume_mm3=body_volume,
        body_found=body_found,
        num_components=num_components,
        labels=labels,
        ccl_converged=converged,
        roots_complete=complete,
        blobs_complete=blobs_complete,
        count_ok=count_ok,
        cand_ok=cand_ok,
        runs_ok=runs_ok,
        compact_ok=compact_ok,
    )

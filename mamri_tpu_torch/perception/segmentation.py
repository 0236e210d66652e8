"""Fiducial + body segmentation: threshold -> ball(2) closing -> CCL -> stats.

Port of the fused kernel branch of `mamri_tpu.perception.segmentation`
(`segment_volume`, segmentation.py:591-644): every step runs through the
wrappers of `gpu_ops` (CUDA kernels on the card, plain twins on the CPU).

Labels are each component's minimum (z, y, x) raster index, so component
order is ITK's raster-scan label order. Stats come from the volume's z-run
decomposition. Every budget is certified, with the same sub-certificates
as the reference (`count_ok`, `cand_ok`, `runs_ok`, `compact_ok`), so the
engine's escalation reads them unchanged. The geometry of the certificates
is the TPU's: (8, 8, 128) padding, y padded to 128 in the run tables, root
candidates per (8 x, 128 y)-line block.
"""

from __future__ import annotations

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

    The port has one path, the kernel branch, so `use_pallas` and
    `exhaustive_roots` (which select among the reference's other paths) are
    carried only so that parameters cross over unchanged."""

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


def _validate(params: SegmentationParams):
    if not (math.isfinite(params.intensity_low) and math.isfinite(params.intensity_high)):
        raise ValueError("intensity thresholds must be finite")
    if params.closing_radius != 2:
        raise NotImplementedError(
            "closing_radius != 2 (the non-fused segmentation branch) is not ported yet: "
            "see ROADMAP.md, queue A, 'the closing_radius != 2 branch'"
        )


def segment_volume(data, spacing, origin, params: SegmentationParams = SegmentationParams()) -> SegmentationResult:
    """Full fiducial + body segmentation of one (nx, ny, nz) volume tensor,
    on the volume's device. Integer scanner volumes are cast to f32 there."""
    _validate(params)
    dev = data.device
    data = data.to(torch.float32).contiguous()
    spacing = torch.as_tensor(spacing, dtype=torch.float32, device=dev)
    origin = torch.as_tensor(origin, dtype=torch.float32, device=dev)

    mask, lab0 = gpu_ops.close_init(data, params.intensity_low, params.intensity_high)
    lab0, reset = _pad_for_kernels(lab0, (mask == 0).to(torch.int8))
    dists = gpu_ops.compute_reset_distances(reset)
    labels_padded, converged = _ccl_sweeps_from_dists(lab0, dists, params.max_sweeps, params.passes)
    (labels, roots, root_valid, counts, sums_ijk, num_components, complete,
     count_ok, cand_ok, runs_ok, compact_ok) = _component_stats_fast(
        labels_padded, dists, data.shape, params.max_roots,
        cand_k=params.cand_k, run_k=params.run_k, compact=params.compact_stats,
    )
    return finalize_segmentation(
        labels, roots, root_valid, counts, sums_ijk, num_components, complete, converged,
        spacing, origin, params, count_ok, cand_ok, runs_ok, compact_ok,
    )


def finalize_segmentation(labels, roots, root_valid, counts, sums_ijk, num_components, complete,
                          converged, spacing, origin, params: SegmentationParams,
                          count_ok, cand_ok, runs_ok, compact_ok) -> SegmentationResult:
    """Blob-band selection + body extraction from per-component stats."""
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
    body_slot = torch.argmax(body_counts)
    body_found = body_counts[body_slot] > 0
    body_root = torch.where(body_found, roots[body_slot], -1)
    body_volume = torch.where(body_found, counts[body_slot] * voxvol, 0.0)

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

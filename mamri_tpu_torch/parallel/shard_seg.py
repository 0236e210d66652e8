"""Spatially sharded segmentation: the volume's x extent split over the
shards of one mesh axis.

Port of `mamri_tpu/parallel/shard_seg.py`. A shard program calls
`segment_volume_sharded` on its local (nx/S, ny, nz) slab with its axis (a
`collectives.ThreadAxis` or `DistAxis`); every cross-shard step is one of
the axis' collectives, as in the reference:

  * fast path (kernels on, local x extent a multiple of 8, closing radius
    2): a 4-plane halo of raw data comes from each neighbour by `ppermute`
    (-inf at the volume's edges), `gpu_ops.close_init` runs on the extended
    slab with the whole volume's (nx, ny) as `label_dims`, and the labels
    are shifted by the shard's x offset. The run-length distances are the
    shard's own (its x edges break runs: exactly what the local x sweep
    needs). Half-sweeps follow the single-card `passes` schedule: y/z by
    `run_min`, x by `run_min` plus an exact cross-shard fix (one
    `all_gather` of every line's boundary-run values, a prefix-combine over
    the shard ring, a masked apply). The fixed-point certificate is the
    kernels' own check plus the shard-boundary pairs, `psum`'d. Stats:
    `z_runs` with the global (nx, ny) and the shard's `x_off`, an
    `all_gather` merge of the root candidates, and `run_stats`' exact int64
    sums with `sum_i += x_off * count`, `psum`'d before they are rounded,
    so every stat equals the single card's.
  * general path (otherwise): a halo of the threshold mask for the closing,
    global raster labels, y/z scans by `gpu_ops.scan_lines` (plain torch
    doubling ladders when `use_pallas` is False), the x scan as local scans
    plus the same prefix-combine, the consistency certificate, an exact
    top-k root merge and per-shard int64 stats, `psum`'d.

At an axis of size 1 it routes to `segment_volume` unless `force_general`
keeps the sharded formulation (to see its cost on one card). The results
are whole-volume but for `labels` and `body_mask`, which are the shard's.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from mamri_tpu_torch.parallel.collectives import ring_perms as _ring_perms
from mamri_tpu_torch.perception import gpu_ops
from mamri_tpu_torch.perception.gpu_ops import BIG
from mamri_tpu_torch.perception.segmentation import (
    SegmentationParams,
    SegmentationResult,
    _labels_consistent,
    _segmented_min_scan,
    _validate_thresholds,
    binary_close,
    finalize_segmentation,
    segment_volume,
)


def _thin_shard_error(nxl: int, h: int, fast: bool) -> ValueError:
    if fast:
        return ValueError(
            f"shard width {nxl} is thinner than the closing halo {h}: halo "
            "exchange would hand a shard its neighbor's planes — use fewer "
            "sp shards or a smaller closing radius"
        )
    return ValueError(
        f"shard width {nxl} is thinner than the closing halo "
        f"{h}: use fewer sp shards or a smaller closing radius"
    )


# ----------------------------------------------------------------- closing
def _closed_mask_sharded(data, thr_lo, thr_hi, radius: int, axis):
    """Threshold + ball closing of the local slab, exact through a halo of
    the mask from each neighbour (zeros at the volume's edges, as
    `binary_close`'s constant-False padding)."""
    mask = (data >= thr_lo) & (data <= thr_hi)
    if radius <= 0:
        return mask
    h = 2 * radius
    if mask.shape[0] < h:
        raise _thin_shard_error(mask.shape[0], h, fast=False)
    fwd, bwd = _ring_perms(axis.axis_size())
    left_halo = axis.ppermute(mask[-h:], fwd)  # from the left neighbour
    right_halo = axis.ppermute(mask[:h], bwd)  # from the right neighbour
    closed = binary_close(torch.cat([left_halo, mask, right_halo], dim=0), radius)
    return closed[h:h + mask.shape[0]]


# ----------------------------------------------------------------- scans
def _local_scan_lines(lab, reset_i32, axis: int, use_pallas: bool):
    """Bidirectional segmented min-scan of the slab along a local axis (1 or
    2): the `scan_lines` kernel on lines brought to the last axis, or plain
    torch ladders."""
    if not use_pallas:
        rb = reset_i32 != 0
        fwd = _segmented_min_scan(lab, rb, axis, reverse=False)
        bwd = _segmented_min_scan(lab, rb, axis, reverse=True)
        return torch.minimum(torch.minimum(fwd, bwd), lab)
    nx, ny, nz = lab.shape
    if axis == 2:
        out = gpu_ops.segmented_min_scan_lines(lab.contiguous().view(nx * ny, nz),
                                               reset_i32.contiguous().view(nx * ny, nz))
        return out.view(nx, ny, nz)
    if axis == 1:
        lab_t = lab.transpose(1, 2).contiguous().view(nx * nz, ny)
        reset_t = reset_i32.transpose(1, 2).contiguous().view(nx * nz, ny)
        out = gpu_ops.segmented_min_scan_lines(lab_t, reset_t)
        return out.view(nx, nz, ny).transpose(1, 2).contiguous()
    raise ValueError("local axes are 1 (y) and 2 (z); axis 0 is sharded")


def _prefix_combine(f_all, v_all, reverse: bool):
    """The incoming scan state of every shard from the shards' (any reset,
    boundary-run value) summaries, in shard order (or reverse): the
    combine (f, v) . (f_t, v_t) = (f | f_t, v_t if f_t else min(v, v_t)) is
    associative, so the shard ring decomposes the scan exactly."""
    n_sp = f_all.shape[0]
    runv = torch.full_like(v_all[0], BIG)
    pref_v = [None] * n_sp
    for t in (range(n_sp - 1, -1, -1) if reverse else range(n_sp)):
        pref_v[t] = runv
        runv = torch.where(f_all[t], v_all[t], torch.minimum(runv, v_all[t]))
    return torch.stack(pref_v)


def _global_x_scan(lab, reset, axis, reverse: bool):
    """Inclusive segmented min-scan along the sharded x axis: the local scan,
    one `all_gather` of every line's fold at the slab's edge, the prefix
    combine, and out = v_loc where a reset precedes locally, else
    min(v_in, v_loc)."""
    r = reset.to(torch.uint8)
    f_loc = (r.flip(0).cummax(0).values.flip(0) if reverse else r.cummax(0).values).bool()
    v_loc = _segmented_min_scan(lab, reset, 0, reverse)
    edge = 0 if reverse else -1
    f_all = axis.all_gather(f_loc[edge])  # (S, ny, nz)
    v_all = axis.all_gather(v_loc[edge])
    v_in = _prefix_combine(f_all, v_all, reverse)[axis.axis_index()]
    return torch.where(f_loc, v_loc, torch.minimum(v_in[None], v_loc))


def _boundary_bad(lab, fg, axis):
    """() int32: 1 iff some foreground pair across a shard boundary has two
    labels: the right neighbour's first plane comes by `ppermute` (the last
    shard gets zeros, i.e. background)."""
    _, bwd = _ring_perms(axis.axis_size())
    nb_lab = axis.ppermute(lab[:1], bwd)[0]
    nb_fg = axis.ppermute(fg[:1].to(torch.int32), bwd)[0]
    return (fg[-1] & (nb_fg == 1) & (lab[-1] != nb_lab)).any().to(torch.int32)


# ------------------------------------------------------------ general sweeps
def _ccl_sweeps_sharded(lab0, reset, params: SegmentationParams, axis, use_pallas: bool):
    """The general path's sweeps on the sharded labels, with the single-card
    `passes` schedule; returns (labels, converged), the certificate global."""
    reset_i32 = reset.to(torch.int32)

    def yz_half(lab):
        lab = _local_scan_lines(lab, reset_i32, 1, use_pallas)
        return _local_scan_lines(lab, reset_i32, 2, use_pallas)

    def x_half(lab):
        fwd = _global_x_scan(lab, reset, axis, reverse=False)
        bwd = _global_x_scan(lab, reset, axis, reverse=True)
        return torch.minimum(torch.minimum(fwd, bwd), lab)

    lab = lab0
    passes = params.passes
    for _ in range(params.max_sweeps if passes is None else passes // 2):
        lab = x_half(yz_half(lab))
    if passes is not None and passes % 2:
        lab = yz_half(lab)
    return lab, _consistency_sharded(lab, reset, axis)


def _consistency_sharded(lab, reset, axis):
    """() bool: the global fixed-point certificate of the general path, the
    slab's own pairs and the shard-boundary pairs, `psum`'d."""
    bad = (~_labels_consistent(lab, reset)).to(torch.int32)
    bad = torch.maximum(bad, _boundary_bad(lab, ~reset, axis))
    return axis.psum(bad) == 0


# ------------------------------------------------------------ fast (kernel) path
def _x_half_sweep_sharded(lab, dists, reset_any, left_run, right_run, axis):
    """The x half of a sweep: `run_min` along x on the slab (its distances
    end runs at the slab's edges), then the exact cross-shard fix. After the
    local pass the edge voxel of a run touching the slab's edge holds the
    minimum of the run's local part, the directional scan's fold there."""
    lab, _ = gpu_ops.ccl_half_sweep_x(lab, dists)
    me = axis.axis_index()
    f_all = axis.all_gather(reset_any)  # (S, nyp, nzp)
    vr_all = axis.all_gather(lab[-1])
    vl_all = axis.all_gather(lab[0])
    v_in_fwd = _prefix_combine(f_all, vr_all, reverse=False)[me]
    v_in_bwd = _prefix_combine(f_all, vl_all, reverse=True)[me]
    lab = torch.where(left_run, torch.minimum(lab, v_in_fwd[None]), lab)
    return torch.where(right_run, torch.minimum(lab, v_in_bwd[None]), lab)


def _segment_volume_sharded_fast(data, spacing, origin, params: SegmentationParams, axis) -> SegmentationResult:
    """The single-card kernel pipeline on the sharded axis; needs nxl % 8 == 0
    (an 8-x block of the certificates must not straddle shards)."""
    nxl, ny, nz = data.shape
    n_sp = axis.axis_size()
    nx = n_sp * nxl
    me = axis.axis_index()
    x_off = me * nxl

    # --- threshold + closing + global labels, with a raw-data halo
    h = 2 * params.closing_radius
    if nxl < h:
        raise _thin_shard_error(nxl, h, fast=True)
    fwd, bwd = _ring_perms(n_sp)
    left = axis.ppermute(data[-h:], fwd)
    right = axis.ppermute(data[:h], bwd)
    if me == 0:  # the volume's edges: out of band for any finite threshold
        left = torch.full_like(left, -torch.inf)
    if me == n_sp - 1:
        right = torch.full_like(right, -torch.inf)
    ext = torch.cat([left, data, right], dim=0)
    mask_ext, lab_ext = gpu_ops.close_init(ext, params.intensity_low, params.intensity_high, label_dims=(nx, ny))
    mask = mask_ext[h:h + nxl]
    # the kernel's x is the extended slab's: shift to global (background stays BIG)
    lab0 = torch.where(mask == 1, lab_ext[h:h + nxl] + (x_off - h), BIG)

    # --- tile padding of y and z only (x padding would cut runs across shards)
    pad = (0, (-nz) % 128, 0, (-ny) % 8)
    labp = F.pad(lab0, pad, value=BIG)
    resetp = F.pad((mask == 0).to(torch.int8), pad, value=1).contiguous()
    dists = gpu_ops.compute_reset_distances(resetp)

    # boundary-run masks and every line's reset summary, fixed across sweeps
    nxlp = labp.shape[0]
    ix = torch.arange(nxlp, dtype=torch.int32, device=data.device)[:, None, None]
    left_run = dists[0].to(torch.int32) == ix + 1  # no local reset at or before
    right_run = dists[1].to(torch.int32) == nxlp - ix  # no local reset at or after
    reset_any = (resetp != 0).any(0)

    # --- the single card's half-sweep schedule
    passes = params.passes if params.passes is not None else 2 * params.max_sweeps
    for _ in range(passes // 2):
        labp, _ = gpu_ops.ccl_half_sweep_yz(labp, dists)
        labp = _x_half_sweep_sharded(labp, dists, reset_any, left_run, right_run, axis)
    if passes % 2:
        labp, bad = gpu_ops.ccl_half_sweep_yz(labp, dists, with_check=True)
        bad = bad | gpu_ops.ccl_check_consistency_x(labp, dists)
    else:
        bad = gpu_ops.ccl_check_consistency(labp, dists)
    # the local x distances break runs at the slab's edges, so the kernels'
    # x check skips exactly the shard-boundary pairs
    bad = torch.maximum(bad[0], _boundary_bad(labp, resetp == 0, axis))
    converged = axis.psum(bad) == 0

    # --- z-run tables with the global offset, merged roots, exact stats
    run_lab, run_z0, run_len, cands, block_counts, num_comp_loc, max_runs_loc = gpu_ops.z_runs(
        labp, dists[4], dists[5], nx, ny, k=params.run_k, cand_k=params.cand_k, x_off=x_off
    )
    num_components = axis.psum(num_comp_loc)
    count_ok = num_components <= params.max_roots
    cand_ok = axis.psum((block_counts > params.cand_k).any().to(torch.int32)) == 0
    runs_ok = axis.pmax(max_runs_loc) <= params.run_k
    complete = count_ok & cand_ok & runs_ok

    r_eff = min(params.max_roots, cands.numel())
    loc = torch.topk(cands, r_eff, largest=False, sorted=True).values
    every = axis.all_gather(loc).reshape(-1)
    roots = torch.topk(every, min(params.max_roots, every.numel()), largest=False, sorted=True).values
    if roots.numel() < params.max_roots:
        roots = torch.cat([roots, roots.new_full((params.max_roots - roots.numel(),), BIG)])
    roots = roots.contiguous()

    sums = gpu_ops.run_stats(run_lab, run_len, run_z0, roots, exact=True)  # local x, int64
    sums = torch.cat([sums[:, :1], sums[:, 1:2] + x_off * sums[:, :1], sums[:, 2:]], dim=1)
    stats = axis.psum(sums).to(torch.float32)

    labels = labp[:, :ny, :nz]
    return finalize_segmentation(
        labels, roots, roots != BIG, stats[:, 0], stats[:, 1:4], num_components, complete, converged,
        spacing, origin, params, count_ok, cand_ok, runs_ok,
    )


# ----------------------------------------------------------------- stats
def _local_component_stats(labels_local, roots, x_off: int, ny: int, nz: int):
    """(R, 4) int64 [count, sum_i, sum_j, sum_k] over the slab with global i
    (x_off added); `psum` completes them. Roots ascending, BIG last."""
    flat = labels_local.reshape(-1)
    r = roots.numel()
    pos = torch.arange(flat.numel(), dtype=torch.int64, device=flat.device)
    idx = torch.searchsorted(roots, flat)
    hit = (flat != BIG) & (idx < r) & (roots[idx.clamp(max=r - 1)] == flat)
    gi = pos // (ny * nz)
    rem = pos - gi * (ny * nz)
    feats = torch.stack([torch.ones_like(pos), gi + x_off, rem // nz, rem % nz], dim=1)
    acc = torch.zeros((r + 1, 4), dtype=torch.int64, device=flat.device)  # row r: voxels of no root
    return acc.index_add_(0, torch.where(hit, idx, r), feats)[:r]


def segment_volume_sharded(data, spacing, origin, params: SegmentationParams, axis,
                           force_general: bool = False) -> SegmentationResult:
    """`segment_volume` of one x-slab of a volume, called by every shard
    program of `axis`.

    `data` is the local (nx/S, ny, nz) slab; the volume is the slabs
    concatenated along x in shard order. Returns a SegmentationResult whose
    `labels` and `body_mask` are the slab's and whose other fields are the
    whole volume's (equal on every shard). The certificates are global, so
    the engine's escalation applies unchanged. `axis` is the shards' mesh
    axis (`collectives.ThreadAxis` or `DistAxis`)."""
    _validate_thresholds(params)
    data = torch.as_tensor(data)
    dev = data.device
    # integer scanner slabs are cast where they lie (the halo fills with f32 -inf)
    data = data.to(torch.float32).contiguous()
    spacing = torch.as_tensor(spacing, dtype=torch.float32, device=dev)
    origin = torch.as_tensor(origin, dtype=torch.float32, device=dev)
    n_sp = axis.axis_size()
    if not force_general and n_sp == 1:
        # one shard: the collectives would be copies around the same work,
        # and the single-card pipeline gives the same results
        return segment_volume(data, spacing, origin, params)
    use_pallas = params.use_pallas is not False

    nxl, ny, nz = data.shape
    if use_pallas and nxl % 8 == 0 and params.closing_radius == 2:
        return _segment_volume_sharded_fast(data, spacing, origin, params, axis)

    nx = n_sp * nxl
    x_off = axis.axis_index() * nxl
    closed = _closed_mask_sharded(data, params.intensity_low, params.intensity_high, params.closing_radius, axis)

    # labels: global (z, y, x) raster indices
    gi = torch.arange(nxl, dtype=torch.int32, device=dev)[:, None, None] + x_off
    gj = torch.arange(ny, dtype=torch.int32, device=dev)[None, :, None]
    gk = torch.arange(nz, dtype=torch.int32, device=dev)[None, None, :]
    lin = gk * (nx * ny) + gj * nx + gi
    lab0 = torch.where(closed, lin, BIG)
    labels, converged = _ccl_sweeps_sharded(lab0, ~closed, params, axis, use_pallas)

    # roots: the slab's exact top-k, merged across shards
    is_root = (labels == lin) & (labels != BIG)
    num_components = axis.psum(is_root.sum(dtype=torch.int32))
    complete = num_components <= params.max_roots
    keys_local = torch.where(is_root, -lin, -BIG).reshape(-1)
    loc_keys = torch.topk(keys_local, min(params.max_roots, keys_local.numel())).values
    every = axis.all_gather(loc_keys).reshape(-1)
    roots = -torch.topk(every, min(params.max_roots, every.numel())).values
    if roots.numel() < params.max_roots:
        roots = torch.cat([roots, roots.new_full((params.max_roots - roots.numel(),), BIG)])

    stats = axis.psum(_local_component_stats(labels, roots, x_off, ny, nz)).to(torch.float32)
    return finalize_segmentation(
        labels, roots, roots != BIG, stats[:, 0], stats[:, 1:4], num_components, complete, converged,
        spacing, origin, params,
    )


def gather_result(parts) -> SegmentationResult:
    """One SegmentationResult of the whole volume from the shards' results:
    `labels` and `body_mask` concatenated along x on the first shard's
    device, every other field taken from the first shard (all are equal)."""
    first = parts[0]
    dev = first.labels.device
    return first._replace(
        labels=torch.cat([p.labels.to(dev) for p in parts], dim=0),
        body_mask=torch.cat([p.body_mask.to(dev) for p in parts], dim=0),
    )


def segment_volume_threads(data, spacing, origin, params: SegmentationParams, devices,
                           force_general: bool = False, timeout: Optional[float] = None) -> SegmentationResult:
    """`segment_volume_sharded` of a whole (nx, ny, nz) volume on a
    `ThreadAxis`: one x-slab and shard thread for each of `devices` (nx
    must divide evenly), and the shards' results gathered into one."""
    from mamri_tpu_torch.parallel.collectives import run_threads

    data = torch.as_tensor(data)
    nx, n_sp = data.shape[0], len(devices)
    if nx % n_sp:
        raise ValueError(f"volume x extent {nx} does not divide into {n_sp} sp shards")
    slabs = data.split(nx // n_sp, dim=0)
    args = [(slab.to(d), spacing, origin, params) for slab, d in zip(slabs, devices)]

    def shard(axis, slab, sp, org, p):
        return segment_volume_sharded(slab, sp, org, p, axis, force_general=force_general)

    return gather_result(run_threads(shard, args, devices=devices, timeout=timeout))

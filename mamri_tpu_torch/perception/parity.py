"""Kernel parity harness: every CUDA kernel against plain references.

Counterpart of `mamri_tpu/perception/parity.py` (`run_parity_checks`,
which `tools/tpu_parity.py` runs on a TPU at sizes 128 and 80). The checks
and report keys are the reference's. Each kernel runs on `device`, through
the wrappers of `gpu_ops`, and is held against a plain reference built from
the twins: the CCL fixed point from `scan_lines_plain` (the counterpart of
`_ccl_sweeps_jnp`), the stats from `component_stats_raster_plain`, the
closing from `segmentation.binary_close`. End to end, the fused branch on
`device` is held against the non-fused branch on the CPU. On the CPU the
wrappers run the twins, so `device="cpu"` tests the harness itself.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from mamri_tpu_torch.perception import gpu_ops as G
from mamri_tpu_torch.perception import segmentation as seg

BIG = G.BIG


def _scene(size, seed: int = 42):
    """Deterministic blobs + ellipsoid + sparse speckle scene (the
    reference's, with the same RNG stream). `size` may be an int (cubic) or
    an (nx, ny, nz) shape."""
    shape = (size,) * 3 if isinstance(size, int) else tuple(size)
    nx, ny, nz = shape
    rng = np.random.default_rng(seed)
    x, y, z = np.mgrid[:nx, :ny, :nz].astype(np.float32)
    data = np.full(shape, 10.0, np.float32)
    n = max(4, min(shape) // 24)
    if nx == ny == nz:
        centers = rng.integers(8, nx - 8, size=(n, 3))
    else:
        centers = np.stack([rng.integers(8, d - 8, size=n) for d in shape], axis=1)
    for c in centers:
        data[((x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2) < 16] = 120.0
    data[
        ((x - nx / 2) ** 2 / (nx / 3.2) ** 2)
        + ((y - ny / 2) ** 2 / (ny / 4) ** 2)
        + ((z - nz / 1.7) ** 2 / (nz / 3.6) ** 2)
        < 1.0
    ] = 90.0
    sp = rng.random(data.shape) < 2.5e-5
    data[sp] = 100.0
    return data


def _scan_axis_plain(lab, reset_i32, axis: int):
    lab_t = lab.movedim(axis, -1).contiguous()
    r_t = reset_i32.movedim(axis, -1).contiguous()
    n = lab_t.shape[-1]
    out = G.scan_lines_plain(lab_t.reshape(-1, n), r_t.reshape(-1, n))
    return out.reshape(lab_t.shape).movedim(-1, axis).contiguous()


def _labels_consistent(lab, reset):
    """() bool: every within-run adjacent label pair is equal along every
    axis, i.e. `lab` is the exact CCL fixed point."""
    fg = ~reset
    bad = torch.zeros((), dtype=torch.bool, device=lab.device)
    for axis in range(3):
        n = lab.shape[axis]
        pair = fg.narrow(axis, 1, n - 1) & fg.narrow(axis, 0, n - 1)
        diff = lab.narrow(axis, 1, n - 1) != lab.narrow(axis, 0, n - 1)
        bad = bad | (pair & diff).any()
    return ~bad


def _ccl_sweeps_plain(lab0, reset, sweeps: int):
    """The plain fixed point: `sweeps` rounds of the segmented min scan
    along x, y and z (the twin of kernel 12), then the consistency check.
    `reset` is bool. Returns (labels, converged)."""
    lab = lab0
    r32 = reset.to(torch.int32)
    for _ in range(sweeps):
        for axis in (0, 1, 2):
            lab = _scan_axis_plain(lab, r32, axis)
    return lab, _labels_consistent(lab, reset)


def _equal(a, b) -> bool:
    return bool(torch.equal(a.cpu(), b.cpu()))


def _segment_compare(data_np, sweeps: int, dev):
    """The fused branch's kernels on `dev` against the non-fused branch's
    twins on the CPU (the reference's kernel path vs its jnp path)."""
    sp3, org = np.ones(3, np.float32), np.zeros(3, np.float32)
    rk = seg.segment_volume(torch.as_tensor(data_np, device=dev), sp3, org,
                            seg.SegmentationParams(max_sweeps=sweeps, cand_k=16))
    rj = seg.segment_volume(torch.as_tensor(data_np), sp3, org,
                            seg.SegmentationParams(max_sweeps=sweeps, use_pallas=False))
    return {
        "centroids_max_diff_mm": float((rk.centroids_ras.cpu() - rj.centroids_ras).abs().max()),
        "volumes_exact": _equal(rk.volumes_mm3, rj.volumes_mm3),
        "num_components_exact": int(rk.num_components) == int(rj.num_components),
        "body_mask_exact": _equal(rk.body_mask, rj.body_mask),
        "certificates": {
            "converged": bool(rk.ccl_converged),
            "roots_complete": bool(rk.roots_complete),
            "blobs_complete": bool(rk.blobs_complete),
        },
    }


def run_parity_checks(size: int = 128, sweeps: int = 6, device="cuda") -> Dict:
    """Run every kernel on `device` against its plain reference; a report
    with the reference's keys, plus `all_exact` and `num_checks`."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_parity_checks(device='cuda'): torch.cuda.is_available() is False")
    data_np = _scene(size)
    data = torch.as_tensor(data_np, device=dev)
    report: Dict = {
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "backend": dev.type,
        "size": size,
    }

    # --- fused threshold + closing + label init
    mask_k, lab0_k = G.close_init(data, 65.0, 65535.0)
    mask_ref = seg.binary_close((data >= 65.0) & (data <= 65535.0), 2)
    lab0_ref = seg._init_labels(mask_ref)
    report["fused_threshold_close_init"] = {
        "mask_exact": _equal(mask_k != 0, mask_ref),
        "labels_exact": _equal(lab0_k, lab0_ref),
    }

    # --- CCL: run-length sweeps vs the plain fixed point
    reset_b = ~mask_ref
    ref_labels, ref_conv = _ccl_sweeps_plain(lab0_ref, reset_b, sweeps)
    lab0_p, reset_p = seg._pad_for_kernels(lab0_ref.clone(), reset_b.to(torch.int8))
    got_labels_p, got_conv = seg._ccl_sweeps_pallas(lab0_p, reset_p, sweeps)
    got_labels = got_labels_p[: size, : size, : size]
    report["ccl_sweep_dist"] = {
        "labels_exact": _equal(got_labels, ref_labels),
        "converged_flag": bool(got_conv) == bool(ref_conv),
    }

    # --- line-scan sweeps (kernel 12 along z, y, x)
    legacy = lab0_ref
    reset_i32 = reset_b.to(torch.int32)
    for _ in range(sweeps):
        legacy = G.ccl_sweep_pallas(legacy, reset_i32)
    report["ccl_sweep_pallas"] = {"labels_exact": _equal(legacy, ref_labels)}

    # --- root extraction vs host numpy
    cands, counts, num = G.extract_root_candidates(got_labels_p, size, size, k=16)
    flat = ref_labels.cpu().numpy().transpose(2, 1, 0).reshape(-1)
    lin = np.arange(flat.size)
    true_roots = set(map(int, lin[(flat == lin) & (flat != BIG)]))
    c = cands.cpu().numpy()
    counts_np = counts.cpu().numpy()
    report["extract_root_candidates"] = {
        "count_exact": int(num) == len(true_roots),
        "all_roots_found": true_roots.issubset(set(map(int, c[c != BIG]))) or bool(counts_np.max() > 16),
        "no_slab_overflow": bool(counts_np.max() <= 16),
    }

    # --- stats kernels vs the plain raster stats
    roots = np.full(128, BIG, np.int32)
    srt = np.sort(list(true_roots))[:128]
    roots[: len(srt)] = srt
    roots_t = torch.as_tensor(roots, device=dev)
    flat_t = torch.as_tensor(flat.copy(), device=dev)
    ref_stats = G.component_stats_raster_plain(flat_t, roots_t, size, size).cpu().numpy()
    got_raster = G.component_stats_matmul(flat_t, roots_t, size, size).cpu().numpy()
    got_xyz = G.component_stats_matmul_xyz(ref_labels.reshape(-1), roots_t, size, size, size).cpu().numpy()
    nvalid = len(srt)

    def _stats_check(got, ref):
        # exact below 2^24 (a body's coordinate sums exceed it), rtol 2e-6 above
        got, ref = got[:nvalid], ref[:nvalid]
        small = ref[:, 0] < (1 << 24) / max(size, 1)
        return {
            "max_abs_diff": float(np.abs(got - ref).max()),
            "max_rel_diff": float((np.abs(got - ref) / np.maximum(np.abs(ref), 1.0)).max()),
            "within_f32_tolerance": bool(np.allclose(got, ref, rtol=2e-6, atol=0.5)),
            "small_components_exact": bool(np.array_equal(got[small], ref[small])),
        }

    report["component_stats_matmul"] = _stats_check(got_raster, ref_stats)
    report["component_stats_matmul_xyz"] = _stats_check(got_xyz, ref_stats)

    # --- z-run extraction + run-length stats vs the same reference
    dists = G.compute_reset_distances(reset_p)
    run_lab, run_z0, run_len, root_cands, _, num_roots, max_runs = G.z_runs(
        got_labels_p, dists[4], dists[5], size, size, k=16, cand_k=16
    )
    mask_np = mask_ref.cpu().numpy()
    starts_np = mask_np & ~np.concatenate([np.zeros_like(mask_np[:, :, :1]), mask_np[:, :, :-1]], axis=2)
    got_run_stats = G.run_stats(run_lab, run_len, run_z0, roots_t).cpu().numpy()
    rk = root_cands.cpu().numpy()
    report["extract_z_runs"] = {
        "max_runs_exact": int(max_runs) == int(starts_np.sum(axis=2).max()),
        "total_length_exact": int(run_len.sum()) == int(mask_np.sum()),
        "no_line_overflow": int(max_runs) <= 16,
        "fused_roots_exact": set(map(int, rk[rk != BIG])) == true_roots and int(num_roots) == len(true_roots),
    }
    run_check = _stats_check(got_run_stats, ref_stats)
    run_check["sentinel_rows_zero"] = bool(np.all(got_run_stats[nvalid:] == 0.0))
    report["run_stats_matmul"] = run_check

    # --- compact-table stats must reproduce the dense table's bit for bit
    m = run_len.numel()
    cap = 1 << max(int((run_len > 0).sum()) * 2 - 1, 1).bit_length()
    cap = min(max(cap, 256), m)
    lab_c, len_c, z0_c, gi_c, gj_c, _ = seg.compact_runs(run_lab, run_len, run_z0, cap)
    got_compact = G.run_stats_compact(lab_c, len_c, z0_c, gi_c, gj_c, roots_t).cpu().numpy()
    report["run_stats_matmul_compact"] = {
        "bitexact_vs_dense": bool(np.array_equal(got_compact, got_run_stats)),
        **_stats_check(got_compact, ref_stats),
    }

    # --- end to end, cubic and on a non-cubic grid
    report["segment_volume_end_to_end"] = _segment_compare(data_np, sweeps, dev)
    ashape = (size + 32, size, max(48, size // 2))
    report["segment_volume_anisotropic"] = {
        "shape": "x".join(map(str, ashape)),
        **_segment_compare(_scene(ashape, seed=7), sweeps, dev),
    }

    def _collect(d):
        oks = []
        for v in d.values():
            if isinstance(v, dict):
                oks.extend(_collect(v))
            elif isinstance(v, bool):
                oks.append(v)
        return oks

    checks = _collect({k: v for k, v in report.items() if isinstance(v, dict)})
    report["all_exact"] = all(checks)
    report["num_checks"] = len(checks)
    return report

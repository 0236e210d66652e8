"""Per-stage timing of the PyTorch port's segmentation kernels on the card.

The port's counterpart of tools/profile_stages.py, on its scene (12
spheres of radius 4 voxels and an ellipsoid body, seed 0, SIZE^3). Each
stage goes through `perception/gpu_ops.py` (and the sweeps through
`segmentation._ccl_sweeps_pallas_from_dists`): the fused threshold +
closing + initial labels, the three axes' reset distances, two full CCL
sweeps, the three-axis fixed-point check, the z-run tables with their
root candidates, and the run stats at 128 and 2048 roots. On the card a
stage's time is the median of its CUDA-event times over --reps calls, each
queued behind a spin kernel so that the events hold the card's time, not
the host's enqueue (the L2 is not flushed); with --cpu the stages run the
plain twins, timed on the host clock.

Prints one line per stage.

    python tools/profile_stages_torch.py [SIZE] [--reps 8] [--cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

SPIN_CYCLES = 4_000_000  # ~2.4 ms at 1.7 GHz: longer than the host takes to enqueue a stage


def profile_scene(size):
    """tools/profile_stages.py's volume: (size,)*3 f32."""
    rng = np.random.default_rng(0)
    x, y, z = np.mgrid[:size, :size, :size].astype(np.float32)
    data = np.full((size,) * 3, 10.0, np.float32)
    for c in rng.integers(10, size - 10, size=(12, 3)):
        data[((x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2) < 16] = 120.0
    data[
        ((x - size / 2) ** 2 / (size / 3.2) ** 2)
        + ((y - size / 2) ** 2 / (size / 4) ** 2)
        + ((z - size / 1.7) ** 2 / (size / 3.6) ** 2)
        < 1
    ] = 90.0
    return data


def _median_ms(fn, make_args, reps):
    """Median time of fn(*make_args()) (arguments made outside the timing):
    CUDA events behind a spin on a card, the host clock on the CPU; NaN
    for no reps."""
    import torch

    times = []
    for _ in range(reps):
        args = make_args()
        if args[0].device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda._sleep(SPIN_CYCLES)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn(*args)
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)) if times else float("nan")


def run_stages(data, reps=8):
    """[(stage, median ms of `reps` calls, outputs)] on `data`'s device: the
    kernels on a card, their twins on the CPU. The outputs are one call's,
    made outside the timing."""
    import torch

    from mamri_tpu_torch.perception import gpu_ops
    from mamri_tpu_torch.perception import segmentation as seg

    size = data.shape[0]
    rows = []

    def stage(name, fn, *args, fresh=()):
        """`fresh`: positions of arguments the stage writes in place, cloned
        for every call."""

        def make():
            return tuple(a.clone() if i in fresh else a for i, a in enumerate(args))

        out = fn(*make())  # the result (and a warm-up)
        rows.append((name, _median_ms(fn, make, reps), out))
        return out

    mask, lab0 = stage("close_init", lambda d: gpu_ops.close_init(d, 65.0, 65535.0), data)
    lab0p, resetp = seg._pad_for_kernels(lab0, mask == 0)
    dists = stage("reset_distances (x, y, z)", gpu_ops.compute_reset_distances, resetp.to(torch.int8).contiguous())
    labp, _ = stage("ccl sweeps (2)", lambda lab, dd: seg._ccl_sweeps_pallas_from_dists(lab, dd, 2),
                    lab0p, dists, fresh=(0,))
    stage("ccl_check_consistency (y, z, x)", gpu_ops.ccl_check_consistency, labp, dists)
    run_lab, run_z0, run_len = stage(
        "z_runs (+ root candidates)",
        lambda lab, a, b: gpu_ops.z_runs(lab, a, b, size, size, k=8, cand_k=8), labp, dists[4], dists[5],
    )[:3]
    for r in (128, 2048):
        roots = torch.arange(r, dtype=torch.int32, device=data.device)
        stage(f"run_stats R={r}", gpu_ops.run_stats, run_lab, run_len, run_z0, roots)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("size", nargs="?", type=int, default=256)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--cpu", action="store_true", help="run the twins on the CPU (default: the kernels on the card)")
    args = ap.parse_args(argv)
    import torch

    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("profile_stages_torch: no CUDA card (pass --cpu for the twins on the CPU)")
    data = torch.from_numpy(profile_scene(args.size)).to("cpu" if args.cpu else "cuda")
    where = "cpu (twins, host clock)" if args.cpu else f"{torch.cuda.get_device_name(0)} (kernels, CUDA events)"
    print(f"profile_stages {args.size}^3 on {where}, median of {args.reps}")
    for name, ms, _ in run_stages(data, args.reps):
        print(f"{name:40s} {ms:9.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())

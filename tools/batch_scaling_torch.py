"""Batch scaling of the PyTorch port: batch 1 -> 64 at 256^3 on the card.

The port's counterpart of tools/batch_scaling.py, with its method and its
record. For each batch size the batch (bench.py's canonical scene, repeated)
is staged on the device once, the upload timed apart (`h2d_f32_s`, and
`h2d_i16_s` for the int16 batch, half the bytes); the timed reps run the
engine's batch program (`MamriEngine._get_batch_pipeline`) on the resident
buffers and fetch the results. `microbatch` sets how many volumes' results
are held on the device before a fetch. The int16 batch is checked once, at
the smallest size, to give the float32 batch's angles exactly, and is
freed before the float32 batch is staged, so one input batch is resident
at a time. On `torch.cuda.OutOfMemoryError` a size is retried down the
microbatch ladder (8, 4, 2, 1).

Prints one JSON line per configuration.

    python tools/batch_scaling_torch.py [--sizes 1,8,16,32,64] [--micro 0,0,0,8,8] [--volume 256] [--cpu]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

_SMALL = ("success", "seg_converged", "roots_complete", "blobs_complete", "angles")


def bench_batch_volume(model, size):
    """bench.py's canonical scene at size^3 (the first of its 4)."""
    from mamri_tpu_torch.api.demo import bench_scenes, render_bench_scene

    scenes, spacing, origin, body_center = bench_scenes(model, size)
    return render_bench_scene(scenes[0][2], (size,) * 3, spacing, origin, body_center)


def run_config(engine, vol, b, mb, reps, int16_check):
    """One (batch, microbatch) configuration on resident buffers: its record
    and the float32 batch's results."""
    import torch

    data = np.asarray(vol.data)
    microbatch = mb if mb > 0 else None
    fn = engine._get_batch_pipeline(data.shape, engine.seg_params, microbatch)
    dev = engine.device

    def stage(host_batch):
        t0 = time.perf_counter()
        staged = torch.from_numpy(host_batch).to(dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return staged, time.perf_counter() - t0

    batch = np.broadcast_to(data, (b,) + data.shape).copy()
    rec = {"batch": b, "microbatch": mb}
    if int16_check:
        dev16, h2d16 = stage(batch.astype(np.int16))
        out16 = fn(dev16, vol.spacing, vol.origin)
        del dev16
        rec["h2d_i16_s"] = round(h2d16, 2)
    staged, h2d32 = stage(batch)

    t0 = time.perf_counter()
    out = fn(staged, vol.spacing, vol.origin)
    first = time.perf_counter() - t0  # the first call of this shape
    ok = bool(out["success"].all())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(staged, vol.spacing, vol.origin)
        times.append(time.perf_counter() - t0)
    del staged
    t = min(times)
    rec.update(
        vols_per_s=round(b / t, 2),
        secs_per_batch=round(t, 4),
        success=ok,
        certified=bool(out["seg_converged"].all() and out["roots_complete"].all() and out["blobs_complete"].all()),
        h2d_f32_s=round(h2d32, 2),
        first_call_s=round(first, 1),
    )
    if int16_check:
        rec["int16_matches"] = bool(np.array_equal(out["angles"], out16["angles"]))
    return rec, {k: out[k] for k in _SMALL}


def scale(engine, vol, sizes, micros, reps, emit=print):
    """Every configuration, retried down the microbatch ladder on running
    out of device memory. -> [(record, results or None), ...]."""
    import torch

    done, int16_done = [], False
    for b, mb in zip(sizes, micros):
        attempts = [mb] + [m for m in (8, 4, 2, 1) if m < b and (mb == 0 or m < mb)]
        for mb_try in attempts:
            want_int16 = b == min(sizes) and not int16_done
            try:
                rec, small = run_config(engine, vol, b, mb_try, reps, want_int16)
            except torch.cuda.OutOfMemoryError as e:
                torch.cuda.empty_cache()
                rec, small = {"batch": b, "microbatch": mb_try, "error": str(e)[:200]}, None
                emit(json.dumps(rec))
                done.append((rec, small))
                continue
            int16_done = int16_done or want_int16
            emit(json.dumps(rec))
            done.append((rec, small))
            break
    return done


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default="1,8,16,32,64")
    ap.add_argument("--volume", type=int, default=256)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--micro", default="0,0,0,8,8", help="microbatch per batch size; 0: one fetch per batch")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    if args.reps < 1:
        ap.error("--reps must be >= 1")
    args.sizes = [int(s) for s in args.sizes.split(",")]
    args.micro = [int(m) for m in args.micro.split(",")]
    if len(args.micro) < len(args.sizes):
        ap.error("--micro needs a value for every batch size")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    from mamri_tpu_torch.api.engine import MamriEngine
    from mamri_tpu_torch.core.robot import load_robot_model

    engine = MamriEngine(device="cpu" if args.cpu else "cuda")
    vol = bench_batch_volume(load_robot_model(device="cpu"), args.volume)
    done = scale(engine, vol, args.sizes, args.micro, args.reps)
    return 0 if all(r.get("success") and r.get("certified") for r, small in done if small is not None) else 1


if __name__ == "__main__":
    sys.exit(main())

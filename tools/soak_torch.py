"""Sustained-operation soak of the PyTorch port: N frames through
`PoseTracker`, mixed clean / noisy / shape-changing, with memory, the
pipeline cache and latency drift tracked.

The port's counterpart of tools/soak.py, with its frame mix and its JSON
keys. Frames go up as scanner-native int16 (half the bytes of float32). A
noisy frame (400 speckle components in the fiducial band and N(0, 5) noise)
comes every --noisy-every frames and must certify through the engine's
escalation; every --alt-every frames the scan's shape changes (x 1.5 times
longer), so a second pipeline joins the engine's bounded cache. On the card
it measures: whether every frame solves, frame latency (p50, p95, max, the
p50 of each half of the run, fps), the host's resident memory now
(`rss_now_growth_mb`, VmRSS after against before) and at its peak
(`rss_peak_growth_mb`), and the cache's size.

Prints one JSON line (and writes it to --out).

    python tools/soak_torch.py [--frames 200] [--size 192] [--noisy-every 20] [--alt-every 50] [--cpu]
"""

import argparse
import gc
import json
import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def _vm_rss_mb():
    """The current resident set (MB); ru_maxrss is the peak."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return -1.0


def soak_volumes(model, size):
    """{"clean": [4 int16 bench scenes at size^3], "alt": the first at
    (1.5 size, size, size), "noisy": the first with speckle and noise}, and
    the two shapes (tools/soak.py's frames, seeds and all)."""
    from mamri_tpu_torch.api.demo import bench_scenes, render_bench_scene
    from mamri_tpu_torch.perception.volume import Volume

    scenes, spacing, origin, body_center = bench_scenes(model, size)

    def render(pts, shape):
        # per-axis spacing keeps the physical extent of every shape
        sp = (spacing * size / np.asarray(shape)).astype(np.float32)
        return render_bench_scene(pts, shape, sp, origin, body_center)

    def compact(v):
        return Volume(v.data.astype(np.int16), v.spacing, v.origin)

    shape_a = (size,) * 3
    shape_b = (size + size // 2, size, size)
    clean = [compact(render(s[2], shape_a)) for s in scenes]
    alt = compact(render(scenes[0][2], shape_b))

    rng = np.random.default_rng(7)
    noisy_f = clean[0].data.astype(np.float32)
    idx = rng.integers(0, np.asarray(shape_a) - 1, size=(400, 3))
    noisy_f[idx[:, 0], idx[:, 1], idx[:, 2]] = 120.0
    noisy_f = noisy_f + rng.normal(0.0, 5.0, noisy_f.shape).astype(np.float32)
    noisy = Volume(np.clip(np.round(noisy_f), -32768, 32767).astype(np.int16), spacing, origin)
    return {"clean": clean, "alt": alt, "noisy": noisy}, shape_a, shape_b


def run_soak(engine, vols, frames, noisy_every, alt_every, on_frame=None):
    """Warm every shape, then `frames` frames. -> (latencies s, kinds,
    alt deferred past the end, tracker, wall s, rss figures). `on_frame(i,
    kind, volume, result)` sees every timed frame."""
    from mamri_tpu_torch.api.streaming import PoseTracker

    tracker = PoseTracker(engine)
    for v in (vols["clean"][0], vols["alt"], vols["noisy"]):
        tracker.step(v)
    if tracker.failures:
        raise RuntimeError("warm-up frames must all solve")
    tracker.tracer.spans["frame"].clear()
    tracker.frames = tracker.failures = 0

    gc.collect()
    rss0, vm0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss, _vm_rss_mb()
    lat, kinds = [], {"clean": 0, "noisy": 0, "alt": 0}
    pending_alt = False  # an alt frame deferred because it met a noisy one
    t_start = time.perf_counter()
    for i in range(frames):
        want_noisy = noisy_every and i % noisy_every == noisy_every - 1
        want_alt = alt_every and i % alt_every == alt_every - 1
        if want_noisy and want_alt:
            pending_alt = True  # noisy wins this frame; alt runs on the next
        if want_noisy:
            kind, v = "noisy", vols["noisy"]
        elif want_alt or pending_alt:
            pending_alt = False
            kind, v = "alt", vols["alt"]
        else:
            kind, v = "clean", vols["clean"][i % len(vols["clean"])]
        t0 = time.perf_counter()
        r = tracker.step(v)
        lat.append(time.perf_counter() - t0)
        kinds[kind] += 1
        if not r.success:
            print(json.dumps({"soak": "FAIL", "frame": i, "kind": kind, "message": r.message}), flush=True)
        if on_frame is not None:
            on_frame(i, kind, v, r)
    wall = time.perf_counter() - t_start
    gc.collect()
    rss1, vm1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss, _vm_rss_mb()
    return lat, kinds, pending_alt, tracker, wall, (rss1 - rss0) / 1024.0, vm1 - vm0


def soak_record(frames, engine, lat, kinds, pending_alt, tracker, wall, rss_peak_mb, rss_now_mb, shape_a, shape_b):
    """tools/soak.py's JSON record of a run of `frames` frames."""

    def p50(xs):
        return sorted(xs)[len(xs) // 2]

    first, second = lat[: len(lat) // 2], lat[len(lat) // 2:]
    lat_sorted = sorted(lat)
    return {
        "metric": "soak",
        "frames": frames,
        "kinds": kinds,
        # a noisy / alt collision on the last frame defers the alt past the end
        "alt_deferred_past_end": pending_alt,
        "failures": tracker.failures,
        "all_success": tracker.failures == 0,
        "p50_ms": round(p50(lat) * 1e3, 2),
        "p95_ms": round(lat_sorted[min(int(len(lat) * 0.95), len(lat) - 1)] * 1e3, 2),
        "max_ms": round(lat_sorted[-1] * 1e3, 2),
        # drift: the p50 of the run's first half against its second half
        "p50_first_half_ms": round(p50(first) * 1e3, 2) if first else None,
        "p50_second_half_ms": round(p50(second) * 1e3, 2) if second else None,
        "fps": round(frames / wall, 2),
        "wall_s": round(wall, 1),
        "rss_peak_growth_mb": round(rss_peak_mb, 1),
        "rss_now_growth_mb": round(rss_now_mb, 1),
        "pipeline_cache_entries": len(engine._pipeline_cache),
        "volume": f"{shape_a} + alt {shape_b}",
        "dtype": "int16 frames (compact ingest)",
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=200)
    # the smallest grid whose voxels resolve band-legal (50-1500 mm^3)
    # fiducials over the bench's union box
    ap.add_argument("--size", type=int, default=192)
    ap.add_argument("--noisy-every", type=int, default=20)
    ap.add_argument("--alt-every", type=int, default=50)
    ap.add_argument("--out", default="")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    if args.frames < 1:
        ap.error("--frames must be >= 1")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    from mamri_tpu_torch.api.engine import MamriEngine
    from mamri_tpu_torch.core.robot import load_robot_model

    engine = MamriEngine(device="cpu" if args.cpu else "cuda")
    vols, shape_a, shape_b = soak_volumes(load_robot_model(device="cpu"), args.size)
    run = run_soak(engine, vols, args.frames, args.noisy_every, args.alt_every)
    result = soak_record(args.frames, engine, *run, shape_a, shape_b)
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0 if result["all_success"] else 1


if __name__ == "__main__":
    sys.exit(main())

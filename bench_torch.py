"""Benchmark of the PyTorch port: batched 256^3 scan -> joint-angles
throughput on one NVIDIA GPU, with bench.py's scenes, measurements and record.

The port's counterpart of bench.py (which drives `mamri_tpu` on a TPU). It
runs the engine's defaults, exactly what `estimate_pose` runs: the 3-half-
sweep CCL schedule with the fixed-point certificate, 128 candidate roots
with the completeness certificate, the blob-band certificate and the
analytic-seeded 24-iteration IK. The headline is the WORST of bench.py's 4
scenes (its canonical pose and 3 seeded random poses and base yaws, in one
shared union-bbox grid). Each block below ports a block of bench.py:

  * `build_scenes`      the scenes and their volumes (bench.py:49-95, :144-155)
  * `make_fns`          the batched and single functions (:158-178)
  * `scene_throughput`  per-scene checks, escalation and throughput (:180-246)
  * `sync_latency`      synchronous single-volume round trips (:250-255)
  * `chained_latency`   K dependent calls behind one fence (:257-277)
  * `streaming`         `PoseTracker` sync, pipelined, int16, ROI (:283-352)
  * `planning`          entry search, up-over-down path, 8-distance sweep (:358-387)
  * `noisy_volume`, `noisy_scan`  the dense-speckle scan at the noisy settings (:394-449)
  * `large_spacing`, `large_volume`  the anisotropic large volume (:455-518)
  * `run`               every block, composed into bench.py's record (:520-576)

A batch is the per-volume program (`MamriEngine._get_pipeline`) run on each
row of a batch resident on the device, its outputs stacked on the device;
throughput enqueues `reps` batches and fences once on the last one's RMSE
(`MamriEngine._fetch`), as bench.py does. On the card every number includes
the host's enqueue, and the frame and planning times the PCIe upload and
the result fetch; there is no relay. `vs_baseline` is null: BASELINE.md's
64 vol/s is a TPU target. `p50_sync_incl_relay_rtt_ms` keeps bench.py's key
and holds the host <-> card round trip.

    python3 bench_torch.py [--cpu]

reads bench.py's environment: BENCH_BATCH (16), BENCH_SIZE (256), BENCH_REPS
(5), BENCH_STREAM_FRAMES (12), BENCH_LARGE (512x512x192; "off" skips the
large volume). It runs on the card unless --cpu is given; without a card
and without --cpu it exits 1 and prints no record. Prints ONE JSON line.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

TARGET_STREAM_MS = 100.0  # the tracker's interactive bar (api/streaming.py `stats`)
KEEP = ("angles", "rmse", "success", "seg_converged", "roots_complete", "blobs_complete")
SWEEP_MM = [2.0, 5.0, 7.5, 10.0, 12.5, 15.0, 17.5, 20.0]


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _p50(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def _p95(xs):
    xs = sorted(xs)
    return xs[min(int(len(xs) * 0.95), len(xs) - 1)]


def _round(x):
    return None if x is None else round(x, 2)


def build_scenes(model, size):
    """bench.py's 4 scenes in their union box at size^3: (scenes, spacing,
    origin, body_center, volumes), each scene (true angles, base, markers)."""
    from mamri_tpu_torch.api.demo import bench_scenes, render_bench_scene

    scenes, spacing, origin, body_center = bench_scenes(model, size)
    vols = [render_bench_scene(pts, (size,) * 3, spacing, origin, body_center) for _, _, pts in scenes]
    return scenes, spacing, origin, body_center, vols


def make_fns(engine, shape, spacing, origin, params, keep=KEEP):
    """(fb, f1): the per-volume program at `params` for volumes of `shape`
    with the batch's fixed arguments (no saved baseplate, zero current
    angles). f1(d) is one call on a device volume; fb(d) runs it on each row
    of a device batch and stacks the `keep` outputs on the device. Neither
    reads anything back."""
    import torch

    pipeline = engine._get_pipeline(shape, params)
    fixed = engine._batch_fixed(spacing, origin, False)

    def f1(d):
        out = pipeline(d, *fixed)
        return {k: out[k] for k in keep}

    def fb(d):
        outs = [f1(row) for row in d]
        return {k: torch.stack([o[k] for o in outs]) for k in keep}

    return fb, f1


def device_batch(engine, data, batch):
    """`data` as a (batch, *shape) batch materialized on the engine's device."""
    one = engine._upload(data)
    return one.unsqueeze(0).expand((batch,) + tuple(one.shape)).contiguous()


def _tcp(engine, angles, base):
    import torch

    from mamri_tpu_torch.core.robot import fk_all_links

    f32 = torch.float32
    return fk_all_links(engine.model, engine._upload(angles, f32), engine._upload(base, f32))[-1, :3, 3].cpu().numpy()


def scene_throughput(engine, scenes, dev_batches, fns_for, batch, reps):
    """Per scene: the batch until it certifies (escalated as bench.py does,
    with the untargeted step), the honesty checks, then `reps` batches
    enqueued behind one fence. -> bench.py's `per_scene` rows."""
    per_scene = []
    for si, ((true_angles, base, _), dev_batch) in enumerate(zip(scenes, dev_batches)):
        params = engine.seg_params
        while True:
            res = engine._fetch(fns_for(params)[0](dev_batch))
            converged = bool(res["seg_converged"].all())
            complete = bool(res["roots_complete"].all())
            blobs_ok = bool(res["blobs_complete"].all())
            certified = converged and complete and blobs_ok
            if certified:
                break
            stronger = engine._escalate_seg_params(params, converged, complete, blobs_ok)
            if stronger is None:
                break
            params = stronger
        fb_s = fns_for(params)[0]
        ok = bool(res["success"].all())
        est = res["angles"][0]
        err_deg = np.degrees(np.abs(est - true_angles))
        tcp_err = float(np.linalg.norm(_tcp(engine, true_angles, base) - _tcp(engine, est, base)))
        rmse = float(res["rmse"].max())
        solved = bool(ok and certified and rmse < 1.5 and tcp_err < 2.0 and err_deg[0] < 1.5)

        t0 = time.perf_counter()
        outs = [fb_s(dev_batch) for _ in range(reps)]
        engine._fetch({"rmse": outs[-1]["rmse"]})
        vols_per_s = batch * reps / (time.perf_counter() - t0)
        per_scene.append(
            {
                "scene": si,
                "vols_per_s": round(vols_per_s, 3),
                "solved": solved,
                "certified": certified,
                "escalated": params != engine.seg_params,
                "passes": params.passes,
                "rmse_mm": round(rmse, 4),
                "tcp_err_mm": round(tcp_err, 4),
                "max_angle_err_deg": round(float(err_deg.max()), 4),
            }
        )
    return per_scene


def sync_latency(engine, f1, dev_one, reps):
    """p50 ms of max(2 reps, 10) calls, each followed by a fetch of its RMSE."""
    lats = []
    for _ in range(max(reps * 2, 10)):
        t0 = time.perf_counter()
        engine._fetch({"rmse": f1(dev_one)["rmse"]})
        lats.append(time.perf_counter() - t0)
    return _p50(lats) * 1e3


def chained_latency(engine, f1, dev_one, k, samples):
    """(p50, p95) ms per call of `k` dependent calls behind one fence,
    `samples` times: each call's input is the volume plus 0 x the previous
    call's RMSE, so no call can start before the one before it ends."""
    import torch

    per_call = []
    for _ in range(samples):
        t0 = time.perf_counter()
        r = torch.zeros((), dtype=torch.float32, device=dev_one.device)
        for _ in range(k):
            r = f1(dev_one + 0.0 * r)["rmse"]
        engine._fetch({"rmse": r})
        per_call.append((time.perf_counter() - t0) / k)
    return _p50(per_call) * 1e3, _p95(per_call) * 1e3


def streaming(engine, vols, spacing, origin, n_frames):
    """`PoseTracker` over fresh host frames: sync float32 (p50, p95),
    pipelined depth 1 (frames/s), sync int16 (p50) and ROI int16 on scene 0
    (p50; anchor and window frames first). -> a dict of bench.py's values."""
    from mamri_tpu_torch.api.streaming import PoseTracker
    from mamri_tpu_torch.perception.volume import Volume

    frames = [np.array(v.data, copy=True) for v in vols]
    fail = []

    def frame(data):
        return Volume(data=data, spacing=spacing, origin=origin)

    def sync(frame_list, mode):
        tr = PoseTracker(engine)
        tr.step(frame(frame_list[0]))
        tr.tracer.spans["frame"].clear()
        lats = []
        for i in range(n_frames):
            t0 = time.perf_counter()
            r = tr.step(frame(frame_list[i % len(frame_list)]))
            lats.append(time.perf_counter() - t0)
            if not r.success:
                fail.append(mode)
        return _p50(lats) * 1e3, _p95(lats) * 1e3

    p50_ms, p95_ms = sync(frames, "sync_f32")

    tracker = PoseTracker(engine, pipelined=True, depth=1)
    tracker.step(frame(frames[0]))  # fill
    t0 = time.perf_counter()
    for i in range(n_frames):
        r = tracker.step(frame(frames[i % len(frames)]))
        if r is not None and not r.success:
            fail.append("pipelined")
    for r in tracker.flush():
        if not r.success:
            fail.append("pipelined")
    fps = n_frames / (time.perf_counter() - t0)

    frames_i16 = [f.astype(np.int16) for f in frames]
    i16_p50_ms, _ = sync(frames_i16, "sync_int16")

    roi = PoseTracker(engine, roi_margin_mm=40.0)
    roi.step(frame(frames_i16[0]))  # anchor (full)
    roi.step(frame(frames_i16[0]))  # the window's first frame
    roi.tracer.spans["frame"].clear()
    roi_lats = []
    for _ in range(n_frames):
        t0 = time.perf_counter()
        r = roi.step(frame(frames_i16[0]))
        roi_lats.append(time.perf_counter() - t0)
        if not r.success:
            fail.append("roi_int16")
    roi_stats = roi.stats()
    roi_mb = float(np.prod(roi_stats["roi_shape"]) * 2 / 1e6) if "roi_shape" in roi_stats else None
    return {
        "p50_ms": p50_ms,
        "p95_ms": p95_ms,
        "pipelined_fps": fps,
        "int16_frames_p50_ms": i16_p50_ms,
        "roi_int16_p50_ms": _p50(roi_lats) * 1e3,
        "roi_stats": roi_stats,
        "roi_upload_mb_per_frame": roi_mb,
        "full_upload_mb_per_frame": frames[0].nbytes / 1e6,
        "failed_modes": sorted(set(fail)),
    }


def timed_p50(fn, reps):
    """p50 ms of `reps` calls after one warm-up call."""
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return _p50(ts) * 1e3


def planning(engine, vol, target, reps):
    """`estimate_pose` of `vol`, then the entry search, the up-over-down path
    and the 8-distance sweep, each p50 ms of `reps`. A failed pose or entry
    search skips what needs it and leaves its times None (valid JSON, not
    NaN). -> bench.py's `planning` block."""
    est = engine.estimate_pose(vol)
    plan_ok = bool(est.success)
    entry_ms = path_ms = sweep_ms = None
    if plan_ok:
        entry_ms = timed_p50(lambda: engine.find_entry_point(target), reps)
        ep = engine.find_entry_point(target)
        plan_ok = bool(ep.found)
    if plan_ok:
        path_ms = timed_p50(
            lambda: engine.plan_heuristic_path(target, ep.point_ras, 5.0, start_pose_steps=est.steps), reps
        )
        sweep_ms = timed_p50(lambda: engine.plan_trajectory_sweep(target, ep.point_ras, SWEEP_MM), reps)
        plan = engine.plan_heuristic_path(target, ep.point_ras, 5.0, start_pose_steps=est.steps)
        plan_ok = plan.success and not plan.collision_detected
    return {
        "entry_search_p50_ms": _round(entry_ms),
        "heuristic_path_p50_ms": _round(path_ms),
        "safety_sweep8_p50_ms": _round(sweep_ms),
        "success_collision_free": bool(plan_ok),
        "includes": "public-API calls incl. one host fetch each (host <-> card, no relay); eager torch on the "
                    "engine's device",
    }


def noisy_volume(data, size):
    """bench.py's dense-speckle variant of `data`: 1500 lone bright voxels
    (numpy seed 5; none within 2 voxels of a bright one) + N(0, 5) noise."""
    rng = np.random.default_rng(5)
    noisy = np.array(data, copy=True)
    idx = rng.integers(2, size - 2, size=(1500, 3))
    bright = noisy > 60.0
    for i, j, k in idx:
        if not bright[i - 2 : i + 3, j - 2 : j + 3, k - 2 : k + 3].any():
            noisy[i, j, k] = 100.0
    return noisy + rng.normal(0.0, 5.0, noisy.shape).astype(np.float32)


def noisy_scan(engine, noisy, spacing, origin, true_angles, batch, reps):
    """The noisy scan as a `batch`-row batch at the settings the engine's
    targeted escalation lands on (max_roots 4096 > 256: the compact run
    stats), one checked batch, then max(reps // 2, 2) batches behind one
    fence. -> bench.py's `noisy_scan` block."""
    from mamri_tpu_torch.perception.segmentation import SegmentationParams

    params = SegmentationParams(max_sweeps=2, passes=3, max_roots=4096, cand_k=64, run_k=8)
    fbn, _ = make_fns(engine, noisy.shape, spacing, origin, params, KEEP + ("num_components",))
    dev_noisy = device_batch(engine, noisy, batch)
    res = engine._fetch(fbn(dev_noisy))
    err_deg = float(np.degrees(np.abs(res["angles"] - true_angles[None])).max())
    t0 = time.perf_counter()
    outs = [fbn(dev_noisy) for _ in range(max(reps // 2, 2))]
    engine._fetch({"rmse": outs[-1]["rmse"]})
    return {
        "vols_per_s": round(batch * len(outs) / (time.perf_counter() - t0), 3),
        "speckle_components": int(res["num_components"].max()),
        "certified_no_truncation": bool(
            res["seg_converged"].all() and res["roots_complete"].all() and res["blobs_complete"].all()
        ),
        "success": bool(res["success"].all()),
        "max_angle_err_deg": round(err_deg, 4),
        "settings": "max_roots=4096, cand_k=64, run_k=8, compact stats (targeted-escalation landing point, one compile)",
    }


def large_spacing(spacing, size, lshape):
    """bench.py's large-volume spacing: the bench grid's cube (`size` voxels
    of `spacing`) spread over `lshape`."""
    extent = spacing * size
    return (extent / np.asarray(lshape)).astype(np.float32)


def large_volume(engine, markers, spacing, origin, body_center, size, lshape, reps):
    """Scene 0 rendered into `lshape` over the bench grid's cube: escalated
    until it certifies, then `reps` single calls behind one fence.
    -> bench.py's `large_volume` block."""
    from mamri_tpu_torch.api.demo import render_bench_scene

    lspacing = large_spacing(spacing, size, lshape)
    lvol = render_bench_scene(markers, lshape, lspacing, origin, body_center)
    dev_large = engine._upload(lvol.data)
    params = engine.seg_params
    while True:
        f1 = make_fns(engine, lshape, lspacing, origin, params)[1]
        res = engine._fetch(f1(dev_large))
        conv, comp, blob = bool(res["seg_converged"]), bool(res["roots_complete"]), bool(res["blobs_complete"])
        if conv and comp and blob:
            break
        stronger = engine._escalate_seg_params(params, conv, comp, blob)
        if stronger is None:
            break
        params = stronger
    t0 = time.perf_counter()
    outs = [f1(dev_large) for _ in range(reps)]
    engine._fetch({"rmse": outs[-1]["rmse"]})
    return {
        "shape": "x".join(map(str, lshape)),
        "vols_per_s": round(reps / (time.perf_counter() - t0), 3),
        "success": bool(res["success"]),
        "certified": conv and comp and blob,
        "escalated": params != engine.seg_params,
        "rmse_mm": round(float(res["rmse"]), 4),
    }


def run(device, size, batch, reps, stream_frames, large, chain_k=10, chain_samples=10, plan_reps=8):
    """Every block of bench.py on `device` ("cuda" or "cpu") at bench.py's
    settings; `large` is an "AxBxC" shape, or "", "0" or "off" to skip the
    large volume. -> bench.py's record."""
    from mamri_tpu_torch.api.engine import MamriEngine

    engine = MamriEngine(device=device)  # the default (certified) settings throughout
    scenes, spacing, origin, body_center, vols = build_scenes(engine.model, size)
    shape = (size,) * 3
    fns = {}

    def fns_for(params):
        if params not in fns:
            fns[params] = make_fns(engine, shape, spacing, origin, params)
        return fns[params]

    fb, f1 = fns_for(engine.seg_params)
    dev_batches = [device_batch(engine, v.data, batch) for v in vols]
    dev_one = engine._upload(vols[0].data)
    engine._fetch({"rmse": fb(dev_batches[0])["rmse"]})  # warm-up
    engine._fetch({"rmse": f1(dev_one)["rmse"]})

    per_scene = scene_throughput(engine, scenes, dev_batches, fns_for, batch, reps)
    del dev_batches
    worst = min(per_scene, key=lambda s: s["vols_per_s"])
    pipeline_success = all(s["solved"] for s in per_scene)

    p50_sync_ms = sync_latency(engine, f1, dev_one, reps)
    p50_device_ms, p95_device_ms = chained_latency(engine, f1, dev_one, chain_k, chain_samples)
    del dev_one

    st = streaming(engine, vols, spacing, origin, stream_frames)
    plan = planning(engine, vols[0], np.asarray(body_center, np.float32), plan_reps)
    noisy = noisy_scan(engine, noisy_volume(vols[0].data, size), spacing, origin, scenes[0][0], batch, reps)
    lv = None
    if large not in ("", "0", "off"):
        lshape = tuple(int(t) for t in large.split("x"))
        lv = large_volume(engine, scenes[0][2], spacing, origin, body_center, size, lshape, reps)

    return {
        "metric": f"scan->joint-angles throughput, batched {size}^3 MRI volumes (worst of {len(scenes)} scenes)",
        "value": worst["vols_per_s"],
        "unit": "volumes/sec",
        "vs_baseline": None,
        "p50_latency_ms": round(p50_device_ms, 2),
        "p95_latency_ms": round(p95_device_ms, 2),
        "p50_sync_incl_relay_rtt_ms": round(p50_sync_ms, 2),
        "batch": batch,
        "volume": f"{size}^3",
        "pipeline_success": bool(pipeline_success),
        "per_scene": per_scene,
        "streaming": {
            "p50_ms": round(st["p50_ms"], 2),
            "p95_ms": round(st["p95_ms"], 2),
            "pipelined_fps": round(st["pipelined_fps"], 2),
            "int16_frames_p50_ms": round(st["int16_frames_p50_ms"], 2),
            "roi_int16_p50_ms": round(st["roi_int16_p50_ms"], 2),
            "roi_frames": st["roi_stats"].get("roi_frames"),
            "roi_fallbacks": st["roi_stats"].get("roi_fallbacks"),
            "roi_upload_mb_per_frame": _round(st["roi_upload_mb_per_frame"]),
            "full_upload_mb_per_frame": round(st["full_upload_mb_per_frame"], 2),
            "device_only_p50_ms": round(p50_device_ms, 2),
            "device_only_interactive": p50_device_ms < TARGET_STREAM_MS,
            "frames": stream_frames,
            "all_success": not st["failed_modes"],
            "failed_modes": st["failed_modes"],
            "interactive": st["p50_ms"] < TARGET_STREAM_MS,
            "includes": "host read + H2D upload (PCIe) + host enqueue + device compute + result fetch, per frame, "
                        "no relay (pipelined_fps overlaps them across frames; device_only_p50_ms is the chained "
                        "per-call time on a device-resident volume, the host's enqueue included)",
        },
        "planning": plan,
        "large_volume": lv,
        "noisy_scan": noisy,
        "settings": "engine defaults (certified): [yz,x,yz] half-sweep schedule + local-consistency certificate, "
                    "128 roots, run_k=8 run-length stats, 32-slot certified blob band, IK 24 iters analytic-seeded",
        "angle_err_note": "per-joint wrist deviations equal the converged SciPy-TRF-from-truth bound on identical "
                          "residuals (voxel-centroid quantization gauge freedom, IK_ORACLE.json; invariants: "
                          "rmse_mm, tcp_err_mm, J1)",
        "device": card_line() if engine.device.type == "cuda" else "cpu",
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    import torch

    if not args.cpu and not torch.cuda.is_available():
        print("bench_torch: torch.cuda.is_available() is False: no CUDA card (pass --cpu for the CPU)",
              file=sys.stderr)
        return 1
    env = os.environ.get
    record = run(
        "cpu" if args.cpu else "cuda",
        size=int(env("BENCH_SIZE", "256")),
        batch=int(env("BENCH_BATCH", "16")),
        reps=int(env("BENCH_REPS", "5")),
        stream_frames=int(env("BENCH_STREAM_FRAMES", "12")),
        large=env("BENCH_LARGE", "512x512x192"),
    )
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())

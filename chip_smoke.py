#!/usr/bin/env python3
"""Drive the PyTorch port's scan -> pose path once on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit) and the torch / CUDA
   versions, and builds the CUDA kernels from `mamri_tpu_torch/csrc/`.
2. Holds every kernel against its plain-torch twin on the same CUDA inputs
   (exact equality: every output is an integer or an exact integer sum) at
   256^3, at 80^3 (a shape that does not divide the (8, 8, 128) tiles) and
   at 512x512x192, and times both (CUDA events, median of 5).
3. Runs `MamriEngine(device="cuda").estimate_pose` on bench.py's canonical
   scene rendered into 256^3 (random-free synthetic scan, known pose): one
   warm-up, then 5 timed calls. Checks the pose against the truth.
4. Escalated paths: a speckle scene must escalate through the compact
   run-stats kernel; a starved sweep budget (even half-sweep count) must
   converge through the three-axis fixed-point check.
5. One 512x512x192 frame through `estimate_pose`.

Launch counts are reset just before phase 3 and read after phase 5; every
kernel of the path must have launched. The last two lines are the kernels'
JSON and the result JSON; any failure raises and exits non-zero. Without
CUDA it exits 1 and prints no result.
"""

import json
import logging
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
REPS = 5
TRUE_ANGLES = np.array([0.3, -0.7, 0.5, 0.2, -0.4, 0.6], dtype=np.float32)
MARKER_LINKS = ("Baseplate", "Joint2", "Joint4", "Joint6")
PALLAS = "mamri_tpu/perception/pallas_ops.py"
KERNELS = {  # wrapper -> (CUDA source, the TPU kernel it replaces)
    "close_init": ("mamri_tpu_torch/csrc/close_init.cu", f"{PALLAS}:211"),
    "reset_distances": ("mamri_tpu_torch/csrc/ccl.cu", f"{PALLAS}:295"),
    "run_min": ("mamri_tpu_torch/csrc/ccl.cu", f"{PALLAS}:408"),
    "check": ("mamri_tpu_torch/csrc/ccl.cu", f"{PALLAS}:562"),
    "z_runs": ("mamri_tpu_torch/csrc/runs.cu", f"{PALLAS}:713"),
    "run_stats": ("mamri_tpu_torch/csrc/runs.cu", f"{PALLAS}:816"),
    "run_stats_compact": ("mamri_tpu_torch/csrc/runs.cu", f"{PALLAS}:893"),
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def med_ms(fn, make_args, reps=REPS):
    """Median CUDA-event time of fn(*make_args()) over `reps` runs (the
    arguments are made outside the timed region)."""
    import torch

    fn(*make_args())  # warm-up
    times = []
    for _ in range(reps):
        args = make_args()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# ------------------------------------------------------------------ scenes
def _base_tf(yaw, t=(-60.0, -120.0, 0.0)):
    import torch
    from mamri_tpu_torch.core import transforms as T

    return T.translate(torch.tensor(t)) @ T.rot_x(-np.pi / 2) @ T.rot_z(yaw)


def _markers(model, angles, base):
    import torch
    from mamri_tpu_torch.core.robot import marker_world_positions

    a = torch.as_tensor(angles, dtype=torch.float32)
    return torch.cat([marker_world_positions(model, a, ln, base) for ln in MARKER_LINKS]).numpy()


def bench_scene(model, shape):
    """bench.py's canonical scene (its first of 4, with the union bounding
    box of all 4) rendered into `shape` with per-axis spacing."""
    from mamri_tpu_torch.perception.volume import synthetic_volume

    rng = np.random.default_rng(23)
    limits = model.limits_rad.cpu().numpy()
    lo_lim, hi_lim = limits[:, 0], limits[:, 1]
    scenes = [(TRUE_ANGLES, _base_tf(0.15))]
    for _ in range(3):
        frac = 0.25 + 0.5 * rng.random(6)
        angles = (lo_lim + frac * (hi_lim - lo_lim)).astype(np.float32)
        if abs(angles[4]) < 0.3:
            angles[4] = np.float32(0.3 if angles[4] >= 0 else -0.3)
        scenes.append((angles, _base_tf(float(rng.uniform(-0.4, 0.4)))))
    pts = [_markers(model, a, b) for a, b in scenes]
    body_center = np.array([-60.0, -40.0, 130.0])
    all_pts = np.concatenate(pts)
    lo = np.minimum(all_pts.min(0) - 40, body_center - 75)
    hi = np.maximum(all_pts.max(0) + 40, body_center + 75)
    lps_lo = np.array([-hi[0], -hi[1], lo[2]], dtype=np.float32)
    lps_hi = np.array([-lo[0], -lo[1], hi[2]], dtype=np.float32)
    ext = lps_hi - lps_lo
    if shape[0] == shape[1] == shape[2]:
        spacing = np.full(3, float(ext.max()) / shape[0], dtype=np.float32)  # bench.py's grid
    else:
        spacing = (ext / np.asarray(shape, dtype=np.float32)).astype(np.float32)
    vol = synthetic_volume(
        shape=shape, spacing=spacing, origin=lps_lo, fiducials_ras=pts[0],
        fiducial_radius_mm=4.0, body_center_ras=body_center, body_radii_mm=[45.0, 55.0, 65.0],
    )
    return vol, scenes[0][1]


def test_scene(model, spacing):
    """tests/test_engine.py's scene (`_make_scene`) at `spacing` mm."""
    from mamri_tpu_torch.perception.volume import synthetic_volume

    pts = _markers(model, TRUE_ANGLES, _base_tf(0.15))
    body_center = np.array([-60.0, -40.0, 130.0])
    lo = np.minimum(pts.min(0) - 40, body_center - 75)
    hi = np.maximum(pts.max(0) + 40, body_center + 75)
    lps_lo = np.array([-hi[0], -hi[1], lo[2]])
    lps_hi = np.array([-lo[0], -lo[1], hi[2]])
    sp = np.array([spacing] * 3, dtype=np.float32)
    shape = tuple(int(np.ceil(e)) for e in (lps_hi - lps_lo) / sp)
    return synthetic_volume(
        shape=shape, spacing=sp, origin=lps_lo, fiducials_ras=pts, fiducial_radius_mm=4.0,
        body_center_ras=body_center, body_radii_mm=[45.0, 55.0, 65.0],
    )


def speckle_scene(model):
    """tests/test_engine.py:305-319: 1400 lone bright voxels + N(0, 5) noise."""
    from mamri_tpu_torch.perception.volume import Volume

    vol = test_scene(model, 2.5)
    data = np.asarray(vol.data).copy()
    rng = np.random.default_rng(11)
    idx = rng.integers(0, np.array(data.shape)[None, :], size=(1400, 3))
    bright = data > 60.0
    for i, j, k in idx:
        if not bright[max(i - 2, 0):i + 3, max(j - 2, 0):j + 3, max(k - 2, 0):k + 3].any():
            data[i, j, k] = 100.0
    data = data + rng.normal(0.0, 5.0, data.shape).astype(np.float32)
    return Volume(data=data.astype(np.float32), spacing=vol.spacing, origin=vol.origin)


# ------------------------------------------------------- phase 2: kernels
def compare_kernels(data_np, label, card, failures, timings):
    """Every kernel against its twin on the same CUDA inputs, stage by
    stage through the segmentation of one volume."""
    import torch
    from mamri_tpu_torch.perception import gpu_ops as g
    from mamri_tpu_torch.perception.segmentation import _pad_for_kernels, compact_runs

    dev = torch.device("cuda")
    data = torch.as_tensor(data_np).to(dev)
    nx, ny, nz = data.shape
    errs = {}

    def record(name, got, want, kernel_ms, plain_ms):
        got = got if isinstance(got, (tuple, list)) else (got,)
        want = want if isinstance(want, (tuple, list)) else (want,)
        err = 0.0
        for a, b in zip(got, want):
            if a.shape != b.shape:
                failures.append(f"{label} {name}: shape {tuple(a.shape)} != {tuple(b.shape)}")
                err = float("inf")
                continue
            if a.numel():
                err = max(err, float((a.double() - b.double()).abs().max()))
        if err != 0.0:
            failures.append(f"{label} {name}: max |kernel - twin| = {err}")
        errs[name] = max(errs.get(name, 0.0), err)
        timings.setdefault(label, {})[name] = (kernel_ms, plain_ms)
        print(f"kernel {label} {name}: max_abs_err={err} ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} ({card})")

    lo, hi = 65.0, 65535.0
    got, want = g.close_init(data, lo, hi), g.close_init_plain(data, lo, hi)
    record("close_init", got, want,
           med_ms(g.close_init, lambda: (data, lo, hi)),
           med_ms(g.close_init_plain, lambda: (data, lo, hi)))
    mask, lab0 = got
    lab0, reset = _pad_for_kernels(lab0, (mask == 0).to(torch.int8))

    dists = []
    for axis in (0, 1, 2):
        got, want = g.reset_distances(reset, axis), g.reset_distances_plain(reset, axis)
        record("reset_distances", got, want,
               med_ms(g.reset_distances, lambda: (reset, axis)),
               med_ms(g.reset_distances_plain, lambda: (reset, axis)))
        dists.extend(got)

    # the engine's schedule [yz, x, yz], each half-sweep held against the twin
    lab = lab0.clone()
    for axis in (1, 2, 0, 1, 2):
        df, db = dists[2 * axis], dists[2 * axis + 1]
        a, fa = lab.clone(), g.new_flag(dev)
        b, fb = lab.clone(), g.new_flag(dev)
        g.run_min(a, df, db, axis, fa)
        g.run_min_plain(b, df, db, axis, fb)
        record("run_min", (a, fa), (b, fb),
               med_ms(g.run_min, lambda: (lab.clone(), df, db, axis, g.new_flag(dev))),
               med_ms(g.run_min_plain, lambda: (lab.clone(), df, db, axis, g.new_flag(dev))))
        lab = a
    for labels in (lab0, lab):
        for axis in (0, 1, 2):
            df = dists[2 * axis]
            fa, fb = g.new_flag(dev), g.new_flag(dev)
            g.check(labels, df, axis, fa)
            g.check_plain(labels, df, axis, fb)
            record("check", fa, fb,
                   med_ms(g.check, lambda: (labels, df, axis, g.new_flag(dev))),
                   med_ms(g.check_plain, lambda: (labels, df, axis, g.new_flag(dev))))

    k, cand_k = 8, 8
    args = (lab, dists[4], dists[5], nx, ny, k, cand_k)
    got, want = g.z_runs(*args), g.z_runs_plain(*args)
    record("z_runs", got, want, med_ms(g.z_runs, lambda: args), med_ms(g.z_runs_plain, lambda: args))
    run_lab, run_z0, run_len, cands = got[:4]
    roots = torch.topk(cands, min(256, cands.numel()), largest=False).values.contiguous()
    args = (run_lab, run_len, run_z0, roots)
    record("run_stats", g.run_stats(*args), g.run_stats_plain(*args),
           med_ms(g.run_stats, lambda: args), med_ms(g.run_stats_plain, lambda: args))
    cols = compact_runs(run_lab, run_len, run_z0, 32768)[:5]
    args = (*cols, roots)
    record("run_stats_compact", g.run_stats_compact(*args), g.run_stats_compact_plain(*args),
           med_ms(g.run_stats_compact, lambda: args), med_ms(g.run_stats_compact_plain, lambda: args))
    return errs


# ---------------------------------------------------- phases 3-5: the path
class _Escalations(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def check_pose(engine, res, truth, label, rmse_max=0.5):
    seg = engine.last_segmentation
    certs = {k: bool(seg[k]) for k in ("seg_converged", "roots_complete", "blobs_complete")}
    j1_err_deg = float(np.degrees(abs(res.angles_rad[0] - truth[0]))) if res.success else float("nan")
    print(f"{label}: success={res.success} markers={res.markers_found} rmse_mm={res.rmse_mm} "
          f"J1_err_deg={j1_err_deg} certificates={certs} num_components={int(seg['num_components'])}")
    if not res.success:
        raise AssertionError(f"{label}: estimate_pose failed: {res.message}")
    if not all(res.markers_found.values()):
        raise AssertionError(f"{label}: not every marker triplet found: {res.markers_found}")
    if not all(certs.values()):
        raise AssertionError(f"{label}: certificates not held: {certs}")
    if not res.rmse_mm < rmse_max:
        raise AssertionError(f"{label}: RMSE {res.rmse_mm} mm >= {rmse_max}")
    if not j1_err_deg < 1.0:
        raise AssertionError(f"{label}: |J1 - truth| = {j1_err_deg} deg >= 1")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from mamri_tpu_torch import _build
    from mamri_tpu_torch.api.engine import MamriEngine
    from mamri_tpu_torch.core.robot import load_robot_model
    from mamri_tpu_torch.perception import gpu_ops
    from mamri_tpu_torch.perception.segmentation import SegmentationParams

    # ---- phase 1: card, versions, build
    card = card_line()
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.library()
    print(f"kernels built/loaded in {time.perf_counter() - t0:.3f} s "
          f"(nvcc {_build.last_build['seconds']:.3f} s) -> {_build.last_build['path']}")
    for line in _build.last_build["log"].splitlines():
        if "registers" in line or "error" in line.lower() or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # ---- phase 2: kernels vs twins
    model = load_robot_model(device="cpu")
    vol256, base256 = bench_scene(model, (256, 256, 256))
    vol512, _ = bench_scene(model, (512, 512, 192))
    from mamri_tpu_torch.perception.volume import synthetic_volume

    vol80 = synthetic_volume(
        shape=(80, 80, 80), fiducials_ras=np.array([[10.0, 5.0, 0.0], [-20.0, 12.0, 8.0], [3.0, -25.0, -15.0]]),
        body_center_ras=[0.0, 8.0, -6.0], body_radii_mm=[20.0, 14.0, 25.0], noise_sigma=20.0, seed=5,
    )
    failures, timings, errs = [], {}, {}
    for label, vol in (("256^3", vol256), ("80^3", vol80), ("512x512x192", vol512)):
        for name, e in compare_kernels(vol.data, label, card, failures, timings).items():
            errs[name] = max(errs.get(name, 0.0), e)
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError("kernels disagree with their twins:\n" + "\n".join(failures))

    # ---- phases 3-5: the port's path; counts from here on are the path's
    gpu_ops.reset_launch_counts()
    engine = MamriEngine(device="cuda")
    engine.estimate_pose(vol256)  # warm-up
    lat = []
    for _ in range(REPS):
        engine.current_angles = np.zeros(6, np.float32)
        t0 = time.perf_counter()
        res = engine.estimate_pose(vol256)
        lat.append((time.perf_counter() - t0) * 1e3)
    check_pose(engine, res, TRUE_ANGLES, "main 256^3")
    p50 = float(np.median(lat))
    print(f"estimate_pose 256^3 p50_ms={p50:.3f} all_ms={[round(x, 3) for x in lat]} ({card})")
    default_path = ("close_init", "reset_distances", "run_min", "check", "z_runs", "run_stats")
    missing = [n for n in default_path if gpu_ops.LAUNCHES[n] == 0]
    if missing:
        raise AssertionError(f"default path did not launch: {missing} ({gpu_ops.LAUNCHES})")
    print(f"default path launches: {dict(gpu_ops.LAUNCHES)}")

    log = logging.getLogger("mamri_tpu_torch.api.engine")
    esc = _Escalations()
    log.addHandler(esc)
    try:
        before = gpu_ops.LAUNCHES["run_stats_compact"]
        eng = MamriEngine(device="cuda")
        res = eng.estimate_pose(speckle_scene(model))
        check_pose(eng, res, TRUE_ANGLES, "speckle 2.5 mm", rmse_max=1.5)
        if not any("escalation" in m for m in esc.messages):
            raise AssertionError("speckle scene did not escalate")
        if int(eng.last_segmentation["num_components"]) <= 1000:
            raise AssertionError("speckle scene: the final segmentation missed speckle components")
        if gpu_ops.LAUNCHES["run_stats_compact"] == before:
            raise AssertionError("speckle scene: compact run_stats never launched")
        print(f"speckle escalations: {[m for m in esc.messages if 'escalation' in m]}")

        esc.messages.clear()
        before = gpu_ops.LAUNCHES["check"]
        eng = MamriEngine(device="cuda", seg_params=SegmentationParams(max_sweeps=1, max_roots=128))
        res = eng.estimate_pose(test_scene(model, 2.5))  # passes = 2*max_sweeps: even
        check_pose(eng, res, TRUE_ANGLES, "starved sweeps 2.5 mm", rmse_max=1.5)
        if gpu_ops.LAUNCHES["check"] == before:
            raise AssertionError("starved sweeps: the three-axis check never launched")
        print(f"starved-sweep escalations: {[m for m in esc.messages if 'escalation' in m]}")
    finally:
        log.removeHandler(esc)

    eng = MamriEngine(device="cuda")
    ms512 = []
    for _ in range(2):  # a cold call, then a warm one
        eng.current_angles = np.zeros(6, np.float32)
        t0 = time.perf_counter()
        res = eng.estimate_pose(vol512)
        ms512.append((time.perf_counter() - t0) * 1e3)
        check_pose(eng, res, TRUE_ANGLES, "512x512x192")
    print(f"estimate_pose 512x512x192 cold_ms={ms512[0]:.3f} warm_ms={ms512[1]:.3f} ({card})")
    counts = dict(gpu_ops.LAUNCHES)
    missing = [n for n, c in counts.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels of the path never launched: {missing} ({counts})")

    main_t = timings["256^3"]
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": src,
            "replaces": replaces,
            "launches": counts[name],
            "max_abs_err": errs[name],
            "ms": main_t[name][0],
            "plain_ms": main_t[name][1],
        }
        for name, (src, replaces) in KERNELS.items()
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

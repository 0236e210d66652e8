#!/usr/bin/env python3
"""Drive the PyTorch port's scan -> pose paths once on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit) and the torch / CUDA
   versions, and builds the CUDA kernels from `mamri_tpu_torch/csrc/`.
2. Holds every kernel against its plain-torch twin on the same CUDA inputs
   (exact equality: every output is an integer or an exact integer sum) at
   256^3, at 80^3 (a shape that does not divide the (8, 8, 128) tiles) and
   at 512x512x192, and times both (CUDA events, median of 5) beside the
   kernel's bound (the bytes it must move at 3.35 TB/s, or its operations
   at 67 T/s, whichever is larger; for `run_min` and `z_runs`, whose
   traffic depends on the data, the bytes this volume needs, with the
   bytes of every input and output counted whole printed beside them). Each timed launch follows a 128 MB
   read that flushes the 50 MB L2 (and writes its dirty lines back before
   the timer starts), so a kernel moves to and from device memory the
   bytes its bound counts; a spin kernel then keeps the card busy while
   the host enqueues the timed call, so no host time lies between the
   events. Times are kept per variant of a kernel
   (`reset_distances[z]`, `run_min[y.2]`, `root_candidates[k16]`, ...).
   The four stats wrappers (two kernels) are also held against their twins at 4096 roots
   (the escalated size, where their tables take most of a block's shared
   memory) and on a 512x512x192 volume that is one component (every
   coordinate sum above 2^32, every update on one row; `root_candidates`
   there finds one root among all-foreground voxels); `root_candidates` also
   runs on close_init's labels, where every foreground voxel is a root
   (`all-roots`, kept out of the JSON's `ms` as `R4096` is), and one profiled
   call of each stats wrapper gives the device time of every launch behind
   it (profiled again, up to 5 sessions, when torch.profiler records no
   device activity; printed as not measured after that). An empty kernel, launched once, twice and three times in a row
   behind the same flush and spin, gives the launch floor
   (`launch_floor_ms`): the least a wrapper of that many dependent launches
   can take, whatever its bytes.
   Then `segment_volume` alone on the device-resident scans, both
   branches at 256^3 and 512x512x192: one warm-up, p50 of 5 (host clock,
   each call ends in a synchronize), and its device time (CUDA events
   behind a spin that outlasts the host's enqueue of the whole call).
3. Runs `MamriEngine(device="cuda").estimate_pose` on bench.py's canonical
   scene rendered into 256^3 (random-free synthetic scan, known pose): one
   warm-up, then 5 timed calls. Checks the pose against the truth. Then one
   more call under `torch.cuda.set_sync_debug_mode("warn")`: a line gives
   how many synchronizing calls it reported and the file:line of each, and
   none may come from `api/engine.py` (`_fetch`'s one wait per attempt is
   a CUDA event's, which the mode does not report).
4. Escalated paths: a speckle scene must escalate through the compact
   run-stats kernel; a starved sweep budget (even half-sweep count) must
   converge through the three-axis fixed-point check.
5. One 512x512x192 frame through `estimate_pose`.
6. The non-fused branch: `estimate_pose` with `closing_radius=1` at 256^3
   (one warm-up, 5 timed calls) and at 512x512x192 (cold, then warm). It
   must launch `component_stats_xyz` and never `close_init`.
7. The kernel-parity harness, `run_parity_checks` at sizes 128 and 80 on the
   card: every check must hold.
8. Batch and async at 256^3: bench.py's four scenes as one
   `estimate_pose_batch` (every row passes check_pose's criteria and equals
   `estimate_pose` of its volume on the card exactly, and the batch launches
   exactly the kernels of those four calls), timed (p50 of 5) against four
   sequential `estimate_pose` calls; a batch with one noisy volume (only it
   escalates, every row equal to its single call); three frames through
   `estimate_pose_async` / `estimate_pose_collect`, each equal to the
   synchronous path's, with dispatch and collect times and the host syncs
   the sync debug mode reports under dispatch (printed, not failed on).
9. Planning on the bench scene at 256^3 after `estimate_pose`: the
   collision world's build, `find_entry_point`, `plan_trajectory`,
   `plan_trajectory_sweep` over 3 distances, `plan_heuristic_path` (100
   steps) and `validate_plan_exact`, each p50 of 5 on the card, and each held
   against the same call of a `device="cpu"` engine carrying the same state:
   the world and entry point equal, flags equal, angles within 1e-3 rad.
10. A stream from disk on the clinical grid (512x512x192, phase 5's): the
   bench scene at the poses a0 + 0.02 k, k = 0..3, written as int16 raw
   NRRD (frame 0 also as a DICOM series and as NIfTI) by the port's writers
   into a temporary directory under `build/`, each file read back by
   `load_volume` equal to what was written (ms per format printed; whether
   the native host library was built, printed too). Then `PoseTracker`:
   synchronous on the full frames, ROI (40 mm; 3 ROI frames, no fallback,
   angles within 0.2 deg of the full frames'), a pose jump past a 25 mm
   window (the same step falls back to the full frame), pipelined depth 1
   (within 1e-4 rad of the synchronous result with the host frame
   overwritten as soon as `step` returns; then the 4 frames), re-planning
   on the 256^3 bench scene (`replan_every=2` over 2 frames: one plan),
   int16 against float32 (bit-equal), and one stream frame's launches
   against one `estimate_pose`'s, full and ROI. Frame p50 per mode, the
   upload of a float32 frame, an int16 frame and the ROI window, and the
   engine tracer's report are printed. After the path's counts are read,
   every kernel is held against its twin at the frozen ROI window's shape.
11. The engine's whole surface on the bench scene at 256^3: (a)
   `match_mode="global"` interleaved with the default mode, 5 calls each
   (poses bit-equal, the same launches per call, p50 of each; one global
   call's host syncs), and the global matcher alone on the card against
   the CPU (8 dropout trials at K = 32, one case at K = 128: equal `found`
   and `member_ids`), timed beside the greedy matcher; (b) the state
   methods against a `device="cpu"` engine given the same state (FK within
   1e-4 mm, the same reports, tables and actions), timed; (c) the planned
   keyframes on `hw.sim.simulated_hardware` on the real clock at the
   reference's 150 ms tick, the sync loop running and a `watch` thread
   subscribed: success, the encoder at the last keyframe, the engine's
   angles following, the ticks, pose_cb p50 / p95 and the frames watched
   printed; (d) every export (OBJ, glTF, HTML viewer, animated trajectory,
   posed STLs, a 960x720 PNG) from both engines under `build/`, compared
   (vertices, transforms and boxes within 1e-3 mm, at most 0.5 % of the
   pixels differ) and timed; (d) runs before (c), which moves the card
   engine's pose. Neither the exports nor the hardware loop may launch a
   kernel.

Each kernel path (phases 3-5, 6, 7, 8's batch and its async frames, 10, 11's global calls) runs
with the launch counts set to 0 just before it and read just after it (for
phase 8, the launches of its own calls are tallied); every kernel of a path
must have launched in it. Planning launches no kernel. The last two lines are the kernels' JSON and the result JSON; any
failure raises and exits non-zero. A kernel's JSON entry gives its slowest
variant at 256^3 (`ms`, `plain_ms`, `bound_ms` of that variant) and every
variant's times in `ms_by_variant`; the kernels' JSON also carries
`launch_floor_ms`. Without CUDA it exits 1 and prints no
result.
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
BODY_CENTER = np.array([-60.0, -40.0, 130.0], dtype=np.float32)  # bench.py's body, the planning target
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
    "scan_lines": ("mamri_tpu_torch/csrc/scan_lines.cu", f"{PALLAS}:93"),
    "root_candidates": ("mamri_tpu_torch/csrc/roots.cu", f"{PALLAS}:503"),
    "component_stats_xyz": ("mamri_tpu_torch/csrc/stats.cu", f"{PALLAS}:1046"),
    "component_stats_raster": ("mamri_tpu_torch/csrc/stats.cu", f"{PALLAS}:964"),
}
# H100 SXM peaks: HBM3 bytes/s, and the non-tensor f32 rate, against which the
# kernels' 32-bit integer operations (compares, mins, adds) are counted
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
STRESS_VARIANTS = ("R4096", "all-roots")  # timed beside the others, kept out of a kernel's `ms`
SPIN_CYCLES = 4_000_000  # ~2.4 ms at 1.7 GHz: longer than the host takes to enqueue a timed call
SEGMENT_SPIN_CYCLES = 40_000_000  # ~24 ms: longer than the host takes to enqueue a whole segment_volume


def bound(nbytes, nops):
    """(least ms, "bytes" or "operations"): the larger of the two times."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / ALU_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


_FLUSH = []


def flush_l2():
    """Read 128 MB (over twice the H100's 50 MB L2): evicts whatever a
    kernel would find cached and writes the dirty lines back now, so the
    next kernel pays for neither. (A write would leave L2 full of dirty
    lines for the timed kernel to write back.)"""
    import torch

    if not _FLUSH:
        _FLUSH.extend([torch.ones(32 << 20, dtype=torch.float32, device="cuda"),
                       torch.empty((), dtype=torch.float32, device="cuda")])
    torch.sum(_FLUSH[0], dim=0, out=_FLUSH[1])


def med_ms(fn, make_args, reps=REPS, spin=SPIN_CYCLES):
    """Median CUDA-event time of fn(*make_args()) over `reps` runs, each
    launched with the L2 flushed (arguments made and L2 flushed outside the
    timed region) and queued behind a spin kernel, so that the start event
    fires when the card reaches the call, not before the host has issued
    it."""
    import torch

    fn(*make_args())  # warm-up
    times = []
    for _ in range(reps):
        args = make_args()
        flush_l2()
        torch.cuda._sleep(spin)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def launch_floor(card):
    """{"1": ms, "2": ms, "3": ms}: an empty kernel launched once, twice and
    three times in a row on one stream, timed as every kernel is."""
    import torch
    from mamri_tpu_torch import _build

    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream

    def noop(launches):
        err = lib.mamri_noop(launches, stream)
        if err != 0:
            raise RuntimeError(f"mamri_noop: CUDA error {err}")

    floor = {str(k): med_ms(noop, lambda: (k,)) for k in (1, 2, 3)}
    print(f"launch_floor_ms={json.dumps(floor)} ({card})")
    return floor


def launch_split(fn, make_args, tries=5):
    """([(kernel or memset name, device microseconds), ...], sessions) of
    one call of fn(*make_args()) with the L2 flushed, in launch order, from
    one profiled call. torch.profiler has now and then come back from a
    session with no device events at all (one run of this script on an
    H100 lost the third of its 18 profiled calls so), so an empty session is profiled
    again, up to `tries` sessions; the split is None if none of them showed
    device activity. The split is a breakdown printed beside the CUDA-event
    times, which do not depend on it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn(*make_args())  # warm-up
    for session in range(1, tries + 1):
        args = make_args()
        flush_l2()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn(*args)
            torch.cuda.synchronize()
        parts = sorted((e.time_range.start, e.name, e.time_range.elapsed_us()) for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        if parts:
            # a kernel's name without its signature
            return [(name.split("(")[0], us) for _, name, us in parts], session
    return None, tries


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


def bench_scenes(model, shape, count=4):
    """bench.py's scenes (its canonical pose and 3 seeded random ones), the
    first `count` of them, each rendered into `shape` in the union bounding
    box of all 4 (per-axis spacing where `shape` is not a cube): [(volume,
    true angles, base transform), ...]."""
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
    all_pts = np.concatenate(pts)
    lo = np.minimum(all_pts.min(0) - 40, BODY_CENTER - 75)
    hi = np.maximum(all_pts.max(0) + 40, BODY_CENTER + 75)
    lps_lo = np.array([-hi[0], -hi[1], lo[2]], dtype=np.float32)
    lps_hi = np.array([-lo[0], -lo[1], hi[2]], dtype=np.float32)
    ext = lps_hi - lps_lo
    if shape[0] == shape[1] == shape[2]:
        spacing = np.full(3, float(ext.max()) / shape[0], dtype=np.float32)  # bench.py's grid
    else:
        spacing = (ext / np.asarray(shape, dtype=np.float32)).astype(np.float32)
    return [
        (synthetic_volume(shape=shape, spacing=spacing, origin=lps_lo, fiducials_ras=p, fiducial_radius_mm=4.0,
                          body_center_ras=BODY_CENTER, body_radii_mm=[45.0, 55.0, 65.0]), a, b)
        for p, (a, b) in list(zip(pts, scenes))[:count]
    ]


def bench_scene(model, shape):
    """bench.py's canonical scene (its first of 4, with the union bounding
    box of all 4) rendered into `shape`: (volume, base transform)."""
    vol, _, base = bench_scenes(model, shape, count=1)[0]
    return vol, base


def test_scene(model, spacing):
    """tests/test_engine.py's scene (`_make_scene`) at `spacing` mm."""
    from mamri_tpu_torch.perception.volume import synthetic_volume

    pts = _markers(model, TRUE_ANGLES, _base_tf(0.15))
    lo = np.minimum(pts.min(0) - 40, BODY_CENTER - 75)
    hi = np.maximum(pts.max(0) + 40, BODY_CENTER + 75)
    lps_lo = np.array([-hi[0], -hi[1], lo[2]])
    lps_hi = np.array([-lo[0], -lo[1], hi[2]])
    sp = np.array([spacing] * 3, dtype=np.float32)
    shape = tuple(int(np.ceil(e)) for e in (lps_hi - lps_lo) / sp)
    return synthetic_volume(
        shape=shape, spacing=sp, origin=lps_lo, fiducials_ras=pts, fiducial_radius_mm=4.0,
        body_center_ras=BODY_CENTER, body_radii_mm=[45.0, 55.0, 65.0],
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
    stage through the segmentation of one volume, each timed beside its
    bound. Bytes: each input read once, each output written once. Operations
    (32-bit integer): per cell, close_init 34 (threshold, two ball(2) passes
    of 15, label), reset_distances 4, run_min 2, check 3, z_runs 2,
    scan_lines 4, root_candidates 2 (+ 8 per foreground voxel), stats 2 (+
    log2 R + 10 per matched voxel or run)."""
    import torch
    from mamri_tpu_torch.perception import gpu_ops as g
    from mamri_tpu_torch.perception.segmentation import _pad_for_kernels, compact_runs

    dev = torch.device("cuda")
    data = torch.as_tensor(data_np).to(dev)
    nx, ny, nz = data.shape
    n = data.numel()
    errs = {}

    def record(name, got, want, fn=None, plain=None, make_args=None, nbytes=0, nops=0, variant=None,
               contract_bytes=None):
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
        tag = f"{name}[{variant}]" if variant else name
        if fn is None:
            print(f"kernel {label} {tag}: max_abs_err={err}")
            return
        kernel_ms, plain_ms = med_ms(fn, make_args), med_ms(plain, make_args)
        bound_ms, bound_by = bound(nbytes, nops)
        timings.setdefault(label, {}).setdefault(name, {})[variant or name] = (kernel_ms, plain_ms, bound_ms,
                                                                               bound_by)
        contract = "" if contract_bytes is None else f", {contract_bytes} B counting every input and output whole"
        print(f"kernel {label} {tag}: max_abs_err={err} ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={bound_ms:.4f} ({bound_by}, {nbytes} B{contract}) ({card})")

    def both(name, fn, plain, make_args, nbytes, nops, variant=None, split=False):
        got, want = fn(*make_args()), plain(*make_args())
        record(name, got, want, fn, plain, make_args, nbytes, nops, variant)
        if split:
            parts, sessions = launch_split(fn, make_args)
            shown = (f"not measured (torch.profiler recorded no device activity in {sessions} sessions)"
                     if parts is None else ", ".join(f"{kernel} {us:.1f}" for kernel, us in parts))
            if parts is not None and sessions > 1:
                shown += f" (profiled in session {sessions}: the earlier ones recorded no device activity)"
            print(f"launches {label} {name}{f'[{variant}]' if variant else ''}, device us each: {shown}")
        return got

    lo, hi = 65.0, 65535.0
    mask, lab0 = both("close_init", g.close_init, g.close_init_plain, lambda: (data, lo, hi), 9 * n, 34 * n)
    lab0, reset = _pad_for_kernels(lab0, (mask == 0).to(torch.int8))
    npad = lab0.numel()

    dists = []
    for axis in (0, 1, 2):
        dists.extend(both("reset_distances", g.reset_distances, g.reset_distances_plain,
                          lambda: (reset, axis), 5 * npad, 4 * npad, "xyz"[axis]))

    # the engine's schedule [yz, x, yz], each half-sweep held against the twin
    lab = lab0.clone()
    for step, axis in enumerate((1, 2, 0, 1, 2)):
        df, db = dists[2 * axis], dists[2 * axis + 1]
        a, fa = lab.clone(), g.new_flag(dev)
        b, fb = lab.clone(), g.new_flag(dev)
        g.run_min(a, df, db, axis, fa)
        g.run_min_plain(b, df, db, axis, fb)
        # what this step needs: every label and df read, the labels that change written (db bounds
        # the same runs as df, so the function can do without it)
        record("run_min", (a, fa), (b, fb), g.run_min, g.run_min_plain,
               lambda: (lab.clone(), df, db, axis, g.new_flag(dev)), 6 * npad + 4 * int((b != lab).sum()),
               2 * npad, f"{'xyz'[axis]}.{step // 3 + 1}", contract_bytes=12 * npad)
        lab = a
    for state, labels in (("init", lab0), ("swept", lab)):
        for axis in (0, 1, 2):
            df = dists[2 * axis]
            both("check", g.check, g.check_plain, lambda: (labels, df, axis, g.new_flag(dev)), 6 * npad, 3 * npad,
                 f"{'xyz'[axis]} {state}")

    k, cand_k = 8, 8
    nyq = -(-lab.shape[1] // 128) * 128
    m = lab.shape[0] * k * nyq
    nblocks = (lab.shape[0] // 8) * (nyq // 128)
    z_args = (lab, dists[4], dists[5], nx, ny, k, cand_k)
    z_got = g.z_runs(*z_args)
    run_lab, run_z0, run_len, cands = z_got[:4]
    runs = int((run_len > 0).sum())
    # what this volume needs: dfz read, the tables and roots written, label and dbz of each run kept
    z_out = 12 * m + 4 * nblocks * (cand_k + 1)
    record("z_runs", z_got, g.z_runs_plain(*z_args), g.z_runs, g.z_runs_plain, lambda: z_args,
           2 * npad + z_out + 6 * runs, 2 * npad, contract_bytes=8 * npad + z_out)
    roots = torch.topk(cands, min(256, cands.numel()), largest=False).values.contiguous()
    r = roots.numel()
    per_hit = int(np.ceil(np.log2(r))) + 10
    both("run_stats", g.run_stats, g.run_stats_plain, lambda: (run_lab, run_len, run_z0, roots),
         12 * m + 20 * r, 2 * m + runs * per_hit, split=True)
    cols = compact_runs(run_lab, run_len, run_z0, 32768)[:5]
    cap = cols[0].numel()
    both("run_stats_compact", g.run_stats_compact, g.run_stats_compact_plain, lambda: (*cols, roots),
         20 * cap + 20 * r, 2 * cap + runs * per_hit, split=True)

    # kernel 12 along z, y, x, on the lines ccl_sweep_pallas hands it, then
    # the whole sweep against the composition of its twins
    lab_u = lab0[:nx, :ny, :nz].contiguous()
    reset_u = (lab_u == g.BIG).to(torch.int32)
    plain_sweep = lab_u
    for axis in (2, 1, 0):
        lines = plain_sweep.movedim(axis, -1).contiguous()
        r_lines = reset_u.movedim(axis, -1).contiguous()
        args = (lines.reshape(-1, lines.shape[-1]), r_lines.reshape(-1, lines.shape[-1]))
        both("scan_lines", g.scan_lines, g.scan_lines_plain, lambda: args, 12 * n, 4 * n, "xyz"[axis])
        plain_sweep = g.scan_lines_plain(*args).reshape(lines.shape).movedim(-1, axis).contiguous()
    record("scan_lines", g.ccl_sweep_pallas(lab_u, reset_u), plain_sweep)

    fg = int((lab != g.BIG).sum())
    for kk in (8, 16):
        both("root_candidates", g.root_candidates, g.root_candidates_plain, lambda: (lab, nx, ny, kk),
             4 * npad + 4 * (lab.shape[0] // 8) * (kk + 1), 2 * npad + 8 * fg, f"k{kk}")
    # close_init's labels: every foreground voxel is a root
    both("root_candidates", g.root_candidates, g.root_candidates_plain, lambda: (lab0, nx, ny, 16),
         4 * npad + 4 * (lab0.shape[0] // 8) * 17, 2 * npad + 8 * fg, "all-roots")

    lab_c = lab[:nx, :ny, :nz].contiguous()
    flat = lab_c.reshape(-1)
    hits = int(torch.isin(flat, roots[roots != g.BIG]).sum())
    both("component_stats_xyz", g.component_stats_xyz, g.component_stats_xyz_plain,
         lambda: (flat, roots, nx, ny, nz), 4 * n + 20 * r, 2 * n + hits * per_hit, split=True)
    raster = lab_c.permute(2, 1, 0).contiguous().reshape(-1)
    both("component_stats_raster", g.component_stats_raster, g.component_stats_raster_plain,
         lambda: (raster, roots, nx, ny), 4 * n + 20 * r, 2 * n + hits * per_hit, split=True)

    # the escalated table size: the same roots padded to 4096, as segmentation pads them
    many = torch.cat([roots, torch.full((4096 - r,), g.BIG, dtype=torch.int32, device=dev)])
    per_hit = 12 + 10
    both("run_stats", g.run_stats, g.run_stats_plain, lambda: (run_lab, run_len, run_z0, many),
         12 * m + 20 * 4096, 2 * m + runs * per_hit, "R4096", split=True)
    both("run_stats_compact", g.run_stats_compact, g.run_stats_compact_plain, lambda: (*cols, many),
         20 * cap + 20 * 4096, 2 * cap + runs * per_hit, "R4096")
    both("component_stats_xyz", g.component_stats_xyz, g.component_stats_xyz_plain,
         lambda: (flat, many, nx, ny, nz), 4 * n + 20 * 4096, 2 * n + hits * per_hit, "R4096", split=True)
    both("component_stats_raster", g.component_stats_raster, g.component_stats_raster_plain,
         lambda: (raster, many, nx, ny), 4 * n + 20 * 4096, 2 * n + hits * per_hit, "R4096")
    return errs


def compare_one_component(shape, card, failures, timings):
    """The four stats wrappers against their twins on a volume that is one
    foreground component (label 0, its root's raster index): every voxel and
    every run updates one row, and every coordinate sum passes 2^32. The run
    tables come from `z_runs` over the padded volume. Then `root_candidates`
    on the padded labels: every voxel foreground, one root."""
    import torch
    from mamri_tpu_torch.perception import gpu_ops as g
    from mamri_tpu_torch.perception.segmentation import _pad_for_kernels, compact_runs

    dev = torch.device("cuda")
    nx, ny, nz = shape
    n = nx * ny * nz
    label = f"{nx}x{ny}x{nz} one component"
    lab = torch.zeros(shape, dtype=torch.int32, device=dev)
    roots = torch.tensor([0] + [g.BIG] * 127, dtype=torch.int32, device=dev)
    padded, reset = _pad_for_kernels(lab, torch.zeros(shape, dtype=torch.int8, device=dev))
    dfz, dbz = g.reset_distances(reset, 2)
    k = 8
    run_lab, run_z0, run_len = g.z_runs(padded, dfz, dbz, nx, ny, k, 8)[:3]
    *cols, n_runs = compact_runs(run_lab, run_len, run_z0, nx * ny)
    if int(n_runs) != nx * ny:
        raise AssertionError(f"{label}: expected one run in each of the {nx * ny} z lines, got {int(n_runs)}")
    flat = lab.reshape(-1)
    m, cap = run_lab.numel(), cols[0].numel()
    cases = (
        ("run_stats", g.run_stats, g.run_stats_plain, (run_lab, run_len, run_z0, roots), 12 * m, 2 * m + 17 * nx * ny),
        ("run_stats_compact", g.run_stats_compact, g.run_stats_compact_plain, (*cols, roots), 20 * cap, 19 * cap),
        ("component_stats_xyz", g.component_stats_xyz, g.component_stats_xyz_plain, (flat, roots, nx, ny, nz),
         4 * n, 19 * n),
        ("component_stats_raster", g.component_stats_raster, g.component_stats_raster_plain, (flat, roots, nx, ny),
         4 * n, 19 * n),
    )
    for name, fn, plain, args, nbytes, nops in cases:
        got, want = fn(*args), plain(*args)
        err = float((got.double() - want.double()).abs().max())
        if err != 0.0:
            failures.append(f"{label} {name}: max |kernel - twin| = {err}")
        if not float(got[0, 1:].min()) > 2.0**32:
            failures.append(f"{label} {name}: expected every coordinate sum above 2^32, got {got[0].tolist()}")
        _time_one(label, name, fn, plain, args, nbytes + 20 * 128, nops, err, card, timings)
    got, want = g.root_candidates(padded, nx, ny, 16), g.root_candidates_plain(padded, nx, ny, 16)
    err = float((got.double() - want.double()).abs().max())
    if err != 0.0 or int(got[:, 16].sum()) != 1:
        failures.append(f"{label} root_candidates: max |kernel - twin| = {err}, roots {int(got[:, 16].sum())} (want 1)")
    npad = padded.numel()
    _time_one(label, "root_candidates", g.root_candidates, g.root_candidates_plain, (padded, nx, ny, 16),
              4 * npad + 4 * (padded.shape[0] // 8) * 17, 2 * npad + 8 * n, err, card, timings)


def _time_one(label, name, fn, plain, args, nbytes, nops, err, card, timings):
    kernel_ms, plain_ms = med_ms(fn, lambda: args), med_ms(plain, lambda: args)
    bound_ms, bound_by = bound(nbytes, nops)
    timings.setdefault(label, {}).setdefault(name, {})[name] = (kernel_ms, plain_ms, bound_ms, bound_by)
    print(f"kernel {label} {name}: max_abs_err={err} ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
          f"bound_ms={bound_ms:.4f} ({bound_by}) ({card})")


def time_segmentation(vol, label, params, card):
    """(p50 of REPS `segment_volume` calls on a device-resident scan by the
    host clock, each call ending in torch.cuda.synchronize(); the median
    device time of the same call, CUDA events behind a spin long enough for
    the host to have enqueued all of it, so that no launch waits for the
    host)."""
    import torch
    from mamri_tpu_torch.perception.segmentation import segment_volume

    dev = torch.device("cuda")
    args = (torch.as_tensor(np.asarray(vol.data)).to(dev), torch.as_tensor(vol.spacing, dtype=torch.float32).to(dev),
            torch.as_tensor(vol.origin, dtype=torch.float32).to(dev), params)
    segment_volume(*args)  # warm-up
    lat = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        segment_volume(*args)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    p50 = float(np.median(lat))
    device_ms = med_ms(segment_volume, lambda: args, spin=SEGMENT_SPIN_CYCLES)
    print(f"segment_volume {label} p50_ms={p50:.3f} all_ms={[round(x, 3) for x in lat]} "
          f"device_ms={device_ms:.3f} ({card})")
    return p50, device_ms


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


DEFAULT_PATH_KERNELS = ("close_init", "reset_distances", "run_min", "check", "z_runs", "run_stats",
                        "run_stats_compact")
NONFUSED_PATH_KERNELS = ("reset_distances", "run_min", "check", "component_stats_xyz")


def read_path_counts(gpu_ops, required, label):
    """The launch counts of the path just driven; each required kernel must
    have launched in it."""
    return read_tally(dict(gpu_ops.LAUNCHES), required, label)


def read_tally(tally, required, label):
    missing = [n for n in required if tally.get(n, 0) == 0]
    if missing:
        raise AssertionError(f"{label}: kernels never launched: {missing} ({tally})")
    print(f"{label} launches: {tally}")
    return tally


def time_estimates(engine, vol, label, card):
    """p50 of REPS warm `estimate_pose` calls (host clock; the call ends in
    its result fetch), each checked against the truth."""
    lat = []
    for _ in range(REPS):
        engine.current_angles = np.zeros(6, np.float32)
        t0 = time.perf_counter()
        res = engine.estimate_pose(vol)
        lat.append((time.perf_counter() - t0) * 1e3)
        check_pose(engine, res, TRUE_ANGLES, label)
    p50 = float(np.median(lat))
    print(f"estimate_pose {label} p50_ms={p50:.3f} all_ms={[round(x, 3) for x in lat]} ({card})")
    return p50


def report_host_syncs(engine, vol):
    """One more warm `estimate_pose` under torch's sync debug mode: prints
    how many synchronizing calls it reports and where (file:line, times),
    and fails if one comes from `api/engine.py`. `_fetch`'s one wait per
    attempt is a CUDA event's, which the mode does not report (it flags
    synchronizing copies and stream or device synchronizations)."""
    engine.current_angles = np.zeros(6, np.float32)
    res, where = syncs_in(lambda: engine.estimate_pose(vol))
    check_pose(engine, res, TRUE_ANGLES, "sync-debug 256^3")
    print(f"host syncs in one warm estimate_pose at 256^3: {sum(where.values())} {json.dumps(where)}")
    engine_syncs = [at for at in where if at.startswith("mamri_tpu_torch/api/engine.py")]
    if engine_syncs:
        raise AssertionError(f"api/engine.py synchronizes outside _fetch's wait: {engine_syncs}")


def cold_warm(engine, vol, label, card):
    ms = []
    for _ in range(2):  # a cold call, then a warm one
        engine.current_angles = np.zeros(6, np.float32)
        t0 = time.perf_counter()
        res = engine.estimate_pose(vol)
        ms.append((time.perf_counter() - t0) * 1e3)
        check_pose(engine, res, TRUE_ANGLES, label)
    print(f"estimate_pose {label} cold_ms={ms[0]:.3f} warm_ms={ms[1]:.3f} ({card})")


# ------------------------------------------------- phase 8: batch and async
def check_estimate(res, truth, label, rmse_max=0.5):
    """check_pose's criteria on a PoseEstimate alone (the async path keeps
    no segmentation; collect returns only certified results)."""
    j1_err_deg = float(np.degrees(abs(res.angles_rad[0] - truth[0]))) if res.success else float("nan")
    print(f"{label}: success={res.success} markers={res.markers_found} rmse_mm={res.rmse_mm} J1_err_deg={j1_err_deg}")
    if not (res.success and all(res.markers_found.values()) and res.rmse_mm < rmse_max and j1_err_deg < 1.0):
        raise AssertionError(f"{label}: pose check failed ({res.message})")


def check_row(out, row, truth, label, rmse_max=0.5):
    """check_pose's criteria on one row of an `estimate_pose_batch` result."""
    certs = {k: bool(out[k][row]) for k in ("seg_converged", "roots_complete", "blobs_complete")}
    j1_err_deg = float(np.degrees(abs(out["angles"][row][0] - truth[0])))
    rmse = float(out["rmse"][row])
    print(f"{label}: success={bool(out['success'][row])} markers={out['markers_found'][row].tolist()} "
          f"rmse_mm={rmse} J1_err_deg={j1_err_deg} certificates={certs} "
          f"num_components={int(out['num_components'][row])}")
    if not (bool(out["success"][row]) and out["markers_found"][row].all() and all(certs.values())):
        raise AssertionError(f"{label}: not solved and certified")
    if not (rmse < rmse_max and j1_err_deg < 1.0):
        raise AssertionError(f"{label}: RMSE {rmse} mm (limit {rmse_max}), |J1 - truth| {j1_err_deg} deg")


def rows_equal_singles(out, datas, spacing, origin, label):
    """Each batch row equals, exactly, `estimate_pose` of its volume on a
    fresh engine on the card (no saved baseplate, zero current angles).
    Returns the kernel launches of those single calls, summed."""
    from mamri_tpu_torch.api.engine import MamriEngine
    from mamri_tpu_torch.perception import gpu_ops
    from mamri_tpu_torch.perception.volume import Volume

    singles = {}
    for row, data in enumerate(datas):
        eng = MamriEngine(device="cuda")
        with_counts(gpu_ops, singles, eng.estimate_pose, Volume(data, spacing, origin))
        for k, v in out.items():
            if not np.array_equal(v[row], eng.last_segmentation[k]):
                raise AssertionError(f"{label} row {row}: {k} = {v[row]}, estimate_pose gave {eng.last_segmentation[k]}")
    print(f"{label}: every row equals estimate_pose of its volume on the card, exactly")
    return singles


def with_counts(gpu_ops, tally, fn, *args, **kw):
    """fn(*args, **kw), adding the kernel launches it made to `tally`."""
    before = dict(gpu_ops.LAUNCHES)
    result = fn(*args, **kw)
    for k, v in gpu_ops.LAUNCHES.items():
        tally[k] = tally.get(k, 0) + v - before[k]
    return result


def p50_ms(fn, reps=REPS):
    """(p50, all) of `reps` calls of fn() by the host clock, each ending in a
    synchronize; one warm-up call first."""
    import torch

    fn()
    lat = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(lat)), [round(x, 3) for x in lat]


def syncs_in(fn):
    """(fn(), {file:line: times}) of the synchronizing calls that torch's
    sync debug mode reports while fn runs."""
    import warnings

    import torch

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            result = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    where = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            at = f"{os.path.relpath(w.filename, REPO)}:{w.lineno}"
            where[at] = where.get(at, 0) + 1
    return result, dict(sorted(where.items(), key=lambda kv: -kv[1]))


def phase_batch_async(model, card, paths):
    """bench.py's four 256^3 scenes as one batch, a batch with one noisy
    volume, and three frames through the async pair."""
    from mamri_tpu_torch.api.engine import MamriEngine
    from mamri_tpu_torch.perception import gpu_ops
    from mamri_tpu_torch.perception.volume import Volume

    scenes = bench_scenes(model, (256, 256, 256))
    spacing, origin = scenes[0][0].spacing, scenes[0][0].origin
    datas = [np.asarray(v.data) for v, _, _ in scenes]
    batch = np.stack(datas)
    engine = MamriEngine(device="cuda")
    tally = {}
    with_counts(gpu_ops, tally, engine.estimate_pose_batch, batch, spacing, origin)  # warm-up
    once = {}
    out = with_counts(gpu_ops, once, engine.estimate_pose_batch, batch, spacing, origin)
    for k, v in once.items():
        tally[k] += v
    for row, (_, truth, _) in enumerate(scenes):
        check_row(out, row, truth, f"batch 256^3 row {row}")
    singles = rows_equal_singles(out, datas, spacing, origin, "batch 256^3")
    print(f"launches per estimate_pose_batch of {len(datas)} at 256^3: {once} (its {len(datas)} volumes' "
          f"estimate_pose calls: {singles})")
    if once != singles:
        raise AssertionError("the batch did not launch the kernels of one estimate_pose per volume")

    def batch_call():
        with_counts(gpu_ops, tally, engine.estimate_pose_batch, batch, spacing, origin)

    def sequential():
        for data in datas:
            engine.estimate_pose(Volume(data, spacing, origin), store_state=False, keep_segmentation=False)

    b_p50, b_all = p50_ms(batch_call)
    s_p50, s_all = p50_ms(sequential)
    print(f"estimate_pose_batch B={len(datas)} 256^3 p50_ms={b_p50:.3f} all_ms={b_all}; {len(datas)} sequential "
          f"estimate_pose p50_ms={s_p50:.3f} all_ms={s_all}; per volume {b_p50 / len(datas):.3f} vs "
          f"{s_p50 / len(datas):.3f} ({card})")

    # one noisy volume (bench.py's 1500 speckles + N(0, 5)) among clean ones: only it escalates
    rng = np.random.default_rng(5)
    noisy = datas[0].copy()
    bright = noisy > 60.0
    for i, j, k in rng.integers(2, noisy.shape[0] - 2, size=(1500, 3)):  # bench.py: 2 .. SIZE - 2
        if not bright[i - 2:i + 3, j - 2:j + 3, k - 2:k + 3].any():
            noisy[i, j, k] = 100.0
    noisy = noisy + rng.normal(0.0, 5.0, noisy.shape).astype(np.float32)
    mixed = [datas[1], noisy, datas[2]]
    log = logging.getLogger("mamri_tpu_torch.api.engine")
    esc = _Escalations()
    log.addHandler(esc)
    try:
        t0 = time.perf_counter()
        out = with_counts(gpu_ops, tally, engine.estimate_pose_batch, np.stack(mixed), spacing, origin)
        mixed_ms = (time.perf_counter() - t0) * 1e3
    finally:
        log.removeHandler(esc)
    print(f"noisy batch: {esc.messages} in {mixed_ms:.3f} ms ({card})")
    if not esc.messages or not all("escalation for 1/3 volumes" in m for m in esc.messages):
        raise AssertionError(f"noisy batch: expected escalations of the noisy row only, got {esc.messages}")
    for row, truth, rmse_max in ((0, scenes[1][1], 0.5), (1, TRUE_ANGLES, 1.5), (2, scenes[2][1], 0.5)):
        check_row(out, row, truth, f"noisy batch row {row}", rmse_max)
    rows_equal_singles(out, mixed, spacing, origin, "noisy batch")
    paths["estimate_batch"] = read_tally(tally, DEFAULT_PATH_KERNELS, "batch path")

    # three frames dispatched and collected, against the synchronous path on its own engine
    tally = {}
    frames = [Volume(d, spacing, origin) for d in datas[:3]]
    sync_eng, async_eng = MamriEngine(device="cuda"), MamriEngine(device="cuda")
    sync_eng.estimate_pose(frames[0], keep_segmentation=False)  # warm-up
    async_eng.estimate_pose_collect(async_eng.estimate_pose_async(frames[0]))
    sync_eng.current_angles = np.zeros(6, np.float32)
    async_eng.current_angles = np.zeros(6, np.float32)
    for i, (frame, (_, truth, _)) in enumerate(zip(frames, scenes)):
        want = sync_eng.estimate_pose(frame, keep_segmentation=False)
        t0 = time.perf_counter()
        handle, where = syncs_in(lambda: with_counts(gpu_ops, tally, async_eng.estimate_pose_async, frame))
        t1 = time.perf_counter()
        got = with_counts(gpu_ops, tally, async_eng.estimate_pose_collect, handle)
        t2 = time.perf_counter()
        print(f"async frame {i}: dispatch_ms={(t1 - t0) * 1e3:.3f} collect_ms={(t2 - t1) * 1e3:.3f} "
              f"host syncs under dispatch: {sum(where.values())} {json.dumps(where)} ({card})")
        check_estimate(got, truth, f"async frame {i}")
        for field in ("angles_rad", "steps", "baseplate_tf"):
            if not np.array_equal(getattr(got, field), getattr(want, field)):
                raise AssertionError(f"async frame {i}: {field} {getattr(got, field)} != sync {getattr(want, field)}")
        if (got.rmse_mm, got.markers_found, got.num_blobs) != (want.rmse_mm, want.markers_found, want.num_blobs):
            raise AssertionError(f"async frame {i}: differs from the synchronous path")
    print("async frames: each equals the synchronous estimate_pose, exactly")
    paths["estimate_async"] = read_tally(tally, DEFAULT_PATH_KERNELS[:-1], "async path")


# ------------------------------------------------------ phase 9: planning
def phase_planning(vol, card):
    """Entry search, goal IK, a sweep of 3 distances, the heuristic path and
    the exact validation on the bench scene at 256^3: on the card, timed,
    and held against a CPU engine carrying the same state."""
    import torch
    from mamri_tpu_torch.api.engine import MamriEngine

    gpu = MamriEngine(device="cuda")
    est = gpu.estimate_pose(vol)
    check_pose(gpu, est, TRUE_ANGLES, "planning scan 256^3")
    cpu = MamriEngine(device="cpu")
    cpu.load_state_from_numpy(baseplate_tf=gpu.baseplate_tf, current_angles=gpu.current_angles)
    cpu.set_body_segmentation(gpu.body_mask(), *gpu.last_volume_geom)

    def build_world():
        gpu._drop_body_world()
        gpu._require_body_world()

    world_p50, world_all = p50_ms(build_world)
    gw, cw = gpu._require_body_world(), cpu._require_body_world()
    if not (torch.equal(gw.occupancy.cpu(), cw.occupancy) and torch.equal(gw.inside_depth.cpu(), cw.inside_depth)):
        raise AssertionError("collision world on the card differs from the CPU's")
    print(f"planning build_collision_world 256^3 (upload of the mask included) p50_ms={world_p50:.3f} "
          f"all_ms={world_all}; equal to the CPU's ({card})")

    def close(a, b, what, atol=1e-3):
        gap = float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())
        if not gap <= atol:
            raise AssertionError(f"planning {what}: card and CPU differ by {gap} (limit {atol})")
        return gap

    def equal(a, b, what):
        if not np.array_equal(np.asarray(a), np.asarray(b)):
            raise AssertionError(f"planning {what}: card {a} != CPU {b}")

    calls = {}
    entry = gpu.find_entry_point(BODY_CENTER)
    c_entry = cpu.find_entry_point(BODY_CENTER)
    equal(entry.point_ras, c_entry.point_ras, "entry point")
    equal(entry.found, c_entry.found, "entry found")
    close(entry.normal_ras, c_entry.normal_ras, "entry normal", 1e-5)
    if not bool(entry.found):
        raise AssertionError("planning: no entry point found")
    calls["find_entry_point"] = p50_ms(lambda: gpu.find_entry_point(BODY_CENTER))
    ep = entry.point_ras

    def same_goal(g, c, what):
        for f in ("success", "collides"):
            equal(getattr(g, f), getattr(c, f), f"{what} {f}")
        close(g.position_error_mm, c.position_error_mm, f"{what} position error", 1e-2)
        return close(g.angles, c.angles, f"{what} angles")

    goal, c_goal = gpu.plan_trajectory(BODY_CENTER, ep), cpu.plan_trajectory(BODY_CENTER, ep)
    gaps = {"plan_trajectory": same_goal(goal, c_goal, "plan_trajectory")}
    if not bool(goal.success):
        raise AssertionError("planning: plan_trajectory found no collision-free goal")
    calls["plan_trajectory"] = p50_ms(lambda: gpu.plan_trajectory(BODY_CENTER, ep))

    distances = [2.0, 5.0, 10.0]
    sweep, c_sweep = gpu.plan_trajectory_sweep(BODY_CENTER, ep, distances), cpu.plan_trajectory_sweep(BODY_CENTER, ep,
                                                                                                     distances)
    gaps["plan_trajectory_sweep"] = same_goal(sweep, c_sweep, "sweep")
    calls["plan_trajectory_sweep(3)"] = p50_ms(lambda: gpu.plan_trajectory_sweep(BODY_CENTER, ep, distances))

    plan = gpu.plan_heuristic_path(BODY_CENTER, ep, 5.0, start_pose_steps=est.steps)
    c_plan = cpu.plan_heuristic_path(BODY_CENTER, ep, 5.0, start_pose_steps=est.steps)
    equal(plan.success, c_plan.success, "heuristic path success")
    if not plan.success:
        raise AssertionError(f"planning: plan_heuristic_path failed: {plan.message}")
    equal(plan.collision_detected, c_plan.collision_detected, "heuristic path collision flag")
    gaps["plan_heuristic_path"] = max(close(plan.goal_angles, c_plan.goal_angles, "heuristic goal"),
                                      close(plan.keyframes, c_plan.keyframes, "keyframes"),
                                      close(plan.path, c_plan.path, "path"))
    calls["plan_heuristic_path(100)"] = p50_ms(
        lambda: gpu.plan_heuristic_path(BODY_CENTER, ep, 5.0, start_pose_steps=est.steps))

    exact, c_exact = gpu.validate_plan_exact(plan), cpu.validate_plan_exact(plan)  # one path, both engines
    for k in exact:
        equal(exact[k], c_exact[k], f"validate_plan_exact {k}")
    calls["validate_plan_exact"] = p50_ms(lambda: gpu.validate_plan_exact(plan))

    print(f"planning entry={entry.point_ras.tolist()} goal success={bool(goal.success)} "
          f"position_error_mm={float(goal.position_error_mm)} sweep position_error_mm="
          f"{sweep.position_error_mm.tolist()} path collision={plan.collision_detected} exact collision_free="
          f"{exact['collision_free']} max |card - CPU| rad: {json.dumps(gaps)}")
    for name, (p50, all_ms) in calls.items():
        print(f"planning {name} 256^3 p50_ms={p50:.3f} all_ms={all_ms} ({card})")


# ------------------------------------------- phase 10: stream from disk
STREAM_DEPTH = 4  # frames of the pose sequence a0 + 0.02 k, k = 0..3 (tests/test_streaming_roi.py:58-60)
JUMP = np.array([0.7, 0.3, -0.4, 0.3, 0.3, 0.5], dtype=np.float32)  # tests/test_streaming_roi.py's pose jump


def paint_spheres(background, spacing, origin, pts, radius=4.0, value=120.0):
    """`background` with a sphere of `value` at each RAS point, painted on
    the sphere's own sub-grid with `synthetic_volume`'s float32 arithmetic,
    so a frame equals `synthetic_volume`'s rendering of the same scene."""
    data = background.copy()
    for c in np.asarray(pts, np.float32).reshape(-1, 3):
        idx = (np.array([-c[0], -c[1], c[2]], np.float64) - origin) / spacing
        lo = np.maximum(np.floor(idx - radius / spacing).astype(int) - 1, 0)
        hi = np.minimum(np.ceil(idx + radius / spacing).astype(int) + 2, data.shape)
        gi, gj, gk = np.meshgrid(*(np.arange(a, b, dtype=np.float32) for a, b in zip(lo, hi)), indexing="ij")
        rx = -(origin[0] + spacing[0] * gi)
        ry = -(origin[1] + spacing[1] * gj)
        rz = origin[2] + spacing[2] * gk
        d2 = (rx - c[0]) ** 2 + (ry - c[1]) ** 2 + (rz - c[2]) ** 2
        data[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]][d2 <= radius ** 2] = value
    return data


def frame_ms(tracker):
    """(p50, all) of a tracker's per-step host times, ms, unrounded."""
    xs = [x * 1e3 for x in tracker.tracer.spans["frame"]]
    return float(np.median(xs)), xs


def phase_stream(model, vol512, vol256, card):
    """Frames on disk -> `load_volume` -> `PoseTracker.step` on the clinical
    grid. Returns the stream path's launch counts (taken with the counts set
    to 0 at its start) and the frozen ROI window of frame 3, for the kernels'
    check at that shape."""
    import shutil
    import tempfile

    import torch
    from mamri_tpu_torch import native
    from mamri_tpu_torch.api.engine import MamriEngine
    from mamri_tpu_torch.api.streaming import PoseTracker
    from mamri_tpu_torch.perception import gpu_ops
    from mamri_tpu_torch.perception.dicom import save_dicom_series
    from mamri_tpu_torch.perception.formats import load_volume, save_nrrd
    from mamri_tpu_torch.perception.io import save_nifti
    from mamri_tpu_torch.perception.volume import Volume, synthetic_volume
    from mamri_tpu_torch.utils.trace import Tracer

    sp, org = vol512.spacing, vol512.origin
    base = _base_tf(0.15)
    poses = [TRUE_ANGLES + np.float32(0.02 * k) for k in range(STREAM_DEPTH)]
    jump = TRUE_ANGLES + JUMP
    t0 = time.perf_counter()
    bg = synthetic_volume(shape=vol512.shape, spacing=sp, origin=org, body_center_ras=BODY_CENTER,
                          body_radii_mm=[45.0, 55.0, 65.0]).data
    datas = [paint_spheres(bg, sp, org, _markers(model, a, base)).astype(np.int16) for a in poses + [jump]]
    if not np.array_equal(datas[0], vol512.data):
        raise AssertionError("stream frame 0 differs from synthetic_volume's rendering of the same scene")
    print(f"stream: {len(datas)} frames of {vol512.shape} int16 rendered in {time.perf_counter() - t0:.3f} s; "
          f"native host library built: {native.available()}")

    # ---- 1-2: write with the port's writers, read back with load_volume
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="stream-", dir=os.path.join(REPO, "build"))
    try:
        files = []
        t0 = time.perf_counter()
        for k, d in enumerate(datas[:STREAM_DEPTH]):
            files.append((f"nrrd frame {k}", os.path.join(tmp, f"frame{k}.nrrd"), d))
            save_nrrd(files[-1][1], Volume(d, sp, org), encoding="raw")
        write_ms = {"nrrd": (time.perf_counter() - t0) * 1e3 / STREAM_DEPTH}
        t0 = time.perf_counter()
        save_dicom_series(os.path.join(tmp, "dicom0"), Volume(datas[0], sp, org), transfer="explicit_le")
        write_ms["dicom explicit_le"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        save_nifti(os.path.join(tmp, "frame0.nii"), Volume(datas[0], sp, org))
        write_ms["nifti"] = (time.perf_counter() - t0) * 1e3
        files += [("dicom explicit_le frame 0", os.path.join(tmp, "dicom0"), datas[0]),
                  ("nifti frame 0", os.path.join(tmp, "frame0.nii"), datas[0])]
        frames, load_ms = [], {}
        for label, path, want in files:
            t0 = time.perf_counter()
            v = load_volume(path)
            load_ms[label] = (time.perf_counter() - t0) * 1e3
            if not (v.data.dtype == want.dtype and np.array_equal(v.data, want)
                    and v.spacing.tobytes() == sp.tobytes() and v.origin.tobytes() == org.tobytes()):
                raise AssertionError(f"stream: {label} read back as {v.data.dtype} {v.spacing} {v.origin}, "
                                     f"not what was written")
            if label.startswith("nrrd"):
                frames.append(v)
    finally:
        shutil.rmtree(tmp)
    print(f"stream files: write ms {json.dumps(write_ms)}; load_volume ms {json.dumps(load_ms)}; each equal to what "
          f"was written (data, dtype, spacing, origin) ({card})")
    jump_frame = Volume(datas[-1], sp, org)

    log = logging.getLogger("mamri_tpu_torch.api.engine")
    esc = _Escalations()
    log.addHandler(esc)
    gpu_ops.reset_launch_counts()  # the stream path from here on
    try:
        # ---- 3: the synchronous tracker on the full frames
        tracer = Tracer()
        eng = MamriEngine(device="cuda", tracer=tracer)
        sync = PoseTracker(eng)
        sync_res = [sync.step(f) for f in frames]
        for k, (r, a) in enumerate(zip(sync_res, poses)):
            check_estimate(r, a, f"stream sync frame {k}")

        # ---- 4: the ROI tracker
        eng.set_pose(np.zeros(6, np.float32))
        roi = PoseTracker(eng, roi_margin_mm=40.0)
        roi_res = [roi.step(f) for f in frames]
        for k, (r, a) in enumerate(zip(roi_res, poses)):
            check_estimate(r, a, f"stream ROI frame {k}")
        st = roi.stats()
        if (st["roi_frames"], st["roi_fallbacks"]) != (STREAM_DEPTH - 1, 0):
            raise AssertionError(f"stream ROI: {st}")
        gap = max(float(np.degrees(np.abs(r.angles_rad - s.angles_rad)).max())
                  for r, s in zip(roi_res[1:], sync_res[1:]))
        if not gap < 0.2:
            raise AssertionError(f"stream ROI: angles {gap} deg from the full frames' (limit 0.2)")
        window = roi._crop_roi(frames[-1])
        item = frames[0].data.itemsize
        print(f"stream ROI: roi_frames={st['roi_frames']} roi_fallbacks={st['roi_fallbacks']} roi_shape="
              f"{st['roi_shape']} {int(np.prod(st['roi_shape'])) * item} B against the full frame's "
              f"{frames[0].data.size * item} B; max |ROI - full| {gap} deg")

        # ---- 5: a pose jump past a 25 mm margin: the same step falls back to the full frame
        eng.set_pose(np.zeros(6, np.float32))
        tight = PoseTracker(eng, roi_margin_mm=25.0)
        check_estimate(tight.step(frames[0]), poses[0], "stream jump frame 0")
        r = tight.step(jump_frame)
        st = tight.stats()
        if not (r.success and st["roi_fallbacks"] == 1 and st["failures"] == 0):
            raise AssertionError(f"stream jump: {r.message} {st}")
        check_estimate(r, jump, "stream jump frame (full-frame fallback)")

        # ---- 6: pipelined, depth 1; the host frame overwritten as soon as step returns
        eng.set_pose(np.zeros(6, np.float32))
        ref = PoseTracker(eng).step(frames[0])
        eng.set_pose(np.zeros(6, np.float32))
        pipe = PoseTracker(eng, pipelined=True, depth=1)
        scratch = Volume(frames[0].data.copy(), sp, org)
        if pipe.step(scratch) is not None:
            raise AssertionError("stream pipelined: a result before the pipeline filled")
        scratch.data[...] = 0
        r1 = pipe.step(frames[0])
        rest = pipe.flush()
        if r1 is None or len(rest) != 1 or pipe.frames != 2 or pipe.failures:
            raise AssertionError(f"stream pipelined: {r1} {rest} {pipe.stats()}")
        pgap = float(np.abs(r1.angles_rad - ref.angles_rad).max())
        if not pgap <= 1e-4:
            raise AssertionError(f"stream pipelined: {pgap} rad from the synchronous result (limit 1e-4)")
        eng.set_pose(np.zeros(6, np.float32))
        pipe = PoseTracker(eng, pipelined=True, depth=1)
        pipe_res = [pipe.step(f) for f in frames]
        pipe_res = [r for r in pipe_res if r is not None] + pipe.flush()
        for k, (r, a) in enumerate(zip(pipe_res, poses)):
            check_estimate(r, a, f"stream pipelined frame {k}")
        print(f"stream pipelined: equal to the synchronous result within {pgap} rad with the host frame "
              f"overwritten after step; {len(pipe_res)} frames checked")

        # ---- 7: re-planning on the 256^3 bench scene (it has a body)
        eng256 = MamriEngine(device="cuda", tracer=tracer)
        check_pose(eng256, eng256.estimate_pose(vol256), TRUE_ANGLES, "stream re-plan scan 256^3")
        ep = eng256.find_entry_point(BODY_CENTER)
        replan = PoseTracker(eng256, target_ras=BODY_CENTER, entry_ras=ep.point_ras, safety_mm=5.0, replan_every=2)
        for _ in range(2):
            check_estimate(replan.step(vol256), TRUE_ANGLES, "stream re-plan frame")
        plan = replan.last_plan
        if not (plan is not None and plan.success and plan.path.shape == (101, 6)
                and replan.tracer.stats("replan")["count"] == 1):
            raise AssertionError(f"stream re-plan: {plan}")
        print(f"stream re-plan: one plan, success, path {plan.path.shape}, collision={plan.collision_detected}, "
              f"replan_ms={replan.tracer.spans['replan'][0] * 1e3} ({card})")

        # ---- 8: int16 against float32 of the same frame
        e16, e32 = MamriEngine(device="cuda"), MamriEngine(device="cuda")
        a16 = e16.estimate_pose(frames[0], keep_segmentation=False)
        a32 = e32.estimate_pose(Volume(frames[0].data.astype(np.float32), sp, org), keep_segmentation=False)
        for field in ("angles_rad", "steps", "baseplate_tf", "rmse_mm", "markers_found", "num_blobs"):
            if not np.array_equal(np.asarray(getattr(a16, field)), np.asarray(getattr(a32, field))):
                raise AssertionError(f"stream int16 vs float32: {field} {getattr(a16, field)} != {getattr(a32, field)}")
        print("stream int16 vs float32: bit-equal")

        # ---- 10: one stream frame launches what one estimate_pose launches
        tallies = {}
        for label, volume, tracker_args in (("full", frames[1], {}), ("ROI", frames[1], {"roi_margin_mm": 40.0})):
            e_step, e_call = MamriEngine(device="cuda"), MamriEngine(device="cuda")
            tr = PoseTracker(e_step, **tracker_args)
            tr.last_estimate = sync_res[0]  # anchors the window on frame 0's pose
            call_vol = tr._crop_roi(volume) if tracker_args else volume
            step_tally, call_tally = {}, {}
            with_counts(gpu_ops, step_tally, tr.step, volume)
            with_counts(gpu_ops, call_tally, e_call.estimate_pose, call_vol, keep_segmentation=False)
            if step_tally != call_tally or (tracker_args and tr.roi_frames != 1):
                raise AssertionError(f"stream {label} frame launched {step_tally}, estimate_pose {call_tally}")
            tallies[label] = step_tally
        print(f"launches of one stream frame = one estimate_pose's: {json.dumps(tallies)}")
    finally:
        log.removeHandler(esc)
    uncertified = [m for m in esc.messages if "uncertified" in m]
    if uncertified:
        raise AssertionError(f"stream: uncertified segmentations: {uncertified}")
    counts = read_path_counts(gpu_ops, DEFAULT_PATH_KERNELS[:-1], "stream path")

    # timings: frames per mode, and the uploads
    for label, tracker in (("sync", sync), ("ROI", roi), ("pipelined", pipe)):
        p50, xs = frame_ms(tracker)
        print(f"stream frame {label} 512x512x192 p50_ms={p50} all_ms={xs} ({card})")
    f32 = frames[0].data.astype(np.float32)
    for label, data in (("float32 frame", f32), ("int16 frame", frames[0].data), ("ROI int16 window", window.data)):
        p50, xs = p50_ms(lambda: eng._upload(data))
        print(f"stream upload {label} {data.shape} {data.nbytes} B p50_ms={p50} all_ms={xs} ({card})")
    print("stream engine tracer:\n" + tracer.report())
    return counts, window


# --------------------------------------------- phase 11: the engine's whole surface
ARMS = ((40.0, 20.0), (70.0, 25.0), (70.0, 20.0), (45.0, 20.0))  # the four marker signatures
HW_TICK_S = 0.15  # the reference's control tick
HW_SEGMENT_S = 1.0  # the simulated speed takes about this long for each keyframe's move


def _l_local(l1, l2, offset):
    return np.array([[0.0, 0.0, 0.0], [0.0, l2, 0.0], [l1, 0.0, 0.0]], np.float32) + np.float32(offset)


def matcher_cases():
    """[(label, points (K, 3), valid (K,))]: tests/test_lshape.py's 8 seeded
    dropout trials at K = 32, and the four triplets among 116 stray blobs
    at K = 128 (the escalated blob budget)."""
    rng = np.random.default_rng(23)
    cases = []
    for trial in range(8):
        present = rng.random(4) > 0.35
        tris = [_l_local(a[0], a[1], rng.uniform(-150, 150, 3).astype(np.float32))
                for a, keep in zip(ARMS, present) if keep]
        noise = rng.uniform(-120, 120, size=(3, 3)).astype(np.float32)
        pts = np.concatenate(tris + [noise]) if tris else noise
        pts = pts[rng.permutation(len(pts))]
        padded = np.zeros((32, 3), np.float32)
        padded[:len(pts)] = pts
        cases.append((f"dropout trial {trial}", padded, np.arange(32) < len(pts)))
    rng = np.random.default_rng(7)
    pts = rng.uniform(-400, 400, (128, 3)).astype(np.float32)
    slots = rng.permutation(np.arange(64, 128))[:12]
    pts[slots] = np.concatenate([_l_local(a[0], a[1], rng.uniform(-150, 150, 3)) for a in ARMS])
    cases.append(("K=128", pts, np.ones(128, dtype=bool)))
    return cases


def _obj_vertices(path):
    out, cur = {}, None
    with open(path) as f:
        for line in f:
            if line.startswith("o "):
                cur = line[2:].strip()
                out[cur] = []
            elif line.startswith("v "):
                out[cur].append([float(x) for x in line.split()[1:]])
    return {k: np.asarray(v) for k, v in out.items()}


def _glb_positions(path):
    from mamri_tpu_torch.utils.glb import read_glb

    gltf, blob = read_glb(path)
    out = {}
    for node in gltf.get("nodes", []):
        acc = gltf["accessors"][gltf["meshes"][node["mesh"]]["primitives"][0]["attributes"]["POSITION"]]
        view = gltf["bufferViews"][acc["bufferView"]]
        out[node["name"]] = np.frombuffer(blob[view["byteOffset"]:view["byteOffset"] + view["byteLength"]],
                                          "<f4").reshape(-1, 3)
    return out


def _png_pixels(path):
    import struct
    import zlib

    with open(path, "rb") as f:
        data = f.read()
    w, h = struct.unpack(">II", data[16:24])
    pos, idat = 8, b""
    while pos < len(data):
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    return np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)[:, 1:].reshape(h, w, 3)


def _close(a, b, atol, what):
    gap = float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max()) if np.size(a) else 0.0
    if not (np.shape(a) == np.shape(b) and gap <= atol):
        raise AssertionError(f"{what}: card and CPU differ by {gap} (limit {atol}; shapes {np.shape(a)} "
                             f"{np.shape(b)})")
    return gap


def _same_report(got, want, what):
    """Equal line by line, each number within one unit of its last digit."""
    import re

    number = r"-?\d+\.\d+"
    g_lines, w_lines = got.splitlines(), want.splitlines()
    ok = len(g_lines) == len(w_lines)
    for g, w in zip(g_lines, w_lines):
        ok = ok and re.sub(number, "#", g) == re.sub(number, "#", w)
        for a, b in zip(re.findall(number, g), re.findall(number, w)):
            ok = ok and abs(float(a) - float(b)) <= 10.0 ** -len(b.split(".")[1]) * 1.0001
    if not ok:
        raise AssertionError(f"{what}: card and CPU reports differ:\n{got}\n---\n{want}")


def phase_global(model, vol256, card, paths, device):
    """(a) `match_mode="global"` at 256^3 against the default mode: the
    pose bit-equal, the same launches per call, p50 of 5 interleaved; then
    the matcher alone on the card against the CPU."""
    import torch
    from mamri_tpu_torch.api.engine import MamriEngine
    from mamri_tpu_torch.perception import gpu_ops
    from mamri_tpu_torch.registration.lshape import match_l_shaped_triplets, match_l_shaped_triplets_global

    default, glob = MamriEngine(device=device), MamriEngine(device=device, match_mode="global")
    for eng in (default, glob):
        eng.estimate_pose(vol256)  # warm-up
    # the global path's launches are tallied per call: its calls alternate with the default mode's
    lat = {"default": [], "global": []}
    tally = {"default": {}, "global": {}}
    for _ in range(REPS):
        res = {}
        for label, eng in (("default", default), ("global", glob)):
            eng.current_angles = np.zeros(6, np.float32)
            t0 = time.perf_counter()
            res[label] = with_counts(gpu_ops, tally[label], eng.estimate_pose, vol256)
            lat[label].append((time.perf_counter() - t0) * 1e3)
            check_pose(eng, res[label], TRUE_ANGLES, f"{label} mode 256^3")
        got, want = res["global"], res["default"]
        for field in ("angles_rad", "steps", "baseplate_tf"):
            if not np.array_equal(getattr(got, field), getattr(want, field)):
                raise AssertionError(f"global mode: {field} {getattr(got, field)} != default {getattr(want, field)}")
        if (got.rmse_mm, got.markers_found, got.num_blobs) != (want.rmse_mm, want.markers_found, want.num_blobs):
            raise AssertionError("global mode: the result differs from the default mode's")
    if tally["global"] != tally["default"]:
        raise AssertionError(f"global mode launched {tally['global']}, the default mode {tally['default']}")
    paths["estimate_global"] = read_tally(tally["global"], DEFAULT_PATH_KERNELS[:-1], "global path")
    glob.current_angles = np.zeros(6, np.float32)
    res, where = syncs_in(lambda: glob.estimate_pose(vol256))
    check_pose(glob, res, TRUE_ANGLES, "sync-debug global 256^3")
    print(f"host syncs in one warm global estimate_pose at 256^3: {sum(where.values())} {json.dumps(where)}")
    print(f"global mode 256^3: angles, steps, baseplate bit-equal to the default mode's in all {REPS} calls; "
          f"launches per call {json.dumps({k: v // REPS for k, v in tally['global'].items()})} (the default mode's "
          f"the same)")
    print(f"estimate_pose 256^3 p50_ms default={np.median(lat['default']):.3f} global={np.median(lat['global']):.3f} "
          f"all_ms default={[round(x, 3) for x in lat['default']]} global={[round(x, 3) for x in lat['global']]} "
          f"(interleaved) ({card})")

    dev = torch.device(device)
    for label, pts, valid in matcher_cases():
        args_cpu = (torch.as_tensor(pts), torch.as_tensor(valid), ARMS)
        args_gpu = (args_cpu[0].to(dev), args_cpu[1].to(dev), ARMS)
        got, want = match_l_shaped_triplets_global(*args_gpu), match_l_shaped_triplets_global(*args_cpu)
        if not (torch.equal(got.found.cpu(), want.found) and torch.equal(got.member_ids.cpu(), want.member_ids)):
            raise AssertionError(f"global matcher {label}: card {got.found.tolist()} {got.member_ids.tolist()} != "
                                 f"CPU {want.found.tolist()} {want.member_ids.tolist()}")
        gap = _close(got.points.cpu(), want.points, 1e-4, f"global matcher {label} points")
        if label in ("dropout trial 0", "K=128"):
            p50, all_ms = p50_ms(lambda: match_l_shaped_triplets_global(*args_gpu))
            greedy_p50, greedy_all = p50_ms(lambda: match_l_shaped_triplets(*args_gpu))
            print(f"global matcher alone {label} (K={len(pts)}): found={got.found.tolist()} p50_ms={p50:.3f} "
                  f"all_ms={all_ms}; the greedy best-mode matcher on the same blobs p50_ms={greedy_p50:.3f} "
                  f"all_ms={greedy_all} ({card})")
    print(f"global matcher: card = CPU (found, member_ids; points within {gap}) on 8 dropout trials and K=128")


def phase_state_methods(gpu, cpu, card):
    """(b) The state methods on the card against a CPU engine with the
    same state."""
    angles = [0.1, -0.2, 0.3, -0.4, 0.5, -0.6]
    gaps = {
        "link_world_transforms": _close(gpu.link_world_transforms(), cpu.link_world_transforms(), 1e-4, "FK"),
        "link_world_transforms(angles)": _close(gpu.link_world_transforms(angles), cpu.link_world_transforms(angles),
                                                1e-4, "FK at given angles"),
        "needle_tcp": _close(gpu.needle_tcp(), cpu.needle_tcp(), 1e-4, "needle TCP"),
    }
    rng = np.random.default_rng(2)
    j6, j4 = (rng.normal(size=(2, 3, 3)) * 50).astype(np.float32)
    for corrected in (False, True):
        _same_report(gpu.describe_ik_solution(j6, j4, apply_correction=corrected),
                     cpu.describe_ik_solution(j6, j4, apply_correction=corrected), "describe_ik_solution")
    if gpu.pose_table(gpu.current_angles) != cpu.pose_table(cpu.current_angles):
        raise AssertionError("pose_table: card and CPU differ")
    acts = [{k: (v.enabled, v.reason) for k, v in e.available_actions(True, True, True).items()} for e in (gpu, cpu)]
    if acts[0] != acts[1]:
        raise AssertionError("available_actions: card and CPU differ")
    timed = {
        "link_world_transforms": p50_ms(gpu.link_world_transforms),
        "needle_tcp": p50_ms(gpu.needle_tcp),
        "describe_ik_solution": p50_ms(lambda: gpu.describe_ik_solution(j6, j4)),
        f"path FK of export_trajectory_html ({len(gpu.trajectory_path)} samples)": p50_ms(gpu._path_fk),
        "link_world_transforms (CPU engine)": p50_ms(cpu.link_world_transforms),
    }
    print(f"state methods: card = CPU engine (FK gaps mm {json.dumps(gaps)}; reports, pose table, actions)")
    for name, (p50, all_ms) in timed.items():
        print(f"state {name} p50_ms={p50:.4f} all_ms={all_ms} ({card})")


def phase_hardware(gpu, card):
    """(c) The hardware loop on a simulated rig on the real clock: the sync
    loop running, a `watch` subscriber, the planned keyframes executed."""
    import threading

    from mamri_tpu_torch.hw.sim import simulated_hardware
    from mamri_tpu_torch.perception import gpu_ops

    kf_steps = np.stack([gpu.convert_angles_to_steps(k) for k in gpu.trajectory_keyframes])
    start = np.asarray(gpu.convert_angles_to_steps(np.zeros(6, np.float32)))
    longest = float(np.abs(np.diff(np.vstack([start, kf_steps]), axis=0)).max())
    speed = max(1000.0, longest / HW_SEGMENT_S)
    launches = dict(gpu_ops.LAUNCHES)
    stack, robot, shutdown = simulated_hardware(gpu, speed_steps_per_s=speed)
    stop_sync = stack.start_sync_loop()
    cb_ms = []
    engine_cb = stack.runner.pose_callback

    def timed_cb(steps):
        t0 = time.perf_counter()
        engine_cb(steps)
        cb_ms.append((time.perf_counter() - t0) * 1e3)

    stack.runner.pose_callback = timed_cb
    watched = []
    watcher = threading.Thread(target=lambda: watched.extend(stack.watch(idle_timeout_s=5.0)), daemon=True)
    watcher.start()
    try:
        time.sleep(0.05)  # the watcher subscribes before the task starts
        t0 = time.perf_counter()
        stack.execute_trajectory(list(gpu.trajectory_keyframes), timeout_s=60.0)
        state = stack.runner.run(tick_interval_s=HW_TICK_S)
        run_s = time.perf_counter() - t0
        watcher.join(timeout=10.0)
        final = stack.encoder.latest_position
    finally:
        stop_sync()
        shutdown()
    if watcher.is_alive():
        raise AssertionError("hardware: the watcher did not see the task finish")
    if state.outcome.value != "success":
        raise AssertionError(f"hardware: {state.outcome.value}: {state.message}")
    if final != kf_steps[-1].tolist():
        raise AssertionError(f"hardware: encoder at {final}, last keyframe {kf_steps[-1].tolist()}")
    if not np.array_equal(gpu.current_angles, gpu.convert_steps_to_angles(np.asarray(final))):
        raise AssertionError(f"hardware: engine angles {gpu.current_angles} do not follow the encoder {final}")
    poses = [f for f in watched if f["event"] == "pose"]
    if not (poses and watched[-1]["event"] == "task_finished" and all("tcp_world" in f for f in poses)):
        raise AssertionError(f"hardware: watched frames {watched[-3:]}")
    if dict(gpu_ops.LAUNCHES) != launches:
        raise AssertionError("hardware: the loop launched a kernel")
    print(f"hardware: {len(kf_steps)} keyframes at {speed:.1f} steps/s in {run_s:.3f} s, {len(cb_ms)} ticks, "
          f"pose_cb p50_ms={np.percentile(cb_ms, 50):.4f} p95_ms={np.percentile(cb_ms, 95):.4f} "
          f"max_ms={max(cb_ms):.4f}, {len(watched)} frames watched ({len(poses)} pose), outcome success, "
          f"no kernel launched ({card})")


def phase_exports(gpu, cpu, card):
    """(d) Every export from the card engine and the CPU engine, under
    build/, compared as the CPU tests compare them, and timed."""
    import shutil
    import tempfile

    from mamri_tpu_torch.perception import gpu_ops
    from mamri_tpu_torch.utils.html_viewer import read_html_scene_summary
    from mamri_tpu_torch.utils.scene import capsule_mesh
    from mamri_tpu_torch.utils.stl import load_stl, save_stl

    launches = dict(gpu_ops.LAUNCHES)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="exports-", dir=os.path.join(REPO, "build"))
    try:
        meshes = os.path.join(tmp, "meshes")
        os.makedirs(meshes)
        for i, spec in enumerate(gpu.model.specs):
            if spec.visual_mesh and spec.name not in ("Joint4", "Needle"):  # Joint4 becomes a capsule
                save_stl(os.path.join(meshes, spec.visual_mesh), capsule_mesh(12.0 + 4 * i, 6.0))
        target = BODY_CENTER
        entry = gpu.find_entry_point(BODY_CENTER).point_ras
        ms = {}

        def both(name, call):
            out = []
            for tag, eng in (("card", gpu), ("cpu", cpu)):
                t0 = time.perf_counter()
                out.append(call(eng, os.path.join(tmp, f"{tag}-{name}")))
                if tag == "card":
                    ms[name] = (time.perf_counter() - t0) * 1e3
            if name != "posed" and out[0] != out[1]:  # posed: the paths written, one directory each
                raise AssertionError(f"export {name}: card {out[0]} != CPU {out[1]}")
            return [os.path.join(tmp, f"{tag}-{name}") for tag in ("card", "cpu")], out[0]

        kw = dict(mesh_dir=meshes, target_ras=target, entry_ras=entry)
        (a, b), summary = both("scene.obj", lambda e, p: e.export_scene(p, **kw))
        va, vb = _obj_vertices(a), _obj_vertices(b)
        if list(va) != list(vb):
            raise AssertionError("export scene.obj: objects differ")
        gap = max(_close(va[k], vb[k], 1e-3 + 1e-6, f"scene.obj {k}") for k in va)
        (a, b), _ = both("scene.glb", lambda e, p: e.export_scene(p, **kw))
        ga, gb = _glb_positions(a), _glb_positions(b)
        if list(ga) != list(gb):
            raise AssertionError("export scene.glb: nodes differ")
        gap = max([gap] + [_close(ga[k], gb[k], 1e-3, f"scene.glb {k}") for k in ga])
        for name, call in (("scene.html", lambda e, p: e.export_scene(p, **kw)),
                           ("trajectory.html", lambda e, p: e.export_trajectory_html(p, **kw))):
            (a, b), html_summary = both(name, call)
            sa, sb = read_html_scene_summary(a), read_html_scene_summary(b)
            if list(sa) != list(sb):
                raise AssertionError(f"export {name}: objects differ")
            for k in sb:
                if k == "__anim__":
                    gap = max(gap, _close(sa[k]["transforms"], sb[k]["transforms"], 1e-3, f"{name} transforms"))
                else:
                    gap = max(gap, _close(sa[k]["bbox_lo"] + sa[k]["bbox_hi"], sb[k]["bbox_lo"] + sb[k]["bbox_hi"],
                                          1e-3, f"{name} {k} bbox"))
        (a, b), written = both("posed", lambda e, p: e.export_posed_meshes(p, meshes))
        names = sorted(os.path.basename(p) for p in written)
        if not (names == sorted(os.listdir(a)) == sorted(os.listdir(b)) and len(names) == len(os.listdir(meshes))):
            raise AssertionError(f"export_posed_meshes: {names} against {os.listdir(b)}")
        for f in names:
            gap = max(gap, _close(load_stl(os.path.join(a, f)), load_stl(os.path.join(b, f)), 1e-3, f"posed {f}"))
        (a, b), size = both("scene.png", lambda e, p: e.render_scene(p, **kw))
        pa, pb = _png_pixels(a), _png_pixels(b)
        differ = float((pa != pb).any(-1).mean()) if pa.shape == pb.shape else 1.0
        if not differ <= 0.005:
            raise AssertionError(f"render_scene: {differ:.4%} of the pixels differ between card and CPU (limit 0.5%)")
    finally:
        shutil.rmtree(tmp)
    if dict(gpu_ops.LAUNCHES) != launches:
        raise AssertionError("exports launched a kernel")
    print(f"exports: card = CPU engine (summaries, vertices, transforms and boxes within {gap} mm; {differ:.4%} of "
          f"the {size[0]}x{size[1]} PNG's pixels differ); scene {json.dumps(summary)}; trajectory "
          f"{json.dumps(html_summary)}; no kernel launched")
    print(f"exports ms on the card engine: {json.dumps({k: round(v, 3) for k, v in ms.items()})} ({card})")


def phase_engine_surface(model, vol256, card, paths, device="cuda"):
    """Phase 11: (a) the global mode, (b) the state methods, (c) the
    hardware loop and (d) the exports (run before (c), which moves the
    engine's pose), on the bench scene at 256^3, on
    `device` against a CPU engine (the card; the CPU only to rehearse the
    phase's flow)."""
    from mamri_tpu_torch.api.engine import MamriEngine

    t_phase = time.perf_counter()
    phase_global(model, vol256, card, paths, device)
    gpu = MamriEngine(device=device)
    est = gpu.estimate_pose(vol256)
    check_pose(gpu, est, TRUE_ANGLES, "surface scan 256^3")
    plan = gpu.plan_heuristic_path(BODY_CENTER, gpu.find_entry_point(BODY_CENTER).point_ras, 5.0,
                                   start_pose_steps=est.steps)
    if not plan.success:
        raise AssertionError(f"surface: plan_heuristic_path failed: {plan.message}")
    cpu = MamriEngine(device="cpu")
    cpu.load_state_from_numpy(baseplate_tf=gpu.baseplate_tf, current_angles=gpu.current_angles)
    cpu.last_ik_error = gpu.last_ik_error
    cpu.set_body_segmentation(gpu.body_mask(), *gpu.last_volume_geom)
    cpu.trajectory_path = gpu.trajectory_path.copy()
    cpu.trajectory_keyframes = gpu.trajectory_keyframes.copy()
    phase_state_methods(gpu, cpu, card)
    phase_exports(gpu, cpu, card)
    phase_hardware(gpu, card)
    print(f"phase 11 (engine surface) took {time.perf_counter() - t_phase:.1f} s")


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
    t_start = time.perf_counter()
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
    floor = launch_floor(card)
    for label, vol in (("256^3", vol256), ("80^3", vol80), ("512x512x192", vol512)):
        for name, e in compare_kernels(vol.data, label, card, failures, timings).items():
            errs[name] = max(errs.get(name, 0.0), e)
        torch.cuda.empty_cache()
    compare_one_component((512, 512, 192), card, failures, timings)
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("kernels disagree with their twins:\n" + "\n".join(failures))
    fused = SegmentationParams(max_sweeps=2, passes=3, max_roots=128)  # the engine's defaults
    nonfused = SegmentationParams(closing_radius=1, max_sweeps=2, passes=3, max_roots=128)
    for label, vol in (("256^3", vol256), ("512x512x192", vol512)):
        time_segmentation(vol, f"fused {label}", fused, card)
        time_segmentation(vol, f"non-fused {label}", nonfused, card)

    # ---- phases 3-5: the default path; counts from here on are the path's
    gpu_ops.reset_launch_counts()
    engine = MamriEngine(device="cuda")
    engine.estimate_pose(vol256)  # warm-up
    per_call = {"fused": dict(gpu_ops.LAUNCHES)}
    p50 = time_estimates(engine, vol256, "main 256^3", card)
    report_host_syncs(engine, vol256)

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

    cold_warm(MamriEngine(device="cuda"), vol512, "512x512x192", card)
    paths = {"estimate_default": read_path_counts(gpu_ops, DEFAULT_PATH_KERNELS, "default path")}

    # ---- phase 6: the non-fused branch (closing_radius != 2)
    gpu_ops.reset_launch_counts()
    engine = MamriEngine(device="cuda", seg_params=nonfused)
    engine.estimate_pose(vol256)  # warm-up
    per_call["nonfused"] = dict(gpu_ops.LAUNCHES)
    p50_nf = time_estimates(engine, vol256, "non-fused 256^3", card)
    cold_warm(MamriEngine(device="cuda", seg_params=nonfused), vol512, "non-fused 512x512x192", card)
    paths["estimate_nonfused"] = read_path_counts(gpu_ops, NONFUSED_PATH_KERNELS, "non-fused path")
    if paths["estimate_nonfused"]["close_init"]:
        raise AssertionError("non-fused path launched close_init: the fused branch ran")
    print(f"launches per estimate_pose at 256^3: {per_call}")
    print(f"estimate_pose 256^3 p50_ms fused={p50:.3f} non-fused={p50_nf:.3f} ({card})")

    # ---- phase 7: the kernel-parity harness
    from mamri_tpu_torch.perception.parity import run_parity_checks

    gpu_ops.reset_launch_counts()
    for size in (128, 80):
        t0 = time.perf_counter()
        rep = run_parity_checks(size, device="cuda")
        print(f"parity size {size}: all_exact={rep['all_exact']} num_checks={rep['num_checks']} "
              f"seconds={time.perf_counter() - t0:.3f}")
        if not rep["all_exact"]:
            raise AssertionError(f"parity size {size} failed: {json.dumps(rep)}")
    paths["parity"] = read_path_counts(gpu_ops, tuple(KERNELS), "parity harness")

    # ---- phase 8: batch and async at 256^3
    phase_batch_async(model, card, paths)

    # ---- phase 9: planning on the bench scene at 256^3 (no kernel runs on this path)
    phase_planning(vol256, card)

    # ---- phase 10: a stream from disk on the clinical grid; then every kernel at its ROI window's shape
    paths["stream"], window = phase_stream(model, vol512, vol256, card)
    label = "ROI " + "x".join(str(n) for n in window.shape)
    for name, e in compare_kernels(window.data.astype(np.float32), label, card, failures, timings).items():
        errs[name] = max(errs.get(name, 0.0), e)
    if failures:
        raise AssertionError("kernels disagree with their twins at the ROI window:\n" + "\n".join(failures))

    # ---- phase 11: the global matcher, the state methods, the hardware loop and the exports
    phase_engine_surface(model, vol256, card, paths)

    main_t = timings["256^3"]
    kernels = []
    for name, (src, replaces) in KERNELS.items():
        variants = main_t[name]
        # the slowest variant at the size the main path gives the kernel (not the escalated table, not every
        # voxel a root)
        ms, plain_ms, bound_ms, bound_by = max((t for v, t in variants.items() if v not in STRESS_VARIANTS),
                                               key=lambda t: t[0])
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": src,
            "replaces": replaces,
            "launches": sum(p[name] for p in paths.values()),
            "launches_by_path": {path: p[name] for path, p in paths.items()},
            "max_abs_err": errs[name],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "ms_by_variant": {v: {"ms": t[0], "plain_ms": t[1], "bound_ms": t[2]} for v, t in variants.items()},
            "library_ms": None,  # no single PyTorch call computes any of these functions
        })
    print(card)
    print(json.dumps({"kernels": kernels, "launch_floor_ms": floor}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

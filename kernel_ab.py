#!/usr/bin/env python3
"""Time every kernel of one checkout on one GPU, as chip_smoke.py times them.

    python3 kernel_ab.py [--root DIR] [--estimate]

Imports `mamri_tpu_torch` from DIR (default: this checkout), builds its
kernels and runs this checkout's chip_smoke.py phase 2 on it at 256^3 and
512x512x192: every kernel of chip_smoke.KERNELS held against its twin and
timed at chip_smoke's variant keys (`reset_distances[z]`, `run_min[y.2]`,
...; L2 flushed, median of chip_smoke.REPS), then `segment_volume` on both
branches (host-clock p50 and device time), after the launch floor (an empty
kernel once, twice and three times in a row) where DIR's library has the
empty kernel. DIR must define every wrapper chip_smoke calls (true of the
package since all its kernels were ported). The last line is one JSON
object of the times. To compare two commits on one card, unpack the other
into a git-ignored directory (`git archive`) and run both in one call:
other, this, this, other.

`--estimate` times the whole call instead: `MamriEngine(device="cuda")
.estimate_pose` of DIR on chip_smoke's bench scene at 256^3 (fused branch,
the engine's defaults), one warm-up and ESTIMATE_CALLS warm calls by the host
clock, each checked to succeed with every marker found; the last line gives
the p50 and every sample. It imports only DIR's engine, robot model and
volume (and what chip_smoke's scene needs of them), so it runs on any
checkout of the port.
"""

import argparse
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ESTIMATE_CALLS = 20


def _chip_smoke():
    """This checkout's chip_smoke.py (scenes, kernel comparisons, timing)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def estimate(cs):
    """{"p50": ms, "all": [ms, ...]}: warm estimate_pose calls at 256^3."""
    import numpy as np
    from mamri_tpu_torch.api.engine import MamriEngine
    from mamri_tpu_torch.core.robot import load_robot_model

    vol, _ = cs.bench_scene(load_robot_model(device="cpu"), (256, 256, 256))
    engine = MamriEngine(device="cuda")
    cs.check_pose(engine, engine.estimate_pose(vol), cs.TRUE_ANGLES, "warm-up 256^3")
    lat = []
    for _ in range(ESTIMATE_CALLS):
        engine.current_angles = np.zeros(6, np.float32)
        t0 = time.perf_counter()
        res = engine.estimate_pose(vol)
        lat.append((time.perf_counter() - t0) * 1e3)
        if not (res.success and all(res.markers_found.values())):
            raise AssertionError(f"estimate_pose failed: {res}")
    return {"p50": float(np.median(lat)), "all": lat}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE, help="checkout whose mamri_tpu_torch is timed")
    ap.add_argument("--estimate", action="store_true", help="time estimate_pose at 256^3, not the kernels")
    opts = ap.parse_args()
    root = os.path.abspath(opts.root)
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: torch.cuda.is_available() is False; this script needs a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    cs = _chip_smoke()
    from mamri_tpu_torch import _build
    from mamri_tpu_torch.core.robot import load_robot_model
    from mamri_tpu_torch.perception import gpu_ops
    from mamri_tpu_torch.perception.segmentation import SegmentationParams

    if not gpu_ops.__file__.startswith(root):
        raise AssertionError(f"imported {gpu_ops.__file__}, not the package under {root}")
    card = cs.card_line()
    if opts.estimate:
        print(json.dumps({"root": root, "card": card, "estimate_pose_256_ms": estimate(cs)}))
        return 0
    # a checkout from before the launch floor has no empty kernel to time
    floor = cs.launch_floor(card) if hasattr(_build.library(), "mamri_noop") else None
    model = load_robot_model(device="cpu")
    failures, timings, times = [], {}, {}
    branches = {"fused": SegmentationParams(max_sweeps=2, passes=3, max_roots=128),  # the engine's defaults
                "non-fused": SegmentationParams(closing_radius=1, max_sweeps=2, passes=3, max_roots=128)}
    for label, shape in (("256^3", (256, 256, 256)), ("512x512x192", (512, 512, 192))):
        vol, _ = cs.bench_scene(model, shape)
        cs.compare_kernels(vol.data, label, card, failures, timings)
        for name, variants in timings[label].items():
            for variant, (ms, *_rest) in variants.items():
                times[f"{label} {name}" + (f"[{variant}]" if variant != name else "")] = ms
        for branch, params in branches.items():
            host_ms, device_ms = cs.time_segmentation(vol, f"{branch} {label}", params, card)
            times[f"{label} segment_volume {branch}"] = host_ms
            times[f"{label} segment_volume {branch} device"] = device_ms
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError("kernels disagree with their twins:\n" + "\n".join(failures))
    print(json.dumps({"root": root, "card": card, "launch_floor_ms": floor, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

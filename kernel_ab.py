#!/usr/bin/env python3
"""Time every kernel of one checkout on one GPU, as chip_smoke.py times them.

    python3 kernel_ab.py [--root DIR]

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
"""

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def _chip_smoke():
    """This checkout's chip_smoke.py (scenes, kernel comparisons, timing)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE, help="checkout whose mamri_tpu_torch is timed")
    root = os.path.abspath(ap.parse_args().root)
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

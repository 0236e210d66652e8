"""Multi-shard dry run of the mesh-batched pipeline on a virtual mesh.

    python -m mamri_tpu_torch.parallel.dryrun N [--platform cpu]

The port's counterpart of `__graft_entry__.dryrun_multichip`: the demo
scene (6 mm) through `run_sharded_batched` on the mesh shapes (N, 1),
(N/4, 4) or (N/2, 2), and (1, N), every shard on one device (the card
unless `--platform cpu`). The fast sharded kernel path runs (fused init
with raw-data halos, the cross-shard x fix, `psum`'d certificates, exact
run stats). Every shape must succeed, certify, and give angles and RMSE
bit-equal to the single-device `pipeline_fn` on the same bytes.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def mesh_shapes(n_devices: int):
    """dp only, dp x sp and sp only, as the reference sweeps them."""
    shapes = [(n_devices, 1)]
    if n_devices % 4 == 0 and n_devices > 4:
        shapes.append((n_devices // 4, 4))
    elif n_devices % 2 == 0 and n_devices > 2:
        shapes.append((n_devices // 2, 2))
    if n_devices > 1:
        shapes.append((1, n_devices))
    return shapes


def dryrun_multichip(n_devices: int, device="cuda") -> list:
    """Run every mesh shape on `n_devices` virtual devices over `device`;
    returns one summary dict per shape. Raises on any failure."""
    from mamri_tpu_torch.api.demo import build_demo_scene
    from mamri_tpu_torch.api.engine import MamriEngine
    from mamri_tpu_torch.parallel import make_mesh, run_sharded_batched
    from mamri_tpu_torch.perception.segmentation import SegmentationParams

    device = torch.device(device)
    seg_params = SegmentationParams(max_sweeps=2, passes=3, max_roots=128, use_pallas=True)
    engine = MamriEngine(ik_iters=10, ik_restarts=0, seg_params=seg_params, device=device)
    vol = build_demo_scene(engine, spacing=6.0)[0]
    shapes = mesh_shapes(n_devices)

    # one shape for every mesh: nx divisible by every sp and by the kernels' 8-row x tile
    max_sp = max(sp for _, sp in shapes)
    data = vol.data
    pad_x = (-data.shape[0]) % (8 * max_sp)
    if pad_x:
        data = np.pad(data, ((0, pad_x), (0, 0), (0, 0)), constant_values=10.0)

    # the single-device reference: the same pipeline, unsharded, one volume
    f32 = torch.float32
    ref = engine._fetch(engine.pipeline_fn(seg_params)(
        engine._upload(data), engine._upload(vol.spacing, f32), engine._upload(vol.origin, f32),
        engine._upload(np.eye(4, dtype=np.float32)), engine._upload(False), engine._upload(False),
        engine._upload(False), engine._upload(np.zeros(engine.model.num_joints, dtype=np.float32)),
    ))
    if not bool(ref["success"]):
        raise AssertionError("single-device reference run failed")

    summaries = []
    for dp, sp in shapes:
        mesh = make_mesh(n_devices, axes=("dp", "sp"), shape=(dp, sp), devices=[device] * n_devices)
        batch = np.broadcast_to(data, (max(dp, 2),) + data.shape).copy()
        out, final_params, certified = run_sharded_batched(
            engine, mesh, batch, vol.spacing, vol.origin, dp_axis="dp", sp_axis="sp"
        )
        ok = out["success"]
        bitexact = bool(
            np.array_equal(out["angles"], np.broadcast_to(ref["angles"], out["angles"].shape))
            and np.array_equal(out["rmse"], np.broadcast_to(ref["rmse"], out["rmse"].shape))
        )
        print(
            f"dryrun_multichip: mesh dp={dp} sp={sp}, batch={batch.shape}, "
            f"success={ok.tolist()}, rmse={out['rmse'].round(3).tolist()}, "
            f"certified={certified} (ccl_converged={out['seg_converged'].tolist()}, "
            f"roots_complete={out['roots_complete'].tolist()}, "
            f"blobs_complete={out['blobs_complete'].tolist()}, "
            f"final passes={final_params.passes}, max_roots={final_params.max_roots}), "
            f"bitexact_vs_single_device={bitexact}",
            flush=True,
        )
        if not ok.all():
            raise AssertionError(f"mesh dp={dp} sp={sp}: pipeline failed")
        if not certified:
            raise AssertionError(f"mesh dp={dp} sp={sp}: certificates not asserted")
        if not bitexact:
            raise AssertionError(f"mesh dp={dp} sp={sp}: outputs differ from the single-device run")
        summaries.append({"dp": dp, "sp": sp, "batch": int(batch.shape[0]), "certified": certified,
                          "bitexact": bitexact})
    return summaries


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mamri_tpu_torch.parallel.dryrun", description=__doc__.split("\n\n")[0])
    ap.add_argument("n_devices", type=int, nargs="?", default=8)
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda",
                    help="the device every virtual shard runs on (default: the card)")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, device=args.platform)
    return 0


if __name__ == "__main__":
    sys.exit(main())

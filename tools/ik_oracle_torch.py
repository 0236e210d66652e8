"""The IK oracle on the PyTorch port: SciPy's TRF against the port's LM.

The port's counterpart of tools/ik_oracle.py, with its protocol. Per scene
(bench.py's 4 scenes, then a 16-pose random sweep, seed 101):
  1. True angles and base -> FK marker positions -> quantized detections:
     the centroid of the voxel centres each 4 mm sphere rasterizes to on the
     bench's 256^3 grid (what the segmentation measures).
  2. The baseplate from the quantized markers: Y-flatten + Kabsch, as the
     engine's pipeline computes it.
  3. Solve with (a) the port's LM at the engine's defaults (24 iterations,
     2 restarts, analytic seeds) on the engine's device, (b) TRF from the
     reference's guesses {current, zeros}, (c) TRF seeded at the truth: the
     bound no solver can beat on the same data.
TRF runs on a CPU model (SciPy is host code; on a card every residual
evaluation would be a round trip). The LM runs on the card unless --cpu.

Prints the summary (IK_ORACLE.json's keys) as one JSON line, and on
stderr each scene's row and the largest |LM - TRF from the truth| over the
joints of each scene; `--out FILE` writes the summary with its rows.

    python tools/ik_oracle_torch.py [--scenes 20] [--out FILE] [--cpu]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

SWEEP_POSES = 16
MARKER_LINKS = ("Baseplate", "Joint2", "Joint4", "Joint6")


def sweep_poses(model, count=SWEEP_POSES):
    """tools/ik_oracle.py's random sweep (seed 101): [(angles, base), ...]."""
    from mamri_tpu_torch.api.demo import bench_base_tf

    rng = np.random.default_rng(101)
    limits = model.limits_rad.cpu().numpy()
    out = []
    for _ in range(count):
        frac = 0.2 + 0.6 * rng.random(6)
        a = (limits[:, 0] + frac * (limits[:, 1] - limits[:, 0])).astype(np.float32)
        if abs(a[4]) < 0.3:
            a[4] = np.float32(0.3 if a[4] >= 0 else -0.3)
        out.append((a, bench_base_tf(float(rng.uniform(-0.4, 0.4))).numpy()))
    return out


def run_oracle(device, scenes=4 + SWEEP_POSES, log=sys.stderr):
    """(IK_ORACLE.json's summary over the first `scenes` scenes, {scene: max
    |LM - TRF from the truth| in degrees over the joints})."""
    import torch

    from mamri_tpu_torch.api.demo import bench_scenes
    from mamri_tpu_torch.api.engine import MamriEngine
    from mamri_tpu_torch.core.robot import fk_all_links, load_robot_model, marker_world_positions
    from mamri_tpu_torch.ik.residuals import full_chain_residual, solve_full_chain_ik
    from mamri_tpu_torch.ik.trf import solve_full_chain_trf
    from mamri_tpu_torch.perception.volume import rasterized_sphere_centroids as quantized_centroids
    from mamri_tpu_torch.registration.kabsch import kabsch_rigid_transform

    engine = MamriEngine(device=device)  # the LM's model, iterations and restarts
    host = load_robot_model(device="cpu")  # TRF, FK and the scene
    dev = engine.model.device
    bench, spacing, origin, _ = bench_scenes(host)
    cases = [(a, b, f"bench_scene_{i}") for i, (a, b, _) in enumerate(bench)]
    cases += [(a, b, f"sweep_{i}") for i, (a, b) in enumerate(sweep_poses(host))]

    def t(v, device="cpu"):
        return torch.as_tensor(np.asarray(v, dtype=np.float32)).to(device)

    true_flag, false_flag = torch.tensor(True), torch.tensor(False)

    def tcp(angles, base):
        return fk_all_links(host, t(angles), t(base))[-1][:3, 3].numpy()

    def markers(angles, base, link):
        return marker_world_positions(host, t(angles), link, t(base)).numpy()

    def solve_scene(true_angles, base, tag):
        q = {ln: quantized_centroids(markers(true_angles, base, ln), 4.0, spacing, origin) for ln in MARKER_LINKS}
        quant_noise = max(float(np.abs(q[ln] - markers(true_angles, base, ln)).max()) for ln in q)
        # the baseplate as the pipeline computes it: Y-flatten, then Kabsch
        bp = q["Baseplate"].astype(np.float32)
        bp[:, 1] = bp[:, 1].mean()
        bp_local = host.marker_local[host.link_index("Baseplate")]
        base_est = kabsch_rigid_transform(bp_local, t(bp)).numpy()
        j6, j4, j2 = (q[ln].astype(np.float32) for ln in ("Joint6", "Joint4", "Joint2"))

        def residual_cost(x):
            r = full_chain_residual(host, t(x), t(base_est), t(j6), false_flag, t(j4), true_flag).numpy()
            return 0.5 * float((r * r).sum())

        found = torch.tensor(True, device=dev)
        lm = solve_full_chain_ik(
            engine.model, t(j6, dev), t(base_est, dev),
            num_iters=engine.ik_iters, num_random_restarts=engine.ik_restarts,
            joint4_targets=t(j4, dev), joint4_found=found, joint2_targets=t(j2, dev), joint2_found=found,
        )
        lm_angles, lm_cost, lm_rmse = (v.cpu().numpy() for v in (lm.angles, lm.cost, lm.rmse))
        trf = solve_full_chain_trf(host, j6, base_est, joint4_targets=j4, joint4_found=True)
        trf_truth = solve_full_chain_trf(
            host, j6, base_est, joint4_targets=j4, joint4_found=True, extra_guesses=[np.asarray(true_angles)]
        )

        def per_joint(a):
            return np.degrees(np.abs(np.asarray(a) - np.asarray(true_angles)))

        def err(a):
            return float(per_joint(a).max())

        def tcp_err(a):
            return float(np.linalg.norm(tcp(a, base) - tcp(true_angles, base)))

        lm_vs_truth_trf[tag] = float(np.degrees(np.abs(lm_angles - trf_truth.angles)).max())
        return {
            "scene": tag,
            "quantization_noise_mm": round(quant_noise, 4),
            "cost_at_truth": round(residual_cost(true_angles), 6),
            "lm": {"max_err_deg": round(err(lm_angles), 4), "tcp_err_mm": round(tcp_err(lm_angles), 4),
                   "cost": round(float(lm_cost), 6), "rmse_mm": round(float(lm_rmse), 4),
                   "per_joint_err_deg": [round(x, 3) for x in per_joint(lm_angles).tolist()]},
            "trf_ref_guesses": {"max_err_deg": round(err(trf.angles), 4), "tcp_err_mm": round(tcp_err(trf.angles), 4),
                                "cost": round(trf.cost, 6), "rmse_mm": round(trf.rmse, 4), "nfev": trf.nfev,
                                "per_joint_err_deg": [round(x, 3) for x in per_joint(trf.angles).tolist()]},
            "trf_from_truth": {"max_err_deg": round(err(trf_truth.angles), 4),
                               "tcp_err_mm": round(tcp_err(trf_truth.angles), 4),
                               "cost": round(trf_truth.cost, 6),
                               "per_joint_err_deg": [round(x, 3) for x in per_joint(trf_truth.angles).tolist()]},
        }

    t0 = time.time()
    rows, lm_vs_truth_trf = [], {}
    for true_angles, base, tag in cases[:scenes]:
        rows.append(solve_scene(true_angles, base, tag))
        print(json.dumps(rows[-1]), file=log)
    return {
        "protocol": "quantized 256^3-grid centroids; base from Y-flattened Kabsch; identical residuals",
        "elapsed_s": round(time.time() - t0, 1),
        "lm_max_err_deg": max(r["lm"]["max_err_deg"] for r in rows),
        "trf_ref_max_err_deg": max(r["trf_ref_guesses"]["max_err_deg"] for r in rows),
        "trf_from_truth_max_err_deg": max(r["trf_from_truth"]["max_err_deg"] for r in rows),
        "lm_max_tcp_err_mm": max(r["lm"]["tcp_err_mm"] for r in rows),
        "trf_from_truth_max_tcp_err_mm": max(r["trf_from_truth"]["tcp_err_mm"] for r in rows),
        "lm_cost_le_trf_cost_everywhere": all(
            r["lm"]["cost"] <= r["trf_ref_guesses"]["cost"] * 1.001 + 1e-9 for r in rows
        ),
        "scenes": rows,
    }, lm_vs_truth_trf


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenes", type=int, default=4 + SWEEP_POSES, help="run the first N of the 20 scenes")
    ap.add_argument("--out", default="", help="write the summary with every scene's row here")
    ap.add_argument("--cpu", action="store_true", help="run the LM on the CPU (default: the card)")
    args = ap.parse_args(argv)
    if not 1 <= args.scenes <= 4 + SWEEP_POSES:
        ap.error(f"--scenes must lie in [1, {4 + SWEEP_POSES}]")
    summary, lm_vs_trf = run_oracle("cpu" if args.cpu else "cuda", args.scenes)
    print(json.dumps({"max_abs_lm_minus_trf_from_truth_deg": lm_vs_trf}), file=sys.stderr)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps({k: v for k, v in summary.items() if k != "scenes"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

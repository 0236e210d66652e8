"""Self-contained demo scene: the full workflow with zero input data.

The port of `mamri_tpu/api/demo.py`: the robot upright on the bed (mount
convention: local +Z along world +Y), fiducial spheres rendered at the FK
marker positions of a known pose, and an ellipsoid body phantom. The base
and the marker points are computed on the engine's device (the card unless
the engine was built on the CPU) and fetched once; the rest is numpy, as in
the reference.
"""

from __future__ import annotations

import numpy as np

DEMO_ANGLES = (0.3, -0.7, 0.5, 0.2, -0.4, 0.6)
DEMO_BODY_CENTER_RAS = (-60.0, -40.0, 130.0)
DEMO_BODY_RADII_MM = (45.0, 55.0, 65.0)


def build_demo_scene(engine, spacing: float = 3.0, angles=None, yaw: float = 0.15):
    """-> (volume, true_angles, base_tf, target_ras).

    `spacing` trades fidelity for speed (3 mm default; larger for smoke
    runs). The grid is auto-fit to the FK marker bounding box + body
    phantom, so markers always render inside the volume. `target_ras` is a
    biopsy-style point inside the body phantom for entry-search/planning
    demos."""
    import torch

    from mamri_tpu_torch.core.robot import marker_world_positions
    from mamri_tpu_torch.perception.volume import synthetic_volume

    true_angles = np.asarray(
        DEMO_ANGLES if angles is None else angles, dtype=np.float32
    )

    def dev(v):
        return torch.tensor(v, dtype=torch.float32, device=engine.device)

    base_dev = bench_base_tf(yaw, engine.device)
    links = ["Baseplate", "Joint2", "Joint4", "Joint6"]
    pts_dev = torch.cat(
        [marker_world_positions(engine.model, dev(true_angles), ln, base_dev) for ln in links]
    )
    base, pts = base_dev.cpu().numpy(), pts_dev.cpu().numpy()
    body_center = np.asarray(DEMO_BODY_CENTER_RAS)
    lo = np.minimum(pts.min(0) - 40, body_center - 70)
    hi = np.maximum(pts.max(0) + 40, body_center + 70)
    lps_lo = np.array([-hi[0], -hi[1], lo[2]], dtype=np.float32)
    lps_hi = np.array([-lo[0], -lo[1], hi[2]], dtype=np.float32)
    sp = np.array([spacing] * 3, dtype=np.float32)
    shape = tuple(int(np.ceil(e)) for e in (lps_hi - lps_lo) / sp)
    volume = synthetic_volume(
        shape=shape,
        spacing=sp,
        origin=lps_lo,
        fiducials_ras=pts,
        fiducial_radius_mm=5.0,
        body_center_ras=list(body_center),
        body_radii_mm=list(DEMO_BODY_RADII_MM),
    )
    target_ras = (body_center + np.array([0.0, 0.0, -15.0])).astype(np.float32)
    return volume, true_angles, base, target_ras


def bench_base_tf(yaw, device="cpu"):
    """(4, 4) f32 tensor: the bench's baseplate, upright on the bed (local +Z
    along world +Y) at (-60, -120, 0) mm, turned by `yaw` rad."""
    import torch

    from mamri_tpu_torch.core import transforms as T

    def dev(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    return T.translate(dev([-60.0, -120.0, 0.0])) @ T.rot_x(dev(-np.pi / 2)) @ T.rot_z(dev(yaw))


def bench_scenes(model, size=256):
    """bench.py's `_build_scenes` (bench.py:48-97) without jax: its canonical
    pose and 3 random in-bounds poses and base yaws (seed 23, J5 kept off the
    wrist singularity), and the union bounding box they render into.

    -> (scenes, spacing, origin, body_center), each scene (true angles (6,)
    f32, base (4, 4) f32, marker points (12, 3) f32: Baseplate, Joint2,
    Joint4, Joint6). `size` is bench.py's BENCH_SIZE (spacing = the box's
    largest extent / size, the same on every axis); a 3-tuple shape gives
    per-axis spacing over the same box instead. FK runs on `model`'s device."""
    import torch

    from mamri_tpu_torch.core.robot import marker_world_positions

    def dev(v):
        return torch.tensor(v, dtype=torch.float32, device=model.device)

    def markers(angles, base):
        links = ["Baseplate", "Joint2", "Joint4", "Joint6"]
        return torch.cat([marker_world_positions(model, dev(angles), ln, base) for ln in links]).cpu().numpy()

    rng = np.random.default_rng(23)
    limits = model.limits_rad.cpu().numpy()
    lo_lim, hi_lim = limits[:, 0], limits[:, 1]
    poses = [(np.asarray(DEMO_ANGLES, dtype=np.float32), 0.15)]  # bench.py's canonical pose is the demo's
    for _ in range(3):
        frac = 0.25 + 0.5 * rng.random(6)
        angles = (lo_lim + frac * (hi_lim - lo_lim)).astype(np.float32)
        if abs(angles[4]) < 0.3:  # keep J5 off the wrist singularity
            angles[4] = np.float32(0.3 if angles[4] >= 0 else -0.3)
        poses.append((angles, float(rng.uniform(-0.4, 0.4))))
    scenes = []
    for angles, yaw in poses:
        base = bench_base_tf(yaw, model.device)
        scenes.append((angles, base.cpu().numpy(), markers(angles, base)))

    body_center = np.asarray(DEMO_BODY_CENTER_RAS)
    all_pts = np.concatenate([s[2] for s in scenes])
    lo = np.minimum(all_pts.min(0) - 40, body_center - 75)
    hi = np.maximum(all_pts.max(0) + 40, body_center + 75)
    lps_lo = np.array([-hi[0], -hi[1], lo[2]], dtype=np.float32)
    lps_hi = np.array([-lo[0], -lo[1], hi[2]], dtype=np.float32)
    if np.ndim(size) == 0:
        spacing = np.full(3, float((lps_hi - lps_lo).max()) / size, dtype=np.float32)
    else:
        spacing = ((lps_hi - lps_lo) / np.asarray(size, dtype=np.float32)).astype(np.float32)
    return scenes, spacing, lps_lo, body_center


def render_bench_scene(points, shape, spacing, origin, body_center):
    """One bench scene's scan: 4 mm fiducial spheres at `points` and the
    bench's ellipsoid body (radii 45, 55, 65 mm), as bench.py renders it."""
    from mamri_tpu_torch.perception.volume import synthetic_volume

    return synthetic_volume(
        shape=tuple(shape), spacing=spacing, origin=origin, fiducials_ras=points,
        fiducial_radius_mm=4.0, body_center_ras=body_center,
        body_radii_mm=list(DEMO_BODY_RADII_MM),
    )

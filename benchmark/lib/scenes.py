"""The benchmark's inputs, made from its own recipe and seed, never by the
program: bench.py's four scenes in their union box, the scans they render
to, a slow seeded arm trajectory for tracking, and lesion-sized targets.

The scene recipe is bench.py's (`_build_scenes`, bench.py:48-97): its
canonical pose plus three poses and base yaws drawn with seed 23, J5 kept
off the wrist singularity; 4 mm fiducial spheres at the Baseplate, Joint2,
Joint4 and Joint6 markers and a 45/55/65 mm ellipsoid body, intensities
120 / 90 / 10. Scans are rendered on the given device in float32 and copied
to host memory once.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.lib.arm import Arm, bed_base, marker_points

CANONICAL_ANGLES = (0.3, -0.7, 0.5, 0.2, -0.4, 0.6)
CANONICAL_YAW = 0.15
SCENE_SEED = 23
BODY_CENTER_RAS = (-60.0, -40.0, 130.0)
BODY_RADII_MM = (45.0, 55.0, 65.0)
FIDUCIAL_RADIUS_MM = 4.0
FIDUCIAL, BODY, BACKGROUND = 120.0, 90.0, 10.0


def bench_poses(arm: Arm):
    """[(angles (6,) f64, yaw)] of bench.py's four scenes."""
    rng = np.random.default_rng(SCENE_SEED)
    lo, hi = arm.limits[:, 0].astype(np.float32), arm.limits[:, 1].astype(np.float32)
    poses = [(np.asarray(CANONICAL_ANGLES, np.float32), CANONICAL_YAW)]
    for _ in range(3):
        frac = 0.25 + 0.5 * rng.random(6)
        angles = (lo + frac * (hi - lo)).astype(np.float32)
        if abs(angles[4]) < 0.3:  # keep J5 off the wrist singularity
            angles[4] = np.float32(0.3 if angles[4] >= 0 else -0.3)
        poses.append((angles, float(rng.uniform(-0.4, 0.4))))
    return [(a.astype(np.float64), yaw) for a, yaw in poses]


def markers(arm: Arm, angles, base) -> np.ndarray:
    """(12, 3) f64 world marker positions (Baseplate, Joint2, Joint4, Joint6)."""
    t = torch.float64
    return marker_points(arm, torch.as_tensor(angles, dtype=t), torch.as_tensor(base, dtype=t)).numpy()


def union_box(all_markers: np.ndarray):
    """(lps_lo, lps_hi) f64: the box around every marker (+40 mm) and the
    body (+75 mm), in LPS."""
    body = np.asarray(BODY_CENTER_RAS)
    lo = np.minimum(all_markers.min(0) - 40, body - 75)
    hi = np.maximum(all_markers.max(0) + 40, body + 75)
    return np.array([-hi[0], -hi[1], lo[2]]), np.array([-lo[0], -lo[1], hi[2]])


def grid(box, shape, cube_size):
    """(spacing, origin) f32 of `shape` over the box: the bench grid is the
    box's largest extent / `cube_size` on every axis; a shape other than
    the cube spreads that cube's extent over its own voxel counts."""
    lps_lo, lps_hi = box
    cube = float((np.float32(lps_hi) - np.float32(lps_lo)).max()) / cube_size
    spacing = np.float32(cube) * np.float32(cube_size) / np.asarray(shape, np.float32)
    return spacing.astype(np.float32), np.float32(lps_lo)


def render(points_ras, shape, spacing, origin, device, dtype=torch.float32, slab=32):
    """(nx, ny, nz) scan on `device`: background, the ellipsoid body and a
    sphere at each point, tested at voxel centres in RAS, in float32."""
    f32 = torch.float32
    sp = torch.as_tensor(spacing, dtype=f32, device=device)
    org = torch.as_tensor(origin, dtype=f32, device=device)
    nx, ny, nz = shape
    out = torch.empty(shape, dtype=dtype, device=device)
    c = torch.tensor(BODY_CENTER_RAS, dtype=f32, device=device)
    r = torch.tensor(BODY_RADII_MM, dtype=f32, device=device)
    pts = torch.as_tensor(np.asarray(points_ras, np.float32), device=device)
    ry = -(org[1] + sp[1] * torch.arange(ny, dtype=f32, device=device))[None, :, None]
    rz = (org[2] + sp[2] * torch.arange(nz, dtype=f32, device=device))[None, None, :]
    for x0 in range(0, nx, slab):
        rx = -(org[0] + sp[0] * torch.arange(x0, min(x0 + slab, nx), dtype=f32, device=device))[:, None, None]
        inside = ((rx - c[0]) / r[0]) ** 2 + ((ry - c[1]) / r[1]) ** 2 + ((rz - c[2]) / r[2]) ** 2 <= 1.0
        vol = torch.where(inside, BODY, BACKGROUND)
        for p in pts:
            d2 = (rx - p[0]) ** 2 + (ry - p[1]) ** 2 + (rz - p[2]) ** 2
            vol = torch.where(d2 <= FIDUCIAL_RADIUS_MM ** 2, FIDUCIAL, vol)
        out[x0:x0 + vol.shape[0]] = vol.to(dtype)
    return out


class Scene:
    """One scan's truth: joint angles, base and the 12 marker points."""

    def __init__(self, angles, base, pts):
        self.angles, self.base, self.markers = angles, base, pts


def bench_scenes(arm: Arm):
    """bench.py's four scenes and their union box."""
    scenes = []
    for angles, yaw in bench_poses(arm):
        base = bed_base(yaw)
        scenes.append(Scene(angles, base, markers(arm, angles, base)))
    return scenes, union_box(np.concatenate([s.markers for s in scenes]))


def drift_poses(arm: Arm, start, base, count: int, step_deg: float, bound_deg: float, rng):
    """`count` scenes along a slow random walk from `start`: each joint moves
    by at most `step_deg` a pose and stays within `bound_deg` of the start."""
    step, bound = math.radians(step_deg), math.radians(bound_deg)
    a0 = np.asarray(start, np.float64)
    a = a0.copy()
    out = []
    for _ in range(count):
        out.append(Scene(a.copy(), base, markers(arm, a, base)))
        a = np.clip(a + rng.uniform(-step, step, a.shape), a0 - bound, a0 + bound)
    return out


def forth_and_back(count: int):
    """Frame order 0, 1, .., n-1, n-2, .., 1, 0, 1, ..: no frame jumps."""
    return list(range(count)) + list(range(count - 2, 0, -1))


def seeded_order(rng, n_items: int, length: int):
    """`length` indices: successive seeded permutations of range(n_items)."""
    out = []
    while len(out) < length:
        out.extend(int(i) for i in rng.permutation(n_items))
    return out[:length]


def targets_near(center, radius_mm: float, count: int, rng) -> np.ndarray:
    """(count, 3) f32 points uniform in a ball of `radius_mm` about `center`."""
    d = rng.normal(size=(count, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rad = radius_mm * rng.random(count) ** (1.0 / 3.0)
    return (np.asarray(center, np.float64) + d * rad[:, None]).astype(np.float32)

"""Robot collision geometry: per-part surface point clouds (port of
`mamri_tpu/planning/geometry.py`).

Each checked part (Joint1..Joint6) becomes a fixed-size local-frame point
cloud once, at engine construction: sampled from the part's STL when a mesh
directory holds one (the collision hull first, the visual mesh as the
fallback), else from a capsule spanning the link's offset to its child. The
clouds come from numpy's `default_rng(seed=link_index)`, so they are
bit-equal to the reference's, and are uploaded once to the model's device as
one (n_parts, P, 3) tensor.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from mamri_tpu_torch.core.robot import RobotModel
from mamri_tpu_torch.utils.stl import load_stl, sample_surface_points

PARTS_TO_CHECK: Tuple[str, ...] = ("Joint1", "Joint2", "Joint3", "Joint4", "Joint5", "Joint6")
DEFAULT_PART_RADIUS_MM = 22.0
MIN_PART_LENGTH_MM = 26.0


class ArmGeometry(NamedTuple):
    part_points: torch.Tensor  # (n_parts, P, 3) local-frame surface points
    part_link_idx: Tuple[int, ...]  # link indices (Joint1..Joint6)
    part_names: Tuple[str, ...]


def _capsule_points(length: float, radius: float, n: int, seed: int) -> np.ndarray:
    """Surface points of a capsule along local +Z from z=0 to z=length."""
    rng = np.random.default_rng(seed)
    n_side = int(n * 0.7)
    n_caps = n - n_side
    # lateral surface
    theta = rng.uniform(0, 2 * np.pi, n_side)
    z = rng.uniform(0.0, length, n_side)
    side = np.stack([radius * np.cos(theta), radius * np.sin(theta), z], axis=1)
    # hemispherical caps
    phi = rng.uniform(0, 2 * np.pi, n_caps)
    cost = rng.uniform(-1, 1, n_caps)
    sint = np.sqrt(1 - cost**2)
    sph = np.stack([radius * sint * np.cos(phi), radius * sint * np.sin(phi), radius * cost], axis=1)
    top = cost >= 0
    caps = sph.copy()
    caps[top, 2] += length  # upper hemisphere on the far end
    return np.concatenate([side, caps]).astype(np.float32)


def resolve_part_source(model, link_index: int, mesh_dir):
    """(stl_path or None, capsule_length_mm) of one checked part, shared by
    the fast checker and the exact validator so both resolve a part the same
    way: an existing STL (collision mesh first, visual mesh as the fallback),
    else a capsule from this link's origin to its child's fixed offset."""
    spec = model.specs[link_index]
    if mesh_dir is not None:
        for mesh_name in (spec.collision_mesh, spec.visual_mesh):
            if not mesh_name:
                continue
            path = os.path.join(mesh_dir, mesh_name)
            if os.path.exists(path):
                return path, 0.0
    child = next((s for s in model.specs if s.parent == link_index), None)
    length = float(np.linalg.norm(child.offset_mm)) if child is not None else 0.0
    return None, max(length, MIN_PART_LENGTH_MM)


def build_arm_geometry(
    model: RobotModel,
    mesh_dir: Optional[str] = None,
    points_per_part: int = 2048,
    radius_mm: float = DEFAULT_PART_RADIUS_MM,
) -> ArmGeometry:
    """The stacked per-part clouds, on the model's device."""
    link_idx = tuple(model.link_index(nm) for nm in PARTS_TO_CHECK)

    clouds = []
    for k, name in enumerate(PARTS_TO_CHECK):
        li = link_idx[k]
        stl_path, capsule_len = resolve_part_source(model, li, mesh_dir)
        if stl_path is not None:
            pts = sample_surface_points(load_stl(stl_path), points_per_part, seed=li)
        else:
            pts = _capsule_points(capsule_len, radius_mm, points_per_part, seed=li)
        if pts.shape[0] < points_per_part:
            reps = -(-points_per_part // pts.shape[0])
            pts = np.tile(pts, (reps, 1))[:points_per_part]
        clouds.append(pts[:points_per_part])

    return ArmGeometry(
        part_points=torch.as_tensor(np.stack(clouds)).to(model.device),
        part_link_idx=link_idx,
        part_names=PARTS_TO_CHECK,
    )

"""Triangle-exact final-plan collision validation, host-side (port of
`mamri_tpu/planning/exact.py`).

The fast checker is conservatively voxelized (dilated occupancy, finite
surface sampling): it never calls a colliding configuration free but can
over-reject a tight, legal trajectory. For a FINAL plan, each part hull is
densified to a sub-voxel point grid (the STL triangles when a mesh
directory holds them, dense capsule clouds otherwise), placed by FK at
every path sample and tested against the UNDILATED body voxels. Host numpy
by design (it runs once per accepted plan); the FK of the whole path is one
batched torch FK on the model's device, fetched once.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from mamri_tpu_torch.core.robot import RobotModel, fk_all_links
from mamri_tpu_torch.planning.geometry import (
    DEFAULT_PART_RADIUS_MM,
    PARTS_TO_CHECK,
    _capsule_points,
    resolve_part_source,
)
from mamri_tpu_torch.utils.stl import load_stl


class ExactParts(NamedTuple):
    clouds: List[np.ndarray]  # per part: (Ni, 3) local-frame dense points
    link_idx: Tuple[int, ...]
    names: Tuple[str, ...]
    mode: str  # "stl-dense" | "capsule-dense"
    max_edge_mm: float


def densify_triangles(tris: np.ndarray, max_edge: float) -> np.ndarray:
    """Barycentric point grid with spacing <= max_edge over every triangle,
    vertices and edges included, so thin features are covered."""
    out = []
    for tri in np.asarray(tris, dtype=np.float64):
        a, b, c = tri
        n = int(
            np.ceil(
                max(
                    np.linalg.norm(b - a),
                    np.linalg.norm(c - a),
                    np.linalg.norm(c - b),
                )
                / max_edge
            )
        )
        n = max(n, 1)
        for i in range(n + 1):
            for j in range(n + 1 - i):
                u, v = i / n, j / n
                out.append(a + u * (b - a) + v * (c - a))
    return np.asarray(out, dtype=np.float32)


def build_exact_parts(
    model: RobotModel,
    mesh_dir: Optional[str] = None,
    max_edge_mm: float = 1.0,
    capsule_points: int = 20000,
) -> ExactParts:
    """Dense per-part clouds for the exact validator: the STL hulls (the
    collision mesh, the visual mesh as the fallback, as the fast geometry
    resolves them) with `mesh_dir`, else capsules ~10x denser than the fast
    checker's."""
    clouds: List[np.ndarray] = []
    mode = "capsule-dense"
    link_idx = tuple(model.link_index(nm) for nm in PARTS_TO_CHECK)
    for li in link_idx:
        stl_path, capsule_len = resolve_part_source(model, li, mesh_dir)
        if stl_path is not None:
            pts = densify_triangles(load_stl(stl_path), max_edge_mm)
            mode = "stl-dense"
        else:
            pts = _capsule_points(capsule_len, DEFAULT_PART_RADIUS_MM, capsule_points, seed=li)
        clouds.append(np.asarray(pts, dtype=np.float32))
    return ExactParts(clouds=clouds, link_idx=link_idx, names=PARTS_TO_CHECK, mode=mode, max_edge_mm=max_edge_mm)


def validate_path_exact(
    model: RobotModel,
    parts: ExactParts,
    body_mask: np.ndarray,
    spacing,
    origin_lps,
    base_tf,
    path,
) -> dict:
    """Exact per-sample collision profile of a path against the UNDILATED
    body voxels: {"collision_free": bool, "colliding_samples": [int, ...],
    "per_sample": (P,) bool array, "checked_samples": P, "mode": ...}."""
    mask = np.asarray(body_mask, dtype=bool)
    spacing = np.asarray(spacing, dtype=np.float64)
    origin = np.asarray(origin_lps, dtype=np.float64)
    shape = np.asarray(mask.shape)
    path = np.asarray(path, dtype=np.float32).reshape(-1, model.num_joints)
    base = torch.as_tensor(np.asarray(base_tf, dtype=np.float32)).to(model.device)

    # FK of every sample in one batched call, then host point tests
    tfs_all = fk_all_links(model, torch.as_tensor(path).to(model.device), base).cpu().numpy()

    flip = np.array([-1.0, -1.0, 1.0])
    hits = np.zeros(len(path), dtype=bool)
    for cloud, li in zip(parts.clouds, parts.link_idx):
        cl64 = cloud.astype(np.float64)
        for p in range(len(path)):
            if hits[p]:
                continue  # already colliding; skip remaining parts' work
            tf = tfs_all[p, li].astype(np.float64)
            world_ras = cl64 @ tf[:3, :3].T + tf[:3, 3]
            lps = world_ras * flip
            vox = np.round((lps - origin) / spacing).astype(np.int64)
            ok = np.all((vox >= 0) & (vox < shape), axis=1)
            if ok.any() and mask[vox[ok, 0], vox[ok, 1], vox[ok, 2]].any():
                hits[p] = True
    return {
        "collision_free": bool(not hits.any()),
        "colliding_samples": np.nonzero(hits)[0].tolist(),
        "per_sample": hits,
        "checked_samples": int(len(path)),
        "mode": parts.mode,
    }

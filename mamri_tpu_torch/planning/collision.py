"""Voxel-grid collision checking between the robot and the patient body
(port of `mamri_tpu/planning/collision.py`).

The body segmentation is a voxel grid: a configuration check places the
parts' point clouds by FK and samples the occupancy grid, and a whole path
is one batched lookup. Conservative in the safety-critical direction: any
sampled robot point inside a (dilated) body voxel flags a collision.
`config_penetration` samples a chamfer inside-depth field instead, a
penetration cost whose gradient pushes the trajectory IK out of contact.

Everything runs on the grid's device with the reference's op order:
`torch.roll` wraps at the border as `jnp.roll` does (the chamfer step), the
dilation masks the wrap with index compares, and the clip in `sample_grid`
is `minimum(hi, maximum(lo, x))`, as `jnp.clip` is, so its derivative at an
exact boundary splits ties as JAX's does.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from mamri_tpu_torch.core import transforms
from mamri_tpu_torch.core.robot import RobotModel, fk_all_links


class CollisionWorld(NamedTuple):
    occupancy: torch.Tensor  # (nx, ny, nz) f32 in {0, 1}, DILATED by `dilation_vox` 26-neighbour shells
    inside_depth: torch.Tensor  # (nx, ny, nz) f32 mm, 0 outside the undilated body
    spacing: torch.Tensor  # (3,)
    origin: torch.Tensor  # (3,) LPS
    dilation_vox: int = 2


def _axis_index(shape, axis, device):
    """Index along `axis`, shaped to broadcast against a grid of `shape`."""
    view = [1, 1, 1]
    view[axis] = shape[axis]
    return torch.arange(shape[axis], device=device).view(view)


def build_collision_world(body_mask, spacing, origin, depth_iters: int = 6, dilation_vox: int = 2) -> CollisionWorld:
    """Occupancy (the mask dilated by `dilation_vox` 26-neighbour shells, a
    body clipped at the border not wrapping to the opposite plane) and the
    chamfer inside-depth of the undilated body (`depth_iters` 6-neighbour
    min-plus steps, capped at `depth_iters` x the largest spacing), on the
    mask's device."""
    occ_raw = torch.as_tensor(body_mask).to(torch.bool)
    dev = occ_raw.device
    occ_b = occ_raw
    for _ in range(int(dilation_vox)):
        grown = occ_b
        for axis in (0, 1, 2):
            n = grown.shape[axis]
            idx = _axis_index(grown.shape, axis, dev)
            r1 = torch.roll(grown, 1, dims=axis) & (idx >= 1)
            r2 = torch.roll(grown, -1, dims=axis) & (idx < n - 1)
            grown = grown | (r1 | r2)
        occ_b = grown
    occ = occ_b.to(torch.float32)
    spacing = torch.as_tensor(spacing, dtype=torch.float32).to(dev)
    origin = torch.as_tensor(origin, dtype=torch.float32).to(dev)

    inside = occ_raw.to(torch.float32)
    depth = torch.where(inside > 0, 1e6, 0.0)
    for _ in range(int(depth_iters)):
        best = depth
        for axis in (0, 1, 2):
            for shift in (1, -1):
                # the roll wraps: the border reads as outside (0 + step), which is safe
                best = torch.minimum(best, torch.roll(depth, shift, dims=axis) + spacing[axis])
        depth = torch.where(inside > 0, best, 0.0)
    depth = torch.minimum(depth, float(depth_iters) * spacing.max())
    return CollisionWorld(occupancy=occ, inside_depth=depth, spacing=spacing, origin=origin,
                          dilation_vox=int(dilation_vox))


def _ras_to_index(points_ras, spacing, origin):
    lps = transforms.flip_xy(points_ras)
    return (lps - origin) / spacing


def sample_grid(grid, idx):
    """Trilinear sampling of a 3-D grid at (N, 3) fractional indices;
    out-of-bounds samples read as 0 (no body there)."""
    nx, ny, nz = grid.shape
    shape = torch.tensor([nx, ny, nz], dtype=idx.dtype, device=idx.device)
    hi = shape - 1.0
    in_bounds = ((idx >= 0.0) & (idx <= hi)).all(dim=-1)
    idxc = torch.minimum(hi, torch.maximum(torch.zeros_like(hi), idx))
    i0 = torch.floor(idxc).to(torch.int64)
    i1 = torch.minimum(i0 + 1, torch.tensor([nx - 1, ny - 1, nz - 1], device=idx.device))
    f = idxc - i0.to(idx.dtype)

    def g(ii, jj, kk):
        return grid[ii, jj, kk]

    c000 = g(i0[:, 0], i0[:, 1], i0[:, 2])
    c100 = g(i1[:, 0], i0[:, 1], i0[:, 2])
    c010 = g(i0[:, 0], i1[:, 1], i0[:, 2])
    c110 = g(i1[:, 0], i1[:, 1], i0[:, 2])
    c001 = g(i0[:, 0], i0[:, 1], i1[:, 2])
    c101 = g(i1[:, 0], i0[:, 1], i1[:, 2])
    c011 = g(i0[:, 0], i1[:, 1], i1[:, 2])
    c111 = g(i1[:, 0], i1[:, 1], i1[:, 2])
    fx, fy, fz = f[:, 0], f[:, 1], f[:, 2]
    c00 = c000 * (1 - fx) + c100 * fx
    c10 = c010 * (1 - fx) + c110 * fx
    c01 = c001 * (1 - fx) + c101 * fx
    c11 = c011 * (1 - fx) + c111 * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return (c0 * (1 - fz) + c1 * fz) * in_bounds


def _transformed_part_points(model: RobotModel, part_points, part_link_idx: Sequence[int], angles, base_tf):
    """FK-place all part point clouds: (n_parts, P, 3) world RAS points."""
    tfs = fk_all_links(model, angles, base_tf)
    return transforms.apply(tfs[list(part_link_idx)], part_points)


def config_collides(model: RobotModel, part_points, part_link_idx, angles, base_tf, world: CollisionWorld,
                    occ_threshold: float = 0.5):
    """() bool: does any sampled point of Joint1..Joint6 lie in the occupancy
    grid at this configuration."""
    pts = _transformed_part_points(model, part_points, part_link_idx, angles, base_tf)
    idx = _ras_to_index(pts.reshape(-1, 3), world.spacing, world.origin)
    return (sample_grid(world.occupancy, idx) > occ_threshold).any()


def config_penetration(model: RobotModel, part_points, part_link_idx, angles, base_tf, world: CollisionWorld):
    """() smooth total penetration (mm) of the arm into the body, per
    point of a part: the differentiable collision cost of trajectory IK."""
    pts = _transformed_part_points(model, part_points, part_link_idx, angles, base_tf)
    idx = _ras_to_index(pts.reshape(-1, 3), world.spacing, world.origin)
    return sample_grid(world.inside_depth, idx).sum() / pts.shape[1]

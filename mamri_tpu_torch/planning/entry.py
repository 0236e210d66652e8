"""Skin entry-point search on the body surface (port of
`mamri_tpu/planning/entry.py`).

A masked reduction over the segmentation's voxel grid, on its device:

  surface voxels  = body & ~erode6(body)
  normals         = -grad(box-smoothed occupancy), flipped LPS->RAS
  suitability     = |n_x| - 2*|n_y| > -0.5      (prefer lateral, not A/P)
  candidate mask  = surface & suitable & (dist to target <= 80 mm)
  entry point     = argmin distance among candidates (the first of equals)

Every roll wraps at the border as `jnp.roll` does, the smoothing sums in
the reference's order, and every division is by a tensor on the grid's
device (a Python scalar divisor becomes a multiplication by its reciprocal
on the card), so the field, the distances and with them the chosen voxel
are the reference's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

SEARCH_RADIUS_MM = 80.0
SCORE_THRESHOLD = -0.5


class EntryPointResult(NamedTuple):
    point_ras: torch.Tensor  # (3,)
    normal_ras: torch.Tensor  # (3,) outward surface normal at the entry point
    distance_mm: torch.Tensor  # () distance to target
    found: torch.Tensor  # () bool


def _erode6(mask):
    m = mask
    for axis in (0, 1, 2):
        for shift in (1, -1):
            m = m & torch.roll(mask, shift, dims=axis)
    return m


def _box_smooth(x, iters: int = 2):
    seven = torch.tensor(7.0, device=x.device)
    for _ in range(iters):
        acc = x
        for axis in (0, 1, 2):
            acc = acc + torch.roll(x, 1, dims=axis) + torch.roll(x, -1, dims=axis)
        x = acc / seven
    return x


def find_entry_point(
    body_mask,
    spacing,
    origin,
    target_ras,
    search_radius_mm: float = SEARCH_RADIUS_MM,
    score_threshold: float = SCORE_THRESHOLD,
) -> EntryPointResult:
    """The entry point nearest `target_ras` on the suitable body surface
    within `search_radius_mm`, as tensors on the mask's device."""
    mask = torch.as_tensor(body_mask).to(torch.bool)
    dev = mask.device
    spacing = torch.as_tensor(spacing, dtype=torch.float32).to(dev)
    origin = torch.as_tensor(origin, dtype=torch.float32).to(dev)
    target_ras = torch.as_tensor(target_ras, dtype=torch.float32).to(dev)
    nx, ny, nz = mask.shape

    smooth = _box_smooth(mask.to(torch.float32))
    # central-difference gradient (points toward increasing occupancy = inward)
    gx = (torch.roll(smooth, -1, dims=0) - torch.roll(smooth, 1, dims=0)) / (2.0 * spacing[0])
    gy = (torch.roll(smooth, -1, dims=1) - torch.roll(smooth, 1, dims=1)) / (2.0 * spacing[1])
    gz = (torch.roll(smooth, -1, dims=2) - torch.roll(smooth, 1, dims=2)) / (2.0 * spacing[2])
    norm = torch.sqrt(gx * gx + gy * gy + gz * gz)
    inv = 1.0 / torch.clamp(norm, min=1e-9)
    # outward normal in LPS = -gradient; RAS flips x and y
    n_ras_x = gx * inv  # -(-g): the LPS x flip and the outward flip cancel
    n_ras_y = gy * inv
    n_ras_z = -gz * inv

    surface = mask & ~_erode6(mask)

    # voxel positions in RAS
    ii = torch.arange(nx, dtype=torch.float32, device=dev)[:, None, None]
    jj = torch.arange(ny, dtype=torch.float32, device=dev)[None, :, None]
    kk = torch.arange(nz, dtype=torch.float32, device=dev)[None, None, :]
    px = -(origin[0] + spacing[0] * ii)
    py = -(origin[1] + spacing[1] * jj)
    pz = origin[2] + spacing[2] * kk
    dx = px - target_ras[0]
    dy = py - target_ras[1]
    dz = pz - target_ras[2]
    dist = torch.sqrt(dx * dx + dy * dy + dz * dz)

    suitability = torch.abs(n_ras_x) - 2.0 * torch.abs(n_ras_y)
    candidate = surface & (suitability > score_threshold) & (dist <= search_radius_mm)

    masked_dist = torch.where(candidate, dist, torch.inf).reshape(-1)
    flat_idx = torch.argmin(masked_dist)
    best = masked_dist[flat_idx]
    i = flat_idx // (ny * nz)
    j = (flat_idx // nz) % ny
    k = flat_idx % nz
    point = torch.stack([
        -(origin[0] + spacing[0] * i.to(torch.float32)),
        -(origin[1] + spacing[1] * j.to(torch.float32)),
        origin[2] + spacing[2] * k.to(torch.float32),
    ])
    normal = torch.stack([n_ras_x[i, j, k], n_ras_y[i, j, k], n_ras_z[i, j, k]])
    return EntryPointResult(point_ras=point, normal_ras=normal, distance_mm=best, found=torch.isfinite(best))

"""Homogeneous-transform algebra over (..., 4, 4) float32 tensors.

Port of `mamri_tpu/core/transforms.py`. Matrices are assembled with
`torch.stack`/`torch.cat` (no in-place writes), so every function here
composes with `torch.func.vmap` and `torch.func.jacfwd`, which the IK uses.
Products run in full float32: the package turns TF32 off on import.

Axis conventions (the reference's `_get_rotation_transform`):
  IS -> rotation about +Z by +theta
  PA -> rotation about +Y by -theta
  LR -> rotation about +X by +theta
"""

from __future__ import annotations

import functools

import torch

AXIS_NONE = 0
AXIS_IS = 1
AXIS_PA = 2
AXIS_LR = 3

AXIS_CODE_BY_NAME = {None: AXIS_NONE, "IS": AXIS_IS, "PA": AXIS_PA, "LR": AXIS_LR}


@functools.lru_cache(maxsize=None)
def _last_row(dtype, device):
    # made once per (dtype, device): the IK builds thousands of matrices per
    # call, and a row built from a Python list each time is a host-to-device
    # copy each time
    return torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=dtype, device=device)


def homogeneous(top):
    """(..., 3, 4) [R | t] -> (..., 4, 4) with the row [0, 0, 0, 1] appended."""
    row = _last_row(top.dtype, top.device).expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, row], dim=-2)


def flip_xy(points):
    """(..., 3) -> (-x, -y, z): RotZ(180) on local coordinates, LPS <-> RAS."""
    return torch.cat([-points[..., :2], points[..., 2:]], dim=-1)


def _embed_rot(r):
    """(..., 3, 3) rotation -> (..., 4, 4) homogeneous matrix."""
    return homogeneous(torch.cat([r, r.new_zeros(r.shape[:-2] + (3, 1))], dim=-1))


def _rot(rows):
    return _embed_rot(torch.stack([torch.stack(row, dim=-1) for row in rows], dim=-2))


def _tensor(v):
    return v if isinstance(v, torch.Tensor) else torch.tensor(v, dtype=torch.float32)


def _cs(theta):
    theta = _tensor(theta)
    c, s = torch.cos(theta), torch.sin(theta)
    return c, s, torch.zeros_like(c), torch.ones_like(c)


def rot_x(theta):
    c, s, z, o = _cs(theta)
    return _rot([[o, z, z], [z, c, -s], [z, s, c]])


def rot_y(theta):
    c, s, z, o = _cs(theta)
    return _rot([[c, z, s], [z, o, z], [-s, z, c]])


def rot_z(theta):
    c, s, z, o = _cs(theta)
    return _rot([[c, -s, z], [s, c, z], [z, z, o]])


def translate(v):
    """(..., 3) translation -> (..., 4, 4) homogeneous matrix."""
    v = _tensor(v)
    batch = v.shape[:-1]
    eye3 = torch.eye(3, dtype=v.dtype, device=v.device).expand(batch + (3, 3))
    return homogeneous(torch.cat([eye3, v.unsqueeze(-1)], dim=-1))


def articulation_matrix(axis_code: int, theta):
    """Joint articulation transform for a static axis code: IS -> RotZ(+t),
    PA -> RotY(-t), LR -> RotX(+t); fixed links get the identity."""
    if axis_code == AXIS_IS:
        return rot_z(theta)
    if axis_code == AXIS_PA:
        return rot_y(-theta)
    if axis_code == AXIS_LR:
        return rot_x(theta)
    theta = _tensor(theta)
    return torch.eye(4, dtype=theta.dtype, device=theta.device).expand(theta.shape + (4, 4))


def apply(matrix, points):
    """Apply a (..., 4, 4) transform to (..., N, 3) points."""
    rotated = torch.einsum("...ij,...nj->...ni", matrix[..., :3, :3], points)
    return rotated + matrix[..., None, :3, 3]

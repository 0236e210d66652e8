"""Rigid (Horn/Kabsch) point-set alignment.

Port of `mamri_tpu/registration/kabsch.py`: Horn's quaternion method, the
top eigenvector of the symmetric 4x4 profile matrix (`torch.linalg.eigh`),
not an SVD of the cross-covariance -- marker triplets are coplanar, which
makes the covariance rank-deficient, and the symmetric eigenproblem stays
well-conditioned and never yields a reflection. q and -q give the same
rotation, so the eigenvector's sign does not matter.
"""

from __future__ import annotations

import torch

from mamri_tpu_torch.core.transforms import homogeneous


def kabsch_rigid_transform(source, target):
    """(..., 4, 4) rigid T with T @ source ~= target for (..., N, 3) points
    (equal weights, as the estimate path uses it)."""
    w = torch.ones(source.shape[:-1], dtype=source.dtype, device=source.device)
    wn = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-12)

    s_mean = (source * wn[..., None]).sum(-2, keepdim=True)
    t_mean = (target * wn[..., None]).sum(-2, keepdim=True)
    s_c = source - s_mean
    t_c = target - t_mean
    h = torch.einsum("...ni,...nj->...ij", s_c * wn[..., None], t_c)

    sxx, sxy, sxz = h[..., 0, 0], h[..., 0, 1], h[..., 0, 2]
    syx, syy, syz = h[..., 1, 0], h[..., 1, 1], h[..., 1, 2]
    szx, szy, szz = h[..., 2, 0], h[..., 2, 1], h[..., 2, 2]
    n = torch.stack(
        [
            torch.stack([sxx + syy + szz, syz - szy, szx - sxz, sxy - syx], dim=-1),
            torch.stack([syz - szy, sxx - syy - szz, sxy + syx, szx + sxz], dim=-1),
            torch.stack([szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy], dim=-1),
            torch.stack([sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz], dim=-1),
        ],
        dim=-2,
    )
    _, eigvecs = torch.linalg.eigh(n)  # ascending eigenvalues
    q = eigvecs[..., :, -1]
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = torch.stack(
        [
            torch.stack([w * w + x * x - y * y - z * z, 2 * (x * y - w * z), 2 * (x * z + w * y)], dim=-1),
            torch.stack([2 * (x * y + w * z), w * w - x * x + y * y - z * z, 2 * (y * z - w * x)], dim=-1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), w * w - x * x - y * y + z * z], dim=-1),
        ],
        dim=-2,
    )
    t = t_mean[..., 0, :] - torch.einsum("...ij,...j->...i", r, s_mean[..., 0, :])
    return homogeneous(torch.cat([r, t[..., None]], dim=-1))

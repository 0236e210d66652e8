"""Rigid (Horn/Kabsch) point-set alignment.

Port of `mamri_tpu/registration/kabsch.py`: Horn's quaternion method, the
top eigenvector of the symmetric 4x4 profile matrix, not an SVD of the
cross-covariance -- marker triplets are coplanar, which makes the
covariance rank-deficient, and the symmetric eigenproblem stays
well-conditioned and never yields a reflection. q and -q give the same
rotation, so the eigenvector's sign does not matter.

On a card the whole fit is one launch of `csrc/kabsch.cu` (`mamri_kabsch`,
one thread per problem), with the eigenvector from a fixed number of cyclic
Jacobi sweeps, not eigh: `torch.linalg.eigh` checks its solver's status on
the host, which waits for the card, and the pose pipeline must queue its
work without waiting (`MamriEngine.estimate_pose_async`). Its plain twin,
`kabsch_rigid_transform_plain`, is the same fit in tensor ops through
`_top_eigenvector`. There is no fallback: a CUDA tensor reaches the kernel
or an error. A launch is counted in `_build.LAUNCHES["kabsch"]` and, under a
current tracer, adds one to the request's counter `registration.kabsch_fused`.

On the CPU nothing waits, and eigh is LAPACK's, as the reference's is on
the CPU: an unconverged IK (10 iterations) turns the last-bit differences
between two correct eigenvectors into ~1e-4 rad, so the CPU keeps the
reference's solver.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from mamri_tpu_torch import _build
from mamri_tpu_torch.core.transforms import homogeneous
from mamri_tpu_torch.utils.trace import current_count

# the six (p, q) planes of a 4x4 in three rounds of two disjoint rotations;
# each round is one product J^T A J
_JACOBI_ROUNDS = ((0, 1, 2, 3), (0, 2, 1, 3), (0, 3, 1, 2))
# quadratic convergence: 4x4 f32 matrices reach rounding in 4-5 sweeps
_JACOBI_SWEEPS = 6

@functools.lru_cache(maxsize=None)
def _round_tables(dtype, device):
    """Per round, (2, 4, 4) masks of the cosine entries (p, p), (q, q) and of
    the sine entries (+1 at (p, q), -1 at (q, p)) of its two rotations."""
    cos_m = torch.zeros((len(_JACOBI_ROUNDS), 2, 4, 4), dtype=dtype)
    sin_m = torch.zeros_like(cos_m)
    for r, (p1, q1, p2, q2) in enumerate(_JACOBI_ROUNDS):
        for k, (p, q) in enumerate(((p1, q1), (p2, q2))):
            cos_m[r, k, p, p] = cos_m[r, k, q, q] = 1.0
            sin_m[r, k, p, q], sin_m[r, k, q, p] = 1.0, -1.0
    return cos_m.to(device), sin_m.to(device)


def _top_eigenvector(n):
    """Eigenvector of the largest eigenvalue of each symmetric (..., 4, 4)
    matrix: cyclic Jacobi rotations (Golub and Van Loan's symmetric Schur
    pair per plane), then the column of the accumulated rotations whose
    diagonal entry is largest."""
    cos_m, sin_m = _round_tables(n.dtype, n.device)
    eye = torch.eye(4, dtype=n.dtype, device=n.device)
    a = n
    v = eye.expand(n.shape)
    for _ in range(_JACOBI_SWEEPS):
        for r, (p1, q1, p2, q2) in enumerate(_JACOBI_ROUNDS):
            app = torch.stack([a[..., p1, p1], a[..., p2, p2]], dim=-1)
            aqq = torch.stack([a[..., q1, q1], a[..., q2, q2]], dim=-1)
            apq = torch.stack([a[..., p1, q1], a[..., p2, q2]], dim=-1)
            zero = apq == 0
            tau = (aqq - app) / (2 * torch.where(zero, 1.0, apq))
            t = torch.where(tau >= 0, 1.0, -1.0) / (tau.abs() + torch.hypot(torch.ones_like(tau), tau))
            t = torch.where(zero, 0.0, t)
            c = torch.rsqrt(1 + t * t)
            rot = (eye + torch.einsum("...k,kij->...ij", c - 1, cos_m[r])
                   + torch.einsum("...k,kij->...ij", t * c, sin_m[r]))
            a = rot.transpose(-1, -2) @ a @ rot
            v = v @ rot
    top = torch.argmax(torch.diagonal(a, dim1=-2, dim2=-1), dim=-1)
    return torch.gather(v, -1, top[..., None, None].expand(n.shape[:-1] + (1,)))[..., 0]


def _fit(source, target, top_eigenvector):
    """(..., 4, 4) rigid T with T @ source ~= target for (..., N, 3) points
    (equal weights, as the estimate path uses it), in tensor ops, with the
    profile matrix's top eigenvector from `top_eigenvector`."""
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
    q = top_eigenvector(n)
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


def _eigh_top(n):
    return torch.linalg.eigh(n)[1][..., -1]


def kabsch_rigid_transform_plain(source, target):
    """Plain twin of the kernel: the fit in tensor ops with the eigenvector
    from `_top_eigenvector`'s Jacobi sweeps (what a card ran before the
    kernel, on any device)."""
    return _fit(source, target, _top_eigenvector)


def _check_inputs(source, target) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors; a
    shape that is not (..., N, 3) on both sides with leading dimensions that
    broadcast, a mix of devices, or on a card anything but contiguous
    float32, is an error."""
    if source.dim() < 2 or target.dim() < 2 or source.shape[-1] != 3 or target.shape[-2:] != source.shape[-2:]:
        raise ValueError(f"kabsch: expected (..., N, 3) source and target, got {tuple(source.shape)} and "
                         f"{tuple(target.shape)}")
    _leading_shape(source, target)  # raises ValueError where they do not broadcast
    on_cuda = _build.on_cuda(source, target)
    if on_cuda:
        _build.check(source, "kabsch source", torch.float32)
        _build.check(target, "kabsch target", torch.float32)
    return on_cuda


def _leading_shape(source, target):
    # numpy's, not torch.broadcast_shapes: that imports torch.fx's symbolic
    # shapes (and sympy) on its first call, seconds of a process's first pose
    return np.broadcast_shapes(tuple(source.shape[:-2]), tuple(target.shape[:-2]))


def _launch(source, target):
    lead = _leading_shape(source, target)
    n = source.shape[-2]
    source, target = (t if t.shape[:-2] == lead else t.expand(lead + (n, 3)).contiguous() for t in (source, target))
    out = torch.empty(lead + (4, 4), dtype=torch.float32, device=source.device)
    _build.launch("kabsch", "mamri_kabsch", source.device, source.data_ptr(), target.data_ptr(), out.numel() // 16,
                  n, out.data_ptr())
    current_count("registration.kabsch_fused")
    return out


def kabsch_rigid_transform(source, target):
    """(..., 4, 4) rigid T with T @ source ~= target for (..., N, 3) points
    (equal weights, as the estimate path uses it; leading dimensions
    broadcast): one kernel launch on a card (contiguous float32), the fit in
    tensor ops with LAPACK's eigh on the CPU."""
    if _check_inputs(source, target):
        return _launch(source, target)
    return _fit(source, target, _eigh_top)

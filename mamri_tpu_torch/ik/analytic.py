"""Closed-form IK seeds for the MAMRI 6R chain (port of `mamri_tpu/ik/analytic.py`).

The detected Joint6 triplet fixes the Joint6 frame (Kabsch); the wrist
centre is a fixed offset along its z axis; Joint1 is the wrist centre's
azimuth (2 branches); Joint2/3 a planar 2R problem (elbow up/down); Joint4/5/6
a ZYZ decomposition of the residual rotation (2 wrist branches): 8 seeds
that the LM only polishes. Degenerate poses give finite garbage seeds that
the cost scoring ignores.
"""

from __future__ import annotations

import math

import torch

from mamri_tpu_torch.core import transforms
from mamri_tpu_torch.core.robot import RobotModel
from mamri_tpu_torch.ik.fused_lm import joint6_local
from mamri_tpu_torch.registration.kabsch import kabsch_rigid_transform

_IS_PA_PATTERN = (1, 2, 2, 1, 2, 1)  # AXIS_IS / AXIS_PA codes of Joint1..Joint6


def chain_is_analytic(model: RobotModel) -> bool:
    """True iff the chain is IS-PA-PA-IS-PA-IS with pure z offsets."""
    arts = model.articulated_links
    if len(arts) != 6:
        return False
    if tuple(model.specs[i].axis_code for i in arts) != _IS_PA_PATTERN:
        return False
    return all(abs(model.specs[i].offset_mm[0]) <= 1e-6 and abs(model.specs[i].offset_mm[1]) <= 1e-6 for i in arts)


def joint6_frame_from_markers(model: RobotModel, joint6_targets, apply_correction):
    """World pose of the Joint6 frame implied by its detected triplet."""
    return kabsch_rigid_transform(joint6_local(model, apply_correction), joint6_targets)


def _rigid_inverse(tf):
    rt = tf[:3, :3].T
    return transforms.homogeneous(torch.cat([rt, -(rt @ tf[:3, 3])[:, None]], dim=1))


def _rotz(a):
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, z]), torch.stack([s, c, z]), torch.stack([z, z, o])])


def _roty(a):
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, z, s]), torch.stack([z, o, z]), torch.stack([-s, z, c])])


def analytic_ik_seeds(model: RobotModel, joint6_frame_world, base_tf):
    """(8, 6) candidates reaching the Joint6 world frame:
    {2 shoulder azimuths} x {elbow up/down} x {2 wrist flips}."""
    dz = [model.fixed_offsets[i][2, 3] for i in model.articulated_links]
    shoulder_z = dz[0] + dz[1]
    l_upper = dz[2] + dz[3]
    l_fore = dz[4]
    d6 = dz[5]

    m = _rigid_inverse(base_tf) @ joint6_frame_world
    p6 = m[:3, 3]
    r6 = m[:3, :3]
    p5 = p6 - d6 * r6[:, 2]
    v = p5 - torch.stack([torch.zeros_like(shoulder_z), torch.zeros_like(shoulder_z), shoulder_z])
    a1_base = torch.atan2(v[1], v[0])

    seeds = []
    for a1_flip in (0.0, math.pi):
        a1 = torch.atan2(torch.sin(a1_base + a1_flip), torch.cos(a1_base + a1_flip))
        r = torch.cos(a1) * v[0] + torch.sin(a1) * v[1]
        h = v[2]
        c2 = torch.clamp((r * r + h * h - l_upper**2 - l_fore**2) / (2.0 * l_upper * l_fore), -1.0, 1.0)
        for elbow in (1.0, -1.0):
            t2 = elbow * torch.arccos(c2)
            t1 = torch.atan2(r, h) - torch.atan2(l_fore * torch.sin(t2), l_upper + l_fore * torch.cos(t2))
            a2 = -t1
            a3 = -t2
            rw = (_rotz(a1) @ _roty(-(a2 + a3))).T @ r6
            phi0 = torch.arccos(torch.clamp(rw[2, 2], -1.0, 1.0))
            for wrist in (1.0, -1.0):
                phi = wrist * phi0
                safe = torch.abs(torch.sin(phi)) > 1e-6
                a4 = torch.where(safe, torch.atan2(rw[1, 2] * wrist, rw[0, 2] * wrist), 0.0)
                a6 = torch.where(
                    safe,
                    torch.atan2(rw[2, 1] * wrist, -rw[2, 0] * wrist),
                    torch.atan2(-rw[0, 1], rw[0, 0]),
                )
                seeds.append(torch.stack([a1, a2, a3, a4, -phi, a6]))
    return torch.stack(seeds)

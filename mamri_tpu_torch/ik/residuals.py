"""Full-chain pose IK and the trajectory residual (port of
`mamri_tpu/ik/residuals.py`).

`full_chain_residual` is the reference's `_full_chain_ik_error_function`:
9 Joint6 marker errors (optionally with the 180-degree Z correction of the
Joint6 local frame) and a Joint4 block weighted 0.05 when Joint4 was found,
0 otherwise. `solve_full_chain_ik` polishes {current pose, zero pose}, the 8
closed-form branches and optional random restarts with batched LM, then
scores by (cost, Joint2 evidence, distance to the current pose) and picks
the Joint6 winding nearest the current pose. `trajectory_pose_residual`
is the needle tip position + direction residual of the trajectory goal IK.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch.func import vmap

from mamri_tpu_torch.core import transforms
from mamri_tpu_torch.core.robot import RobotModel, fk_all_links
from mamri_tpu_torch.ik.analytic import analytic_ik_seeds, chain_is_analytic, joint6_frame_from_markers
from mamri_tpu_torch.ik.lm import least_squares_lm

JOINT4_WEIGHT = 0.05
ORIENTATION_WEIGHT = 50.0


class FullChainIKResult(NamedTuple):
    angles: torch.Tensor  # (J,)
    rmse: torch.Tensor  # () over the 9 Joint6 errors
    cost: torch.Tensor  # () best 0.5*|r|^2
    best_guess: torch.Tensor  # () index of the winning guess
    grad_norm: torch.Tensor


def full_chain_residual(
    model: RobotModel,
    angles,
    base_tf,
    joint6_targets,
    apply_correction,
    joint4_targets=None,
    joint4_found=None,
    joint4_weight: float = JOINT4_WEIGHT,
):
    """(18,) marker-position residual. `apply_correction` and `joint4_found`
    are () bool tensors; the Joint4 block is zero-weighted when not found."""
    idx6 = model.link_index("Joint6")
    idx4 = model.link_index("Joint4")
    tfs = fk_all_links(model, angles, base_tf)
    local6 = model.marker_local[idx6]
    local6 = torch.where(apply_correction, transforms.flip_xy(local6), local6)
    e6 = (transforms.apply(tfs[idx6], local6) - joint6_targets).reshape(-1)

    if joint4_targets is None:
        joint4_targets = torch.zeros((3, 3), dtype=angles.dtype, device=angles.device)
    found4 = torch.zeros((), dtype=torch.bool, device=angles.device) if joint4_found is None else joint4_found
    w4 = torch.where(found4, joint4_weight, 0.0)
    pred4 = transforms.apply(tfs[idx4], model.marker_local[idx4])
    e4 = (w4 * (pred4 - joint4_targets)).reshape(-1)
    return torch.cat([e6, e4])


def trajectory_pose_residual(model: RobotModel, angles, base_tf, target_tf, orientation_weight: float = ORIENTATION_WEIGHT):
    """(6,) needle position + orientation residual for the trajectory IK."""
    needle = fk_all_links(model, angles, base_tf)[model.link_index("Needle")]
    pos_err = needle[:3, 3] - target_tf[:3, 3]
    actual_needle_dir = -needle[:3, 0]
    orient_err = orientation_weight * (target_tf[:3, 0] - actual_needle_dir)
    return torch.cat([pos_err, orient_err])


def random_restart_guesses(model: RobotModel, count: int, seed: int):
    """(count, J) guesses uniform in 0.8 x the joint limits, drawn from a CPU
    `torch.Generator` seeded with `seed`: the same guesses on every device."""
    lower, upper = model.limits_rad[:, 0], model.limits_rad[:, 1]
    gen = torch.Generator().manual_seed(seed)
    u = torch.rand((count, model.num_joints), generator=gen).to(model.device)
    return lower * 0.8 + u * (upper * 0.8 - lower * 0.8)


def solve_full_chain_ik(
    model: RobotModel,
    joint6_targets,
    base_tf,
    current_angles=None,
    apply_correction=None,
    joint4_targets=None,
    joint4_found=None,
    num_iters: int = 80,
    num_random_restarts: int = 8,
    restart_seed: int = 0,
    joint2_targets=None,
    joint2_found=None,
    use_analytic_seeds: bool = True,
    restart_guesses: Optional[torch.Tensor] = None,
) -> FullChainIKResult:
    """Full-chain pose IK with the reference's restart/bounds/RMSE semantics.

    Random restarts are drawn uniformly in 0.8 x the joint limits from a CPU
    `torch.Generator` seeded with `restart_seed` (the same guesses on every
    device). `restart_guesses` (R, J) replaces those draws, e.g. with another
    implementation's exact guesses in a parity test."""
    dev = model.device
    nj = model.num_joints
    false = torch.zeros((), dtype=torch.bool, device=dev)
    apply_correction = false if apply_correction is None else apply_correction
    if current_angles is None:
        current_angles = torch.zeros(nj, dtype=torch.float32, device=dev)
    lower = model.limits_rad[:, 0]
    upper = model.limits_rad[:, 1]
    guesses = [torch.stack([current_angles, torch.zeros_like(current_angles)])]
    if use_analytic_seeds and chain_is_analytic(model):
        frame = joint6_frame_from_markers(model, joint6_targets, apply_correction)
        guesses.append(analytic_ik_seeds(model, frame, base_tf))
    if restart_guesses is not None:
        guesses.append(restart_guesses.to(device=dev, dtype=torch.float32))
    elif num_random_restarts > 0:
        guesses.append(random_restart_guesses(model, num_random_restarts, restart_seed))
    guesses = torch.cat(guesses)

    def res(x):
        return full_chain_residual(
            model, x, base_tf, joint6_targets, apply_correction, joint4_targets, joint4_found
        )

    results = least_squares_lm(res, guesses, lower, upper, num_iters=num_iters)

    score = results.cost + 1e-4 * ((results.x - current_angles) ** 2).sum(1)
    if joint2_targets is not None:
        idx2 = model.link_index("Joint2")
        local2 = model.marker_local[idx2]

        def j2_err(x):
            pred = transforms.apply(fk_all_links(model, x, base_tf)[idx2], local2)
            return ((pred - joint2_targets) ** 2).sum()

        found2 = false if joint2_found is None else joint2_found
        score = score + torch.where(found2, 1e-2 * vmap(j2_err)(results.x), 0.0)
    sel = torch.argmin(score)
    angles = results.x[sel]

    # Joint6 winding: a6 and a6 +- 360 deg are one pose; take the in-limits
    # winding nearest the current pose (exactly equal cost)
    two_pi = 2 * math.pi
    a6 = angles[5]
    winds = torch.stack([a6 - two_pi, a6, a6 + two_pi])
    ok = (winds >= lower[5]) & (winds <= upper[5])
    wdist = torch.where(ok, torch.abs(winds - current_angles[5]), torch.inf)
    angles = torch.cat([angles[:5], winds[torch.argmin(wdist)][None], angles[6:]])

    e6 = full_chain_residual(model, angles, base_tf, joint6_targets, apply_correction)[:9]
    return FullChainIKResult(
        angles=angles,
        rmse=torch.sqrt((e6 * e6).mean()),
        cost=results.cost[sel],
        best_guess=sel,
        grad_norm=results.grad_norm[sel],
    )

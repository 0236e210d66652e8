"""Full-chain pose IK and the trajectory residual (port of
`mamri_tpu/ik/residuals.py`).

`full_chain_residual` is the reference's `_full_chain_ik_error_function`:
9 Joint6 marker errors (optionally with the 180-degree Z correction of the
Joint6 local frame) and a Joint4 block weighted 0.05 when Joint4 was found,
0 otherwise. `solve_full_chain_ik` polishes {current pose, zero pose}, the 8
closed-form branches and optional random restarts with one batched LM
(`ik/fused_lm.full_chain_lm`: one kernel launch on a card), then
scores by (cost, Joint2 evidence, distance to the current pose) and picks
the Joint6 winding nearest the current pose. `trajectory_pose_residual`
is the needle tip position + direction residual of the trajectory goal IK.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from mamri_tpu_torch.core import transforms
from mamri_tpu_torch.core.robot import RobotModel, fk_all_links
from mamri_tpu_torch.ik.analytic import analytic_ik_seeds, chain_is_analytic, joint6_frame_from_markers
from mamri_tpu_torch.ik.fused_lm import JOINT4_WEIGHT, full_chain_jacobian, full_chain_lm

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
    """(..., 18) marker-position residual at (..., J) angles (the closed-form
    Jacobian's rows, `fused_lm.full_chain_jacobian`). `apply_correction` and
    `joint4_found` are () bool tensors; the Joint4 block is zero-weighted
    when not found."""
    return full_chain_jacobian(model, angles, base_tf, joint6_targets, apply_correction, joint4_targets,
                               joint4_found, joint4_weight, jacobian=False)[0]


def trajectory_pose_residual(model: RobotModel, angles, base_tf, target_tf, orientation_weight: float = ORIENTATION_WEIGHT):
    """(6,) needle position + orientation residual for the trajectory IK."""
    needle = fk_all_links(model, angles, base_tf)[model.link_index("Needle")]
    pos_err = needle[:3, 3] - target_tf[:3, 3]
    actual_needle_dir = -needle[:3, 0]
    orient_err = orientation_weight * (target_tf[:3, 0] - actual_needle_dir)
    return torch.cat([pos_err, orient_err])


def _wrap_pi(a):
    return torch.where(a > math.pi, a - 2 * math.pi, torch.where(a < -math.pi, a + 2 * math.pi, a))


def symmetry_twin(angles):
    """The chain's exact marker-preserving symmetry: (J1 + pi, -J2, -J3,
    J4 + pi, J5, J6) puts every Joint4 and Joint6 marker at the same world
    position (the IS-PA-PA-IS-PA-IS axis pattern), so the full-chain
    objective has two branches of exactly equal cost."""
    a = torch.as_tensor(angles)
    return torch.stack([_wrap_pi(a[0] + math.pi), -a[1], -a[2], _wrap_pi(a[3] + math.pi), a[4], a[5]])


def wrist_twin(angles):
    """The wrist's exact Joint6-frame-preserving flip (J4 + pi, -J5, J6 + pi):
    the Joint6 markers stay put and Joint4's turn 180 degrees about its axis,
    a strong local minimum with Joint4 weighted 0.05 and an exact tie
    without it."""
    a = torch.as_tensor(angles)
    return torch.stack([a[0], a[1], a[2], _wrap_pi(a[3] + math.pi), -a[4], _wrap_pi(a[5] + math.pi)])


def ik_branch_family(angles):
    """(12, nj): {id, shoulder twin} x {id, wrist flip} x the Joint6 winding
    {-360, 0, +360} degrees, in that order. Every member puts the Joint6
    markers at the same positions."""
    angles = torch.as_tensor(angles)
    wind = torch.zeros_like(angles)
    wind[5] = 2 * math.pi
    cands = []
    for shoulder in (angles, symmetry_twin(angles)):
        for branch in (shoulder, wrist_twin(shoulder)):
            for w in (-1.0, 0.0, 1.0):
                cands.append(branch + w * wind)
    return torch.stack(cands)


def random_restart_guesses(model: RobotModel, count: int, seed: int):
    """(count, J) guesses uniform in 0.8 x the joint limits, drawn from a CPU
    `torch.Generator` seeded with `seed`: the same guesses on every device."""
    lower, upper = model.limits_rad[:, 0], model.limits_rad[:, 1]
    gen = torch.Generator().manual_seed(seed)
    u = torch.rand((count, model.num_joints), generator=gen).to(model.device, non_blocking=True)  # queued: no wait
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
    device). `restart_guesses` (R, J) replaces those draws: the engine's own
    draws, made once (a captured graph copies nothing from the host), or
    another implementation's exact guesses in a parity test."""
    dev = model.device
    nj = model.num_joints
    false = torch.zeros((), dtype=torch.bool, device=dev)
    apply_correction = false if apply_correction is None else apply_correction
    if current_angles is None:
        current_angles = torch.zeros(nj, dtype=torch.float32, device=dev)
    lower, upper = model.limit_rows
    guesses = [torch.stack([current_angles, torch.zeros_like(current_angles)])]
    if use_analytic_seeds and chain_is_analytic(model):
        frame = joint6_frame_from_markers(model, joint6_targets, apply_correction)
        guesses.append(analytic_ik_seeds(model, frame, base_tf))
    if restart_guesses is not None:
        guesses.append(restart_guesses.to(device=dev, dtype=torch.float32))
    elif num_random_restarts > 0:
        guesses.append(random_restart_guesses(model, num_random_restarts, restart_seed))
    guesses = torch.cat(guesses)

    results = full_chain_lm(
        model, guesses, lower, upper, base_tf, joint6_targets, apply_correction, joint4_targets, joint4_found,
        num_iters=num_iters,
    )

    score = results.cost + 1e-4 * ((results.x - current_angles) ** 2).sum(1)
    if joint2_targets is not None:
        idx2 = model.link_index("Joint2")
        pred2 = transforms.apply(fk_all_links(model, results.x, base_tf)[:, idx2], model.marker_local[idx2])
        j2_err = ((pred2 - joint2_targets) ** 2).sum((-2, -1))
        found2 = false if joint2_found is None else joint2_found
        score = score + torch.where(found2, 1e-2 * j2_err, 0.0)
    # a 0-d index read on the host would wait on the card: index_select queues
    sel = torch.argmin(score).reshape(1)
    angles = results.x.index_select(0, sel)[0]

    # Joint6 winding: a6 and a6 +- 360 deg are one pose; take the in-limits
    # winding nearest the current pose (exactly equal cost)
    two_pi = 2 * math.pi
    a6 = angles[5]
    winds = torch.stack([a6 - two_pi, a6, a6 + two_pi])
    ok = (winds >= lower[5]) & (winds <= upper[5])
    wdist = torch.where(ok, torch.abs(winds - current_angles[5]), torch.inf)
    angles = torch.cat([angles[:5], winds.index_select(0, torch.argmin(wdist).reshape(1)), angles[6:]])

    e6 = full_chain_residual(model, angles, base_tf, joint6_targets, apply_correction)[:9]
    return FullChainIKResult(
        angles=angles,
        rmse=torch.sqrt((e6 * e6).mean()),
        cost=results.cost.index_select(0, sel)[0],
        best_guess=sel[0],
        grad_norm=results.grad_norm.index_select(0, sel)[0],
    )

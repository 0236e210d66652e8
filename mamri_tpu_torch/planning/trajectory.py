"""Trajectory goal IK: reach the needle standoff pose, collision-aware (port
of `mamri_tpu/planning/trajectory.py`).

  * target frame: x_axis = normalize(target - entry); needle tip standoff =
    entry - safety_distance * x_axis; y/z from world-up with the
    0.99-parallel fallback.
  * bounded LM from {current pose, zero pose} + the best closed-form seeds
    (or random restarts); the winner is the lowest final position error
    among collision-free solutions.
  * collision handling: the residual gets a smooth penetration-depth term,
    and colliding solutions are masked out of the final argmin.

Every guess is one row of one batched LM (`ik/lm.least_squares_lm`), as
the reference vmaps one solve over its guesses.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch.func import vmap

from mamri_tpu_torch.core import transforms
from mamri_tpu_torch.core.robot import RobotModel
from mamri_tpu_torch.ik.analytic import analytic_ik_seeds, chain_is_analytic
from mamri_tpu_torch.ik.lm import least_squares_lm
from mamri_tpu_torch.ik.residuals import random_restart_guesses, trajectory_pose_residual
from mamri_tpu_torch.planning.collision import CollisionWorld, config_collides, config_penetration
from mamri_tpu_torch.planning.geometry import ArmGeometry

COLLISION_PENALTY_WEIGHT = 20.0  # mm of penetration -> residual units

# Success gate on the winner's tip position error: reachable targets converge
# sub-mm while out-of-reach local minima sit tens of mm off (the reference's
# SUCCESS_POSITION_ERROR_MM, 2x its 5 mm distance tolerance).
SUCCESS_POSITION_ERROR_MM = 10.0

# Near-ties resolve in a fixed order. Every closed-form branch at every roll
# reaches a reachable goal exactly, so the reference's picks among them (the
# top-k seed costs, the final argmin of position errors) are decided by the
# last bits of its arithmetic: a 1e-4 mm change of the target, or another
# device's rounding, picks another branch. Here a seed whose cost is below
# EXACT_SEED_COST (~1 um, ~1e-3 deg) ranks as exact, and among the guesses
# within TIE_POSITION_ERROR_MM of the best error the first that started
# exact wins (else the first of them). An exact seed stays where it is,
# while a guess that travels to the goal lands at a roll about the needle
# that rounding moves by ~3e-3 rad; so the card and the CPU choose the same
# answer. A winner separated by more than the tolerance is the reference's.
EXACT_SEED_COST = 1e-6
TIE_POSITION_ERROR_MM = 1e-3


class TrajectoryIKResult(NamedTuple):
    angles: torch.Tensor  # (J,)
    position_error_mm: torch.Tensor  # ()
    orientation_error: torch.Tensor  # () |50*(tx-(-fx))|
    collides: torch.Tensor  # () bool: the boolean check at the solution
    success: torch.Tensor  # () bool: converged and collision-free
    target_tf: torch.Tensor  # (4, 4) the needle target frame solved for


def _orthonormal_basis(x_axis):
    """(y, z) completing `x_axis` to a right-handed frame, with the
    reference's world-up choice and 0.99-parallel fallback; shared by the
    goal frame and the analytic seeds so the threshold cannot drift."""
    up = torch.tensor([0.0, 0.0, 1.0], dtype=x_axis.dtype, device=x_axis.device)
    alt = torch.tensor([0.0, 1.0, 0.0], dtype=x_axis.dtype, device=x_axis.device)
    up = torch.where(torch.abs(torch.dot(x_axis, up)) > 0.99, alt, up)
    y_axis = torch.linalg.cross(up, x_axis)
    y_axis = y_axis / torch.clamp(torch.linalg.norm(y_axis), min=1e-9)
    z_axis = torch.linalg.cross(x_axis, y_axis)
    return y_axis, z_axis


def needle_target_frame(target_ras, entry_ras, safety_distance_mm):
    """(4, 4) needle goal frame from the target and entry points."""
    target_ras = torch.as_tensor(target_ras, dtype=torch.float32)
    entry_ras = torch.as_tensor(entry_ras, dtype=torch.float32)
    direction = target_ras - entry_ras
    x_axis = direction / torch.clamp(torch.linalg.norm(direction), min=1e-9)
    tip = entry_ras - safety_distance_mm * x_axis
    y_axis, z_axis = _orthonormal_basis(x_axis)
    return transforms.homogeneous(torch.stack([x_axis, y_axis, z_axis, tip], dim=1))


def analytic_trajectory_seeds(model: RobotModel, target_tf, base_tf, n_roll: int = 4):
    """(8*n_roll, J) closed-form joint-angle candidates reaching the needle
    goal frame. The roll about the needle axis is free (the residual holds
    only the tip and the direction), so for each of `n_roll` rolls this
    builds the implied Joint6 frame (the needle is Joint6's -x axis, a pure
    translation away) and takes its eight closed-form branches, roll-major
    as the reference's vmap stacks them."""
    dtype = target_tf.dtype
    needle_off = model.fixed_offsets[model.link_index("Needle")][:3, 3]
    x6 = -target_tf[:3, 0]
    tip = target_tf[:3, 3]
    y0, z0 = _orthonormal_basis(x6)
    rolls = (2.0 * math.pi / n_roll) * torch.arange(n_roll, dtype=dtype, device=target_tf.device)
    seeds = []
    for roll in rolls:
        c, s = torch.cos(roll), torch.sin(roll)
        y6 = c * y0 + s * z0
        z6 = -s * y0 + c * z0
        r = torch.stack([x6, y6, z6], dim=1)
        frame = transforms.homogeneous(torch.cat([r, (tip - r @ needle_off)[:, None]], dim=1))
        seeds.append(analytic_ik_seeds(model, frame, base_tf))
    return torch.cat(seeds).reshape(-1, model.num_joints)


def top_seeds(costs, k: int):
    """Indices of the `k` cheapest seeds, the cheapest first: a stable
    ascending sort, so equal costs keep the lower index first as
    `lax.top_k(-costs, k)` does, with costs below EXACT_SEED_COST counted
    as equal."""
    return torch.argsort(torch.clamp(costs, min=EXACT_SEED_COST), stable=True)[: min(k, costs.shape[0])]


def solve_trajectory_ik(
    model: RobotModel,
    geometry: Optional[ArmGeometry],
    target_ras,
    entry_ras,
    safety_distance_mm,
    base_tf,
    world: Optional[CollisionWorld],
    current_angles=None,
    num_iters: Optional[int] = None,
    num_random_restarts: Optional[int] = None,
    restart_seed: int = 0,
    success_threshold_mm: float = SUCCESS_POSITION_ERROR_MM,
    analytic_seeds: Optional[bool] = None,
    seed_top_k: int = 4,
    restart_guesses: Optional[torch.Tensor] = None,
) -> TrajectoryIKResult:
    """The reference's `solve_trajectory_ik`. `analytic_seeds=None` turns on
    closed-form seeding on the MAMRI chain: the 32 candidates, clipped to
    the limits, are scored by residual cost and the `seed_top_k` cheapest
    (a stable ascending sort: equal costs keep the lower index first, as
    `lax.top_k` does; costs below EXACT_SEED_COST count as equal) join
    {current, zeros} for a 32-iteration polish. The winner has the lowest
    position error among collision-free solutions; near-ties (within
    TIE_POSITION_ERROR_MM) go to the first guess that started exact, else
    to the first guess.
    `analytic_seeds=False` is the unseeded {current, zeros, 6 random} x 100
    search, and `num_random_restarts=0` (strict reference emulation) also
    turns the seeding off. Random restarts come from a CPU generator seeded
    with `restart_seed`; `restart_guesses` (R, J) replaces those draws, e.g.
    with JAX's in a parity test. Tensors on the model's device."""
    nj = model.num_joints
    dev, dtype = model.device, model.limits_rad.dtype
    if analytic_seeds is None:
        analytic_seeds = chain_is_analytic(model) and num_random_restarts != 0
    if num_iters is None:
        num_iters = 32 if analytic_seeds else 100
    if num_random_restarts is None:
        num_random_restarts = 0 if analytic_seeds else 6
    if current_angles is None:
        current_angles = torch.zeros(nj, dtype=dtype, device=dev)
    target_tf = needle_target_frame(
        torch.as_tensor(target_ras, dtype=dtype).to(dev), torch.as_tensor(entry_ras, dtype=dtype).to(dev),
        safety_distance_mm,
    )
    weight = torch.tensor([COLLISION_PENALTY_WEIGHT], dtype=dtype, device=dev)

    def residual(x):
        base = trajectory_pose_residual(model, x, base_tf, target_tf)
        if world is None:
            return base
        pen = config_penetration(model, geometry.part_points, geometry.part_link_idx, x, base_tf, world)
        return torch.cat([base, weight * pen[None]])

    lower = model.limits_rad[:, 0]
    upper = model.limits_rad[:, 1]
    # (guesses, whether each starts on the goal) in the reference's order
    blocks = [(torch.stack([current_angles.to(dtype), torch.zeros(nj, dtype=dtype, device=dev)]),
               torch.zeros(2, dtype=torch.bool, device=dev))]
    if analytic_seeds:
        cand = analytic_trajectory_seeds(model, target_tf, base_tf)
        cand = torch.minimum(upper[None, :], torch.maximum(lower[None, :], cand))
        costs = (vmap(residual)(cand) ** 2).sum(-1)
        top = top_seeds(costs, seed_top_k)
        blocks.append((cand[top], costs[top] < EXACT_SEED_COST))
    if restart_guesses is None and num_random_restarts > 0:
        restart_guesses = random_restart_guesses(model, num_random_restarts, restart_seed)
    if restart_guesses is not None:
        blocks.append((restart_guesses.to(device=dev, dtype=dtype),
                       torch.zeros(restart_guesses.shape[0], dtype=torch.bool, device=dev)))
    guesses = torch.cat([g for g, _ in blocks])
    exact_start = torch.cat([e for _, e in blocks])
    results = least_squares_lm(residual, guesses, lower, upper, num_iters=num_iters)

    pose_res = vmap(lambda x: trajectory_pose_residual(model, x, base_tf, target_tf))(results.x)
    pos_errs = torch.linalg.norm(pose_res[:, :3], dim=-1)
    orient_errs = torch.linalg.norm(pose_res[:, 3:6], dim=-1)
    if world is None:
        colls = torch.zeros(results.x.shape[0], dtype=torch.bool, device=dev)
    else:
        colls = vmap(lambda x: config_collides(
            model, geometry.part_points, geometry.part_link_idx, x, base_tf, world))(results.x)
    # colliding solutions carry a huge final error, so the pick is collision-free where it can be
    score = torch.where(colls, 1e8, pos_errs)
    tied = score <= score.min() + TIE_POSITION_ERROR_MM
    best = torch.argmax(tied.to(torch.int8) + (tied & exact_start).to(torch.int8))
    return TrajectoryIKResult(
        angles=results.x[best],
        position_error_mm=pos_errs[best],
        orientation_error=orient_errs[best],
        collides=colls[best],
        success=~colls[best] & (pos_errs[best] < success_threshold_mm),
        target_tf=target_tf,
    )

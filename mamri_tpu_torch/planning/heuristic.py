"""Heuristic "up, over, down" path planning (port of
`mamri_tpu/planning/heuristic.py`).

  keyframes = [start,
               start with Joint2 = -15 deg        ("up"),
               previous with Joint1 = goal Joint1 ("over"),
               goal]                              ("down")
  path = piecewise linear, total_steps samples split 25/25/50 with
         t = j/steps per segment, plus the final goal appended (101 points).

The collision check of a whole path is one batched grid lookup.
"""

from __future__ import annotations

import math

import torch
from torch.func import vmap

from mamri_tpu_torch.core.robot import RobotModel
from mamri_tpu_torch.planning.collision import CollisionWorld, config_collides

UP_JOINT2_RAD = math.radians(-15.0)


def heuristic_keyframes(start_config, goal_config):
    """(4, J) keyframe stack for the up-over-down maneuver."""
    start = torch.as_tensor(start_config)
    goal = torch.as_tensor(goal_config)
    w1 = start.clone()
    w1[1] = UP_JOINT2_RAD
    w2 = w1.clone()
    w2[0] = goal[0]
    return torch.stack([start, w1, w2, goal])


def interpolate_path(keyframes, total_steps: int = 100):
    """(total_steps + 1, J) linear interpolation with the reference's 25/25/50
    segment split and endpoint handling. `t` is divided by a tensor on the
    keyframes' device: a Python scalar divisor becomes a multiplication by
    its reciprocal on the card."""
    keyframes = torch.as_tensor(keyframes)
    segment_steps = [total_steps // 4, total_steps // 4, total_steps // 2]
    rows = []
    for i, steps in enumerate(segment_steps):
        a, b = keyframes[i], keyframes[i + 1]
        t = torch.arange(steps, dtype=keyframes.dtype, device=keyframes.device)[:, None]
        t = t / torch.tensor(float(steps), dtype=keyframes.dtype, device=keyframes.device)
        rows.append(a[None, :] + t * (b - a)[None, :])
    rows.append(keyframes[-1][None, :])
    return torch.cat(rows, dim=0)


def check_path_collisions(model: RobotModel, geometry, path, base_tf, world: CollisionWorld):
    """(P,) per-sample collision flags for a whole path, batched on the device."""
    return vmap(lambda cfg: config_collides(
        model, geometry.part_points, geometry.part_link_idx, cfg, base_tf, world))(path)

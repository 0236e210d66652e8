"""Public result types of the port's MamriEngine.

The port's own copies of `PoseEstimate`, `ActionState` and `TrajectoryPlan`
(mamri_tpu/api/types.py:11-54): the same fields, defaults and order, so
results read the same in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np


@dataclass
class PoseEstimate:
    """Output of `MamriEngine.estimate_pose`."""

    success: bool
    angles_rad: Optional[np.ndarray] = None  # (6,)
    steps: Optional[np.ndarray] = None  # (6,) int
    rmse_mm: Optional[float] = None
    baseplate_tf: Optional[np.ndarray] = None  # (4, 4)
    baseplate_source: str = "none"  # "detected" | "saved" | "saved_fallback" | "none"
    markers_found: Dict[str, bool] = field(default_factory=dict)
    num_blobs: int = 0
    message: str = ""


@dataclass(frozen=True)
class ActionState:
    """Availability of one user-facing action (a gated UI button of the
    reference); `reason` says what the action does when enabled, or what is
    missing when disabled."""

    enabled: bool
    reason: str = ""

    def __bool__(self) -> bool:
        return self.enabled


@dataclass
class TrajectoryPlan:
    """Output of `MamriEngine.plan_heuristic_path`: the reference's
    `(path, keyframes, collision_detected)` triple and the goal."""

    success: bool
    path: Optional[np.ndarray] = None  # (P, 6) angles
    keyframes: Optional[np.ndarray] = None  # (4, 6)
    collision_detected: bool = False
    goal_angles: Optional[np.ndarray] = None  # (6,)
    goal_steps: Optional[np.ndarray] = None
    position_error_mm: Optional[float] = None
    message: str = ""

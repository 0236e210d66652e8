"""Public result types of the port's MamriEngine.

The port's own copy of `PoseEstimate` (mamri_tpu/api/types.py:11-25): the
same fields, defaults and order, so results read the same in both packages.
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

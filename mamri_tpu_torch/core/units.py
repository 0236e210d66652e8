"""Joint-angle <-> motor-step conversion (port of `mamri_tpu/core/units.py`).

    steps = trunc(angle_rad * (steps_per_rev / (2*pi)))   # toward zero, like int()
    angle = steps * ((2*pi) / steps_per_rev)

Same float32 op order as the JAX version. The divisor is a full tensor, not
a Python scalar: PyTorch may turn division by a scalar into multiplication
by its reciprocal, which is not bit-equal.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def angles_to_steps(angles_rad, steps_per_rev):
    """(..., J) radians -> (..., J) int32 motor steps (truncation toward zero)."""
    spr = steps_per_rev.to(angles_rad.dtype)
    raw = angles_rad * (spr / torch.full_like(spr, 2.0 * math.pi))
    return torch.trunc(raw).to(torch.int32)


def steps_to_angles(steps, steps_per_rev, dtype=torch.float32):
    """(..., J) motor steps -> (..., J) radians."""
    spr = steps_per_rev.to(dtype)
    return steps.to(dtype) * (torch.full_like(spr, 2.0 * math.pi) / spr)


def angles_to_steps_host(angles_rad, steps_per_rev) -> np.ndarray:
    """Host-numpy twin of `angles_to_steps` (the same f32 op order), for
    the paths that convert every control tick and must not wait on a
    device."""
    angles = np.asarray(angles_rad, dtype=np.float32)
    spr = np.asarray(steps_per_rev, dtype=np.float32)
    raw = angles * (spr / np.float32(2.0 * np.pi))
    return np.trunc(raw).astype(np.int32)


def steps_to_angles_host(steps, steps_per_rev, dtype=np.float32) -> np.ndarray:
    """Host-numpy twin of `steps_to_angles` (the same f32 op order)."""
    steps = np.asarray(steps).astype(dtype)
    spr = np.asarray(steps_per_rev, dtype=dtype)
    return steps * (dtype(2.0 * np.pi) / spr)

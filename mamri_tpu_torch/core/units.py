"""Joint-angle -> motor-step conversion (port of `mamri_tpu/core/units.py`).

    steps = trunc(angle_rad * (steps_per_rev / (2*pi)))   # toward zero, like int()

Same float32 op order as the JAX version. The divisor is a full tensor, not
a Python scalar: PyTorch may turn division by a scalar into multiplication
by its reciprocal, which is not bit-equal.
"""

from __future__ import annotations

import math

import torch


def angles_to_steps(angles_rad, steps_per_rev):
    """(..., J) radians -> (..., J) int32 motor steps (truncation toward zero)."""
    spr = steps_per_rev.to(angles_rad.dtype)
    raw = angles_rad * (spr / torch.full_like(spr, 2.0 * math.pi))
    return torch.trunc(raw).to(torch.int32)

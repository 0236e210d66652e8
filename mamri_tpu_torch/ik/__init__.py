from mamri_tpu_torch.ik.lm import LMResult, least_squares_lm
from mamri_tpu_torch.ik.residuals import (
    full_chain_residual,
    solve_full_chain_ik,
    trajectory_pose_residual,
)

__all__ = [
    "LMResult",
    "least_squares_lm",
    "full_chain_residual",
    "trajectory_pose_residual",
    "solve_full_chain_ik",
]

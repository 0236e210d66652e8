from mamri_tpu_torch.planning.collision import (
    CollisionWorld,
    build_collision_world,
    config_collides,
    config_penetration,
)
from mamri_tpu_torch.planning.geometry import ArmGeometry, build_arm_geometry
from mamri_tpu_torch.planning.entry import EntryPointResult, find_entry_point
from mamri_tpu_torch.planning.heuristic import heuristic_keyframes, interpolate_path, check_path_collisions
from mamri_tpu_torch.planning.trajectory import TrajectoryIKResult, needle_target_frame, solve_trajectory_ik

__all__ = [
    "CollisionWorld",
    "build_collision_world",
    "config_collides",
    "config_penetration",
    "ArmGeometry",
    "build_arm_geometry",
    "EntryPointResult",
    "find_entry_point",
    "heuristic_keyframes",
    "interpolate_path",
    "check_path_collisions",
    "TrajectoryIKResult",
    "needle_target_frame",
    "solve_trajectory_ik",
]

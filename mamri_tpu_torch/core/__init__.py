from mamri_tpu_torch.core.robot import RobotModel, default_config_path, fk_all_links, load_robot_model
from mamri_tpu_torch.core import transforms, units

__all__ = [
    "RobotModel",
    "load_robot_model",
    "default_config_path",
    "fk_all_links",
    "transforms",
    "units",
]

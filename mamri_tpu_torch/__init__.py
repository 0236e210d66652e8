"""mamri_tpu_torch — the PyTorch + CUDA port of mamri_tpu: scan -> pose,
planning, streaming, scene export and the hardware loop.

`mamri_tpu` (JAX/Pallas) stays the reference; this package is held against
it on identical inputs. It imports torch and numpy, never jax, and nothing
of `mamri_tpu`: it keeps its own copies of what it needs from there
(`api/types.py`, `api/playback.py`, `resources/mamri_arm.json`,
`perception/volume.py`, the readers and writers, `hw/`, `utils/stl.py` and
the scene writers).

Layering mirrors `mamri_tpu`:
  core/          4x4 algebra, robot model + FK (device and host), units
  perception/    Volume, segmentation, and the hand-written CUDA kernels
                 (`gpu_ops`, sources in `csrc/`) with their plain twins;
                 volume readers and writers
  registration/  L-shape triplet matching (`best`, `strict`, `global`) +
                 Horn/Kabsch rigid fit
  ik/            batched bounded Levenberg-Marquardt, full-chain pose IK
  planning/      collision world, entry search, trajectory goal IK,
                 heuristic path, exact validation
  hw/            serial transports, controller and encoder links, the
                 closed-loop task runner, sync monitor, pose stream and a
                 simulated rig: host code over the engine, which feeds each
                 control tick from the host FK
  utils/         STL ingest, tracer, and the scene writers (OBJ, glTF,
                 WebGL viewer, PNG rasterizer)
  api/           MamriEngine (single, batched and async estimation,
                 planning, state, scene export, `attach_hardware` /
                 HardwareStack), PoseTracker, playback

Geometry runs in strict float32 on the card: both TF32 switches are turned
off when the package is imported, for the reason the JAX package pins
`Precision.HIGHEST` (a 10-bit mantissa rounds millimetre coordinates).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

__all__ = ["MamriEngine", "RobotModel", "load_robot_model", "__version__"]

_EXPORTS = {
    "MamriEngine": "mamri_tpu_torch.api.engine",
    "RobotModel": "mamri_tpu_torch.core.robot",
    "load_robot_model": "mamri_tpu_torch.core.robot",
}


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module 'mamri_tpu_torch' has no attribute {name!r}")

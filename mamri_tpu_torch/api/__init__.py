__all__ = ["MamriEngine", "ActionState", "PoseEstimate", "TrajectoryPlan"]

_EXPORTS = {
    "MamriEngine": "mamri_tpu_torch.api.engine",
    "ActionState": "mamri_tpu_torch.api.types",
    "PoseEstimate": "mamri_tpu_torch.api.types",
    "TrajectoryPlan": "mamri_tpu_torch.api.types",
}


# Lazy exports (PEP 562), as in mamri_tpu.api: importing a light module of
# this package must not load MamriEngine and the device runtime behind it.
def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module 'mamri_tpu_torch.api' has no attribute {name!r}")

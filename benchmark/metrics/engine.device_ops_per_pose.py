"""Device operations (kernels, copies, memsets) per `estimate_pose` call,
from the traced calls' torch.profiler timeline (layer `api.engine`)."""


def read(run):
    prof = run.facts.get("profile")
    return prof["device_ops"] / prof["calls"] if prof else None

"""Device operations (kernels, copies, memsets) per volume of an `estimate_pose_batch`,
from the traced batches' torch.profiler timeline (layer `api.engine`)."""


def read(run):
    prof = run.facts.get("profile")
    return prof["device_ops"] / prof["volumes"] if prof else None

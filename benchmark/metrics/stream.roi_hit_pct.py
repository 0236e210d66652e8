"""Share of the traced tracker frames served from the ROI window
(`PoseTracker.roi_frames` over the frames stepped; layer `api.streaming`)."""


def read(run):
    s = run.facts.get("stream")
    return 100.0 * s["roi_frames"] / s["frames"] if s and s["frames"] else None

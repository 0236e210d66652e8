"""Device ops (kernels, copies, memsets) a call launches inside the
program's `pose.ik` spans (layer `ik`): those whose CUDA runtime call lies
inside a `pose.ik` event of the torch.profiler timeline, per
`estimate_pose` request (`benchmark/lib/program_spans.py`, pass 2)."""

from benchmark.lib.program_spans import device


def read(run):
    return device(run, "ops", "pose.ik")

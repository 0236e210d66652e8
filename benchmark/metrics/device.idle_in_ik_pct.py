"""Share of the card's idle time that falls inside the program's `pose.ik`
spans (layer `device`): the traced window's device-idle intervals
intersected with the `pose.ik` events of the torch.profiler timeline
(`benchmark/lib/program_spans.py`, pass 2)."""

from benchmark.lib.program_spans import device


def read(run):
    return device(run, "idle_pct", "pose.ik")

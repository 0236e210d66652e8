"""Host ms a call spends in the program's `pose.segment` spans (layer
`perception.segmentation`): the segmentation's enqueue; the median over the
traced requests (`benchmark/lib/program_spans.py`, pass 1)."""

from benchmark.lib.program_spans import host


def read(run):
    return host(run, "pose.segment")

"""Host ms a call spends in the program's `pose.ik` spans (layer `ik`):
`solve_full_chain_ik` and the steps; the median over the traced requests
(`benchmark/lib/program_spans.py`, pass 1)."""

from benchmark.lib.program_spans import host


def read(run):
    return host(run, "pose.ik")

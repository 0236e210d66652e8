"""Host ms a call spends in the program's `pose.fetch` spans (layer
`api.engine`): waiting on the card and the copies back, the body mask's
included; the median over the traced requests
(`benchmark/lib/program_spans.py`, pass 1)."""

from benchmark.lib.program_spans import host


def read(run):
    return host(run, "pose.fetch")

"""Host ms of the program's `estimate_pose` span outside its child spans
(layer `api.engine`): matching, Kabsch, the escalation logic and the host
glue; the median over the traced requests
(`benchmark/lib/program_spans.py`, pass 1)."""

from benchmark.lib.program_spans import host


def read(run):
    return host(run, "self")

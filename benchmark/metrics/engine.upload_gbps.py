"""GB/s of the scan's upload in `estimate_pose` (layer `api.engine`): the
program's counter `pose.upload_bytes` over its span `pose.upload`, a
request's bytes over its host time; the median over the traced requests
(`benchmark/lib/program_spans.py`, pass 1)."""

from benchmark.lib.program_spans import host


def read(run):
    return host(run, "upload_gbps")

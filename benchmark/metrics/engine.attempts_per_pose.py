"""Segmentation attempts a call makes (layer `api.engine`): the program's
counter `pose.attempts`, one per pass of `estimate_pose`'s escalation loop;
the median over the traced requests (`benchmark/lib/program_spans.py`,
pass 1)."""

from benchmark.lib.program_spans import host


def read(run):
    return host(run, "attempts")

"""Host ms a call spends in the program's `ik.lm.jacobian` spans (layer
`ik`): the LM's `num_iters + 1` Jacobian evaluations, `vmap(jacfwd)`; the
median over the traced requests (`benchmark/lib/program_spans.py`,
pass 1)."""

from benchmark.lib.program_spans import host


def read(run):
    return host(run, "ik.lm.jacobian")

"""The per-layer metrics read from the program's own spans and counters
(`benchmark/lib/program_spans.py`): each cell's traced path on the CPU at
small sizes, and the same path on a program without those spans."""

import pytest

from benchmark import run as bench
from benchmark.lib import program_spans

from .conftest import SMALL

CELLS = ["bench256.pose", "clinical512.stream"]
SEED = 2 ** 31 + 11
HOST = ["engine.upload_gbps", "engine.fetch_wait_ms", "engine.self_ms", "engine.attempts_per_pose", "seg.host_ms",
        "ik.host_ms", "ik.jacobian_host_ms"]
DEVICE = ["ik.device_ops_per_pose", "device.idle_in_ik_pct"]


def _traced(root, cell, monkeypatch):
    """-> (metrics of one `--trace 1` run of `cell` on the CPU, the facts the
    lib read, [(the engine's tracer before the lib, after it)])."""
    seen, read = [], program_spans.facts
    facts = {}

    def spy(run):
        before = run.engine.tracer
        out = read(run)
        seen.append((before, run.engine.tracer))
        facts.update(out)
        return out

    monkeypatch.setattr(program_spans, "facts", spy)
    result, _ = bench.run_cell(root, cell, SEED, 1.0, True, device="cpu", overrides=SMALL[cell.split(".")[0]])
    return {k: v["value"] for k, v in result["metrics"].items()}, facts, seen


@pytest.mark.parametrize("cell", CELLS)
def test_program_span_metrics(root, cell, monkeypatch):
    metrics, facts, seen = _traced(root, cell, monkeypatch)
    for name in HOST:
        assert metrics.get(name) is not None, name
    for name in DEVICE:  # the card's timeline only
        assert name not in metrics, name
    root_ms = facts["host"]["estimate_pose"]
    assert 0 < metrics["ik.jacobian_host_ms"] <= metrics["ik.host_ms"] <= root_ms
    assert 0 < metrics["seg.host_ms"] <= root_ms and 0 <= metrics["engine.fetch_wait_ms"] <= root_ms
    assert 0 <= metrics["engine.self_ms"] <= root_ms and metrics["engine.upload_gbps"] > 0
    assert metrics["engine.attempts_per_pose"] == 1
    assert seen and all(before is after for before, after in seen)


def test_a_program_without_the_spans_reads_nothing(root, monkeypatch):
    """The parent's program has no request records: the readers give no
    value, and the run still gives its result."""
    from mamri_tpu_torch.utils.trace import Tracer

    monkeypatch.delattr(Tracer, "requests")
    metrics, facts, seen = _traced(root, "bench256.pose", monkeypatch)
    assert facts == {} and seen
    assert not set(HOST + DEVICE) & set(metrics)

"""The port's request-scoped spans and counters (`utils/trace.Tracer`) on the
scan -> pose path.

The scene is the demo scene at 3 mm (tests/test_torch_streaming.py's arm
and body) on a CPU engine with `ik_restarts=0`. One `estimate_pose` under an
enabled tracer is one request: the root `estimate_pose`, its children
`pose.upload`, `pose.segment`, `pose.ik` and `pose.fetch`, one `ik.lm.solve`
under `pose.ik` (the full-chain LM: one kernel launch on a card, its plain
twin here), and the counters `pose.upload_bytes`, `pose.attempts` and
`ik.lm.fused_solves`. A scan that escalates repeats segmentation and IK per
attempt; a disabled tracer, or a solve outside an engine, records nothing
and changes no answer; under `torch.profiler` each span is an event of its
name; the buffer keeps the newest records and counts the rest.
"""

import sys
import threading
from collections import Counter

import numpy as np
import pytest
import torch

from mamri_tpu_torch.api.demo import build_demo_scene
from mamri_tpu_torch.api.engine import MamriEngine
from mamri_tpu_torch.ik.residuals import solve_full_chain_ik
from mamri_tpu_torch.perception.volume import Volume
from mamri_tpu_torch.utils import trace
from test_torch_batch import _speckled
from test_torch_engine import _one_torch_thread  # noqa: F401 (autouse)

POSE_CHILDREN = Counter({"pose.upload": 1, "pose.segment": 1, "pose.ik": 1, "pose.fetch": 2})


@pytest.fixture(scope="module")
def traced():
    """(engine with an enabled tracer, the scene's volume, [its two
    estimates]): two `estimate_pose` calls of the scene."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        eng = MamriEngine(device="cpu", ik_restarts=0, tracer=trace.Tracer())
        vol = build_demo_scene(eng, 3.0)[0]
        ests = [eng.estimate_pose(vol) for _ in range(2)]
    finally:
        torch.set_num_threads(threads)
    return eng, vol, ests


def _by_request(tracer):
    return list(tracer.requests().values())


def _children(recs, parent):
    return [r for r in recs if r.parent == parent.index]


def _upload_bytes(vol):
    # the scan, spacing and origin (f32), the saved base (4x4 f32), three
    # bools and the current angles (6 f32)
    return vol.data.nbytes + 3 * 4 + 3 * 4 + 16 * 4 + 3 + 6 * 4


def test_one_pose_is_one_request(traced):
    eng, vol, ests = traced
    assert all(e.success for e in ests)
    reqs = _by_request(eng.tracer)
    assert len(reqs) == 2
    ids = set()
    for recs in reqs:
        root = recs[0]
        assert root.name == "estimate_pose" and root.parent == -1
        assert {r.request for r in recs} == {root.request}
        ids.add(root.request)
        kids = _children(recs, root)
        assert Counter(r.name for r in kids) == POSE_CHILDREN
        (ik,) = [r for r in kids if r.name == "pose.ik"]
        solve = [r for r in recs if r.name == "ik.lm.solve"]
        assert len(solve) == 1 and solve[0].parent == ik.index
        assert not [r for r in recs if r.name == "ik.lm.jacobian"]  # the generic LM is off the pose path
        assert len(recs) == 1 + sum(POSE_CHILDREN.values()) + len(solve)
        spans = {r.index: r for r in recs}
        for r in recs[1:]:
            p = spans[r.parent]
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns, (r.name, p.name)
        assert root.counters == {"pose.attempts": 1, "pose.upload_bytes": _upload_bytes(vol), "ik.lm.fused_solves": 1}
        assert all(r.counters is None for r in recs[1:])
    assert len(ids) == 2
    assert eng.tracer.counters["pose.attempts"] == 2 and eng.tracer.dropped == 0
    assert eng.tracer.stats("estimate_pose")["count"] == 2


@pytest.fixture
def restore_tracer(traced):
    eng = traced[0]
    kept = eng.tracer
    yield eng
    eng.tracer = kept


def test_an_escalating_scan_repeats_segmentation_and_ik(traced, restore_tracer):
    """tests/test_torch_batch.py's speckled scan (lone bright voxels that
    overflow the default 128 roots): one attempt per segmentation setting,
    each with its segmentation, IK and fetch."""
    eng, vol, _ = traced
    noisy = Volume(_speckled(np.asarray(vol.data)), vol.spacing, vol.origin)
    eng.tracer = trace.Tracer()
    est = eng.estimate_pose(noisy, store_state=False, keep_segmentation=False)
    assert est.success
    (recs,) = _by_request(eng.tracer)
    root = recs[0]
    attempts = root.counters["pose.attempts"]
    assert attempts >= 2
    names = Counter(r.name for r in _children(recs, root))
    assert names == Counter({"pose.upload": 1, "pose.segment": attempts, "pose.ik": attempts,
                             "pose.fetch": attempts})
    assert sum(r.name == "ik.lm.solve" for r in recs) == attempts == root.counters["ik.lm.fused_solves"]


def test_off_records_nothing_and_changes_nothing(traced, restore_tracer):
    eng, vol, ests = traced
    eng.tracer = trace.Tracer(enabled=False)  # the default engine's tracer
    before = {k: len(v) for k, v in trace.global_tracer().spans.items()}
    eng.set_pose(np.zeros(6, np.float32))
    off = eng.estimate_pose(vol)
    assert not eng.tracer.spans and not eng.tracer.records and not eng.tracer.counters

    # a solve outside an engine call has no current tracer to record into;
    # inside a request it records into that request's tracer
    targets = torch.as_tensor(off.baseplate_tf[:3, 3]) + torch.eye(3) * 10.0

    def solve():
        solve_full_chain_ik(eng.model, targets, torch.eye(4), num_iters=2, num_random_restarts=0)

    solve()
    assert {k: len(v) for k, v in trace.global_tracer().spans.items()} == before
    on = trace.Tracer()
    with on.span("outer"):
        solve()
    assert [r.name for r in on.records].count("ik.lm.solve") == 1 and on.counters["ik.lm.fused_solves"] == 1

    # the first traced call started from the zero pose too: the same answer bit for bit
    first = ests[0]
    np.testing.assert_array_equal(off.angles_rad, first.angles_rad)
    np.testing.assert_array_equal(off.steps, first.steps)
    assert off.rmse_mm == first.rmse_mm


def test_spans_are_profiler_events(traced, restore_tracer, monkeypatch):
    """Under a profile each span is a `record_function` event of its name,
    and the LM's ATen ops lie inside `ik.lm.solve`; without one no
    `record_function` is entered."""
    eng, vol, _ = traced
    entered = []
    real = torch.profiler.record_function

    def spy(name, *a, **k):
        entered.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    eng.tracer = trace.Tracer()
    eng.estimate_pose(vol, store_state=False)
    assert entered == []

    eng.tracer = trace.Tracer()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        eng.estimate_pose(vol, store_state=False)
    (recs,) = _by_request(eng.tracer)
    assert Counter(entered) == Counter(r.name for r in recs)
    events = prof.profiler.kineto_results.events()
    spans = Counter(e.name() for e in events if e.is_user_annotation())
    assert spans == Counter(r.name for r in recs)

    def intervals(name):
        return [(e.start_ns(), e.end_ns()) for e in events if e.name() == name and e.is_user_annotation()]

    solve, ik = intervals("ik.lm.solve"), intervals("pose.ik")
    assert len(solve) == 1
    assert all(any(a <= s and e <= b for a, b in ik) for s, e in solve)
    aten = [(e.start_ns(), e.end_ns()) for e in events if e.name().startswith("aten::")]
    for s, e in solve:
        assert any(s <= a and b <= e for a, b in aten), "an LM span without its ATen ops"


def test_the_buffer_keeps_the_newest(monkeypatch):
    monkeypatch.setattr(trace, "MAX_RECORDS", 10)
    t = trace.Tracer()
    for i in range(15):
        with t.span("req"):
            t.count("n", i)
    assert [r.index for r in t.records] == list(range(5, 15))
    assert [r.counters["n"] for r in t.records] == list(range(5, 15))
    assert t.dropped == 5 and len(t.spans["req"]) == 10 and t.counters["n"] == sum(range(15))
    assert len(t.requests()) == 10
    t.reset()
    assert not t.records and not t.spans and not t.counters and t.dropped == 0


def test_requests_stay_apart_across_threads():
    """Threads recording into one tracer at once: every request keeps its
    own children and counters, and no count is lost."""
    t = trace.Tracer()
    n_threads, n_requests = 8, 200
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for _ in range(n_requests):
                with t.span(f"root{k}"):
                    with trace.current_span("child"):
                        trace.current_count("c")
                    trace.current_count("c", 2)
        threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(switch)
    reqs = t.requests()
    assert len(reqs) == n_threads * n_requests
    for recs in reqs.values():
        root, child = recs
        assert root.name.startswith("root") and child.name == "child" and child.parent == root.index
        assert root.counters == {"c": 3}
    assert t.counters["c"] == 3 * n_threads * n_requests
    assert trace.current_span("x") is trace.current_span("y")  # outside a request: the shared no-op

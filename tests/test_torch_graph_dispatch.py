"""`MamriEngine.estimate_pose`'s dispatch of its cached pipelines as CUDA
graphs (`api/engine._StageGraphs`), without a card.

A CPU stand-in takes the place of `torch.cuda.CUDAGraph`: it "captures" a
stage by running it once on the static inputs (its outputs become the
static outputs) and "replays" it by running it again and writing the
results into those same tensors, dropping what the stage counts meanwhile,
as a replay runs no Python. With it the engine's own code decides when a
key runs eagerly, captures or replays, where the scan goes, which lock is
held, what is counted and when a graph is freed; the card's tests
(tests/test_torch_cuda.py) hold the real graphs to the eager answers.
"""

import gc
import sys
import threading
import weakref

import numpy as np
import pytest
import torch

from mamri_tpu_torch import _build
from mamri_tpu_torch.api import engine as E
from mamri_tpu_torch.api.demo import bench_scenes, render_bench_scene
from mamri_tpu_torch.core.robot import load_robot_model
from mamri_tpu_torch.ik.residuals import random_restart_guesses
from mamri_tpu_torch.perception.segmentation import SegmentationParams
from mamri_tpu_torch.perception.volume import Volume
from mamri_tpu_torch.utils.trace import Tracer, counts_recorded, current_count
from test_torch_engine import _one_torch_thread  # noqa: F401 (autouse)

SIZE = 96  # every bench scene is found and certified at 96^3 on the CPU, ~0.4 s a pose
COUNTERS = ("pose.eager_stages", "pose.graph_captures", "pose.graph_replays")
CERTS = ("seg_converged", "roots_complete", "blobs_complete", "seg_count_ok", "seg_cand_ok", "seg_runs_ok",
         "seg_compact_ok")


def _write_into(static, fresh):
    if isinstance(static, torch.Tensor):
        static.copy_(fresh)
    elif isinstance(static, dict):
        for key in static:
            _write_into(static[key], fresh[key])
    else:
        for s, f in zip(static, fresh):
            _write_into(s, f)


class FakeGraph:
    """`_CudaStageGraph`'s stand-in on the CPU (see the module docstring)."""

    made = []

    @staticmethod
    def new_pool():
        return object()

    def __init__(self, run, env, pool):
        self.run, self.env, self.pool = run, env, pool
        self.collecting = gc.isenabled()  # a real capture must see no garbage collection
        self.thread = threading.get_ident()
        self.out = run(env)
        self.replays = 0
        FakeGraph.made.append(weakref.ref(self))

    def replay(self):
        with _build.launches_recorded(), counts_recorded():
            fresh = self.run(self.env)
        _write_into(self.out, fresh)
        self.replays += 1


@pytest.fixture
def fake_card(monkeypatch):
    """The engine dispatches by graphs on the CPU, with `FakeGraph`; its
    fetches hand out arrays of their own, as on a card (the CPU's share the
    tensors' memory, which the next replay overwrites)."""
    fetch = E.MamriEngine._fetch
    monkeypatch.setattr(E, "_graphs_run_on", lambda device: True)
    monkeypatch.setattr(E, "_CudaStageGraph", FakeGraph)
    monkeypatch.setattr(E.MamriEngine, "_fetch", lambda self, dev_out: {k: np.array(v) for k, v in
                                                                          fetch(self, dev_out).items()})
    FakeGraph.made = []


@pytest.fixture(scope="module")
def scenes():
    model = load_robot_model(device="cpu")
    found, spacing, origin, body_center = bench_scenes(model, SIZE)
    return [render_bench_scene(s[2], (SIZE,) * 3, spacing, origin, body_center) for s in found[:3]]


@pytest.fixture(scope="module")
def eager_answers(scenes):
    """Each scene's answer from a CPU engine that never dispatches by graphs."""
    eng = E.MamriEngine(device="cpu")
    return [_pose(eng, v) for v in scenes]


def _pose(eng, volume, **kw):
    """`estimate_pose` from the zero pose, and its answer: angles, steps,
    RMSE, base, markers, and the stored body mask and certificates."""
    eng.zero_robot()
    est = eng.estimate_pose(volume, **kw)
    seg = eng.last_segmentation
    return {"angles": est.angles_rad, "steps": est.steps, "rmse": est.rmse_mm, "base_tf": est.baseplate_tf,
            "markers": est.markers_found, "body_mask": seg["body_mask"], **{c: bool(seg[c]) for c in CERTS}}


def _assert_same(got, want):
    assert got.keys() == want.keys()
    for key in want:
        if isinstance(want[key], np.ndarray):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        else:
            assert got[key] == want[key], key


def _graphs(eng, shape, dtype=torch.float32, params=None):
    return eng._get_pipeline(shape, params).stage_graphs(dtype)


def _counts(tracer):
    return tuple(tracer.counters.get(c, 0) for c in COUNTERS)


def test_first_call_eager_second_captures_then_replays(fake_card, scenes):
    """Per key: the first call runs the 3 stages eagerly, the second
    captures each (and replays it), every later one replays only; each
    replay is counted once a stage, and after the first call every stage
    run is a replay."""
    eng = E.MamriEngine(device="cpu", tracer=Tracer())
    steps = []
    for v in scenes[:2] + scenes[:2]:
        before = _counts(eng.tracer)
        eng.estimate_pose(v, store_state=False)
        steps.append(tuple(a - b for a, b in zip(_counts(eng.tracer), before)))
    assert steps == [(3, 0, 0), (0, 3, 3), (0, 0, 3), (0, 0, 3)]
    graphs = _graphs(eng, scenes[0].shape)
    assert graphs.calls == 2 and len(graphs._graphs) == 3
    assert [g.replays for g, _, _ in graphs._graphs] == [3, 3, 3]
    assert eng.tracer.counters["pose.attempts"] == 4


def test_consecutive_scans_each_get_their_own_answer(fake_card, scenes, eager_answers):
    """Different scans back to back through one key's graphs: each call's
    answer (angles, steps, RMSE, base, markers, body mask, certificates) is
    the eager engine's for its own scan, on the eager call, the capture and
    every replay."""
    eng = E.MamriEngine(device="cpu")
    order = [0, 1, 2, 1, 0, 2, 2, 0]
    for i in order:
        _assert_same(_pose(eng, scenes[i]), eager_answers[i])
    assert _graphs(eng, scenes[0].shape).calls == 2


def test_scan_is_uploaded_into_the_static_inputs(fake_card, scenes):
    """Once a key is captured, a call uploads its 8 arguments into the
    graphs' static inputs (no new device tensor) and the graphs read them."""
    eng = E.MamriEngine(device="cpu")
    for v in scenes[:2]:
        eng.estimate_pose(v, store_state=False)
    graphs = _graphs(eng, scenes[0].shape)
    inputs = graphs.inputs
    uploads = []
    upload = eng._upload

    def spy(v, dtype=None, out=None):
        uploads.append(out)
        return upload(v, dtype, out)

    eng._upload = spy
    eng.estimate_pose(scenes[2], store_state=False)
    assert len(uploads) == len(E.PIPELINE_ARGS) and all(o is s for o, s in zip(uploads, inputs))
    assert graphs.inputs is inputs
    np.testing.assert_array_equal(inputs[0].numpy(), scenes[2].data)


@pytest.mark.parametrize("entry", ["batch", "async", "mesh", "cpu"])
def test_other_entries_never_reach_the_runner(fake_card, monkeypatch, scenes, eager_answers, entry):
    """`estimate_pose_batch`, `estimate_pose_async` and the mesh run the
    eager closure even where graphs dispatch, and a CPU engine's
    `estimate_pose` never dispatches by graphs at all; answers unchanged."""
    def refuse(self, args):
        raise AssertionError(f"{entry} reached the graph dispatch")

    monkeypatch.setattr(E._StageGraphs, "run", refuse)
    eng = E.MamriEngine(device="cpu")
    v = scenes[0]
    if entry == "batch":
        out = eng.estimate_pose_batch(np.stack([v.data, scenes[1].data]), v.spacing, v.origin)
        np.testing.assert_array_equal(out["angles"][0], eager_answers[0]["angles"])
        np.testing.assert_array_equal(out["angles"][1], eager_answers[1]["angles"])
    elif entry == "async":
        est = eng.estimate_pose_collect(eng.estimate_pose_async(v), store_state=False)
        np.testing.assert_array_equal(est.angles_rad, eager_answers[0]["angles"])
    elif entry == "mesh":
        from mamri_tpu_torch.parallel import make_mesh, run_sharded_batched

        mesh = make_mesh(2, axes=("dp", "sp"), shape=(1, 2), devices=[torch.device("cpu")] * 2)
        out, _, certified = run_sharded_batched(eng, mesh, v.data[None], v.spacing, v.origin, sp_axis="sp")
        assert certified
        np.testing.assert_array_equal(out["angles"][0], eager_answers[0]["angles"])
    else:
        monkeypatch.setattr(E, "_graphs_run_on", lambda device: device.type == "cuda")
        for _ in range(3):
            est = eng.estimate_pose(v, store_state=False)
        np.testing.assert_array_equal(est.angles_rad, eager_answers[0]["angles"])
    assert not FakeGraph.made


def test_eviction_and_clear_caches_free_the_graphs(fake_card, scenes):
    """A key's graphs, static buffers and pool go with its LRU entry, at
    once: no reference cycle leaves them to the garbage collector, which
    could destroy a graph in the middle of another capture."""
    eng = E.MamriEngine(device="cpu", jit_cache_size=1)
    small = Volume(data=np.ascontiguousarray(scenes[0].data[:88, :88, :88]), spacing=scenes[0].spacing,
                   origin=scenes[0].origin)
    for v in (scenes[0], scenes[1]):
        eng.estimate_pose(v, store_state=False)
    captured = [g for g in FakeGraph.made]
    graphs = weakref.ref(_graphs(eng, scenes[0].shape))
    assert len(captured) == 3 and all(g() is not None for g in captured)
    eng.estimate_pose(small, store_state=False)  # evicts the first key
    assert graphs() is None and all(g() is None for g in captured)
    for _ in range(2):
        eng.estimate_pose(small, store_state=False)
    assert len(FakeGraph.made) == 6 and FakeGraph.made[-1]() is not None
    eng.clear_caches()
    assert all(g() is None for g in FakeGraph.made)


def test_capture_runs_with_the_garbage_collected_and_the_collector_off(fake_card, scenes):
    """Cyclic garbage is collected before a capture and the collector is off
    while the stages are captured (a graph destroyed then would end the
    capture), and on again after it."""
    eng = E.MamriEngine(device="cpu")
    eng.estimate_pose(scenes[0], store_state=False)

    class Cycle:
        def __init__(self):
            self.me = self

    dead = weakref.ref(Cycle())
    assert dead() is not None and gc.isenabled()
    eng.estimate_pose(scenes[1], store_state=False)
    assert dead() is None
    assert [g().collecting for g in FakeGraph.made] == [False] * 3
    assert gc.isenabled()


@pytest.mark.parametrize("keep_segmentation", [True, False])
def test_lock_is_held_until_the_last_fetch(fake_card, scenes, keep_segmentation):
    """The key's lock is held over every fetch of the call, the body mask's
    included, and released when the call returns."""
    eng = E.MamriEngine(device="cpu")
    for v in scenes[:2]:
        eng.estimate_pose(v, store_state=False)
    graphs = _graphs(eng, scenes[0].shape)
    held = []
    fetch = eng._fetch

    def spy(dev_out):
        held.append((sorted(dev_out), graphs.lock.locked()))
        return fetch(dev_out)

    eng._fetch = spy
    est = eng.estimate_pose(scenes[2], keep_segmentation=keep_segmentation)
    assert est.success
    assert [locked for _, locked in held] == [True] * (2 if keep_segmentation else 1)
    assert (held[-1][0] == ["body_mask"]) == keep_segmentation
    assert not graphs.lock.locked()


def test_two_threads_on_one_engine_get_their_own_answers(fake_card, scenes, eager_answers):
    """Two threads calling one engine through the same key's graphs, with
    the interpreter switching threads every 50 us, each get their own
    scan's answer on every call."""
    eng = E.MamriEngine(device="cpu")
    wrong, errors = [], []

    def worker(i):
        try:
            for _ in range(4):
                est = eng.estimate_pose(scenes[i], store_state=False, keep_segmentation=False)
                got = {"angles": est.angles_rad, "steps": est.steps, "base_tf": est.baseplate_tf}
                for key in got:
                    if not np.array_equal(got[key], eager_answers[i][key]):
                        wrong.append((i, key))
        except Exception as e:  # reported below, with the thread's scene
            errors.append((i, repr(e)))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(5e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors and not wrong, (errors, wrong)
    assert _graphs(eng, scenes[0].shape).calls == 2


def test_a_thread_captures_only_after_running_the_stages_eagerly(fake_card, scenes, eager_answers):
    """A key's second call captures, but in a thread that has not yet run
    the stages (a server's new request thread) it runs them eagerly first:
    cuBLAS handles and workspaces are made per thread, and not inside a
    capture. The answers stay the eager ones."""
    eng = E.MamriEngine(device="cpu", tracer=Tracer())
    _assert_same(_pose(eng, scenes[0]), eager_answers[0])
    before = _counts(eng.tracer)
    got = {}

    def second_call():
        est = eng.estimate_pose(scenes[1], store_state=False, keep_segmentation=False)
        got.update(angles=est.angles_rad, counts=tuple(a - b for a, b in zip(_counts(eng.tracer), before)))

    thread = threading.Thread(target=second_call)
    thread.start()
    thread.join(timeout=120)
    assert not thread.is_alive()
    np.testing.assert_array_equal(got["angles"], eager_answers[1]["angles"])
    assert got["counts"] == (3, 3, 3)
    assert {g().thread for g in FakeGraph.made} == {thread.ident}
    _assert_same(_pose(eng, scenes[2]), eager_answers[2])
    assert _counts(eng.tracer)[2] - before[2] == 6


def test_escalated_key_runs_eagerly_then_captures(fake_card, scenes, caplog):
    """Starved CCL sweeps escalate every call to a second key: each key's
    first call is eager and its second captures; the escalated key copies
    the first key's static scan into its own inputs; every answer equals
    an engine's without graphs."""
    params = SegmentationParams(max_sweeps=1, max_roots=128)
    want = E.MamriEngine(device="cpu", seg_params=params)
    eng = E.MamriEngine(device="cpu", seg_params=params, tracer=Tracer())
    for i in (0, 1, 2, 0):
        _assert_same(_pose(eng, scenes[i]), _pose(want, scenes[i]))
    assert any("escalation" in r.getMessage() for r in caplog.records)
    keys = list(eng._pipeline_cache._d)
    assert len(keys) == 2 and keys[0][1] == params
    first, escalated = (_graphs(eng, k[0], params=k[1]) for k in keys)
    assert first.calls == escalated.calls == 2
    assert escalated.inputs[0] is not first.inputs[0]
    assert torch.equal(escalated.inputs[0], first.inputs[0])
    assert eng.tracer.counters["pose.attempts"] == 8
    assert _counts(eng.tracer) == (6, 6, 18)


def test_int16_and_float32_scans_of_one_shape_have_their_own_graphs(fake_card, scenes):
    """A key keeps graphs per scan dtype: static inputs of the scan's own
    dtype, and an answer equal to the eager engine's for each."""
    eng = E.MamriEngine(device="cpu")
    want = E.MamriEngine(device="cpu")
    as_int16 = Volume(data=np.round(scenes[0].data).astype(np.int16), spacing=scenes[0].spacing,
                      origin=scenes[0].origin)
    for v in (scenes[0], as_int16) * 3:
        _assert_same(_pose(eng, v), _pose(want, v))
    f32, i16 = _graphs(eng, scenes[0].shape, torch.float32), _graphs(eng, scenes[0].shape, torch.int16)
    assert f32 is not i16
    assert f32.inputs[0].dtype == torch.float32 and i16.inputs[0].dtype == torch.int16


class _Library:
    """A kernel library whose every entry succeeds and runs nothing."""

    def __getattr__(self, entry):
        return lambda *args: 0


def test_replay_adds_the_captured_launches_and_counts(monkeypatch):
    """What a stage launches (`_build.launch`) and counts while captured is
    kept out of `_build.LAUNCHES` and the tracer, and added once for each
    replay: the counts stay those of launches that ran."""
    class _Stream:
        cuda_stream = None

    monkeypatch.setattr(E, "_CudaStageGraph", FakeGraph)
    monkeypatch.setattr(_build, "library", lambda: _Library())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())

    def stage(v):
        for _ in range(2):
            _build.launch("kabsch", "mamri_kabsch", v["data"].device)
            current_count("registration.kabsch_fused")
        return {"y": v["data"] * 2}

    pipeline = E._Pipeline((E._Stage("pose.segment", stage),), lambda v: {"y": v["y"]})
    graphs = pipeline.stage_graphs(torch.float32)
    tracer = Tracer()
    _build.reset_launch_counts()
    args = tuple(torch.full((2,), float(i)) for i in range(len(E.PIPELINE_ARGS)))
    with tracer.span("estimate_pose"):
        for k in range(4):
            before = (_build.LAUNCHES["kabsch"], tracer.counters.get("registration.kabsch_fused", 0))
            out = graphs.run(tuple(a + k for a in args))
            after = (_build.LAUNCHES["kabsch"], tracer.counters.get("registration.kabsch_fused", 0))
            assert torch.equal(out["y"], (args[0] + k) * 2)
            assert (after[0] - before[0], after[1] - before[1]) == (2, 2), k
    assert graphs._graphs[0][1] == {"kabsch": 2} and graphs._graphs[0][2] == {"registration.kabsch_fused": 2}
    assert _counts(tracer) == (1, 1, 3)


def test_restart_guesses_are_drawn_once_and_equal_a_fresh_draw(monkeypatch, scenes):
    """The engine's restart guesses are `random_restart_guesses(model,
    count, 0)` bit for bit, made once per count (none for no restarts); the
    pose IK uses them, so a pose equals one whose IK draws its own; the
    model's limit rows are its limits, transposed."""
    eng = E.MamriEngine(device="cpu", ik_restarts=2)
    got = eng._restart_guesses(2)
    assert torch.equal(got, random_restart_guesses(eng.model, 2, 0))
    assert eng._restart_guesses(2) is got and eng._restart_guesses(0) is None
    assert torch.equal(eng._restart_guesses(5), random_restart_guesses(eng.model, 5, 0))
    assert torch.equal(eng.model.limit_rows, eng.model.limits_rad.T)
    want = _pose(eng, scenes[1])
    solve = E.solve_full_chain_ik
    used = []

    def own_draws(*args, restart_guesses=None, **kw):
        used.append(restart_guesses)
        return solve(*args, **kw)

    monkeypatch.setattr(E, "solve_full_chain_ik", own_draws)
    drawing = E.MamriEngine(device="cpu", ik_restarts=2)
    _assert_same(_pose(drawing, scenes[1]), want)
    assert len(used) == 1 and torch.equal(used[0], got)

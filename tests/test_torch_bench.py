"""bench_torch.py, the port's counterpart of bench.py, on the CPU at 96^3.

One module-scoped `bench_torch.run(device="cpu", size=96, batch=1, reps=1,
stream_frames=1, large="128x128x48", chain_k=1, chain_samples=1,
plan_reps=1)` is shared by the tests (128x128x48 keeps bench.py's
512x512x192 ratio of z to x and y). bench.py itself is never run here: on
this CPU it takes minutes, most of them compiling; the reference values come
from one call of `mamri_tpu`'s pipeline and one of its `segment_volume`.

At 96^3 (4.79 mm voxels) bench.py's own run on the CPU (`BENCH_SIZE=96
BENCH_BATCH=2 BENCH_REPS=1 BENCH_STREAM_FRAMES=2 BENCH_LARGE=off`) gives, for
all 4 scenes, `certified` true, `escalated` false, `passes` 3 and `solved`
FALSE (`rmse_mm` 0.1886 / 0.515 / 0.6999 / 0.6529, `tcp_err_mm` 3.5443 /
2.202 / 2.541 / 5.2259: over the 2.0 mm limit at this voxel size);
`streaming.all_success` true with no ROI fallback;
`planning.success_collision_free` true; and a noisy scan of 1482 speckle
components that is NOT certified (`certified_no_truncation` and `success`
false). The port's record is held to exactly these flags and counts.
"""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_engine import _one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 96
LARGE = (128, 128, 48)


@pytest.fixture(scope="module")
def record():
    import bench_torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # module fixtures run before the autouse one
    try:
        return bench_torch.run("cpu", size=SIZE, batch=1, reps=1, stream_frames=1,
                               large="x".join(map(str, LARGE)), chain_k=1, chain_samples=1, plan_reps=1)
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def scenes():
    import bench_torch
    from mamri_tpu_torch.core.robot import load_robot_model

    return bench_torch.build_scenes(load_robot_model(device="cpu"), SIZE)


def _bench_py_record_tree():
    """The key tree of the record bench.py prints: its `json.dumps` dict
    literal, with `per_scene` as a list of its `per_scene.append` literal and
    `large_volume` as its `large = {...}` literal."""
    tree = ast.parse(open(os.path.join(REPO, "bench.py")).read())
    found = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            if node.func.attr == "dumps":
                found["record"] = node.args[0]
            elif node.func.attr == "append" and getattr(node.func.value, "id", None) == "per_scene":
                found["per_scene"] = node.args[0]
        elif isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict):
            if any(isinstance(t, ast.Name) and t.id == "large" for t in node.targets):
                found["large"] = node.value

    def keys(d):
        out = {}
        for k, v in zip(d.keys, d.values):
            if isinstance(v, ast.Dict):
                out[k.value] = keys(v)
            elif isinstance(v, ast.Name) and v.id == "per_scene":
                out[k.value] = [keys(found["per_scene"])]
            elif isinstance(v, ast.Name) and v.id == "large":
                out[k.value] = keys(found["large"])
            else:
                out[k.value] = None
        return out

    return keys(found["record"])


def _tree(v):
    if isinstance(v, dict):
        return {k: _tree(x) for k, x in v.items()}
    if isinstance(v, list) and v and all(isinstance(x, dict) for x in v):
        return [_tree(x) for x in v]
    return None


def test_record_has_bench_py_keys_and_no_nan(record):
    want = _bench_py_record_tree()
    got = _tree(record)
    assert len(record["per_scene"]) == 4
    assert got["per_scene"] == want["per_scene"] * 4
    assert got == {**want, "per_scene": want["per_scene"] * 4}
    json.dumps(record, allow_nan=False)  # raises on a NaN or an infinity
    assert record["vs_baseline"] is None and record["device"] == "cpu" and record["volume"] == f"{SIZE}^3"


def test_record_flags_match_the_reference_at_96(record):
    """The flags and counts of bench.py's own 96^3 run (module docstring)."""
    for s in record["per_scene"]:
        assert (s["certified"], s["escalated"], s["passes"], s["solved"]) == (True, False, 3, False), s
    assert record["pipeline_success"] is False
    st = record["streaming"]
    assert st["all_success"] and st["failed_modes"] == [] and st["roi_fallbacks"] == 0
    assert st["roi_frames"] == st["frames"] + 1  # the window's first frame, then every timed one
    assert record["planning"]["success_collision_free"] is True
    noisy = record["noisy_scan"]
    assert noisy["speckle_components"] == 1482
    assert noisy["certified_no_truncation"] is False and noisy["success"] is False
    assert record["large_volume"]["shape"] == "x".join(map(str, LARGE))


def _bench_py_noisy(data, SIZE):
    """bench.py:396-406, verbatim but for `vols[0].data` -> `data`."""
    rng = np.random.default_rng(5)
    noisy = np.array(data, copy=True)
    n_speckle = 1500
    idx = rng.integers(2, SIZE - 2, size=(n_speckle, 3))
    bright = noisy > 60.0
    for i, j, k in idx:
        if not bright[i - 2 : i + 3, j - 2 : j + 3, k - 2 : k + 3].any():
            noisy[i, j, k] = 100.0
    noisy = noisy + rng.normal(0.0, 5.0, noisy.shape).astype(np.float32)
    return noisy


def test_noisy_volume_bit_equal_to_bench_py(scenes):
    import bench_torch

    data = np.asarray(scenes[4][0].data)
    got = bench_torch.noisy_volume(data, SIZE)
    want = _bench_py_noisy(data, SIZE)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_noisy_components_equal_the_reference(record, scenes):
    """`speckle_components` is `mamri_tpu`'s `num_components` of the same
    noisy array at the same settings."""
    import jax
    import jax.numpy as jnp

    import bench_torch
    from mamri_tpu.perception.segmentation import SegmentationParams, segment_volume

    _, spacing, origin, _, vols = scenes
    noisy = bench_torch.noisy_volume(vols[0].data, SIZE)
    params = SegmentationParams(max_sweeps=2, passes=3, max_roots=4096, cand_k=64, run_k=8)
    seg = jax.jit(lambda d: segment_volume(d, jnp.asarray(spacing), jnp.asarray(origin), params))(jnp.asarray(noisy))
    assert record["noisy_scan"]["speckle_components"] == int(seg.num_components)


def test_large_spacing_is_bench_py_formula(scenes):
    import bench_torch

    spacing = scenes[1]
    got = bench_torch.large_spacing(spacing, SIZE, LARGE)
    extent = spacing * SIZE  # bench.py:459-460
    want = (extent / np.asarray(LARGE)).astype(np.float32)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32
    # the cube of the grid's largest extent, not the box's own extents per axis
    assert got[0] == got[1] != got[2]


def test_fb_rows_equal_estimate_pose(scenes):
    """The batched function's rows are `estimate_pose` of each volume, bit
    for bit (a fresh pose state for each: no saved baseplate, zero angles)."""
    import bench_torch
    from mamri_tpu_torch.api.engine import MamriEngine

    _, spacing, origin, _, vols = scenes
    engine = MamriEngine(device="cpu")
    fb, _ = bench_torch.make_fns(engine, vols[0].shape, spacing, origin, engine.seg_params)
    out = engine._fetch(fb(torch.from_numpy(np.stack([vols[0].data, vols[1].data]))))
    for row in range(2):
        engine.current_angles = np.zeros(6, np.float32)
        engine.estimate_pose(vols[row])
        for k in bench_torch.KEEP:
            np.testing.assert_array_equal(out[k][row], engine.last_segmentation[k], err_msg=f"row {row} {k}")


def test_scene0_matches_the_reference(record, scenes):
    """Scene 0's flags equal `mamri_tpu`'s, its RMSE within 1e-3 mm and TCP
    error within 1e-2 mm: one call of the reference's pipeline on the CPU
    with bench.py's fixed arguments (bench.py:161-173), judged as bench.py
    judges it (:218-225). It certifies at the defaults, so no escalation."""
    import jax
    import jax.numpy as jnp

    from mamri_tpu.api import MamriEngine as JaxEngine
    from mamri_tpu.core.robot import fk_all_links

    scene_list, spacing, origin, _, vols = scenes
    true_angles, base, _ = scene_list[0]
    ref = JaxEngine()
    pipeline = ref.pipeline_fn(ref.seg_params)

    def one(d):
        return pipeline(d, jnp.asarray(spacing), jnp.asarray(origin), jnp.eye(4, dtype=jnp.float32),
                        jnp.asarray(False), jnp.asarray(False), jnp.asarray(False),
                        jnp.zeros(ref.model.num_joints, dtype=jnp.float32))

    res = jax.device_get(jax.jit(one)(jnp.asarray(vols[0].data)))
    certified = bool(res["seg_converged"] and res["roots_complete"] and res["blobs_complete"])
    est = np.asarray(res["angles"])
    err_deg = np.degrees(np.abs(est - true_angles))

    def tcp(a):
        return np.asarray(fk_all_links(ref.model, jnp.asarray(a), jnp.asarray(base)))[-1][:3, 3]

    tcp_err = float(np.linalg.norm(tcp(true_angles) - tcp(est)))
    rmse = float(res["rmse"])
    solved = bool(bool(res["success"]) and certified and rmse < 1.5 and tcp_err < 2.0 and err_deg[0] < 1.5)
    got = record["per_scene"][0]
    assert (got["certified"], got["escalated"], got["passes"], got["solved"]) == (certified, False, 3, solved)
    assert got["rmse_mm"] == pytest.approx(rmse, abs=1e-3)
    assert got["tcp_err_mm"] == pytest.approx(tcp_err, abs=1e-2)


def test_failed_pose_gives_planning_nones():
    """A scan with no markers: the pose fails, the planning block is skipped
    (bench.py:372-375) and its times are None, valid JSON."""
    import bench_torch
    from mamri_tpu_torch.api.engine import MamriEngine
    from mamri_tpu_torch.perception.volume import Volume

    empty = Volume(np.zeros((48, 48, 48), np.float32), np.full(3, 4.0, np.float32), np.zeros(3, np.float32))
    block = bench_torch.planning(MamriEngine(device="cpu"), empty, np.zeros(3, np.float32), 1)
    assert json.loads(json.dumps(block, allow_nan=False)) == block
    assert block["entry_search_p50_ms"] is None and block["heuristic_path_p50_ms"] is None
    assert block["safety_sweep8_p50_ms"] is None and block["success_collision_free"] is False
    assert set(block) == set(_bench_py_record_tree()["planning"])


def test_main_without_a_card_exits_1(capsys):
    import bench_torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: main([]) would run the bench on it")
    assert bench_torch.main([]) == 1
    out, err = capsys.readouterr()
    assert out == "" and "--cpu" in err


def test_main_reads_bench_py_environment(monkeypatch, capsys):
    """`main` passes bench.py's environment (and its defaults) to `run` and
    prints its record as one JSON line."""
    import bench_torch

    seen = []
    monkeypatch.setattr(bench_torch, "run", lambda device, **kw: seen.append((device, kw)) or {"value": 1.0})
    for k in ("BENCH_BATCH", "BENCH_SIZE", "BENCH_REPS", "BENCH_STREAM_FRAMES", "BENCH_LARGE"):
        monkeypatch.delenv(k, raising=False)
    assert bench_torch.main(["--cpu"]) == 0
    monkeypatch.setenv("BENCH_SIZE", "64")
    monkeypatch.setenv("BENCH_LARGE", "off")
    assert bench_torch.main(["--cpu"]) == 0
    assert seen == [
        ("cpu", dict(size=256, batch=16, reps=5, stream_frames=12, large="512x512x192")),
        ("cpu", dict(size=64, batch=16, reps=5, stream_frames=12, large="off")),
    ]
    assert capsys.readouterr().out.splitlines() == ['{"value": 1.0}'] * 2


_NO_JAX = r"""
import sys
sys.modules["jax"] = None
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(1)
import bench_torch
from mamri_tpu_torch.api.engine import MamriEngine
engine = MamriEngine(device="cpu")
scenes, spacing, origin, body, vols = bench_torch.build_scenes(engine.model, 32)
fb, f1 = bench_torch.make_fns(engine, vols[0].shape, spacing, origin, engine.seg_params)
out = engine._fetch(fb(bench_torch.device_batch(engine, vols[0].data, 2)))
assert out["angles"].shape == (2, 6)
bench_torch.noisy_volume(vols[0].data, 32)
bench_torch.large_spacing(spacing, 32, (48, 48, 16))
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("mamri_tpu", "jax", "bench") and sys.modules[m] is not None)
print("LOADED", bad)
"""


def test_bench_torch_loads_neither_jax_nor_mamri_tpu():
    out = subprocess.run([sys.executable, "-c", _NO_JAX, REPO], capture_output=True, text=True, timeout=300,
                         cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout, out.stdout[-2000:]

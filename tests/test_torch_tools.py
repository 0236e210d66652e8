"""The port's tools (`tools/*_torch.py`) on the CPU at small sizes.

Each tool's `main(argv)` runs with `--cpu` and writes the reference tool's
record: the same JSON keys (read from the committed IK_ORACLE.json and
SOAK_r05.json, or from the reference tool's source) and no failure. The
oracle's bench_scene_0 and bench_scene_1 rows are held to the committed
IK_ORACLE.json (TRF from the truth within 0.01 deg, the port's LM within
0.05 deg of its own TRF from the truth), the shared scene builder to
`bench._build_scenes`, the batch hook's rows to single `estimate_pose`
calls, the codec bench to the reference's codecs, and a subprocess with
jax unimportable runs the tools' code paths without loading `mamri_tpu`,
`jax` or `bench`.
"""

import ast
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_engine import _one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = ("ik_oracle", "soak", "soak_supervised", "batch_scaling", "profile_stages", "codec_bench")


def _tool(name):
    """tools/<name>.py as a module (tools/ is not a package)."""
    path = os.path.join(REPO, "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"tool_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _record_keys(tool, var):
    """The keys the reference tool gives its record `var`: a dict literal
    assigned to it, constant subscripts of it and keywords of its update."""
    tree = ast.parse(open(os.path.join(REPO, "tools", f"{tool}.py")).read())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(isinstance(t, ast.Name) and t.id == var for t in node.targets):
            if isinstance(node.value, ast.Dict):
                keys |= {k.value for k in node.value.keys}
        elif isinstance(node, ast.Subscript) and isinstance(node.value, ast.Name) and node.value.id == var:
            if isinstance(node.slice, ast.Constant):
                keys.add(node.slice.value)
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) and node.func.attr == "update"
              and isinstance(node.func.value, ast.Name) and node.func.value.id == var):
            keys |= {kw.arg for kw in node.keywords}
    return keys


def _key_tree(d):
    """{key: subtree} of nested dicts, leaves None."""
    return {k: _key_tree(v) if isinstance(v, dict) else None for k, v in d.items()}


def test_bench_scenes_match_bench_py():
    import bench
    from mamri_tpu.api import MamriEngine as JaxEngine
    from mamri_tpu_torch.api.demo import bench_scenes
    from mamri_tpu_torch.core.robot import load_robot_model

    want, w_spacing, w_origin, w_body = bench._build_scenes(JaxEngine())
    got, spacing, origin, body = bench_scenes(load_robot_model(device="cpu"), bench.SIZE)
    np.testing.assert_array_equal(spacing, w_spacing)
    np.testing.assert_array_equal(origin, w_origin)
    np.testing.assert_array_equal(body, w_body)
    assert len(got) == len(want) == 4
    for (a, b, p), (wa, wb, wp) in zip(got, want):
        np.testing.assert_array_equal(a, wa)
        np.testing.assert_allclose(b, wb, rtol=0, atol=1e-6)  # one float32 rounding of the product
        np.testing.assert_allclose(p, wp, rtol=0, atol=1e-4)


def test_ik_oracle_tool(tmp_path):
    committed = json.load(open(os.path.join(REPO, "IK_ORACLE.json")))
    out = tmp_path / "oracle.json"
    assert _tool("ik_oracle_torch").main(["--cpu", "--scenes", "2", "--out", str(out)]) == 0
    got = json.load(open(out))
    assert set(got) == set(committed)
    assert [r["scene"] for r in got["scenes"]] == ["bench_scene_0", "bench_scene_1"]
    for row, want in zip(got["scenes"], committed["scenes"]):
        assert _key_tree(row) == _key_tree(want)
        assert abs(row["trf_from_truth"]["max_err_deg"] - want["trf_from_truth"]["max_err_deg"]) <= 0.01
    assert got["lm_cost_le_trf_cost_everywhere"]


def test_ik_oracle_lm_meets_trf_from_truth():
    """The port's LM within 0.05 deg of its own converged TRF from the truth,
    joint by joint, on the bench scenes."""
    _, lm_vs_trf = _tool("ik_oracle_torch").run_oracle("cpu", scenes=2, log=open(os.devnull, "w"))
    assert sorted(lm_vs_trf) == ["bench_scene_0", "bench_scene_1"]
    assert max(lm_vs_trf.values()) < 0.05, lm_vs_trf


def test_soak_tool(tmp_path):
    out = tmp_path / "soak.json"
    rc = _tool("soak_torch").main(["--cpu", "--size", "96", "--frames", "3", "--noisy-every", "2",
                                   "--alt-every", "3", "--out", str(out)])
    got = json.loads(out.read_text())
    assert set(got) == _record_keys("soak", "result")
    assert rc == 0 and got["failures"] == 0 and got["all_success"]
    assert got["kinds"] == {"clean": 1, "noisy": 1, "alt": 1}
    assert got["pipeline_cache_entries"] >= 2  # the two shapes (and the noisy frame's escalation)


@pytest.fixture(scope="module")
def soak_frames_128():
    """The soak's 4 clean frames at 128^3 (3.6 mm voxels), their true
    angles, and `mamri_tpu`'s `estimate_pose` of each on the CPU."""
    from mamri_tpu.api import MamriEngine as JaxEngine
    from mamri_tpu.perception.volume import Volume as JaxVolume
    from mamri_tpu_torch.api.demo import bench_scenes
    from mamri_tpu_torch.core.robot import load_robot_model

    model = load_robot_model(device="cpu")
    vols = _tool("soak_torch").soak_volumes(model, 128)[0]["clean"]
    truths = [s[0] for s in bench_scenes(model, 128)[0]]
    ref = JaxEngine()
    want = [ref.estimate_pose(JaxVolume(v.data, v.spacing, v.origin), store_state=False) for v in vols]
    return vols, truths, want


@pytest.mark.parametrize("scene", range(4))
def test_soak_frames_at_128_match_the_reference(soak_frames_128, scene):
    """At 128^3 the port's pose is `mamri_tpu`'s on the same frame, so its
    error against the true J1 (over 1 deg on two scenes at this size: the
    reason the soak runs at 192^3) is the grid's, not the port's."""
    from mamri_tpu_torch.api.engine import MamriEngine

    vols, truths, want = soak_frames_128
    got = MamriEngine(device="cpu").estimate_pose(vols[scene], store_state=False)
    ref = want[scene]
    j1 = [float(np.degrees(abs(r.angles_rad[0] - truths[scene][0]))) for r in (got, ref)]
    print(f"soak frame {scene} at 128^3: |J1 - truth| port {j1[0]:.4f} deg, mamri_tpu {j1[1]:.4f} deg")
    assert got.success and ref.success
    assert got.markers_found == ref.markers_found
    np.testing.assert_allclose(got.angles_rad, np.asarray(ref.angles_rad), rtol=0, atol=1e-3)
    assert got.rmse_mm == pytest.approx(ref.rmse_mm, abs=1e-3)


def test_soak_supervised_tool_one_recycle(tmp_path):
    """One recycle on the CPU: the budget sits below the first worker's warm
    RSS, so a worker drains after its first frame and the supervisor starts
    another; the run counts that generation with no failed frame."""
    committed = json.load(open(os.path.join(REPO, "SOAK_r05.json")))
    out = tmp_path / "sup.json"
    _tool("soak_supervised_torch").main(["--cpu", "--size", "80", "--generations", "1",
                                         "--budget-headroom-mb", "-100", "--out", str(out)])
    got = json.loads(out.read_text())
    assert set(got) == set(committed)
    assert got["generations"] == 1 and got["failures"] == 0 and got["frames"] >= 1
    assert got["budget_mb"] == pytest.approx(got["base_rss_mb"] - 100, abs=0.2)


def test_batch_scaling_tool(capsys):
    rc = _tool("batch_scaling_torch").main(["--cpu", "--volume", "96", "--sizes", "1,2", "--micro", "0,1",
                                            "--reps", "1"])
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert rc == 0 and [(r["batch"], r["microbatch"]) for r in recs] == [(1, 0), (2, 1)]
    assert set(recs[0]) == _record_keys("batch_scaling", "rec")
    assert set(recs[1]) == _record_keys("batch_scaling", "rec") - {"h2d_i16_s", "int16_matches"}
    assert all(r["success"] and r["certified"] for r in recs) and recs[0]["int16_matches"]


def test_batch_hook_rows_equal_single_calls():
    """`MamriEngine._get_batch_pipeline` on a device-resident batch: each row
    is `estimate_pose` of its volume, bit for bit."""
    from mamri_tpu_torch.api.demo import bench_scenes, render_bench_scene
    from mamri_tpu_torch.api.engine import MamriEngine

    engine = MamriEngine(device="cpu")
    scenes, spacing, origin, body = bench_scenes(engine.model, 96)
    vols = [render_bench_scene(p, (96,) * 3, spacing, origin, body) for _, _, p in scenes[:2]]
    fn = engine._get_batch_pipeline(vols[0].shape, engine.seg_params, 1)
    out = fn(torch.from_numpy(np.stack([v.data for v in vols])), spacing, origin)
    for row, vol in enumerate(vols):
        single = engine.estimate_pose(vol, store_state=False)
        np.testing.assert_array_equal(out["angles"][row], single.angles_rad)
        np.testing.assert_array_equal(out["steps"][row], single.steps)
    with pytest.raises(ValueError, match="microbatch"):
        engine._get_batch_pipeline(vols[0].shape, engine.seg_params, 2)(
            torch.zeros((3,) + vols[0].shape), spacing, origin)


def test_profile_stages_tool(capsys):
    assert _tool("profile_stages_torch").main(["32", "--cpu", "--reps", "1"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("profile_stages 32^3 on cpu")
    names = [line.rsplit(None, 2)[0] for line in lines[1:]]
    assert names == ["close_init", "reset_distances (x, y, z)", "ccl sweeps (2)", "ccl_check_consistency (y, z, x)",
                     "z_runs (+ root candidates)", "run_stats R=128", "run_stats R=2048"]
    assert all(float(line.split()[-2]) >= 0 for line in lines[1:])


def test_codec_bench_tool(capsys):
    """The reference's codecs and record keys (read from tools/codec_bench.py:
    its `report("name", ...)` calls). The reference tool itself is not run:
    its native build races other workers' (ROADMAP C, hazards)."""
    assert _tool("codec_bench_torch").main(["--size", "32", "--reps", "1"]) == 0
    got = json.loads(capsys.readouterr().out)
    tree = ast.parse(open(os.path.join(REPO, "tools", "codec_bench.py")).read())
    names = {node.args[0].value for node in ast.walk(tree) if isinstance(node, ast.Call)
             and isinstance(node.func, ast.Name) and node.func.id == "report"}
    assert set(got) == {"size", "native_available", "codecs"} and got["size"] == "32^2"
    assert set(got["codecs"]) == names
    for c in got["codecs"].values():
        assert set(c) == {"encode_ms", "decode_ms", "ratio", "lossless", "decode_slices_per_s"}
        assert c["ratio"] > 1.0 and c["decode_ms"] >= 0


_NO_JAX = r"""
import importlib.util, os, sys
sys.modules["jax"] = None
repo = sys.argv[1]
sys.path.insert(0, repo)
import torch
torch.set_num_threads(1)
mods = {}
for name in %r:
    spec = importlib.util.spec_from_file_location(name, os.path.join(repo, "tools", name + "_torch.py"))
    mods[name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mods[name])
from mamri_tpu_torch.core.robot import load_robot_model
model = load_robot_model(device="cpu")
mods["ik_oracle"].run_oracle("cpu", scenes=1, log=open(os.devnull, "w"))
mods["soak"].soak_volumes(model, 32)
mods["batch_scaling"].bench_batch_volume(model, 32)
mods["profile_stages"].run_stages(torch.from_numpy(mods["profile_stages"].profile_scene(32)), reps=1)
mods["codec_bench"].main(["--size", "16", "--reps", "1"])
from mamri_tpu_torch.api.demo import build_demo_scene
from mamri_tpu_torch.api.engine import MamriEngine
from mamri_tpu_torch.perception.io import save_nifti
from mamri_tpu_torch.api.streaming import PoseTracker
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("mamri_tpu", "jax", "bench") and sys.modules[m] is not None)
print("LOADED", bad)
"""


def test_tools_load_neither_jax_nor_mamri_tpu():
    out = subprocess.run([sys.executable, "-c", _NO_JAX % (TOOLS,), REPO], capture_output=True, text=True,
                         timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout, out.stdout[-2000:]

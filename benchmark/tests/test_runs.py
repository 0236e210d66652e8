"""Whole runs of the harness: on the CPU at small sizes (the command line
refuses the CPU), with the timed path sound and with it broken, a cell
added by files alone, and the refusals."""

import json
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest

from benchmark import run as bench
from benchmark.control import readings
from benchmark.lib.common import forbidden_modules

from .conftest import SMALL

CELLS = ["bench256.pose", "clinical512.plan", "clinical512.stream", "bench256.batch"]
SEED = 2 ** 31 + 7  # a run's seed may pass 32 signed bits


@pytest.fixture(scope="module")
def every_cell(root, tmp_path_factory):
    """A copy of the benchmark whose BENCHMARK.json lists every workload
    file, those left out of the benchmark (with their metrics) too."""
    dest = tmp_path_factory.mktemp("every_cell")
    _copy_benchmark(root, dest)
    with open(dest / "BENCHMARK.json") as f:
        manifest = json.load(f)
    listed = {w["name"] for w in manifest["workloads"]}
    for name in sorted(os.listdir(dest / "benchmark" / "workloads")):
        cell = name[:-len(".json")]
        if cell not in listed:
            config, traffic = cell.split(".", 1)
            manifest["workloads"].append({"name": cell, "config": config, "traffic": traffic, "chips": 1,
                                          "why": "left out of the benchmark"})
    for m in manifest["end_to_end"]:
        m.pop("workloads", None)
    (dest / "BENCHMARK.json").write_text(json.dumps(manifest))
    return str(dest)


def _run(root, cell, seconds=1.0, seed=SEED):
    config = cell.split(".")[0]
    result, checks = bench.run_cell(root, cell, seed, seconds, False, device="cpu", overrides=SMALL[config])
    return result


def _cells(root):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(every_cell, cell):
    result = _run(every_cell, cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks" and "setup_s" in result["metrics"]


def _alter_pose(engine_cls, monkeypatch):
    orig = engine_cls.estimate_pose

    def altered(self, *a, **k):
        est = orig(self, *a, **k)
        est.angles_rad = est.angles_rad + np.array([0.0, 0.01, 0.0, 0.0, 0.0, 0.0], np.float32)
        return est

    monkeypatch.setattr(engine_cls, "estimate_pose", altered)


def _stale_tracker(monkeypatch):
    from mamri_tpu_torch.api.streaming import PoseTracker

    orig = PoseTracker.step

    def stale(self, volume):
        if self.last_estimate is not None and self.frames >= 3:
            self.frames += 1
            return self.last_estimate  # the state returned unchanged
        return orig(self, volume)

    monkeypatch.setattr(PoseTracker, "step", stale)


def _late_tracker(monkeypatch):
    from mamri_tpu_torch.api.streaming import PoseTracker

    orig = PoseTracker.step

    def late(self, volume):
        previous = self.last_estimate
        est = orig(self, volume)
        return est if previous is None else previous  # each frame answered with the one before it

    monkeypatch.setattr(PoseTracker, "step", late)


def _half_batch(engine_cls, monkeypatch):
    orig = engine_cls.estimate_pose_batch

    def half(self, data, spacing, origin, **k):
        n = len(data) // 2
        out = orig(self, data[:n], spacing, origin, **k)
        return {key: np.concatenate([v, v]) for key, v in out.items()}  # the rest left out

    monkeypatch.setattr(engine_cls, "estimate_pose_batch", half)


def _alter_plan(engine_cls, monkeypatch):
    orig = engine_cls.plan_heuristic_path

    def altered(self, *a, **k):
        plan = orig(self, *a, **k)
        if plan.goal_angles is not None:
            plan.goal_angles = plan.goal_angles + np.array([0.01, 0, 0, 0, 0, 0], np.float32)
        return plan

    monkeypatch.setattr(engine_cls, "plan_heuristic_path", altered)


@pytest.mark.parametrize("cell,fault", [("bench256.pose", "answer"), ("clinical512.stream", "stale"),
                                        ("clinical512.stream", "late"), ("bench256.batch", "half"),
                                        ("clinical512.plan", "answer")])
def test_broken_path_is_not_correct(every_cell, cell, fault, monkeypatch):
    from mamri_tpu_torch.api.engine import MamriEngine

    if fault == "stale":
        _stale_tracker(monkeypatch)
    elif fault == "late":
        _late_tracker(monkeypatch)
    elif fault == "half":
        _half_batch(MamriEngine, monkeypatch)
    elif cell.endswith(".plan"):
        _alter_plan(MamriEngine, monkeypatch)
    else:
        _alter_pose(MamriEngine, monkeypatch)
    result = _run(every_cell, cell, seconds=3.0)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(every_cell, cell):
    """The reference in bfloat16 in the program's place fails the limits."""
    with open(os.path.join(every_cell, "benchmark", "workloads", cell + ".json")) as f:
        limits = json.load(f)["limits"]
    (_, numbers), = readings(every_cell, cell, [SEED], "control", calls=2, device="cpu",
                             overrides=SMALL[cell.split(".")[0]])
    assert any(v > limits.get(k, -1) for k, v in numbers.items()), numbers


def _copy_benchmark(root, dest):
    shutil.copy(os.path.join(root, "BENCHMARK.json"), dest)
    shutil.copytree(os.path.join(root, "benchmark"), os.path.join(dest, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))


def test_a_cell_added_by_files_alone(root, tmp_path):
    _copy_benchmark(root, tmp_path)
    with open(tmp_path / "BENCHMARK.json") as f:
        manifest = json.load(f)
    with open(tmp_path / "benchmark" / "workloads" / "bench256.pose.json") as f:
        wl = json.load(f)
    wl["params"]["trace_calls"] = 2
    (tmp_path / "benchmark" / "workloads" / "bench256.pose_again.json").write_text(json.dumps(wl))
    (tmp_path / "benchmark" / "metrics" / "calls_seen.py").write_text(
        "def read(run):\n    return float(len(run.records))\n")
    manifest["workloads"].append({"name": "bench256.pose_again", "config": "bench256", "traffic": "pose_again",
                                  "chips": 1, "why": "a second pose mix"})
    moves = next(m["name"] for m in manifest["end_to_end"] if m["name"] != "setup_s"
                 and "bench256.pose" in m.get("workloads", []))
    for m in manifest["end_to_end"]:
        if "bench256.pose" in m.get("workloads", []):
            m["workloads"].append("bench256.pose_again")
    manifest["per_layer"].append({"name": "calls_seen", "unit": "calls", "better": "higher", "source": "host_clock",
                                  "layer": "api.engine", "moves": moves, "workloads": ["bench256.pose_again"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    _, entry, config, workload, driver = bench.resolve(str(tmp_path), "bench256.pose_again")
    assert entry["config"] == "bench256" and workload["params"]["trace_calls"] == 2
    assert [m["name"] for m in bench.reported(manifest, "bench256.pose_again", True)] == ["calls_seen"]
    result, _ = bench.run_cell(str(tmp_path), "bench256.pose_again", SEED, 1.0, True, device="cpu",
                               overrides=SMALL["bench256"])
    assert result["metrics"]["calls_seen"]["value"] == 2.0


def _command(args, cwd, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py"] + args, cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_no_card_no_result(root):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _command(["--workload", "bench256.pose", "--seed", "1", "--seconds", "1", "--trace", "0"], root, env)
    assert out.returncode != 0 and "{" not in out.stdout
    assert "CUDA" in out.stderr


def test_benchmark_alone_gives_no_result(root, tmp_path):
    _copy_benchmark(root, tmp_path)
    out = _command(["--workload", "bench256.pose", "--seed", "1", "--seconds", "1", "--trace", "0"], tmp_path)
    assert out.returncode != 0 and "{" not in out.stdout


def test_a_limit_without_its_number_is_not_correct():
    from benchmark.lib.judge import verdict

    assert verdict({"count_off": 0, "mask_off_vox": 0}, {"count_off": 0, "mask_off_vox": 0})[0]
    ok, checks = verdict({"count_off": 0}, {"count_off": 0, "mask_off_vox": 0})
    assert not ok and checks["mask_off_vox"] == {"value": None, "limit": 0}
    assert not verdict({"count_off": 0, "extra": 0.0}, {"count_off": 0})[0]


def test_guard_compares_whole_top_level_names(monkeypatch):
    assert "mamri_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "mamri_tpu_torch_like", types.ModuleType("mamri_tpu_torch_like"))
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "mamri_tpu.api", types.ModuleType("mamri_tpu.api"))
    assert forbidden_modules() == ["mamri_tpu"]
    with pytest.raises(bench.Refused):
        bench.guard("test")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(root, card, cell):
    """One short run of each cell on the card, from the command line."""
    if cell not in _cells(root):
        pytest.skip(f"{cell} is not in BENCHMARK.json")
    out = _command(["--workload", cell, "--seed", str(SEED), "--seconds", "3", "--trace", "0"], root)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["kind"] == card


def test_reference_imports_nothing_of_the_program(root):
    code = ("import sys; sys.path.insert(0, %r); import benchmark.lib.judge, benchmark.lib.reference, "
            "benchmark.lib.scenes; bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'mamri_tpu', 'mamri_tpu_torch'}); print(bad)") % root
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr

"""BENCHMARK.json against the benchmark's contract, and every file a cell
needs found by name."""

import json
import os
import re

import pytest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|_rank$|head|expansion|per_tok)")


@pytest.fixture(scope="module")
def manifest(root):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_shape_and_names(manifest, root):
    assert set(manifest) == TOP_KEYS
    assert os.path.getsize(os.path.join(root, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(manifest["command"]) <= 32 and all(_line(w) for w in manifest["command"])
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/") and ".." not in p
        assert not p.rstrip("/").endswith("_torch") and os.path.isdir(os.path.join(root, p))
    for word in manifest["command"][1:]:
        if os.sep in word or word.endswith(".py"):
            assert any(word.startswith(p.rstrip("/") + "/") for p in manifest["paths"]), word
    names = {}
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in manifest[group]:
            assert NAME.match(entry["name"]), entry["name"]
            kind = "metric" if group in ("end_to_end", "per_layer") else group
            assert (kind, entry["name"]) not in names
            names[(kind, entry["name"])] = entry
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_configs(manifest, root):
    assert 1 <= len(manifest["configs"]) <= 24
    used = {w["config"] for w in manifest["workloads"]}
    files = set()
    for c in manifest["configs"]:
        assert set(c) == CONFIG_KEYS and c["name"] in used
        assert c["source"].startswith("https://") and _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p.rstrip("/") + "/") for p in manifest["paths"])
        assert c["file"] not in files and os.path.isfile(os.path.join(root, c["file"]))
        files.add(c["file"])
        assert len(c["reduced"]) <= 16 and not any(WIDTH.search(k) for k in c["reduced"])
        assert all(NAME.match(k) for k in c["reduced"])


def test_cells_find_their_files(manifest, root):
    assert 1 <= len(manifest["workloads"]) <= 24
    pairs = set()
    for w in manifest["workloads"]:
        assert set(w) == CELL_KEYS and w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["traffic"]) and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        with open(os.path.join(root, "benchmark", "workloads", w["name"] + ".json")) as f:
            wl = json.load(f)
        assert {"driver", "params", "limits", "why"} <= set(wl)
        assert os.path.isfile(os.path.join(root, "benchmark", "drivers", wl["driver"] + ".py"))
    assert sum(w["chips"] == 4 for w in manifest["workloads"]) <= max(1, len(manifest["workloads"]) // 4)


def _reports(metric, cell):
    return cell in metric.get("workloads", [cell])


def test_metrics(manifest, root):
    e2e, layers = manifest["end_to_end"], manifest["per_layer"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(layers) <= 128
    assert any(m["name"] == "setup_s" for m in e2e)
    cells = [w["name"] for w in manifest["workloads"]]
    for m in e2e:
        assert set(m) - {"workloads"} == E2E_KEYS and m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert all(c in cells for c in m.get("workloads", []))
    by_name = {m["name"]: m for m in e2e}
    for m in layers:
        assert set(m) == LAYER_KEYS | {"workloads"}, m["name"]  # the harness reports a per-layer metric by its list
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in by_name
        assert os.path.isfile(os.path.join(root, "benchmark", "metrics", m["name"] + ".py")), m["name"]
        assert m["workloads"], m["name"]
        for cell in m["workloads"]:
            assert cell in cells and _reports(by_name[m["moves"]], cell), (m["name"], cell)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for cell in cells:
        reported = [m["name"] for m in e2e if _reports(m, cell)]
        assert "setup_s" in reported and len(reported) >= 2, cell
        assert any(_reports(m, cell) for m in layers), cell


def test_run_seconds_fit_the_check(manifest):
    rs = manifest["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    cells = 24  # later PRs may add cells up to the limit under the same length
    assert (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200 <= 43200

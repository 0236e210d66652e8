"""The port's scene export and the engine's state methods against
mamri_tpu's.

A CPU engine of the port and mamri_tpu's engine are given the same state
(baseplate, pose, IK error, body mask, an assigned `trajectory_path`: no
planning program is compiled) and the same mesh directory (STLs written
here with `utils/stl.save_stl`, one link left without one so that it
becomes a capsule; the repo ships no STL). Tolerances: FK transforms and
marker positions within 1e-4 mm; read-back vertices, per-frame transforms
and bounding boxes within 1e-3 mm; every summary equal; at most 0.5 % of a
rendered PNG's pixels differ (an edge pixel may flip where the float32 FK
differs in its last bit); report text equal line by line, each number
within one unit of its last printed digit.
"""

import os
import re
import struct
import zlib

import numpy as np
import pytest

from mamri_tpu.api import MamriEngine as JaxEngine
from mamri_tpu.utils.glb import read_glb as j_read_glb
from mamri_tpu.utils.html_viewer import read_html_scene_summary as j_read_html
from mamri_tpu_torch.api.engine import MamriEngine
from mamri_tpu_torch.core.robot import load_robot_model
from mamri_tpu_torch.utils.glb import read_glb, read_glb_summary
from mamri_tpu_torch.utils.html_viewer import read_html_scene_summary
from mamri_tpu_torch.utils.scene import capsule_mesh, read_obj_summary
from mamri_tpu_torch.utils.stl import load_stl, save_stl
from test_torch_engine import _one_torch_thread  # noqa: F401 (autouse)

BASE = np.array([[0.9553365, -0.2955202, 0.0, -60.0], [0.0, 0.0, 1.0, -120.0], [-0.2955202, -0.9553365, 0.0, 0.0],
                 [0.0, 0.0, 0.0, 1.0]], np.float32)
ANGLES = np.array([0.3, -0.7, 0.5, 0.2, -0.4, 0.6], np.float32)
TARGET, ENTRY = np.array([-60.0, -40.0, 130.0], np.float32), np.array([-60.0, -95.0, 130.0], np.float32)


def _body():
    """A small ellipsoid mask on an anisotropic grid, beside the arm."""
    shape, spacing = (26, 22, 18), np.array([4.0, 3.5, 5.0], np.float32)
    origin = np.array([-10.0, 20.0, 90.0], np.float32)
    idx = np.stack(np.meshgrid(*(np.arange(n) for n in shape), indexing="ij"), -1)
    centre = (np.array(shape) - 1) / 2.0
    mask = (((idx - centre) / (np.array(shape) * 0.4)) ** 2).sum(-1) <= 1.0
    return mask, spacing, origin


@pytest.fixture(scope="module")
def mesh_dir(tmp_path_factory):
    """An STL for every link's visual mesh but Joint4's (it becomes a
    capsule) and the needle's (a cylinder in both packages)."""
    d = tmp_path_factory.mktemp("meshes")
    for i, spec in enumerate(load_robot_model(device="cpu").specs):
        if spec.visual_mesh and spec.name not in ("Joint4", "Needle"):
            save_stl(str(d / spec.visual_mesh), capsule_mesh(12.0 + 4 * i, 6.0, n_seg=10, n_rings=3))
    return str(d)


@pytest.fixture(scope="module")
def engines():
    """(port engine on the CPU, mamri_tpu's engine), given the same state."""
    ours, theirs = MamriEngine(device="cpu"), JaxEngine()
    mask, spacing, origin = _body()
    path = np.linspace(np.zeros(6, np.float32), ANGLES, 21).astype(np.float32)
    for eng in (ours, theirs):
        eng.baseplate_tf = BASE.copy()
        eng.current_angles = ANGLES.copy()
        eng.last_ik_error = 0.123456
        eng.set_body_segmentation(mask, spacing, origin)
        eng.trajectory_path = path.copy()
    return ours, theirs


# ------------------------------------------------------------ state methods
@pytest.mark.parametrize("angles", [None, [0.1, -0.2, 0.3, -0.4, 0.5, -0.6]])
def test_link_world_transforms_match_jax(engines, angles):
    ours, theirs = engines
    got = ours.link_world_transforms(angles)
    assert got.dtype == np.float32 and got.shape == (len(ours.model.specs), 4, 4)
    np.testing.assert_allclose(got, theirs.link_world_transforms(angles), atol=1e-4)
    np.testing.assert_allclose(ours.needle_tcp(angles), theirs.needle_tcp(angles), atol=1e-4)


def test_link_world_transforms_identity_base():
    """Before a baseplate is known the base is the identity: the reference's
    zero-pose link heights."""
    tfs = MamriEngine(device="cpu").link_world_transforms()
    np.testing.assert_array_equal(tfs[:, 2, 3], [0, 20, 50, 200, 200, 355, 368, 439])


def _same_report(got: str, want: str):
    """Equal line by line, each number within one unit of its last digit."""
    number = r"-?\d+\.\d+"
    got_lines, want_lines = got.splitlines(), want.splitlines()
    assert len(got_lines) == len(want_lines)
    for g, w in zip(got_lines, want_lines):
        assert re.sub(number, "#", g) == re.sub(number, "#", w), (g, w)
        for a, b in zip(re.findall(number, g), re.findall(number, w)):
            unit = 10.0 ** -len(b.split(".")[1])
            assert abs(float(a) - float(b)) <= unit * 1.0001, (g, w)


@pytest.mark.parametrize("correction", [False, True])
def test_describe_ik_solution_matches_jax(engines, correction):
    ours, theirs = engines
    rng = np.random.default_rng(2)
    j6 = (rng.normal(size=(3, 3)) * 50).astype(np.float32)
    j4 = (rng.normal(size=(3, 3)) * 50).astype(np.float32)
    got = ours.describe_ik_solution(j6, j4, apply_correction=correction)
    _same_report(got, theirs.describe_ik_solution(j6, j4, apply_correction=correction))
    assert got.count("Comparison") == 2
    _same_report(ours.describe_ik_solution(j6), theirs.describe_ik_solution(j6))
    assert MamriEngine(device="cpu").describe_ik_solution(j6) == JaxEngine().describe_ik_solution(j6)


def test_pose_table_and_actions_match_jax(engines):
    ours, theirs = engines
    for pose in (None, ANGLES, np.deg2rad([10.0, -15.0, 0.0, 5.0, 0.0, 90.0])):
        assert ours.pose_table(pose, title="Goal") == theirs.pose_table(pose, title="Goal")
    fresh, j_fresh = MamriEngine(device="cpu"), JaxEngine()
    for flags in ((False, False, False), (True, False, False), (True, True, True), (False, True, True)):
        for a, b in ((ours, theirs), (fresh, j_fresh)):
            got, want = a.available_actions(*flags), b.available_actions(*flags)
            assert list(got) == list(want)
            assert {k: (v.enabled, v.reason) for k, v in got.items()} == {
                k: (v.enabled, v.reason) for k, v in want.items()}


# ------------------------------------------------------------------ exports
def _obj_vertices(path):
    """{object: (N, 3) vertices} of an OBJ file."""
    out, cur = {}, None
    with open(path) as f:
        for line in f:
            if line.startswith("o "):
                cur = line[2:].strip()
                out[cur] = []
            elif line.startswith("v "):
                out[cur].append([float(x) for x in line.split()[1:]])
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("surface", ["voxel", "smooth"])
def test_export_scene_obj_matches_jax(engines, mesh_dir, tmp_path, surface):
    ours, theirs = engines
    kw = dict(mesh_dir=mesh_dir, target_ras=TARGET, entry_ras=ENTRY, body_surface=surface)
    got = ours.export_scene(str(tmp_path / "ours.obj"), **kw)
    assert got == theirs.export_scene(str(tmp_path / "theirs.obj"), **kw)
    assert got["Body"] > 0 and got["TrajectoryTipPath"] == 21 and got["InsertionSegment"] == 2
    assert read_obj_summary(str(tmp_path / "ours.obj")) == read_obj_summary(str(tmp_path / "theirs.obj"))
    a, b = _obj_vertices(str(tmp_path / "ours.obj")), _obj_vertices(str(tmp_path / "theirs.obj"))
    assert list(a) == list(b)
    for name in a:
        np.testing.assert_allclose(a[name], b[name], atol=1e-3 + 1e-6, err_msg=name)


def _glb_positions(reader, path):
    """{node name: (N, 3) POSITION payload} of a .glb file."""
    gltf, blob = reader(path)
    out = {}
    for node in gltf.get("nodes", []):
        prim = gltf["meshes"][node["mesh"]]["primitives"][0]
        acc = gltf["accessors"][prim["attributes"]["POSITION"]]
        view = gltf["bufferViews"][acc["bufferView"]]
        out[node["name"]] = np.frombuffer(blob[view["byteOffset"]:view["byteOffset"] + view["byteLength"]],
                                          "<f4").reshape(-1, 3)
    return out


def test_export_scene_glb_matches_jax(engines, mesh_dir, tmp_path):
    ours, theirs = engines
    p, q = str(tmp_path / "ours.glb"), str(tmp_path / "theirs.glb")
    got = ours.export_scene(p, mesh_dir=mesh_dir, include_body=True, include_trajectory=True)
    assert got == theirs.export_scene(q, mesh_dir=mesh_dir, include_body=True, include_trajectory=True)
    summary = read_glb_summary(p)  # checks each accessor's min / max against its payload
    assert list(summary) == list(read_glb_summary(q))
    a, b = _glb_positions(read_glb, p), _glb_positions(j_read_glb, q)
    assert list(a) == list(b) and len(a) == len(summary)
    for name in a:
        np.testing.assert_allclose(a[name], b[name], atol=1e-3, err_msg=name)


def _bbox_close(got, want):
    assert {k: (v["kind"], v["link"], v["verts"]) for k, v in got.items() if k != "__anim__"} == {
        k: (v["kind"], v["link"], v["verts"]) for k, v in want.items() if k != "__anim__"}
    for k in want:
        if k != "__anim__":
            np.testing.assert_allclose(got[k]["bbox_lo"], want[k]["bbox_lo"], atol=1e-3, err_msg=k)
            np.testing.assert_allclose(got[k]["bbox_hi"], want[k]["bbox_hi"], atol=1e-3, err_msg=k)


def test_export_scene_html_matches_jax(engines, mesh_dir, tmp_path):
    ours, theirs = engines
    p, q = str(tmp_path / "ours.html"), str(tmp_path / "theirs.html")
    got = ours.export_scene(p, mesh_dir=mesh_dir, include_trajectory=False)
    assert got == theirs.export_scene(q, mesh_dir=mesh_dir, include_trajectory=False)
    assert "TrajectoryTipPath" not in got and "Body" in got
    _bbox_close(read_html_scene_summary(p), j_read_html(q))


def test_export_trajectory_html_matches_jax(engines, mesh_dir, tmp_path):
    ours, theirs = engines
    p, q = str(tmp_path / "ours.html"), str(tmp_path / "theirs.html")
    kw = dict(mesh_dir=mesh_dir, target_ras=TARGET, entry_ras=ENTRY, interval_ms=40)
    got = ours.export_trajectory_html(p, **kw)
    assert got == theirs.export_trajectory_html(q, **kw) and got["frames"] == 21
    a, b = read_html_scene_summary(p), j_read_html(q)
    _bbox_close(a, b)
    assert a["__anim__"]["interval_ms"] == 40 and a["__anim__"]["links"] == len(ours.model.specs)
    np.testing.assert_allclose(a["__anim__"]["transforms"], b["__anim__"]["transforms"], atol=1e-3)
    fresh = MamriEngine(device="cpu")
    with pytest.raises(RuntimeError, match="no trajectory planned"):
        fresh.export_trajectory_html(p)


def test_export_posed_meshes_matches_jax(engines, mesh_dir, tmp_path):
    ours, theirs = engines
    angles = [0.2, 0.1, -0.3, 0.4, 0.2, -0.5]
    got = ours.export_posed_meshes(str(tmp_path / "ours"), mesh_dir, angles)
    want = theirs.export_posed_meshes(str(tmp_path / "theirs"), mesh_dir, angles)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    assert len(got) == len(os.listdir(mesh_dir)) == 6  # Joint4's and the Needle's STLs are missing: skipped
    for p, q in zip(got, want):
        np.testing.assert_allclose(load_stl(p), load_stl(q), atol=1e-3, err_msg=p)


def _png_pixels(path):
    """(H, W, 3) uint8 of an RGB8 PNG written by `utils/render.write_png`
    (one IDAT, filter 0 on every row)."""
    with open(path, "rb") as f:
        data = f.read()
    w, h = struct.unpack(">II", data[16:24])
    pos, idat = 8, b""
    while pos < len(data):
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert not raw[:, 0].any()
    return raw[:, 1:].reshape(h, w, 3)


def test_render_scene_matches_jax(engines, mesh_dir, tmp_path):
    ours, theirs = engines
    p, q = str(tmp_path / "ours.png"), str(tmp_path / "theirs.png")
    kw = dict(mesh_dir=mesh_dir, width=320, height=240, target_ras=TARGET, entry_ras=ENTRY)
    assert ours.render_scene(p, **kw) == theirs.render_scene(q, **kw) == (320, 240)
    a, b = _png_pixels(p), _png_pixels(q)
    assert a.shape == (240, 320, 3)
    differ = float((a != b).any(-1).mean())
    assert differ <= 0.005, differ
    assert len(np.unique(a.reshape(-1, 3), axis=0)) > 3  # something was drawn

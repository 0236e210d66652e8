"""Binary glTF 2.0 (GLB) scene writer — viewer-friendly sibling of the OBJ
export (utils/scene.write_obj).

The reference displays its scene in Slicer's 3-D viewport
(`_build_robot_model` Mamri/Mamri.py:1449-1471, trajectory markup
:1924-1935); this module gives the headless framework a single-file binary
scene any standard glTF viewer opens directly. Dependency-free: the GLB
container is a 12-byte header + one JSON chunk + one BIN chunk, assembled
with `struct`/`json`/numpy only.

Contents map 1:1 to the OBJ export: each named triangle soup becomes a node
with a TRIANGLES primitive, each polyline a node with a LINE_STRIP
primitive. Per-mesh flat colors are attached via the core
`KHR_materials_unlit`-compatible pbrMetallicRoughness baseColorFactor so
viewers show distinct parts without textures.

Coordinates are emitted in RAS millimetres exactly as produced by the scene
assembly (`MamriEngine._scene_objects`). glTF's convention is +Y-up metres;
viewers handle scale/orientation interactively, and keeping RAS mm makes the
file numerically identical to the OBJ/STL artifacts for downstream tooling.
"""

from __future__ import annotations

import json
import struct
from typing import Sequence, Tuple

import numpy as np

_MAGIC = 0x46546C67  # 'glTF'
_JSON_TYPE = 0x4E4F534A  # 'JSON'
_BIN_TYPE = 0x004E4942  # 'BIN\0'

# stable, distinguishable flat colors keyed by substring of the object name
_PALETTE = {
    "Body": (0.85, 0.62, 0.50, 0.45),
    "Needle": (0.85, 0.15, 0.15, 1.0),
    "Trajectory": (0.10, 0.55, 0.95, 1.0),
    "Insertion": (0.95, 0.75, 0.10, 1.0),
    "Baseplate": (0.35, 0.35, 0.40, 1.0),
}
_DEFAULT_COLOR = (0.62, 0.66, 0.70, 1.0)


def _color_for(name: str):
    for key, rgba in _PALETTE.items():
        if key in name:
            return rgba
    return _DEFAULT_COLOR


def write_glb(
    path: str,
    objects: Sequence[Tuple[str, np.ndarray]],
    polylines: Sequence[Tuple[str, np.ndarray]] = (),
) -> None:
    """Write named triangle soups (T,3,3) + polylines (N,3) as one GLB file."""
    bin_parts = []
    buffer_views = []
    accessors = []
    meshes = []
    nodes = []
    materials = []
    offset = 0

    def _push_positions(pts: np.ndarray) -> int:
        """Append a float32 position blob; return its accessor index."""
        nonlocal offset
        pts = np.ascontiguousarray(pts, dtype="<f4")
        blob = pts.tobytes()
        pad = (-len(blob)) % 4
        bin_parts.append(blob + b"\x00" * pad)
        buffer_views.append(
            {
                "buffer": 0,
                "byteOffset": offset,
                "byteLength": len(blob),
                "target": 34962,  # ARRAY_BUFFER
            }
        )
        offset += len(blob) + pad
        accessors.append(
            {
                "bufferView": len(buffer_views) - 1,
                "componentType": 5126,  # FLOAT
                "count": int(len(pts)),
                "type": "VEC3",
                "min": [float(v) for v in pts.min(axis=0)],
                "max": [float(v) for v in pts.max(axis=0)],
            }
        )
        return len(accessors) - 1

    def _push_material(name: str) -> int:
        materials.append(
            {
                "name": f"{name}_mat",
                "pbrMetallicRoughness": {
                    "baseColorFactor": list(_color_for(name)),
                    "metallicFactor": 0.0,
                    "roughnessFactor": 0.85,
                },
                **(
                    {"alphaMode": "BLEND"}
                    if _color_for(name)[3] < 1.0
                    else {}
                ),
                "doubleSided": True,
            }
        )
        return len(materials) - 1

    for name, tris in objects:
        tris = np.asarray(tris, dtype=np.float32)
        if tris.size == 0:
            continue
        acc = _push_positions(tris.reshape(-1, 3))
        meshes.append(
            {
                "name": name,
                "primitives": [
                    {
                        "attributes": {"POSITION": acc},
                        "mode": 4,  # TRIANGLES
                        "material": _push_material(name),
                    }
                ],
            }
        )
        nodes.append({"name": name, "mesh": len(meshes) - 1})

    for name, pts in polylines:
        pts = np.asarray(pts, dtype=np.float32).reshape(-1, 3)
        if len(pts) < 2:
            continue
        acc = _push_positions(pts)
        meshes.append(
            {
                "name": name,
                "primitives": [
                    {
                        "attributes": {"POSITION": acc},
                        "mode": 3,  # LINE_STRIP
                        "material": _push_material(name),
                    }
                ],
            }
        )
        nodes.append({"name": name, "mesh": len(meshes) - 1})

    gltf = {
        "asset": {"version": "2.0", "generator": "mamri_tpu_torch"},
        "scene": 0,
        "scenes": [{"name": "mamri", "nodes": list(range(len(nodes)))}],
        "nodes": nodes,
        "meshes": meshes,
        "materials": materials,
        "accessors": accessors,
        "bufferViews": buffer_views,
        "buffers": [{"byteLength": offset}],
    }
    if not nodes:  # a GLB must still be structurally valid when the scene is empty
        for k in ("nodes", "meshes", "materials", "accessors", "bufferViews", "buffers"):
            gltf.pop(k)
        gltf["scenes"] = [{"name": "mamri"}]

    json_blob = json.dumps(gltf, separators=(",", ":")).encode()
    json_blob += b" " * ((-len(json_blob)) % 4)
    bin_blob = b"".join(bin_parts)

    chunks = [struct.pack("<II", len(json_blob), _JSON_TYPE) + json_blob]
    if bin_blob:
        chunks.append(struct.pack("<II", len(bin_blob), _BIN_TYPE) + bin_blob)
    total = 12 + sum(len(c) for c in chunks)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", _MAGIC, 2, total))
        for c in chunks:
            f.write(c)


def read_glb(path: str) -> Tuple[dict, bytes]:
    """Parse a GLB container back into (gltf json, binary chunk)."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 12:
        raise ValueError(f"not a GLB file: {len(data)} bytes")
    magic, version, total = struct.unpack_from("<III", data, 0)
    if magic != _MAGIC or version != 2:
        raise ValueError(f"not a GLB v2 file: magic={magic:#x} version={version}")
    if total != len(data):
        raise ValueError(f"GLB length mismatch: header {total}, file {len(data)}")
    pos = 12
    gltf = None
    bin_blob = b""
    while pos + 8 <= len(data):
        clen, ctype = struct.unpack_from("<II", data, pos)
        pos += 8
        chunk = data[pos : pos + clen]
        pos += clen
        if ctype == _JSON_TYPE:
            gltf = json.loads(chunk.decode())
        elif ctype == _BIN_TYPE:
            bin_blob = chunk
    if gltf is None:
        raise ValueError("GLB has no JSON chunk")
    return gltf, bin_blob


def read_glb_summary(path: str) -> dict:
    """{node name: {"mode": int, "count": vertex count}} plus geometry checks.

    Decodes every POSITION accessor and verifies the accessor min/max match
    the binary payload — a structural validity check for tests.
    """
    gltf, bin_blob = read_glb(path)
    out = {}
    if not isinstance(gltf, dict):
        raise ValueError("GLB JSON chunk is not an object")
    try:
        nodes = gltf.get("nodes", [])
    except AttributeError as e:
        raise ValueError(f"malformed glTF: {e}") from e
    for node in nodes:
        try:
            name = node.get("name", "?") if isinstance(node, dict) else "?"
            mesh = gltf["meshes"][node["mesh"]]
            prim = mesh["primitives"][0]
            acc = gltf["accessors"][prim["attributes"]["POSITION"]]
            view = gltf["bufferViews"][acc["bufferView"]]
            raw = bin_blob[view["byteOffset"] : view["byteOffset"] + view["byteLength"]]
            count, amin, amax = int(acc["count"]), acc["min"], acc["max"]
            mode = prim.get("mode", 4)
        except (KeyError, IndexError, TypeError) as e:
            raise ValueError(f"malformed glTF structure: {type(e).__name__} {e}") from e
        pts = np.frombuffer(raw, dtype="<f4").reshape(-1, 3)
        if len(pts) != count:
            raise ValueError(f"{name}: accessor count {count} != {len(pts)}")
        if not np.allclose(pts.min(axis=0), amin, atol=1e-5) or not np.allclose(
            pts.max(axis=0), amax, atol=1e-5
        ):
            raise ValueError(f"{name}: accessor min/max do not match payload")
        out[name] = {"mode": mode, "count": count}
    return out

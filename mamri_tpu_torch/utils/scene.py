"""Assembled 3-D scene export (OBJ): posed robot + body surface + trajectory.

The reference renders the FK-posed robot STLs, the segmented body's closed
surface, and the planned trajectory line in Slicer's 3-D view
(`_build_robot_model` Mamri/Mamri.py:1449-1471, trajectory markup
:1924-1935, needle model handling :1454). Headless equivalent: one
Wavefront OBJ file holding

  * one `o` group per robot link — the visual STL posed by FK when a mesh
    directory is given, a procedural capsule sized off the kinematic offsets
    otherwise (the framework ships no copied mesh assets);
  * a needle cylinder generated from the config's tip/axis (the reference's
    Needle.STL is stripped from its own mirror — SURVEY.md §2.1 #35 — so a
    generated cylinder exceeds reference parity here);
  * the body segmentation as an exposed-voxel-face surface in RAS mm
    (exact voxel geometry: every face lies on the segmentation boundary);
  * the planned joint-space path as the needle-tip polyline (OBJ `l`
    elements), plus the straight entry->target insertion segment.

Everything is host-side numpy on final results — no device round-trips
beyond the FK transforms already computed.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

Tris = np.ndarray  # (T, 3, 3) float32 triangle soup


def capsule_mesh(length: float, radius: float, n_seg: int = 24, n_rings: int = 8) -> Tris:
    """Triangulated capsule along local +Z from z=0 to z=length."""
    length = float(max(length, 0.0))
    theta = np.linspace(0.0, 2 * np.pi, n_seg, endpoint=False)
    ct, st = np.cos(theta), np.sin(theta)

    rows = []
    # bottom hemisphere (pole to equator), z centered at 0
    for phi in np.linspace(-np.pi / 2, 0.0, n_rings + 1):
        r = radius * np.cos(phi)
        z = radius * np.sin(phi)
        rows.append(np.stack([r * ct, r * st, np.full(n_seg, z)], axis=1))
    # top hemisphere (equator to pole), z centered at length
    for phi in np.linspace(0.0, np.pi / 2, n_rings + 1):
        r = radius * np.cos(phi)
        z = length + radius * np.sin(phi)
        rows.append(np.stack([r * ct, r * st, np.full(n_seg, z)], axis=1))
    rows = np.stack(rows)  # (R, n_seg, 3)

    tris = []
    nrows = rows.shape[0]
    for i in range(nrows - 1):
        a = rows[i]
        b = rows[i + 1]
        a2 = np.roll(a, -1, axis=0)
        b2 = np.roll(b, -1, axis=0)
        # CCW rings viewed from +z outside: (a, a2, b2) / (a, b2, b) is outward
        tris.append(np.stack([a, a2, b2], axis=1))
        tris.append(np.stack([a, b2, b], axis=1))
    return np.concatenate(tris).astype(np.float32)


def cylinder_mesh(p0, p1, radius: float, n_seg: int = 16) -> Tris:
    """Closed cylinder between two world points."""
    p0 = np.asarray(p0, dtype=np.float64)
    p1 = np.asarray(p1, dtype=np.float64)
    axis = p1 - p0
    h = np.linalg.norm(axis)
    if h < 1e-9:
        return np.zeros((0, 3, 3), dtype=np.float32)
    z = axis / h
    up = np.array([0.0, 0.0, 1.0]) if abs(z[2]) < 0.99 else np.array([0.0, 1.0, 0.0])
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    theta = np.linspace(0.0, 2 * np.pi, n_seg, endpoint=False)
    ring = radius * (np.outer(np.cos(theta), x) + np.outer(np.sin(theta), y))
    a = p0 + ring
    b = p1 + ring
    a2 = np.roll(a, -1, axis=0)
    b2 = np.roll(b, -1, axis=0)
    side = np.concatenate([np.stack([a, a2, b2], axis=1), np.stack([a, b2, b], axis=1)])
    cap0 = np.stack([np.broadcast_to(p0, a.shape), a2, a], axis=1)
    cap1 = np.stack([np.broadcast_to(p1, b.shape), b, b2], axis=1)
    return np.concatenate([side, cap0, cap1]).astype(np.float32)


def voxel_surface_mesh(mask, spacing, origin, max_faces: int = 2_000_000) -> Tris:
    """Exposed-face surface of a boolean voxel volume, in RAS mm.

    Volume geometry is LPS `origin + spacing * idx` (repo convention); the
    emitted vertices are RAS (x, y negated) to match every other world-space
    artifact. Each boundary voxel face becomes two triangles — exact (the
    mesh IS the segmentation boundary), watertight for solid components.
    """
    mask = np.asarray(mask, dtype=bool)
    spacing = np.asarray(spacing, dtype=np.float32)
    origin = np.asarray(origin, dtype=np.float32)
    pad = np.pad(mask, 1)

    # the 4 face-corner offsets (in voxel units, relative to voxel center) for
    # each of the 6 face directions, ordered so the face normal points outward
    # in LPS index space; the RAS flip diag(-1,-1,1) is a proper rotation
    # (det=+1), so outward winding is preserved as-is.
    corners = {
        (-1, 0, 0): [(-0.5, -0.5, -0.5), (-0.5, -0.5, 0.5), (-0.5, 0.5, 0.5), (-0.5, 0.5, -0.5)],
        (1, 0, 0): [(0.5, -0.5, -0.5), (0.5, 0.5, -0.5), (0.5, 0.5, 0.5), (0.5, -0.5, 0.5)],
        (0, -1, 0): [(-0.5, -0.5, -0.5), (0.5, -0.5, -0.5), (0.5, -0.5, 0.5), (-0.5, -0.5, 0.5)],
        (0, 1, 0): [(-0.5, 0.5, -0.5), (-0.5, 0.5, 0.5), (0.5, 0.5, 0.5), (0.5, 0.5, -0.5)],
        (0, 0, -1): [(-0.5, -0.5, -0.5), (-0.5, 0.5, -0.5), (0.5, 0.5, -0.5), (0.5, -0.5, -0.5)],
        (0, 0, 1): [(-0.5, -0.5, 0.5), (0.5, -0.5, 0.5), (0.5, 0.5, 0.5), (-0.5, 0.5, 0.5)],
    }

    tris = []
    total = 0
    for d, quad in corners.items():
        neigh = pad[
            1 + d[0] : pad.shape[0] - 1 + d[0],
            1 + d[1] : pad.shape[1] - 1 + d[1],
            1 + d[2] : pad.shape[2] - 1 + d[2],
        ]
        exposed = mask & ~neigh
        idx = np.argwhere(exposed).astype(np.float32)  # (F, 3) voxel indices
        if idx.size == 0:
            continue
        total += 2 * len(idx)
        if total > max_faces:
            raise ValueError(
                f"voxel surface exceeds {max_faces} faces; downsample the mask first"
            )
        quad = np.asarray(quad, dtype=np.float32)  # (4, 3)
        pts_lps = origin[None, None, :] + spacing[None, None, :] * (idx[:, None, :] + quad[None, :, :])
        pts = pts_lps * np.array([-1.0, -1.0, 1.0], dtype=np.float32)  # RAS
        tris.append(np.stack([pts[:, 0], pts[:, 1], pts[:, 2]], axis=1))
        tris.append(np.stack([pts[:, 0], pts[:, 2], pts[:, 3]], axis=1))
    if not tris:
        return np.zeros((0, 3, 3), dtype=np.float32)
    return np.concatenate(tris).astype(np.float32)


def write_obj(
    path: str,
    objects: Sequence[Tuple[str, Tris]],
    polylines: Sequence[Tuple[str, np.ndarray]] = (),
) -> None:
    """Write named triangle soups + polylines as one Wavefront OBJ."""
    with open(path, "w") as f:
        f.write("# mamri_tpu_torch assembled scene\n")
        voff = 1
        for name, tris in objects:
            tris = np.asarray(tris, dtype=np.float32)
            f.write(f"o {name}\n")
            if tris.size:
                verts = tris.reshape(-1, 3)
                np.savetxt(f, verts, fmt="v %.4f %.4f %.4f")
                ntri = len(tris)
                fi = voff + 3 * np.arange(ntri)
                faces = np.stack([fi, fi + 1, fi + 2], axis=1)
                np.savetxt(f, faces, fmt="f %d %d %d")
                voff += 3 * ntri
        for name, pts in polylines:
            pts = np.asarray(pts, dtype=np.float32).reshape(-1, 3)
            if len(pts) < 2:
                continue
            f.write(f"o {name}\n")
            np.savetxt(f, pts, fmt="v %.4f %.4f %.4f")
            idx = " ".join(str(voff + i) for i in range(len(pts)))
            f.write(f"l {idx}\n")
            voff += len(pts)


def read_obj_summary(path: str) -> dict:
    """Cheap OBJ introspection for tests: object names, vertex/face/line counts."""
    objects = {}
    cur = None
    with open(path) as f:
        for line in f:
            tag = line.split(None, 1)[0] if line.strip() else ""
            if tag == "o":
                cur = line.split(None, 1)[1].strip()
                objects[cur] = {"v": 0, "f": 0, "l": 0}
            elif tag in ("v", "f", "l") and cur is not None:
                objects[cur][tag] += 1
    return objects


# ----------------------------------------------------------- smooth surface
# Kuhn 6-tetrahedra decomposition of each grid cube (all tets share the main
# diagonal c0-c7, which makes shared cube faces split identically in adjacent
# cubes -> the extracted surface is watertight). Corner numbering: bit 0 = +i,
# bit 1 = +j, bit 2 = +k.
_KUHN_TETS = (
    (0, 1, 3, 7),
    (0, 3, 2, 7),
    (0, 2, 6, 7),
    (0, 6, 4, 7),
    (0, 4, 5, 7),
    (0, 5, 1, 7),
)
_CORNER_OFF = np.array(
    [[(c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)], dtype=np.float32
)


def marching_tetrahedra_mesh(mask, spacing, origin, max_tris: int = 4_000_000) -> Tris:
    """Smooth(er) closed surface of a boolean volume via marching tetrahedra,
    in RAS mm — the table-free alternative to `voxel_surface_mesh` (45-degree
    facets instead of axis-aligned steps; the reference's closed-surface
    representation is likewise a smooth mesh, Mamri/Mamri.py:1330-1341).

    Vertices sit at edge midpoints of inside/outside edges; both tets (and
    cubes) adjacent to an edge agree on the midpoint, so the mesh is
    watertight. Winding is oriented outward by construction check: each
    case's triangle normal is flipped to point from the inside corners
    toward the outside corners.
    """
    mask = np.asarray(mask, dtype=bool)
    spacing = np.asarray(spacing, dtype=np.float32)
    origin = np.asarray(origin, dtype=np.float32)
    # pad so the surface closes at the volume border
    m = np.pad(mask, 1)
    nx, ny, nz = m.shape

    # inside flags at the 8 corners of each cube: (8, cx, cy, cz)
    corners = np.stack(
        [
            m[dx : nx - 1 + dx, dy : ny - 1 + dy, dz : nz - 1 + dz]
            for dx, dy, dz in _CORNER_OFF.astype(int)
        ]
    )
    base_idx = np.stack(
        np.meshgrid(
            np.arange(nx - 1, dtype=np.float32),
            np.arange(ny - 1, dtype=np.float32),
            np.arange(nz - 1, dtype=np.float32),
            indexing="ij",
        ),
        axis=-1,
    )  # (cx, cy, cz, 3) cube-base voxel index in PADDED coords

    tris_out = []
    total = 0
    for tet in _KUHN_TETS:
        b = [corners[c] for c in tet]  # 4 bool grids
        code = (
            b[0].astype(np.int8)
            + 2 * b[1].astype(np.int8)
            + 4 * b[2].astype(np.int8)
            + 8 * b[3].astype(np.int8)
        )
        pos = [_CORNER_OFF[c] for c in tet]  # 4 corner offsets (3,)
        for case in range(1, 15):
            sel = np.argwhere(code == case)
            if len(sel) == 0:
                continue
            inside = [t for t in range(4) if (case >> t) & 1]
            outside = [t for t in range(4) if not (case >> t) & 1]
            cube = base_idx[sel[:, 0], sel[:, 1], sel[:, 2]]  # (N, 3)

            def edge_mid(a, bb):
                return cube + (pos[a] + pos[bb]) / 2.0

            if len(inside) == 1 or len(inside) == 3:
                apex = inside[0] if len(inside) == 1 else outside[0]
                others = [t for t in range(4) if t != apex]
                v = [edge_mid(apex, o) for o in others]
                cand = [np.stack([v[0], v[1], v[2]], axis=1)]
            else:  # 2 inside, 2 outside -> quad on 4 edges
                i0, i1 = inside
                o0, o1 = outside
                q = [edge_mid(i0, o0), edge_mid(i0, o1), edge_mid(i1, o1), edge_mid(i1, o0)]
                cand = [
                    np.stack([q[0], q[1], q[2]], axis=1),
                    np.stack([q[0], q[2], q[3]], axis=1),
                ]
            # outward orientation: normal must point inside -> outside
            d = np.mean([pos[o] for o in outside], axis=0) - np.mean(
                [pos[t] for t in inside], axis=0
            )  # constant per case
            for t3 in cand:
                n = np.cross(t3[:, 1] - t3[:, 0], t3[:, 2] - t3[:, 0])
                flip = (n @ d) < 0
                t3[flip] = t3[flip][:, ::-1]
                tris_out.append(t3)
                total += len(t3)
                if total > max_tris:
                    raise ValueError(
                        f"marching tetrahedra exceeds {max_tris} triangles; downsample first"
                    )

    if not tris_out:
        return np.zeros((0, 3, 3), dtype=np.float32)
    tris_idx = np.concatenate(tris_out)  # PADDED voxel-index space
    # padded index -> LPS mm -> RAS: voxel centers sit at origin + spacing*idx,
    # padding shifted indices by +1
    pts_lps = origin[None, None, :] + spacing[None, None, :] * (tris_idx - 1.0)
    return (pts_lps * np.array([-1.0, -1.0, 1.0], dtype=np.float32)).astype(np.float32)

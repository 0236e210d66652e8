"""Headless software renderer: the assembled scene to a PNG.

Completes the reference's 3-D view parity (Slicer viewport,
Mamri/Mamri.py:1449-1471) without a GUI stack: a numpy z-buffer rasterizer
(orthographic camera, Lambertian shading, per-object colors) plus a
dependency-free PNG encoder (zlib + struct — no PIL/matplotlib). Intended
for debug snapshots and CI artifacts, not interactive use; the OBJ export
(`utils/scene.py`) is the interchange format.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Sequence, Tuple

import numpy as np

# distinguishable object palette (dark-on-light), RGB 0-255
PALETTE = (
    (31, 119, 180),
    (255, 127, 14),
    (44, 160, 44),
    (214, 39, 40),
    (148, 103, 189),
    (140, 86, 75),
    (227, 119, 194),
    (127, 127, 127),
    (188, 189, 34),
    (23, 190, 207),
)
BODY_COLOR = (205, 170, 140)
LINE_COLOR = (200, 30, 30)
BACKGROUND = (252, 252, 252)


def _camera_basis(azim_deg: float, elev_deg: float) -> np.ndarray:
    """Rows = (right, up, forward) of an orthographic camera looking at the
    scene from the given azimuth/elevation (RAS world)."""
    az = np.deg2rad(azim_deg)
    el = np.deg2rad(elev_deg)
    fwd = -np.array(
        [np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)], dtype=np.float64
    )
    world_up = np.array([0.0, 0.0, 1.0])
    if abs(np.dot(fwd, world_up)) > 0.99:
        world_up = np.array([0.0, 1.0, 0.0])
    right = np.cross(fwd, world_up)
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    return np.stack([right, up, fwd])


def rasterize(
    objects: Sequence[Tuple[str, np.ndarray]],
    polylines: Sequence[Tuple[str, np.ndarray]] = (),
    width: int = 960,
    height: int = 720,
    azim_deg: float = 35.0,
    elev_deg: float = 22.0,
    colors: Optional[dict] = None,
    light_dir=(-0.4, 0.6, 0.8),
) -> np.ndarray:
    """(H, W, 3) uint8 image of named triangle soups + polylines."""
    cam = _camera_basis(azim_deg, elev_deg)
    light = np.asarray(light_dir, dtype=np.float64)
    light /= np.linalg.norm(light)

    all_pts = [t.reshape(-1, 3) for _, t in objects if len(t)] + [
        np.asarray(p).reshape(-1, 3) for _, p in polylines if len(p)
    ]
    if not all_pts:
        img = np.empty((height, width, 3), np.uint8)
        img[:] = BACKGROUND
        return img
    pts = np.concatenate(all_pts)
    proj = pts @ cam.T  # (N, 3): x=right, y=up, z=depth
    lo, hi = proj[:, :2].min(0), proj[:, :2].max(0)
    span = (hi - lo).max() * 1.08 + 1e-6
    center = (hi + lo) / 2.0
    scale = min(width, height) / span

    def to_screen(p3):
        """world (…, 3) -> (sx, sy, closeness): forward points INTO the
        scene, so closeness = -p·fwd (larger = nearer the camera)."""
        q = p3 @ cam.T
        sx = (q[..., 0] - center[0]) * scale + width / 2.0
        sy = height / 2.0 - (q[..., 1] - center[1]) * scale
        return sx, sy, -q[..., 2]

    img = np.empty((height, width, 3), np.float32)
    img[:] = BACKGROUND
    zbuf = np.full((height, width), -np.inf, np.float32)

    colors = colors or {}
    pal = iter(PALETTE * 50)
    for name, tris in objects:
        if not len(tris):
            continue
        base = np.asarray(
            colors.get(name) or (BODY_COLOR if name == "Body" else next(pal)), np.float32
        )
        t = np.asarray(tris, np.float64)
        n = np.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0])
        nn = np.linalg.norm(n, axis=1, keepdims=True)
        n = n / np.maximum(nn, 1e-12)
        shade = 0.35 + 0.65 * np.abs(n @ light)  # two-sided Lambert
        sx, sy, depth = to_screen(t)  # each (T, 3)

        order = np.argsort(depth.mean(1))  # near-last helps equal-z ties
        for ti in order:
            xs, ys, zs = sx[ti], sy[ti], depth[ti]
            x0, x1 = int(max(np.floor(xs.min()), 0)), int(min(np.ceil(xs.max()), width - 1))
            y0, y1 = int(max(np.floor(ys.min()), 0)), int(min(np.ceil(ys.max()), height - 1))
            if x1 < x0 or y1 < y0:
                continue
            px, py = np.meshgrid(
                np.arange(x0, x1 + 1) + 0.5, np.arange(y0, y1 + 1) + 0.5
            )
            d = (ys[1] - ys[2]) * (xs[0] - xs[2]) + (xs[2] - xs[1]) * (ys[0] - ys[2])
            if abs(d) < 1e-12:
                continue
            w0 = ((ys[1] - ys[2]) * (px - xs[2]) + (xs[2] - xs[1]) * (py - ys[2])) / d
            w1 = ((ys[2] - ys[0]) * (px - xs[2]) + (xs[0] - xs[2]) * (py - ys[2])) / d
            w2 = 1.0 - w0 - w1
            inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
            if not inside.any():
                continue
            z = w0 * zs[0] + w1 * zs[1] + w2 * zs[2]
            sub_z = zbuf[y0 : y1 + 1, x0 : x1 + 1]
            upd = inside & (z > sub_z)
            if not upd.any():
                continue
            sub_z[upd] = z[upd].astype(np.float32)
            img[y0 : y1 + 1, x0 : x1 + 1][upd] = base * shade[ti]

    for name, line in polylines:
        line = np.asarray(line, np.float64).reshape(-1, 3)
        if len(line) < 2:
            continue
        col = np.asarray(colors.get(name, LINE_COLOR), np.float32)
        sx, sy, depth = to_screen(line)
        for i in range(len(line) - 1):
            steps = int(max(abs(sx[i + 1] - sx[i]), abs(sy[i + 1] - sy[i]), 1)) + 1
            tt = np.linspace(0.0, 1.0, steps)
            xs = np.clip(np.round(sx[i] + tt * (sx[i + 1] - sx[i])).astype(int), 0, width - 1)
            ys = np.clip(np.round(sy[i] + tt * (sy[i + 1] - sy[i])).astype(int), 0, height - 1)
            zs = depth[i] + tt * (depth[i + 1] - depth[i]) + 1.0  # bias toward viewer
            vis = zs >= zbuf[ys, xs]
            img[ys[vis], xs[vis]] = col
            zbuf[ys[vis], xs[vis]] = zs[vis]

    return np.clip(img, 0, 255).astype(np.uint8)


def write_png(path: str, img: np.ndarray) -> None:
    """Minimal RGB8 PNG encoder (no dependencies)."""
    img = np.asarray(img, np.uint8)
    h, w, c = img.shape
    assert c == 3, "RGB images only"
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def read_png_size(path: str) -> Tuple[int, int]:
    """(width, height) from a PNG header — test helper."""
    with open(path, "rb") as f:
        head = f.read(24)
    assert head[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    w, h = struct.unpack(">II", head[16:24])
    return w, h

"""Binary/ASCII STL ingest and surface point sampling (host-side, numpy).

The reference reads collision meshes with vtkSTLReader
(Mamri/Mamri.py:1729-1732) and tests triangle-exact contact with
vtkCollisionDetectionFilter. The TPU-native pipeline instead converts each
mesh ONCE at load time into an area-weighted surface point cloud; collision
queries then become trilinear occupancy lookups on-device
(mamri_tpu_torch/planning/collision.py), vmappable over whole trajectories.

No VTK: STL is parsed directly (84-byte-record binary format, with an ASCII
fallback).
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np


def load_stl(path: str) -> np.ndarray:
    """Load an STL file -> (T, 3, 3) float32 triangle vertices (mm).

    Binary files go through the native C++ parser (mamri_tpu_torch.native) when the
    toolchain is available; ASCII and fallback paths are pure Python."""
    with open(path, "rb") as f:
        head = f.read(5)
        f.seek(0)
        if head != b"solid":
            from mamri_tpu_torch import native

            tris = native.parse_stl_native(path)
            if tris is not None:
                return tris
        if head == b"solid":
            # could still be binary (some exporters write 'solid' headers);
            # try ASCII, fall back to binary on parse failure
            try:
                return _load_ascii(path)
            except Exception:
                pass
        return _load_binary(f.read())


def _load_binary(data: bytes) -> np.ndarray:
    if len(data) < 84:
        raise ValueError(f"binary STL truncated: {len(data)} bytes, need >= 84")
    ntri = struct.unpack("<I", data[80:84])[0]
    expected = 84 + ntri * 50
    if len(data) < expected:
        raise ValueError(f"binary STL truncated: {len(data)} bytes, need {expected}")
    rec = np.frombuffer(data[84 : 84 + ntri * 50], dtype=np.uint8).reshape(ntri, 50)
    floats = rec[:, :48].copy().view("<f4").reshape(ntri, 12)
    return floats[:, 3:12].reshape(ntri, 3, 3).astype(np.float32)


def _load_ascii(path: str) -> np.ndarray:
    verts = []
    with open(path, "r") as f:
        for line in f:
            parts = line.split()
            if parts and parts[0] == "vertex":
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
    arr = np.asarray(verts, dtype=np.float32)
    if arr.size == 0 or arr.shape[0] % 3:
        raise ValueError("not a valid ASCII STL")
    return arr.reshape(-1, 3, 3)


def save_stl(path: str, tris: np.ndarray) -> None:
    """Write a (T, 3, 3) triangle soup as binary STL (normals recomputed)."""
    tris = np.asarray(tris, dtype=np.float32)
    a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
    n = np.cross(b - a, c - a)
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    n = n / np.maximum(norm, 1e-12)
    rec = np.zeros((len(tris), 50), dtype=np.uint8)
    payload = np.concatenate([n[:, None, :], tris], axis=1).astype("<f4")  # (T, 4, 3)
    rec[:, :48] = payload.reshape(len(tris), 48 // 4).view(np.uint8).reshape(len(tris), 48)
    with open(path, "wb") as f:
        f.write(b"\0" * 80)
        f.write(struct.pack("<I", len(tris)))
        f.write(rec.tobytes())


def transform_triangles(tris: np.ndarray, matrix: np.ndarray) -> np.ndarray:
    """Apply a (4, 4) homogeneous transform to a (T, 3, 3) triangle soup."""
    tris = np.asarray(tris, dtype=np.float32)
    r = np.asarray(matrix, dtype=np.float32)
    return np.einsum("ij,tvj->tvi", r[:3, :3], tris) + r[:3, 3]


def sample_surface_points(tris: np.ndarray, n_points: int = 2048, seed: int = 0) -> np.ndarray:
    """Area-weighted uniform sampling of a triangle soup -> (n_points, 3).

    Deterministic (seeded); includes every triangle centroid first so coarse
    collision hulls are covered even when n_points is small.
    """
    tris = np.asarray(tris, dtype=np.float32)
    a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
    cross = np.cross(b - a, c - a)
    area = 0.5 * np.linalg.norm(cross, axis=1)
    total = area.sum()
    centroids = (a + b + c) / 3.0
    if n_points <= len(centroids):
        # keep the largest triangles' centroids
        order = np.argsort(-area)
        return centroids[order[:n_points]]
    n_rand = n_points - len(centroids)
    rng = np.random.default_rng(seed)
    probs = area / max(total, 1e-12)
    idx = rng.choice(len(tris), size=n_rand, p=probs)
    u = rng.random(n_rand).astype(np.float32)
    v = rng.random(n_rand).astype(np.float32)
    flip = u + v > 1.0
    u = np.where(flip, 1.0 - u, u)
    v = np.where(flip, 1.0 - v, v)
    pts = a[idx] + u[:, None] * (b[idx] - a[idx]) + v[:, None] * (c[idx] - a[idx])
    return np.concatenate([centroids, pts.astype(np.float32)])

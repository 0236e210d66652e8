"""MRI volume container and synthetic test volumes, in numpy only.

Counterpart of `mamri_tpu/perception/volume.py`, re-implemented because that
module cannot be imported without jax (its package `__init__` loads the
segmentation). The arithmetic is the same, so `synthetic_volume` is
bit-equal to the original (tests/test_torch_core.py holds it so).

Conventions: data in index order (i, j, k); LPS = origin + spacing * index;
RAS = (-LPS_x, -LPS_y, LPS_z).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

_LPS_RAS_FLIP = np.asarray([-1.0, -1.0, 1.0], dtype=np.float32)



def lps_to_ras(points):
    """(..., 3) LPS -> RAS: negate x and y."""
    return np.asarray(points, dtype=np.float32) * _LPS_RAS_FLIP


def ras_to_lps(points):
    """RAS -> LPS (the same involution)."""
    return lps_to_ras(points)


def storage_array(data) -> np.ndarray:
    """The array a format writer stores: compact scanner dtypes
    (`Volume._COMPACT_DTYPES`) pass through native-endian; all else -> f32."""
    arr = np.asarray(data)
    native = arr.dtype.newbyteorder("=")
    if native in Volume._COMPACT_DTYPES:
        return np.asarray(arr, dtype=native)
    return np.asarray(arr, dtype=np.float32)


@dataclass
class Volume:
    """An axis-aligned scalar volume in LPS space."""

    data: np.ndarray  # (nx, ny, nz) float32 (or a compact scanner dtype)
    spacing: np.ndarray  # (3,) mm per voxel
    origin: np.ndarray  # (3,) LPS position of voxel (0, 0, 0)

    # scanner-native dtypes kept as-is: segmentation casts to f32 on the
    # device, and every value of these is exact in f32
    _COMPACT_DTYPES = (np.int8, np.uint8, np.int16, np.uint16)

    def __post_init__(self):
        self.data = storage_array(self.data)
        self.spacing = np.asarray(self.spacing, dtype=np.float32)
        self.origin = np.asarray(self.origin, dtype=np.float32)

    @property
    def shape(self) -> Tuple[int, int, int]:
        return self.data.shape

    @property
    def voxel_volume_mm3(self) -> float:
        return float(np.prod(self.spacing))

    def index_to_lps(self, idx):
        return self.origin + self.spacing * np.asarray(idx, dtype=np.float32)

    def index_to_ras(self, idx):
        lps = self.index_to_lps(idx)
        return lps * np.asarray([-1.0, -1.0, 1.0], dtype=np.float32)

    def ras_to_index(self, ras):
        lps = np.asarray(ras, dtype=np.float32) * np.asarray([-1.0, -1.0, 1.0], dtype=np.float32)
        return (lps - self.origin) / self.spacing


def synthetic_volume(
    shape: Tuple[int, int, int] = (128, 128, 128),
    spacing: Sequence[float] = (1.0, 1.0, 1.0),
    origin: Optional[Sequence[float]] = None,
    fiducials_ras: Optional[np.ndarray] = None,
    fiducial_radius_mm: float = 3.0,
    fiducial_intensity: float = 120.0,
    body_center_ras: Optional[Sequence[float]] = None,
    body_radii_mm: Optional[Sequence[float]] = None,
    body_intensity: float = 90.0,
    background_intensity: float = 10.0,
    noise_sigma: float = 0.0,
    seed: int = 0,
) -> Volume:
    """Sphere fiducials + an ellipsoid body on a constant background (the
    default origin centres the volume on the RAS origin)."""
    shape = tuple(int(s) for s in shape)
    spacing = np.asarray(spacing, dtype=np.float32)
    if origin is None:
        origin = -spacing * (np.asarray(shape, dtype=np.float32) - 1.0) / 2.0
    origin = np.asarray(origin, dtype=np.float32)

    gi, gj, gk = np.meshgrid(
        *(np.arange(n, dtype=np.float32) for n in shape), indexing="ij"
    )
    rx = -(origin[0] + spacing[0] * gi)
    ry = -(origin[1] + spacing[1] * gj)
    rz = origin[2] + spacing[2] * gk

    data = np.full(shape, background_intensity, dtype=np.float32)
    if body_center_ras is not None and body_radii_mm is not None:
        c = np.asarray(body_center_ras, dtype=np.float32)
        r = np.asarray(body_radii_mm, dtype=np.float32)
        inside = ((rx - c[0]) / r[0]) ** 2 + ((ry - c[1]) / r[1]) ** 2 + ((rz - c[2]) / r[2]) ** 2 <= 1.0
        data[inside] = body_intensity
    if fiducials_ras is not None:
        for c in np.asarray(fiducials_ras, dtype=np.float32).reshape(-1, 3):
            d2 = (rx - c[0]) ** 2 + (ry - c[1]) ** 2 + (rz - c[2]) ** 2
            data[d2 <= fiducial_radius_mm**2] = fiducial_intensity
    if noise_sigma > 0:
        rng = np.random.default_rng(seed)
        data = data + rng.normal(0.0, noise_sigma, size=shape).astype(np.float32)
    return Volume(data=data, spacing=spacing, origin=origin)


def rasterized_sphere_centroids(points_ras, radius_mm, spacing, origin_lps):
    """Centroid (RAS, mm) of the voxel-center set each sphere rasterizes to.

    Exactly the set `synthetic_volume` paints (voxel center within radius of
    the sphere center, RAS metric) and therefore exactly the centroid the
    segmentation stage measures for an isolated spherical fiducial — the
    closed-form model of voxel-grid quantization noise used by the IK oracle
    (tools/ik_oracle_torch.py)."""
    out = []
    spacing = np.asarray(spacing, dtype=np.float64)
    origin = np.asarray(origin_lps, dtype=np.float64)
    r = float(radius_mm)
    for c in np.asarray(points_ras, dtype=np.float64).reshape(-1, 3):
        lps = np.array([-c[0], -c[1], c[2]])
        idx = (lps - origin) / spacing
        lo = np.floor(idx - r / spacing).astype(int) - 1
        hi = np.ceil(idx + r / spacing).astype(int) + 2
        gi, gj, gk = np.mgrid[lo[0] : hi[0], lo[1] : hi[1], lo[2] : hi[2]]
        px = origin[0] + spacing[0] * gi
        py = origin[1] + spacing[1] * gj
        pz = origin[2] + spacing[2] * gk
        d2 = (-px - c[0]) ** 2 + (-py - c[1]) ** 2 + (pz - c[2]) ** 2
        m = d2 <= r * r
        cen = np.array([px[m].mean(), py[m].mean(), pz[m].mean()])
        out.append([-cen[0], -cen[1], cen[2]])
    return np.asarray(out)

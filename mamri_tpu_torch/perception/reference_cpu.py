"""Golden CPU reference for the segmentation stage (numpy + scipy.ndimage).

Reproduces the semantics of the reference's SimpleITK pipeline
(Mamri/Mamri.py:1304-1341):
  BinaryThreshold(65, 65535)            -> inclusive intensity band
  BinaryMorphologicalClosing(ball r=2)  -> dilate/erode with a Euclidean ball,
                                           safe-border (pad so the border never
                                           clips the dilation)
  ConnectedComponent                    -> 6-connectivity (ITK default
                                           FullyConnected=False), labels in
                                           raster first-voxel order
  LabelShapeStatisticsImageFilter       -> physical size + physical centroid
Fiducials are components with 50 <= volume <= 1500 mm^3; centroids are
converted LPS->RAS; the body is the largest remaining component
(Mamri/Mamri.py:1310-1322).

This module is the trusted oracle the JAX/TPU path is tested against.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
from scipy import ndimage

from mamri_tpu_torch.perception.volume import Volume

INTENSITY_LOW = 65.0
INTENSITY_HIGH = 65535.0
MIN_VOLUME_MM3 = 50.0
MAX_VOLUME_MM3 = 1500.0
CLOSING_RADIUS_VOX = 2


def ball_structuring_element(radius: int = CLOSING_RADIUS_VOX) -> np.ndarray:
    """Euclidean ball of the given voxel radius (33 voxels for r=2)."""
    r = int(radius)
    g = np.mgrid[-r : r + 1, -r : r + 1, -r : r + 1]
    return (g[0] ** 2 + g[1] ** 2 + g[2] ** 2) <= r * r


def binary_close_safe_border(mask: np.ndarray, radius: int = CLOSING_RADIUS_VOX) -> np.ndarray:
    """Closing computed as if the mask were embedded in infinite background."""
    se = ball_structuring_element(radius)
    padded = np.pad(mask, radius, mode="constant", constant_values=False)
    dil = ndimage.binary_dilation(padded, structure=se)
    ero = ndimage.binary_erosion(dil, structure=se, border_value=0)
    sl = tuple(slice(radius, -radius) for _ in range(3))
    return ero[sl]


@dataclass
class CpuSegmentation:
    centroids_ras: np.ndarray  # (K, 3) fiducial centroids, RAS mm, label order
    volumes_mm3: np.ndarray  # (K,)
    body_mask: np.ndarray  # (nx, ny, nz) bool
    body_volume_mm3: float
    labels: np.ndarray  # full (nx, ny, nz) int labels (0 = background)
    num_components: int


def segment_reference(
    volume: Volume,
    intensity_low: float = INTENSITY_LOW,
    intensity_high: float = INTENSITY_HIGH,
    min_volume_mm3: float = MIN_VOLUME_MM3,
    max_volume_mm3: float = MAX_VOLUME_MM3,
    closing_radius: int = CLOSING_RADIUS_VOX,
) -> CpuSegmentation:
    data = volume.data
    binary = (data >= intensity_low) & (data <= intensity_high)
    closed = binary_close_safe_border(binary, closing_radius)

    structure = ndimage.generate_binary_structure(3, 1)  # 6-connectivity
    labels, num = ndimage.label(closed, structure=structure)

    voxvol = volume.voxel_volume_mm3
    centroids: List[np.ndarray] = []
    vols: List[float] = []
    body_label: Optional[int] = None
    body_count = 0
    if num > 0:
        counts = np.bincount(labels.ravel(), minlength=num + 1)
        coms = ndimage.center_of_mass(closed, labels, index=np.arange(1, num + 1))
        # Re-order labels into ITK's raster order: ITK visits (z, y, x)
        # lexicographically, so its label k has the k-th smallest first voxel
        # in that order. scipy.ndimage.label visits (x, y, z)-major instead.
        nx, ny, _ = labels.shape
        gi, gj, gk = np.meshgrid(
            np.arange(nx), np.arange(ny), np.arange(labels.shape[2]), indexing="ij"
        )
        raster = gk * (nx * ny) + gj * nx + gi
        first_voxel = ndimage.minimum(raster, labels, index=np.arange(1, num + 1))
        order = np.argsort(first_voxel, kind="stable") + 1
        for lbl in order:
            vol = counts[lbl] * voxvol
            if min_volume_mm3 <= vol <= max_volume_mm3:
                com_idx = np.asarray(coms[lbl - 1], dtype=np.float64)
                lps = volume.origin + volume.spacing * com_idx
                centroids.append(lps * np.asarray([-1.0, -1.0, 1.0]))
                vols.append(vol)
            else:
                if counts[lbl] > body_count:
                    body_count = counts[lbl]
                    body_label = lbl

    body_mask = labels == body_label if body_label is not None else np.zeros_like(closed, dtype=bool)
    return CpuSegmentation(
        centroids_ras=np.asarray(centroids, dtype=np.float32).reshape(-1, 3),
        volumes_mm3=np.asarray(vols, dtype=np.float32),
        body_mask=body_mask,
        body_volume_mm3=float(body_count * voxvol),
        labels=labels,
        num_components=int(num),
    )

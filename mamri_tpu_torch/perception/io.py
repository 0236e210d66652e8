"""Medical-volume file IO: NIfTI-1 (.nii / .nii.gz) + geometry normalization.

The reference receives volumes from the Slicer scene (sitkUtils.PullVolume...,
Mamri/Mamri.py:1306); standalone mamri_tpu_torch needs its own ingest. NIfTI affines
map voxel ijk -> RAS+; `Volume` stores LPS origin/spacing. Axis-aligned
affines (any permutation/flip of axes) are normalized by index reordering —
lossless; oblique affines (clinical volumes are rarely perfectly aligned) are
trilinearly resampled onto an axis-aligned LPS grid at the source spacing
(`resample_to_axis_aligned`). DICOM series ingest/export lives in
perception/dicom.py and shares the same normalization (`volume_from_affine`).
"""

from __future__ import annotations

import gzip
import struct
from typing import Tuple

import numpy as np

from mamri_tpu_torch.perception.volume import Volume, storage_array


def _is_axis_aligned(rot: np.ndarray, tol: float = 1e-3) -> bool:
    """True when each column of the 3x3 voxel-step matrix has a single
    dominant entry (pure permutation/flip of axes, no shear/rotation)."""
    for c in range(3):
        col = np.abs(rot[:, c])
        mx = col.max()
        if mx <= 0 or (col.sum() - mx) > tol * mx:
            return False
    return True


def volume_from_affine(data: np.ndarray, affine_lps: np.ndarray) -> Volume:
    """Build an axis-aligned LPS `Volume` from (nx, ny, nz) data and a
    voxel-index -> LPS affine (3x4). Permutation/flip affines are normalized
    exactly by index reordering; oblique affines are resampled."""
    affine_lps = np.asarray(affine_lps, dtype=np.float64)
    rot = affine_lps[:, :3]
    if not _is_axis_aligned(rot):
        return resample_to_axis_aligned(data, affine_lps)
    # permute indices so index axis a drives LPS axis a
    perm = [int(np.argmax(np.abs(rot[:, c]))) for c in range(3)]  # col c -> LPS row
    if sorted(perm) != [0, 1, 2]:
        return resample_to_axis_aligned(data, affine_lps)  # degenerate
    inv_perm = [perm.index(a) for a in range(3)]
    data = np.transpose(data, inv_perm)
    steps = np.array([rot[a, inv_perm[a]] for a in range(3)], dtype=np.float64)
    origin = affine_lps[:, 3].copy()
    for a in range(3):
        if steps[a] < 0:
            data = np.flip(data, axis=a)
            origin[a] = origin[a] + steps[a] * (data.shape[a] - 1)
            steps[a] = -steps[a]
    return Volume(
        # dtype passes through: Volume keeps compact scanner dtypes
        # (int8/16, uint8/16) for the halved-H2D ingest path and
        # normalizes everything else to float32
        data=np.ascontiguousarray(data),
        spacing=steps.astype(np.float32),
        origin=origin.astype(np.float32),
    )


def resample_to_axis_aligned(data: np.ndarray, affine_lps: np.ndarray, fill: float = 0.0) -> Volume:
    """Trilinearly resample an obliquely-oriented volume onto an axis-aligned
    LPS grid at the source spacing (the reference never needs this because
    Slicer's scene holds the IJK->RAS transform; a standalone pipeline must
    normalize geometry itself)."""
    data = np.asarray(data, dtype=np.float32)
    affine_lps = np.asarray(affine_lps, dtype=np.float64)
    rot = affine_lps[:, :3]
    t = affine_lps[:, 3]
    spacing = np.linalg.norm(rot, axis=0)
    shape = np.array(data.shape)

    corners_idx = np.array(
        [[i, j, k] for i in (0, shape[0] - 1) for j in (0, shape[1] - 1) for k in (0, shape[2] - 1)],
        dtype=np.float64,
    )
    corners = corners_idx @ rot.T + t
    lo, hi = corners.min(axis=0), corners.max(axis=0)
    if not (np.all(np.isfinite(affine_lps)) and np.all(spacing > 0)):
        raise ValueError("degenerate affine: non-finite entries or zero-length axis")
    out_shape = np.maximum(np.ceil((hi - lo) / spacing).astype(int) + 1, 1)
    # a rotation never inflates the voxel count beyond ~sqrt(3)^3 of the
    # source; anything larger means a corrupt affine, not an oblique scan
    if int(np.prod(out_shape)) > max(64, 8 * int(np.prod(shape))):
        raise ValueError(
            f"degenerate affine: resample target {tuple(out_shape)} is "
            f"implausible for source {tuple(shape)}"
        )
    try:
        inv = np.linalg.inv(rot)
    except np.linalg.LinAlgError as e:
        raise ValueError(f"degenerate affine: singular direction matrix ({e})") from e
    out = np.empty(tuple(out_shape), dtype=np.float32)
    ys = lo[1] + spacing[1] * np.arange(out_shape[1])
    zs = lo[2] + spacing[2] * np.arange(out_shape[2])
    yy, zz = np.meshgrid(ys, zs, indexing="ij")
    for i in range(out_shape[0]):  # chunk along x to bound memory
        pts = np.stack(
            [np.full(yy.shape, lo[0] + spacing[0] * i), yy, zz], axis=-1
        )  # (ny, nz, 3) LPS
        idx = (pts - t) @ inv.T  # voxel coords
        i0 = np.floor(idx).astype(np.int64)
        frac = (idx - i0).astype(np.float32)
        val = np.zeros(yy.shape, dtype=np.float32)
        inside = np.all((idx >= 0) & (idx <= shape - 1), axis=-1)
        i0c = np.clip(i0, 0, shape - 2)
        f = np.clip(frac, 0.0, 1.0)
        acc = np.zeros(yy.shape, dtype=np.float32)
        for di in (0, 1):
            wi = (1 - f[..., 0]) if di == 0 else f[..., 0]
            for dj in (0, 1):
                wj = (1 - f[..., 1]) if dj == 0 else f[..., 1]
                for dk in (0, 1):
                    wk = (1 - f[..., 2]) if dk == 0 else f[..., 2]
                    acc += (
                        wi
                        * wj
                        * wk
                        * data[i0c[..., 0] + di, i0c[..., 1] + dj, i0c[..., 2] + dk]
                    )
        val = np.where(inside, acc, np.float32(fill))
        out[i] = val
    return Volume(
        data=out,
        spacing=spacing.astype(np.float32),
        origin=lo.astype(np.float32),
    )

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
}


def _read_bytes(path: str) -> bytes:
    if path.lower().endswith(".gz"):
        with gzip.open(path, "rb") as f:
            return f.read()
    with open(path, "rb") as f:
        return f.read()


def load_nifti(path: str) -> Volume:
    raw = _read_bytes(path)
    if len(raw) < 352:
        raise ValueError(f"{path}: too small to be NIfTI-1")
    sizeof_hdr = struct.unpack("<i", raw[:4])[0]
    byteorder = "<"
    if sizeof_hdr != 348:
        sizeof_hdr = struct.unpack(">i", raw[:4])[0]
        if sizeof_hdr != 348:
            raise ValueError(f"{path}: not a NIfTI-1 file")
        byteorder = ">"
    magic = raw[344:348]
    if magic not in (b"n+1\x00", b"ni1\x00"):
        raise ValueError(f"{path}: bad NIfTI magic {magic!r}")

    dim = struct.unpack(byteorder + "8h", raw[40:56])
    ndim = dim[0]
    if ndim < 3:
        raise ValueError(f"{path}: need a 3-D volume, got dim={dim}")
    nx, ny, nz = dim[1], dim[2], dim[3]
    datatype = struct.unpack(byteorder + "h", raw[70:72])[0]
    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
    pixdim = struct.unpack(byteorder + "8f", raw[76:108])
    vox_offset_f = struct.unpack(byteorder + "f", raw[108:112])[0]
    if not np.isfinite(vox_offset_f):
        raise ValueError(f"{path}: non-finite vox_offset")
    vox_offset = int(vox_offset_f)
    scl_slope = struct.unpack(byteorder + "f", raw[112:116])[0] or 1.0
    scl_inter = struct.unpack(byteorder + "f", raw[116:120])[0]
    sform_code = struct.unpack(byteorder + "h", raw[254:256])[0]
    srow = np.array(struct.unpack(byteorder + "12f", raw[280:328])).reshape(3, 4)

    count = nx * ny * nz
    dt = np.dtype(_DTYPES[datatype]).newbyteorder(byteorder)
    if nx <= 0 or ny <= 0 or nz <= 0:
        raise ValueError(f"{path}: non-positive dims {dim[1:4]}")
    if not 0 <= vox_offset <= len(raw) - count * dt.itemsize:
        raise ValueError(
            f"{path}: vox_offset {vox_offset} / dims {dim[1:4]} exceed the file"
        )
    data = np.frombuffer(raw, dtype=dt, count=count, offset=vox_offset)
    data = data.reshape((nx, ny, nz), order="F")
    if scl_slope == 1.0 and scl_inter == 0.0:
        pass  # identity rescale: keep the storage dtype (compact ingest)
    else:
        data = np.asarray(data, dtype=np.float32) * scl_slope + scl_inter

    if sform_code > 0:
        # NIfTI srow maps voxel ijk -> RAS; Volume is LPS = diag(-1,-1,1)@RAS.
        affine_lps = srow.astype(np.float64).copy()
        affine_lps[0] *= -1.0
        affine_lps[1] *= -1.0
        # permutation/flip affines normalize exactly; obliques resample
        return volume_from_affine(data, affine_lps)

    qform_code = struct.unpack(byteorder + "h", raw[252:254])[0]
    if qform_code > 0:
        # qform (the "method 2" orientation real scanners write when no
        # sform is present): unit quaternion (a, b, c, d) with a recovered
        # from the stored (b, c, d), qfac = pixdim[0] (z-column sign), and
        # the qoffset translation. Spec: nifti1.h "METHOD 2".
        b, c, d = struct.unpack(byteorder + "3f", raw[256:268])
        qx, qy, qz = struct.unpack(byteorder + "3f", raw[268:280])
        a_sq = 1.0 - (b * b + c * c + d * d)
        a = np.sqrt(a_sq) if a_sq > 0.0 else 0.0
        rot = np.array(
            [
                [a * a + b * b - c * c - d * d, 2 * b * c - 2 * a * d, 2 * b * d + 2 * a * c],
                [2 * b * c + 2 * a * d, a * a + c * c - b * b - d * d, 2 * c * d - 2 * a * b],
                [2 * b * d - 2 * a * c, 2 * c * d + 2 * a * b, a * a + d * d - c * c - b * b],
            ],
            dtype=np.float64,
        )
        qfac = -1.0 if pixdim[0] < 0 else 1.0
        affine_ras = np.empty((3, 4), dtype=np.float64)
        for col in range(3):
            scale = abs(pixdim[col + 1]) * (qfac if col == 2 else 1.0)
            affine_ras[:, col] = rot[:, col] * scale
        affine_ras[:, 3] = (qx, qy, qz)
        affine_lps = affine_ras
        affine_lps[0] *= -1.0
        affine_lps[1] *= -1.0
        return volume_from_affine(data, affine_lps)

    # no orientation stored at all: pixdim with origin at 0
    spacing = np.array([abs(pixdim[1]), abs(pixdim[2]), abs(pixdim[3])], dtype=np.float32)
    return Volume(data=np.ascontiguousarray(data), spacing=spacing, origin=np.zeros(3, dtype=np.float32))


def save_nifti(path: str, volume: Volume) -> None:
    """Write a minimal NIfTI-1 file (sform from the LPS geometry). The
    volume's storage dtype is kept: compact scanner dtypes (int8/16,
    uint8/16) write as-is and re-load compact; everything else float32."""
    data = storage_array(volume.data)
    code = {
        np.dtype(np.uint8): 2, np.dtype(np.int16): 4, np.dtype(np.float32): 16,
        np.dtype(np.int8): 256, np.dtype(np.uint16): 512,
    }[data.dtype]
    nx, ny, nz = data.shape
    hdr = bytearray(352)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, 3, nx, ny, nz, 1, 1, 1, 1)
    struct.pack_into("<h", hdr, 70, code)  # datatype
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)  # bitpix
    struct.pack_into("<8f", hdr, 76, 1.0, *volume.spacing.tolist(), 1.0, 1.0, 1.0, 1.0)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
    struct.pack_into("<h", hdr, 254, 1)  # sform_code
    origin_ras = volume.origin * np.array([-1.0, -1.0, 1.0], dtype=np.float32)
    # matching qform for readers that prefer method 2: the axis-aligned LPS
    # direction is RotZ(180) in RAS = quaternion (a,b,c,d) = (0,0,0,1)
    struct.pack_into("<h", hdr, 252, 1)  # qform_code
    struct.pack_into("<3f", hdr, 256, 0.0, 0.0, 1.0)  # quatern b, c, d
    struct.pack_into("<3f", hdr, 268, *[float(v) for v in origin_ras])
    sx, sy, sz = volume.spacing.tolist()
    # LPS spacing along +x LPS = -x RAS direction
    struct.pack_into("<4f", hdr, 280, -sx, 0.0, 0.0, float(origin_ras[0]))
    struct.pack_into("<4f", hdr, 296, 0.0, -sy, 0.0, float(origin_ras[1]))
    struct.pack_into("<4f", hdr, 312, 0.0, 0.0, sz, float(origin_ras[2]))
    hdr[344:348] = b"n+1\x00"
    payload = bytes(hdr) + data.astype(data.dtype.newbyteorder("<")).tobytes(order="F")
    if path.lower().endswith(".gz"):
        with gzip.open(path, "wb") as f:
            f.write(payload)
    else:
        with open(path, "wb") as f:
            f.write(payload)

"""Native host-side runtime: ctypes bindings over libmamri_native (C++).

Lazily compiled with g++ on first use (into build/mamri_tpu_torch/native-<hash>/). All
callers have pure-Python fallbacks, so a missing toolchain degrades
gracefully.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ccl_native.cpp")
_CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(_SRC))), "build", "mamri_tpu_torch")
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _lib_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_CACHE_DIR, f"native-{digest}", "libmamri_native.so")


def _build() -> Optional[str]:
    path = _lib_path()
    if os.path.exists(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"  # per process: concurrent builds never share a file
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, path)
        return path
    except Exception as e:  # missing g++, compile error, ...
        logger.warning("native build failed (%s); using Python fallbacks", e)
        return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    if _build_failed:
        return None
    path = _build()
    if path is None:
        _build_failed = True
        return None
    lib = ctypes.CDLL(path)
    lib.mamri_parse_stl.restype = ctypes.c_int
    lib.mamri_parse_stl.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_float))]
    lib.mamri_free.argtypes = [ctypes.c_void_p]
    lib.mamri_label_components.restype = ctypes.c_int
    lib.mamri_label_components.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.mamri_packbits_decode.restype = ctypes.c_int64
    lib.mamri_packbits_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
    ]
    lib.mamri_packbits_encode.restype = ctypes.c_int64
    lib.mamri_packbits_encode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.mamri_jpegll_decode.restype = ctypes.c_int64
    lib.mamri_jpegll_decode.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint16),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.mamri_jpegls_decode.restype = ctypes.c_int64
    lib.mamri_jpegls_decode.argtypes = list(lib.mamri_jpegll_decode.argtypes)
    lib.mamri_jpegls_encode.restype = ctypes.c_int64
    lib.mamri_jpegls_encode.argtypes = [
        ctypes.POINTER(ctypes.c_uint16),
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
    ]
    lib.mamri_jpegll_emit.restype = ctypes.c_int64
    lib.mamri_jpegll_emit.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
    ]
    lib.mamri_jpegdct_scan.restype = ctypes.c_int64
    lib.mamri_jpegdct_scan.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.mamri_j2k_t1_decode.restype = ctypes.c_int64
    lib.mamri_j2k_t1_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.mamri_j2k_t1_encode.restype = ctypes.c_int64
    lib.mamri_j2k_t1_encode.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def parse_stl_native(path: str) -> Optional[np.ndarray]:
    """Binary STL -> (T, 3, 3) float32, or None if unavailable/not binary."""
    lib = _load()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_float)()
    n = lib.mamri_parse_stl(path.encode(), ctypes.byref(out))
    if n < 0:
        return None
    try:
        arr = np.ctypeslib.as_array(out, shape=(n * 9,)).reshape(n, 3, 3).copy()
    finally:
        lib.mamri_free(out)
    return arr


def label_components_native(mask: np.ndarray) -> Optional[Tuple[np.ndarray, int]]:
    """6-connectivity CCL; labels 1..K in ITK raster order, 0 background."""
    lib = _load()
    if lib is None:
        return None
    mask_u8 = np.ascontiguousarray(mask.astype(np.uint8))
    nx, ny, nz = mask_u8.shape
    labels = np.zeros_like(mask_u8, dtype=np.int32)
    k = lib.mamri_label_components(
        mask_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        nx,
        ny,
        nz,
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return labels, int(k)


def packbits_decode_native(data: bytes, expected: int) -> Optional[bytes]:
    """PackBits decode via the C codec; None if unavailable, ValueError on
    truncated input (same contract as the Python fallback)."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty(expected, dtype=np.uint8)
    n = lib.mamri_packbits_decode(
        data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), expected
    )
    if n < 0 or n < expected:
        raise ValueError(f"RLE segment truncated: {max(n, 0)} < {expected}")
    return out.tobytes()


def packbits_encode_native(seg: bytes) -> Optional[bytes]:
    """PackBits encode via the C codec (byte-identical to the Python
    encoder); None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty(len(seg) + len(seg) // 128 + 2, dtype=np.uint8)
    n = lib.mamri_packbits_encode(
        seg, len(seg), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    )
    return out[:n].tobytes()


def jpegll_decode_native(data: bytes) -> Optional[Tuple[np.ndarray, int]]:
    """JPEG Lossless decode via the C++ codec -> ((rows, cols) uint16,
    precision); None if the native library is unavailable, ValueError on a
    malformed stream (the Python decoder in perception.jpegll is the
    fallback and oracle — both must produce identical samples)."""
    lib = _load()
    if lib is None:
        return None
    rows = ctypes.c_int32(0)
    cols = ctypes.c_int32(0)
    prec = ctypes.c_int32(0)
    # size the buffer exactly by walking marker segments to the real SOF3
    # (a raw byte find() would match FF C3 inside APPn/COM payloads)
    r = c = None
    pos = 2 if data[:2] == b"\xff\xd8" else 0
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        marker = data[pos + 1]
        if marker == 0xC3:  # SOF3: len(2) prec(1) rows(2) cols(2)
            if pos + 9 <= len(data):
                r = int.from_bytes(data[pos + 5 : pos + 7], "big")
                c = int.from_bytes(data[pos + 7 : pos + 9], "big")
            break
        if marker == 0xDA:  # SOS without a prior SOF3
            break
        if marker in (0x01, 0xD8) or 0xD0 <= marker <= 0xD7:
            pos += 2  # standalone markers carry no length
            continue
        pos += 2 + int.from_bytes(data[pos + 2 : pos + 4], "big")
    if r is None:
        raise ValueError("not a JPEG Lossless stream (no SOF3 marker)")
    if r * c > 1 << 26:
        raise ValueError("image larger than the 64-Mpixel decode cap")
    cap = max(r * c, 1)
    out = np.empty(cap, dtype=np.uint16)
    n = lib.mamri_jpegll_decode(
        data,
        len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        cap,
        ctypes.byref(rows),
        ctypes.byref(cols),
        ctypes.byref(prec),
    )
    if n < 0:
        raise ValueError(f"JPEG Lossless decode failed (native error {n})")
    return out[:n].reshape(rows.value, cols.value), prec.value


def jpegls_decode_native(data: bytes) -> Optional[Tuple[np.ndarray, int]]:
    """JPEG-LS lossless decode via the C++ codec -> ((rows, cols) uint16,
    precision); None if the native library is unavailable, ValueError on a
    malformed/unsupported stream (perception.jpegls is the fallback and
    oracle — both must produce identical samples)."""
    lib = _load()
    if lib is None:
        return None
    # size the buffer from SOF55, walking marker segments (cf. jpegll above)
    r = c = None
    pos = 2 if data[:2] == b"\xff\xd8" else 0
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        marker = data[pos + 1]
        if marker == 0xF7:  # SOF55: len(2) prec(1) rows(2) cols(2)
            if pos + 9 <= len(data):
                r = int.from_bytes(data[pos + 5 : pos + 7], "big")
                c = int.from_bytes(data[pos + 7 : pos + 9], "big")
            break
        if marker == 0xDA:
            break
        if marker in (0x01, 0xD8) or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        pos += 2 + int.from_bytes(data[pos + 2 : pos + 4], "big")
    if r is None:
        raise ValueError("not a JPEG-LS stream (no SOF55 marker)")
    if r * c > 1 << 26:
        raise ValueError("image larger than the 64-Mpixel decode cap")
    cap = max(r * c, 1)
    out = np.empty(cap, dtype=np.uint16)
    rows = ctypes.c_int32(0)
    cols = ctypes.c_int32(0)
    prec = ctypes.c_int32(0)
    n = lib.mamri_jpegls_decode(
        data,
        len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        cap,
        ctypes.byref(rows),
        ctypes.byref(cols),
        ctypes.byref(prec),
    )
    if n < 0:
        raise ValueError(f"JPEG-LS decode failed (native error {n})")
    return out[:n].reshape(rows.value, cols.value), prec.value


def jpegls_encode_native(img: np.ndarray, precision: int, near: int = 0) -> Optional[bytes]:
    """JPEG-LS entropy coding (lossless NEAR=0 or near-lossless NEAR>0) of
    one (rows, cols) uint16 image via the C++ codec -> raw scan bytes (no
    marker framing; perception.jpegls wraps them). Bit-identical to the
    Python encoder. None if the native library is unavailable, ValueError
    on bad samples."""
    lib = _load()
    if lib is None:
        return None
    a = np.ascontiguousarray(img, dtype=np.uint16)
    rows, cols = a.shape
    # worst case is the limited-Golomb escape every sample: LIMIT bits
    # (<= 64) plus 8/7 stuffing overhead
    cap = a.size * 10 + 1024
    out = np.empty(cap, dtype=np.uint8)
    n = lib.mamri_jpegls_encode(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        rows,
        cols,
        precision,
        near,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        cap,
    )
    if n < 0:
        raise ValueError(f"JPEG-LS encode failed (native error {n})")
    return out[:n].tobytes()


def j2k_t1_decode_native(
    data: bytes, w: int, h: int, orient: int, bitplanes: int, npasses: int
) -> Optional[np.ndarray]:
    """EBCOT Tier-1 code-block decode via the C++ codec -> (h, w) int32;
    None if the native library is unavailable, ValueError on a malformed
    segment (perception.jpeg2000.t1_decode is the fallback and oracle)."""
    lib = _load()
    if lib is None:
        return None
    out = np.zeros(h * w, dtype=np.int32)
    r = lib.mamri_j2k_t1_decode(
        data, len(data), w, h, orient, bitplanes, npasses,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if r < 0:
        raise ValueError(f"JPEG 2000 code-block decode failed (native error {r})")
    return out.reshape(h, w)


def j2k_t1_encode_native(
    coeffs: np.ndarray, orient: int, max_bitplanes: int
) -> Optional[Tuple[bytes, int, int]]:
    """EBCOT Tier-1 code-block encode via the C++ codec -> (data, zero
    bitplanes, passes). Bit-identical to the Python encoder. None if the
    native library is unavailable, ValueError on out-of-range coefficients."""
    lib = _load()
    if lib is None:
        return None
    a = np.ascontiguousarray(coeffs, dtype=np.int32)
    h, w = a.shape
    # worst case: ~3 passes/plane, < 2 decisions/sample/pass, << 1 byte each;
    # 16 bytes/sample is a generous hard bound
    cap = a.size * 16 + 1024
    out = np.empty(cap, dtype=np.uint8)
    zbp = ctypes.c_int32(0)
    np_ = ctypes.c_int32(0)
    n = lib.mamri_j2k_t1_encode(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        w, h, orient, max_bitplanes,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap,
        ctypes.byref(zbp), ctypes.byref(np_),
    )
    if n < 0:
        raise ValueError(f"JPEG 2000 code-block encode failed (native error {n})")
    return out[:n].tobytes(), zbp.value, np_.value


def jpegdct_scan_native(data: bytes, max_blocks: int) -> Optional[Tuple[np.ndarray, int, int, int]]:
    """Sequential-DCT JPEG Huffman scan via the C++ codec -> (zigzag
    coefficients (nblocks, 64) int32, rows, cols, precision); None if the
    native library is unavailable, ValueError on malformed streams
    (perception.jpegdct's Python scan loop is the fallback and oracle)."""
    lib = _load()
    if lib is None:
        return None
    out = np.zeros(max_blocks * 64, dtype=np.int32)
    rows = ctypes.c_int32(0)
    cols = ctypes.c_int32(0)
    prec = ctypes.c_int32(0)
    n = lib.mamri_jpegdct_scan(
        data, len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), max_blocks,
        ctypes.byref(rows), ctypes.byref(cols), ctypes.byref(prec),
    )
    if n < 0:
        raise ValueError(f"JPEG scan decode failed (native error {n})")
    return out[: n * 64].reshape(n, 64).astype(np.int64), rows.value, cols.value, prec.value


def jpegll_emit_native(
    diffs: np.ndarray, cats: np.ndarray, codes: np.ndarray, lens: np.ndarray
) -> Optional[bytes]:
    """Huffman bit-emit of one JPEG-Lossless band via the C++ codec —
    byte-identical to perception.jpegll's Python emit loop. None if the
    native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    d = np.ascontiguousarray(diffs, dtype=np.int32)
    c = np.ascontiguousarray(cats, dtype=np.uint8)
    # Worst case: 16-bit code + 16-bit magnitude = 4 bytes/sample, and FF00
    # stuffing can double that on adversarial all-FF streams -> 8 bytes/sample.
    cap = d.size * 8 + 16
    out = np.empty(cap, dtype=np.uint8)
    n = lib.mamri_jpegll_emit(
        d.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        d.size,
        np.ascontiguousarray(codes, dtype=np.uint32).ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        np.ascontiguousarray(lens, dtype=np.uint8).ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        cap,
    )
    if n == -2:
        return None  # output cap exceeded: fall back to the capless Python emitter
    if n < 0:
        raise ValueError(f"JPEG Lossless emit failed (native error {n})")
    return out[:n].tobytes()

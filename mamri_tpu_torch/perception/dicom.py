"""DICOM series ingest/export, pure numpy (no pydicom in the image).

The reference consumes scanner volumes through the Slicer scene
(`sitkUtils.PullVolumeFromSlicer`, Mamri/Mamri.py:1306), whose DICOM plugin
stack does the series assembly; standalone mamri_tpu_torch does its own:

  * `load_dicom_series(dir)` — MR series in implicit/explicit VR little
    endian, deflated explicit VR LE, explicit VR big endian, RLE Lossless
    (encapsulated PackBits), JPEG Lossless (.57/.70), JPEG-LS lossless
    (.80), JPEG-LS near-lossless (.81), or JPEG 2000 (.90 lossless and
    .91 incl. irreversible 9/7); baseline lossy JPEG is rejected loudly,
    as is near-lossless content mislabeled under a lossless UID. Both
    one-file-per-slice series and multi-frame files assemble: classic
    multi-frame (NumberOfFrames + SpacingBetweenSlices along the IOP
    normal) and Enhanced MR (per-frame PlanePosition + shared
    PlaneOrientation/PixelMeasures/PixelValueTransformation functional
    groups, PS3.3 C.7.6.16). Slices sorted by the projection of
    ImagePositionPatient onto the slice normal (row x col direction), the
    standard geometric sort; rescale slope/intercept applied. Axis-aligned
    orientations (any axis permutation/flip) map directly onto the LPS
    `Volume` grid; oblique series are trilinearly resampled
    (perception.io.resample_to_axis_aligned).
  * `save_dicom_series(dir, volume)` — MR Image Storage, one file per slice,
    int16 with exact rescale, explicit VR LE, deflated (`transfer="deflated"`),
    RLE Lossless (`transfer="rle"`), JPEG Lossless (`transfer="jpegll"`),
    JPEG-LS (`transfer="jpegls"`) or JPEG 2000 (`transfer="j2k"`) — the
    round-trip oracle for the reader and a capability the reference lacks
    (export). `save_dicom_multiframe(path, volume)` writes the Enhanced MR
    single-file form of the same.

DICOM patient coordinates are LPS, the same convention `Volume` stores, so no
RAS flip happens here (the LPS->RAS flip lives at the segmentation boundary,
Mamri/Mamri.py:1317).
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from mamri_tpu_torch.perception.volume import Volume

# transfer syntaxes
_IMPLICIT_LE = "1.2.840.10008.1.2"
_EXPLICIT_LE = "1.2.840.10008.1.2.1"
_DEFLATED_LE = "1.2.840.10008.1.2.1.99"  # raw-deflate over the dataset
_EXPLICIT_BE = "1.2.840.10008.1.2.2"
_RLE_LOSSLESS = "1.2.840.10008.1.2.5"
_JPEG_BASE = "1.2.840.10008.1.2.4.50"  # baseline lossy DCT (8-bit)
_JPEG_EXT = "1.2.840.10008.1.2.4.51"  # extended sequential lossy DCT (12-bit)
_JPEG_LL = "1.2.840.10008.1.2.4.57"  # lossless non-hierarchical, any predictor
_JPEG_LL_SV1 = "1.2.840.10008.1.2.4.70"  # lossless first-order prediction
_JPEG_LS = "1.2.840.10008.1.2.4.80"  # JPEG-LS lossless (NEAR=0)
_JPEG_LS_NEAR = "1.2.840.10008.1.2.4.81"  # JPEG-LS near-lossless (NEAR>0)
_J2K_LL = "1.2.840.10008.1.2.4.90"  # JPEG 2000 lossless-only (reversible 5/3)
_J2K = "1.2.840.10008.1.2.4.91"  # JPEG 2000 (decodable when reversible)
_MR_STORAGE = "1.2.840.10008.5.1.4.1.1.4"
_ENHANCED_MR_STORAGE = "1.2.840.10008.5.1.4.1.1.4.1"

_LONG_VRS = {b"OB", b"OW", b"OF", b"OL", b"OD", b"SQ", b"UC", b"UR", b"UT", b"UN"}

# Sequences we must structurally parse even in implicit VR (no VR byte says
# "SQ" there): the Enhanced multi-frame functional-group containers
# (PS3.3 C.7.6.16) and the macros that hold geometry/rescale inside them.
_SQ_TAGS = {
    (0x5200, 0x9229),  # SharedFunctionalGroupsSequence
    (0x5200, 0x9230),  # PerFrameFunctionalGroupsSequence
    (0x0020, 0x9113),  # PlanePositionSequence
    (0x0020, 0x9116),  # PlaneOrientationSequence
    (0x0028, 0x9110),  # PixelMeasuresSequence
    (0x0028, 0x9145),  # PixelValueTransformationSequence
}


class _Reader:
    def __init__(self, buf: bytes, explicit: bool, big_endian: bool = False):
        self.buf = buf
        self.pos = 0
        self.explicit = explicit
        self.end = ">" if big_endian else "<"

    def eof(self) -> bool:
        return self.pos >= len(self.buf)

    def _u16(self):
        v = struct.unpack_from(self.end + "H", self.buf, self.pos)[0]
        self.pos += 2
        return v

    def _u32(self):
        v = struct.unpack_from(self.end + "I", self.buf, self.pos)[0]
        self.pos += 4
        return v

    def read_element(self) -> Tuple[Tuple[int, int], Optional[bytes]]:
        """Returns ((group, elem), value_bytes). Sequences and undefined-length
        items are skipped structurally (value None) — EXCEPT encapsulated
        pixel data (7FE0,0010 with undefined length), whose compressed frame
        fragments are captured and returned as a list of bytes."""
        group = self._u16()
        elem = self._u16()
        tag = (group, elem)
        if group == 0xFFFE:  # item / delimiters carry no VR ever
            length = self._u32()
            if length == 0xFFFFFFFF:
                length = 0
            self.pos += length
            return tag, None
        if self.explicit:
            vr = self.buf[self.pos : self.pos + 2]
            self.pos += 2
            if vr in _LONG_VRS:
                self.pos += 2  # reserved
                length = self._u32()
            else:
                length = self._u16()
        else:
            vr = b"UN"
            length = self._u32()
        if length == 0xFFFFFFFF:
            if tag == (0x7FE0, 0x0010):
                return tag, self._read_fragments()
            return tag, ("SQ", self._read_items(None))
        if vr == b"SQ" or (not self.explicit and tag in _SQ_TAGS):
            return tag, ("SQ", self._read_items(length))
        value = self.buf[self.pos : self.pos + length]
        self.pos += length
        return tag, value

    def _read_items(self, length: Optional[int]) -> List[bytes]:
        """Parse SQ content into one byte blob per item (each blob is an
        element stream in the parent's encoding). `length=None` walks an
        undefined-length sequence to its (FFFE,E0DD) delimiter."""
        items: List[bytes] = []
        end = None if length is None else self.pos + length
        while (self.pos < end) if end is not None else not self.eof():
            group = self._u16()
            elem = self._u16()
            ilen = self._u32()
            if (group, elem) == (0xFFFE, 0xE0DD):
                return items
            if (group, elem) != (0xFFFE, 0xE000):
                raise ValueError("malformed sequence item")
            if ilen == 0xFFFFFFFF:
                start = self.pos
                self._skip_item_undefined()
                items.append(self.buf[start : self.pos - 8])  # minus (FFFE,E00D)+len
            else:
                items.append(self.buf[self.pos : self.pos + ilen])
                self.pos += ilen
        if end is None:
            raise ValueError("unterminated undefined-length sequence")
        return items

    def _read_fragments(self) -> List[bytes]:
        """Encapsulated pixel data: item 0 = basic offset table (dropped),
        following items = one compressed frame each, until (FFFE,E0DD)."""
        frags: List[bytes] = []
        first = True
        while not self.eof():
            group = self._u16()
            elem = self._u16()
            length = self._u32()
            if (group, elem) == (0xFFFE, 0xE0DD):
                return frags
            if (group, elem) != (0xFFFE, 0xE000):
                raise ValueError("malformed encapsulated pixel data")
            value = self.buf[self.pos : self.pos + length]
            self.pos += length
            if first:
                first = False  # basic offset table
            else:
                frags.append(value)
        raise ValueError("unterminated encapsulated pixel data")

    def _skip_item_undefined(self):
        while not self.eof():
            group = self._u16()
            elem = self._u16()
            if (group, elem) == (0xFFFE, 0xE00D):
                self._u32()
                return
            # nested element inside the item — reuse the normal path
            self.pos -= 4
            self.read_element()


def _parse_item(blob: bytes, explicit: bool, be: bool) -> Dict[Tuple[int, int], object]:
    """Parse one sequence-item blob (an element stream in the parent's
    encoding) into a tag -> value map; nested sequences come back as
    ("SQ", [item_blob, ...])."""
    r = _Reader(blob, explicit=explicit, big_endian=be)
    out: Dict[Tuple[int, int], object] = {}
    while not r.eof():
        tag, val = r.read_element()
        out[tag] = val
    return out


def _floats(val: bytes) -> List[float]:
    return [float(x) for x in val.decode("ascii").strip("\x00 ").split("\\")]


def _resolve_functional_groups(out: Dict, explicit: bool, be: bool) -> None:
    """Enhanced multi-frame files keep geometry/rescale in functional-group
    sequences (PS3.3 C.7.6.16) rather than top-level elements: hoist the
    shared macros into `out` (top-level elements win if both exist) and
    collect per-frame ImagePositionPatient into `out["perframe_ipp"]`."""

    def first_item(d: Dict, tag) -> Optional[Dict]:
        v = d.get(tag)
        if isinstance(v, tuple) and v[0] == "SQ" and v[1]:
            return _parse_item(v[1][0], explicit, be)
        return None

    shared = out.get("shared_fg") or []
    sh = _parse_item(shared[0], explicit, be) if shared else {}
    pm = first_item(sh, (0x0028, 0x9110))  # PixelMeasures
    if pm is not None:
        if "pixel_spacing" not in out and (0x0028, 0x0030) in pm:
            out["pixel_spacing"] = _floats(pm[(0x0028, 0x0030)])
        if "spacing_between" not in out and (0x0018, 0x0088) in pm:
            out["spacing_between"] = _floats(pm[(0x0018, 0x0088)])
    po = first_item(sh, (0x0020, 0x9116))  # PlaneOrientation
    if po is not None and "iop" not in out and (0x0020, 0x0037) in po:
        out["iop"] = _floats(po[(0x0020, 0x0037)])
    pv = first_item(sh, (0x0028, 0x9145))  # PixelValueTransformation
    if pv is not None:
        if "intercept" not in out and (0x0028, 0x1052) in pv:
            out["intercept"] = _floats(pv[(0x0028, 0x1052)])
        if "slope" not in out and (0x0028, 0x1053) in pv:
            out["slope"] = _floats(pv[(0x0028, 0x1053)])

    ipps: List[List[float]] = []
    rescales: List[Optional[Tuple[float, float]]] = []
    for blob in out.get("perframe_fg") or []:
        fr = _parse_item(blob, explicit, be)
        pp = first_item(fr, (0x0020, 0x9113))  # PlanePosition
        if pp is None or (0x0020, 0x0032) not in pp:
            ipps = []  # incomplete per-frame geometry: fall back to classic
            break
        ipps.append(_floats(pp[(0x0020, 0x0032)]))
        if "iop" not in out:
            po = first_item(fr, (0x0020, 0x9116))
            if po is not None and (0x0020, 0x0037) in po:
                out["iop"] = _floats(po[(0x0020, 0x0037)])
        pm = first_item(fr, (0x0028, 0x9110))  # per-frame PixelMeasures
        if pm is not None:
            if "pixel_spacing" not in out and (0x0028, 0x0030) in pm:
                out["pixel_spacing"] = _floats(pm[(0x0028, 0x0030)])
            if "spacing_between" not in out and (0x0018, 0x0088) in pm:
                out["spacing_between"] = _floats(pm[(0x0018, 0x0088)])
        # per-frame rescale (some vendors put PixelValueTransformation here
        # rather than in the shared group); applied frame-wise on split
        pv = first_item(fr, (0x0028, 0x9145))
        if pv is not None and ((0x0028, 0x1052) in pv or (0x0028, 0x1053) in pv):
            rescales.append((
                _floats(pv[(0x0028, 0x1053)])[0] if (0x0028, 0x1053) in pv else 1.0,
                _floats(pv[(0x0028, 0x1052)])[0] if (0x0028, 0x1052) in pv else 0.0,
            ))
        else:
            rescales.append(None)
    if ipps:
        out["perframe_ipp"] = ipps
        out.setdefault("ipp", ipps[0])
        if any(r is not None for r in rescales):
            out["perframe_rescale"] = rescales


def _parse_file(path: str) -> Dict:
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) > 132 and raw[128:132] == b"DICM":
        # file meta group is always explicit VR LE
        meta = _Reader(raw[132:], explicit=True)
        transfer = _EXPLICIT_LE
        meta_len = None
        while not meta.eof():
            tag, val = meta.read_element()
            if tag == (0x0002, 0x0000):
                meta_len = struct.unpack("<I", val)[0]
                end = meta.pos + meta_len
            elif tag == (0x0002, 0x0010):
                transfer = val.decode("ascii").strip("\x00 ")
            if meta_len is not None and meta.pos >= end:
                break
        body_off = 132 + meta.pos
    else:
        transfer = _IMPLICIT_LE
        body_off = 0
    if transfer not in (
        _IMPLICIT_LE, _EXPLICIT_LE, _DEFLATED_LE, _EXPLICIT_BE, _RLE_LOSSLESS,
        _JPEG_BASE, _JPEG_EXT, _JPEG_LL, _JPEG_LL_SV1, _JPEG_LS, _JPEG_LS_NEAR,
        _J2K_LL, _J2K,
    ):
        raise ValueError(
            f"{path}: unsupported transfer syntax {transfer}; implicit/"
            "explicit VR LE, deflated explicit VR LE, explicit VR BE, RLE "
            "Lossless, lossy JPEG .50/.51, JPEG Lossless, JPEG-LS lossless + "
            "near-lossless and JPEG 2000 are supported"
        )

    body = raw[body_off:]
    if transfer == _DEFLATED_LE:
        import zlib

        try:
            body = zlib.decompress(body, -15)  # raw deflate, PS3.5 A.5
        except zlib.error as e:  # keep the loader's per-file ValueError contract
            raise ValueError(f"{path}: corrupt deflated dataset ({e})") from e
    r = _Reader(
        body,
        explicit=(transfer != _IMPLICIT_LE),
        big_endian=(transfer == _EXPLICIT_BE),
    )
    want = {
        (0x0020, 0x000E): "series_uid",
        (0x0020, 0x0032): "ipp",
        (0x0020, 0x0037): "iop",
        (0x0018, 0x0050): "slice_thickness",
        (0x0018, 0x0088): "spacing_between",
        (0x0028, 0x0008): "nframes",
        (0x0028, 0x0010): "rows",
        (0x0028, 0x0011): "cols",
        (0x0028, 0x0030): "pixel_spacing",
        (0x0028, 0x0100): "bits_allocated",
        (0x0028, 0x0103): "pixel_representation",
        (0x0028, 0x1052): "intercept",
        (0x0028, 0x1053): "slope",
        (0x5200, 0x9229): "shared_fg",
        (0x5200, 0x9230): "perframe_fg",
        (0x7FE0, 0x0010): "pixels",
    }
    out: Dict = {"path": path, "transfer": transfer}
    us = (">H" if transfer == _EXPLICIT_BE else "<H")
    while not r.eof():
        tag, val = r.read_element()
        name = want.get(tag)
        if name is None or val is None:
            continue
        if isinstance(val, tuple) and val[0] == "SQ":
            if name in ("shared_fg", "perframe_fg"):
                out[name] = val[1]
            continue
        if name in ("rows", "cols", "bits_allocated", "pixel_representation"):
            out[name] = struct.unpack(us, val[:2])[0]
        elif name == "nframes":
            out[name] = int(val.decode("ascii").strip("\x00 "))
        elif name in (
            "ipp", "iop", "pixel_spacing", "intercept", "slope",
            "spacing_between", "slice_thickness",
        ):
            out[name] = _floats(val)
        elif name == "series_uid":
            out[name] = val.decode("ascii").strip("\x00 ")
        else:
            out[name] = val
    if "shared_fg" in out or "perframe_fg" in out:
        _resolve_functional_groups(
            out, explicit=(transfer != _IMPLICIT_LE), be=(transfer == _EXPLICIT_BE)
        )
    for req in ("ipp", "iop", "rows", "cols", "pixel_spacing", "pixels"):
        if req not in out:
            raise ValueError(f"{path}: missing required DICOM element for {req}")
    return out


def _split_frames(info: Dict) -> List[Dict]:
    """Expand one multi-frame file into synthetic single-frame slice infos.

    Enhanced files carry a per-frame ImagePositionPatient (collected by
    `_resolve_functional_groups`); classic multi-frame files stack along the
    slice normal at SpacingBetweenSlices (default 1 mm) from the one IPP.
    """
    n = info["nframes"]
    ipps = info.get("perframe_ipp")
    if ipps is not None and len(ipps) != n:
        raise ValueError(
            f"{info['path']}: {len(ipps)} per-frame positions for {n} frames"
        )
    if ipps is None:
        step_l = info.get("spacing_between") or info.get("slice_thickness")
        if step_l is None:
            raise ValueError(
                f"{info['path']}: multi-frame file has neither per-frame "
                "positions nor a slice spacing (0018,0088 / 0018,0050)"
            )
        step = step_l[0]
        iop = np.asarray(info["iop"], dtype=np.float64)
        normal = np.cross(iop[:3], iop[3:])
        base = np.asarray(info["ipp"], dtype=np.float64)
        ipps = [(base + normal * (step * k)).tolist() for k in range(n)]
    rescales = info.get("perframe_rescale")
    pixels = info["pixels"]
    nbytes = info["rows"] * info["cols"] * (info.get("bits_allocated", 16) // 8)
    frames: List[Dict] = []
    for k in range(n):
        fi = dict(info)
        fi["nframes"] = 1
        fi["ipp"] = ipps[k]
        if rescales is not None and rescales[k] is not None:
            fi["slope"], fi["intercept"] = [rescales[k][0]], [rescales[k][1]]
        fi.pop("perframe_ipp", None)
        fi.pop("perframe_rescale", None)
        if isinstance(pixels, list):
            # encapsulated multi-frame: PS3.5 A.4 requires one fragment per
            # frame when frames > 1 (no other split is decodable frame-wise)
            if len(pixels) != n:
                raise ValueError(
                    f"{info['path']}: {len(pixels)} pixel fragments for {n} frames"
                )
            fi["pixels"] = [pixels[k]]
        else:
            if len(pixels) < nbytes * n:
                raise ValueError(f"{info['path']}: pixel data too short for {n} frames")
            fi["pixels"] = pixels[nbytes * k : nbytes * (k + 1)]
        frames.append(fi)
    return frames


# --------------------------------------------------- RLE Lossless (PackBits)
def _packbits_decode(data: bytes, expected: int) -> bytes:
    """DICOM/TIFF PackBits: n in [0,127] -> copy n+1 literal bytes;
    n in [129,255] -> repeat next byte 257-n times; 128 -> noop.
    Dispatches to the native C codec when built (mamri_tpu_torch.native);
    byte-identical Python fallback below."""
    from mamri_tpu_torch.native import packbits_decode_native

    native = packbits_decode_native(data, expected)
    if native is not None:
        return native
    out = bytearray()
    i, n = 0, len(data)
    while i < n and len(out) < expected:
        c = data[i]
        i += 1
        if c < 128:
            out += data[i : i + c + 1]
            i += c + 1
        elif c > 128:
            out += bytes([data[i]]) * (257 - c)
            i += 1
    if len(out) < expected:
        raise ValueError(f"RLE segment truncated: {len(out)} < {expected}")
    return bytes(out[:expected])


def _packbits_encode(seg: bytes) -> bytes:
    from mamri_tpu_torch.native import packbits_encode_native

    native = packbits_encode_native(seg)
    if native is not None:
        return native
    out = bytearray()
    i, n = 0, len(seg)
    while i < n:
        j = i
        while j + 1 < n and seg[j + 1] == seg[i] and j - i < 127:
            j += 1
        run = j - i + 1
        if run >= 2:
            out.append((257 - run) & 0xFF)
            out.append(seg[i])
            i = j + 1
        else:
            k = i
            while k < n and k - i < 128:
                if k + 2 < n and seg[k + 1] == seg[k] and seg[k + 2] == seg[k]:
                    break
                k += 1
            out.append(k - i - 1)
            out += seg[i:k]
            i = k
    return bytes(out)


def _rle_decode_frame(frame: bytes, npix: int, nseg_expected: int) -> List[bytes]:
    """One RLE frame -> its decoded byte segments (PS3.5 annex G: a 64-byte
    header of segment count + 15 offsets, then PackBits segments; 16-bit
    data is decomposed big-endian — MSB segment first)."""
    if len(frame) < 64:
        raise ValueError(f"RLE frame header truncated ({len(frame)} < 64 bytes)")
    hdr = struct.unpack_from("<16I", frame, 0)
    nseg = hdr[0]
    if nseg != nseg_expected:
        raise ValueError(f"RLE frame has {nseg} segments, expected {nseg_expected}")
    offsets = list(hdr[1 : 1 + nseg]) + [len(frame)]
    return [
        _packbits_decode(frame[offsets[s] : offsets[s + 1]], npix) for s in range(nseg)
    ]


def _rle_encode_frame(segments: List[bytes]) -> bytes:
    enc = []
    for s in segments:
        e = _packbits_encode(s)
        if len(e) % 2:
            e += b"\x00"  # segments start on even byte boundaries
        enc.append(e)
    offsets = [0] * 15
    pos = 64
    for i, e in enumerate(enc):
        offsets[i] = pos
        pos += len(e)
    return struct.pack("<16I", len(enc), *offsets) + b"".join(enc)


def _sign_extend(arr: np.ndarray, prec: int) -> np.ndarray:
    """Two's-complement sign extension from a `prec`-bit stored pattern.

    Signed DICOM samples are BitsStored-wide two's complement; a 12-bit -1
    decodes as the pattern 0x0FFF and must become -1, not +4095. prec <= 16
    always (BitsAllocated is 8/16), so the result fits — and stays — the
    compact int16 scanner dtype."""
    a = arr.astype(np.int32)
    return np.where(a >= (1 << (prec - 1)), a - (1 << prec), a).astype(np.int16)


def _slice_array(info: Dict) -> np.ndarray:
    bits = info.get("bits_allocated", 16)
    signed = info.get("pixel_representation", 0) == 1
    npix = info["rows"] * info["cols"]
    if bits not in (8, 16):
        raise ValueError(f"{info['path']}: unsupported BitsAllocated {bits}")
    if info.get("transfer") in (_JPEG_LS, _JPEG_LS_NEAR):
        from mamri_tpu_torch.perception.jpegls import _parse_markers, decode_jpeg_ls

        frags = info["pixels"]
        if not isinstance(frags, list):
            raise ValueError(f"{info['path']}: JPEG-LS pixel data must be encapsulated")
        blob = b"".join(frags)
        if info["transfer"] == _JPEG_LS and _parse_markers(blob)["near"] != 0:
            raise ValueError(
                f"{info['path']}: transfer syntax claims JPEG-LS LOSSLESS (.80) "
                "but the scan is near-lossless (NEAR>0) — refusing mislabeled "
                "lossy data"
            )
        arr, prec = decode_jpeg_ls(blob)
        if arr.shape != (info["rows"], info["cols"]):
            raise ValueError(
                f"{info['path']}: JPEG-LS frame {arr.shape} != ({info['rows']}, {info['cols']})"
            )
        if signed:
            arr = _sign_extend(arr, prec)
        elif bits == 8:
            arr = arr.astype(np.uint8)
    elif info.get("transfer") in (_JPEG_BASE, _JPEG_EXT):
        from mamri_tpu_torch.perception.jpegdct import decode_jpeg_dct

        frags = info["pixels"]
        if not isinstance(frags, list):
            raise ValueError(f"{info['path']}: JPEG pixel data must be encapsulated")
        arr, prec = decode_jpeg_dct(b"".join(frags))
        if info["transfer"] == _JPEG_BASE and prec != 8:
            raise ValueError(f"{info['path']}: baseline .50 must be 8-bit, got {prec}")
        if arr.shape != (info["rows"], info["cols"]):
            raise ValueError(
                f"{info['path']}: JPEG frame {arr.shape} != ({info['rows']}, {info['cols']})"
            )
        if bits == 8:
            arr = arr.astype(np.uint8)  # lossy DCT output is unsigned
    elif info.get("transfer") in (_JPEG_LL, _JPEG_LL_SV1):
        from mamri_tpu_torch.perception.jpegll import decode_jpeg_lossless

        frags = info["pixels"]
        if not isinstance(frags, list):
            raise ValueError(f"{info['path']}: JPEG pixel data must be encapsulated")
        # a single-frame codestream may span several fragments
        arr, prec = decode_jpeg_lossless(b"".join(frags))
        if arr.shape != (info["rows"], info["cols"]):
            raise ValueError(
                f"{info['path']}: JPEG frame {arr.shape} != ({info['rows']}, {info['cols']})"
            )
        if signed:
            arr = _sign_extend(arr, prec)
        elif bits == 8:
            arr = arr.astype(np.uint8)
    elif info.get("transfer") in (_J2K_LL, _J2K):
        from mamri_tpu_torch.perception.jpeg2000 import codestream_is_reversible, decode_jpeg2000

        frags = info["pixels"]
        if not isinstance(frags, list):
            raise ValueError(f"{info['path']}: JPEG 2000 pixel data must be encapsulated")
        blob = b"".join(frags)
        if info["transfer"] == _J2K_LL and not codestream_is_reversible(blob):
            raise ValueError(
                f"{info['path']}: transfer syntax claims JPEG 2000 LOSSLESS (.90) "
                "but the codestream uses the irreversible 9/7 transform — "
                "refusing mislabeled lossy data"
            )
        # sample values (incl. signedness) come from the codestream's SIZ
        arr, _prec = decode_jpeg2000(blob)
        if arr.shape != (info["rows"], info["cols"]):
            raise ValueError(
                f"{info['path']}: JPEG 2000 frame {arr.shape} != ({info['rows']}, {info['cols']})"
            )
        # decode returns int32; <=16-bit samples (sign-extended / DC-shifted)
        # fit the compact scanner dtype
        if bits == 16:
            arr = arr.astype(np.int16 if signed else np.uint16)
        else:
            arr = arr.astype(np.int8 if signed else np.uint8)
    elif info.get("transfer") == _RLE_LOSSLESS:
        frags = info["pixels"]
        if not isinstance(frags, list) or len(frags) != 1:
            raise ValueError(f"{info['path']}: expected one RLE frame per file")
        segs = _rle_decode_frame(frags[0], npix, 2 if bits == 16 else 1)
        if bits == 16:
            # MSB segment then LSB segment (big-endian decomposition)
            arr = (
                np.frombuffer(segs[0], np.uint8).astype(np.uint16) << 8
            ) | np.frombuffer(segs[1], np.uint8)
            if signed:
                arr = arr.astype(np.int16)
        else:
            arr = np.frombuffer(segs[0], np.int8 if signed else np.uint8)
    else:
        if isinstance(info["pixels"], list):
            raise ValueError(
                f"{info['path']}: encapsulated pixel data under an uncompressed "
                "transfer syntax"
            )
        be = info.get("transfer") == _EXPLICIT_BE
        if bits == 16:
            dt = (">i2" if signed else ">u2") if be else ("<i2" if signed else "<u2")
        else:
            dt = np.int8 if signed else np.uint8
        arr = np.frombuffer(info["pixels"], dtype=dt, count=npix)
    arr = arr.reshape(info["rows"], info["cols"])
    slope = info.get("slope", [1.0])[0]
    inter = info.get("intercept", [0.0])[0]
    if float(slope) == 1.0 and float(inter) == 0.0:
        # identity rescale: keep the stored dtype — compact scanner frames
        # (int16/uint16/…) ride the halved-H2D ingest path end to end
        return arr
    return arr.astype(np.float32) * np.float32(slope) + np.float32(inter)


def load_dicom_series(directory: str, series_uid: Optional[str] = None) -> Volume:
    """Assemble one DICOM series from a directory into a `Volume` (LPS grid).

    Files are geometrically sorted by ImagePositionPatient projected on the
    slice normal. With several series present, pass `series_uid` (else the
    largest series is taken).
    """
    files = [
        os.path.join(directory, f)
        for f in sorted(os.listdir(directory))
        if not f.startswith(".") and os.path.isfile(os.path.join(directory, f))
    ]
    infos: List[Dict] = []
    errors: List[str] = []
    for p in files:
        try:
            infos.append(_parse_file(p))
        except (ValueError, struct.error) as e:  # non-DICOM/truncated file, or
            errors.append(str(e))  # unsupported syntax — surfaced if NOTHING loads
    if not infos:
        detail = f" ({errors[0]})" if errors else ""
        raise ValueError(f"{directory}: no readable DICOM slices{detail}")
    return _assemble_series(infos, directory, series_uid)


def load_dicom(path: str) -> Volume:
    """Load a single DICOM file (multi-frame or one slice) as a `Volume`.

    The single-file convenience over `load_dicom_series`: Enhanced MR /
    classic multi-frame files carry a whole stack in one SOP instance, and
    a lone classic slice loads as a one-slice volume."""
    if not os.path.isfile(path):
        raise ValueError(f"{path}: not a file")
    return _assemble_series([_parse_file(path)], path, None)


def _assemble_series(infos: List[Dict], directory: str, series_uid: Optional[str]) -> Volume:
    expanded: List[Dict] = []
    for i in infos:
        expanded.extend(_split_frames(i) if i.get("nframes", 1) > 1 else [i])
    infos = expanded
    by_series: Dict[str, List[Dict]] = {}
    for i in infos:
        by_series.setdefault(i.get("series_uid", ""), []).append(i)
    if series_uid is not None:
        if series_uid not in by_series:
            raise ValueError(f"{directory}: series {series_uid} not found")
        slices = by_series[series_uid]
    else:
        slices = max(by_series.values(), key=len)

    iop = np.asarray(slices[0]["iop"], dtype=np.float64)
    row_dir, col_dir = iop[:3], iop[3:]  # along +columns / along +rows
    normal = np.cross(row_dir, col_dir)
    slices.sort(key=lambda s: float(np.dot(np.asarray(s["ipp"]), normal)))

    if len(slices) > 1:
        # the compressed codecs run in native C with the GIL released, so
        # slice decode parallelizes across a small thread pool
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
            arrs = list(ex.map(_slice_array, slices))
    else:
        arrs = [_slice_array(s) for s in slices]
    shp = {a.shape for a in arrs}
    if len(shp) != 1:
        raise ValueError(f"{directory}: inconsistent slice shapes {shp}")
    stack = np.stack(arrs)  # (nslices, rows, cols)

    ipp0 = np.asarray(slices[0]["ipp"], dtype=np.float64)
    if len(slices) > 1:
        step = (np.asarray(slices[-1]["ipp"]) - ipp0) / (len(slices) - 1)
        # verify uniform spacing (scanner series are; reject gaps)
        d = [float(np.dot(np.asarray(s["ipp"]) - ipp0, normal)) for s in slices]
        dd = np.diff(d)
        if dd.size and (np.abs(dd - dd.mean()).max() > 0.01 * max(abs(dd.mean()), 1e-6) + 1e-4):
            raise ValueError(f"{directory}: non-uniform slice spacing {dd}")
    else:
        step = normal  # arbitrary unit thickness for single-slice
    dr, dc = slices[0]["pixel_spacing"][0], slices[0]["pixel_spacing"][1]

    # voxel index (c, r, s) -> LPS affine; choose index order (x=cols,
    # y=rows, z=slices) so the fast axis matches typical in-plane reading
    affine = np.zeros((3, 4), dtype=np.float64)
    affine[:, 0] = row_dir * dc  # moving along columns
    affine[:, 1] = col_dir * dr  # moving along rows
    affine[:, 2] = step
    affine[:, 3] = ipp0
    data = np.ascontiguousarray(np.transpose(stack, (2, 1, 0)))  # (cols, rows, slices)

    from mamri_tpu_torch.perception.io import volume_from_affine

    return volume_from_affine(data, affine)


def _el(group: int, elem: int, vr: bytes, value: bytes) -> bytes:
    if len(value) % 2:
        value += b" " if vr not in (b"OB", b"OW", b"UI") else b"\x00"
    if vr in _LONG_VRS:
        return struct.pack("<HH2sHI", group, elem, vr, 0, len(value)) + value
    return struct.pack("<HH2sH", group, elem, vr, len(value)) + value


def _ds(vals) -> bytes:
    return "\\".join(f"{v:.10g}" for v in np.atleast_1d(vals)).encode("ascii")


def _sq(group: int, elem: int, items: List[bytes]) -> bytes:
    """Defined-length SQ element (explicit VR LE) from item element streams."""
    body = b"".join(
        struct.pack("<HHI", 0xFFFE, 0xE000, len(it)) + it for it in items
    )
    return struct.pack("<HH2sHI", group, elem, b"SQ", 0, len(body)) + body


def _deflate_body(body: bytes, transfer: str) -> bytes:
    """Raw-deflate the dataset for the deflated transfer (PS3.5 A.5);
    pass-through otherwise."""
    if transfer != "deflated":
        return body
    import zlib

    co = zlib.compressobj(9, zlib.DEFLATED, -15)
    return co.compress(body) + co.flush()


def _rescale_int16(data: np.ndarray) -> Tuple[np.ndarray, float, float]:
    """int16 stored values + (slope, intercept) for a lossless-for-rounded-data
    rescale: stored = round((data - lo)/scale) - 32000, keeping hi's stored
    value <= 32767 (64767 steps max; 65000 silently CLIPPED the top 233 steps
    of the range before round 3). Integer-valued data that fits the window
    stores at slope 1 — bit-exact round-trip (CT/MR intensities are
    integral); anything else quantizes onto the grid."""
    lo, hi = float(data.min()), float(data.max())
    integral = hi - lo <= 64767.0 and bool(np.all(data == np.round(data)))
    if integral and -32768.0 <= lo and hi <= 32767.0:
        # already int16-representable: store identity (slope 1, intercept 0)
        # so readers keep the scanner-compact dtype on load
        return data.astype(np.int16), 1.0, 0.0
    if hi <= lo or integral:
        scale = 1.0
    else:
        scale = max((hi - lo) / 64767.0, 1e-6)
    slope, inter = scale, lo + 32000.0 * scale
    stored = np.clip(np.round((data - inter) / slope), -32768, 32767).astype(np.int16)
    return stored, slope, inter


def _rescale_uint16(data: np.ndarray) -> Tuple[np.ndarray, float, float]:
    """Unsigned stored values for near-lossless exports: NEAR quantization
    acts on the uint16 scan samples, so the stored representation must be
    MONOTONE in data units — the int16 two's-complement view is not (its
    32767/32768 pattern boundary sits mid-range, and a NEAR-sized nudge
    across it would flip the sign for a ~65k-step error)."""
    lo, hi = float(data.min()), float(data.max())
    integral = hi - lo <= 64767.0 and bool(np.all(data == np.round(data)))
    if hi <= lo or integral:
        scale = 1.0
    else:
        scale = max((hi - lo) / 64767.0, 1e-6)
    stored = np.clip(np.round((data - lo) / scale), 0, 65535).astype(np.uint16)
    return stored, scale, lo


def _compress_frame(a: np.ndarray, transfer: str, near: int = 0) -> bytes:
    """One (rows, cols) int16 (or uint16, near-lossless) frame -> an
    even-length compressed fragment."""
    if transfer == "rle":
        u = a.view(np.uint16)
        frame = _rle_encode_frame(
            [(u >> 8).astype(np.uint8).tobytes(), (u & 0xFF).astype(np.uint8).tobytes()]
        )
    elif transfer == "jpegls":
        from mamri_tpu_torch.perception.jpegls import encode_jpeg_ls

        # lossless: signed samples ride as their 16-bit two's-complement
        # patterns (bit-exact either way). near>0: the writer stores
        # UNSIGNED samples (see _rescale_uint16) so T.87's per-sample
        # |recon - x| <= NEAR bound is <= near * RescaleSlope in data units
        frame = encode_jpeg_ls(a.view(np.uint16), precision=16, near=near)
    elif transfer == "j2k":
        from mamri_tpu_torch.perception.jpeg2000 import encode_jpeg2000

        # JPEG 2000 carries signedness in the codestream (SIZ Ssiz)
        frame = encode_jpeg2000(a.astype(np.int32), precision=16, signed=True)
    else:
        from mamri_tpu_torch.perception.jpegll import encode_jpeg_lossless

        # signed samples ride as their 16-bit two's-complement patterns
        frame = encode_jpeg_lossless(a.view(np.uint16), precision=16)
    if len(frame) % 2:
        frame += b"\x00"
    return frame


def _encapsulate(frags: List[bytes]) -> bytes:
    """Encapsulated (7FE0,0010): empty basic offset table, one item per
    compressed frame, sequence delimiter."""
    return (
        struct.pack("<HH2sHI", 0x7FE0, 0x0010, b"OB", 0, 0xFFFFFFFF)
        + struct.pack("<HHI", 0xFFFE, 0xE000, 0)
        + b"".join(struct.pack("<HHI", 0xFFFE, 0xE000, len(f)) + f for f in frags)
        + struct.pack("<HHI", 0xFFFE, 0xE0DD, 0)
    )


def save_dicom_series(
    directory: str, volume: Volume, series_number: int = 1,
    transfer: str = "explicit_le", near: int = 0,
) -> List[str]:
    """Write the volume as an MR series (one file per z slice): explicit VR
    LE, deflated explicit VR LE (`transfer="deflated"`), RLE Lossless
    (`transfer="rle"`), JPEG Lossless SV1 (`transfer="jpegll"`) or JPEG-LS
    lossless (`transfer="jpegls"`), the last three encapsulated.

    Intensities are stored as int16 with a lossless-for-rounded-data rescale;
    the reader round-trips `load_dicom_series(save_dicom_series(v)) == v` to
    rescale precision (exact for integer-valued data within range; all the
    compressed transfers here are lossless codecs, so identically exact).
    """
    if transfer not in ("explicit_le", "deflated", "rle", "jpegll", "jpegls", "j2k"):
        raise ValueError(
            f"transfer must be 'explicit_le', 'deflated', 'rle', 'jpegll', "
            f"'jpegls' or 'j2k', got {transfer!r}"
        )
    if near and transfer != "jpegls":
        raise ValueError("near-lossless (near>0) requires transfer='jpegls'")
    os.makedirs(directory, exist_ok=True)
    data = np.asarray(volume.data, dtype=np.float32)
    nx, ny, nz = data.shape
    stored, slope, inter = _rescale_uint16(data) if near else _rescale_int16(data)

    uid_base = "1.2.826.0.1.3680043.9.7431"  # arbitrary org root for synthetic data
    series_uid = f"{uid_base}.{series_number}.1"
    study_uid = f"{uid_base}.{series_number}.0"
    paths = []
    sx, sy, sz = [float(s) for s in volume.spacing]
    ox, oy, oz = [float(o) for o in volume.origin]
    frames = [np.ascontiguousarray(stored[:, :, k].T) for k in range(nz)]
    fragments = None
    if transfer in ("rle", "jpegll", "jpegls", "j2k"):
        # native codecs release the GIL: compress slices in parallel
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
            fragments = list(ex.map(lambda a: _compress_frame(a, transfer, near), frames))
    for k in range(nz):
        rows, cols = ny, nx
        a = frames[k]  # (rows, cols) C-order int16
        if fragments is not None:
            pixel_el = _encapsulate([fragments[k]])
        else:
            pixel_el = _el(0x7FE0, 0x0010, b"OW", a.tobytes())
        body = b"".join(
            [
                _el(0x0008, 0x0016, b"UI", _MR_STORAGE.encode()),
                _el(0x0008, 0x0018, b"UI", f"{series_uid}.{k + 1}".encode()),
                _el(0x0008, 0x0060, b"CS", b"MR"),
                _el(0x0020, 0x000D, b"UI", study_uid.encode()),
                _el(0x0020, 0x000E, b"UI", series_uid.encode()),
                _el(0x0020, 0x0011, b"IS", str(series_number).encode()),
                _el(0x0020, 0x0013, b"IS", str(k + 1).encode()),
                _el(0x0020, 0x0032, b"DS", _ds([ox, oy, oz + sz * k])),
                # rows run along +y LPS, columns along +x LPS
                _el(0x0020, 0x0037, b"DS", _ds([1, 0, 0, 0, 1, 0])),
                _el(0x0028, 0x0002, b"US", struct.pack("<H", 1)),
                _el(0x0028, 0x0004, b"CS", b"MONOCHROME2"),
                _el(0x0028, 0x0010, b"US", struct.pack("<H", rows)),
                _el(0x0028, 0x0011, b"US", struct.pack("<H", cols)),
                _el(0x0028, 0x0030, b"DS", _ds([sy, sx])),  # (row, col) spacing
                _el(0x0028, 0x0100, b"US", struct.pack("<H", 16)),
                _el(0x0028, 0x0101, b"US", struct.pack("<H", 16)),
                _el(0x0028, 0x0102, b"US", struct.pack("<H", 15)),
                _el(0x0028, 0x0103, b"US", struct.pack("<H", 0 if near else 1)),
                _el(0x0028, 0x1052, b"DS", _ds([inter])),
                _el(0x0028, 0x1053, b"DS", _ds([slope])),
                pixel_el,
            ]
        )
        meta_body = b"".join(
            [
                _el(0x0002, 0x0001, b"OB", b"\x00\x01"),
                _el(0x0002, 0x0002, b"UI", _MR_STORAGE.encode()),
                _el(0x0002, 0x0003, b"UI", f"{series_uid}.{k + 1}".encode()),
                _el(
                    0x0002, 0x0010, b"UI",
                    {
                        "rle": _RLE_LOSSLESS,
                        "jpegll": _JPEG_LL_SV1,
                        "jpegls": _JPEG_LS_NEAR if near else _JPEG_LS,
                        "j2k": _J2K_LL,
                        "explicit_le": _EXPLICIT_LE,
                        "deflated": _DEFLATED_LE,
                    }[transfer].encode(),
                ),
            ]
        )
        meta = _el(0x0002, 0x0000, b"UL", struct.pack("<I", len(meta_body))) + meta_body
        path = os.path.join(directory, f"slice_{k:04d}.dcm")
        with open(path, "wb") as f:
            f.write(b"\x00" * 128 + b"DICM" + meta + _deflate_body(body, transfer))
        paths.append(path)
    return paths


def save_dicom_multiframe(
    path: str, volume: Volume, series_number: int = 1,
    transfer: str = "explicit_le", near: int = 0,
) -> str:
    """Write the volume as ONE Enhanced MR multi-frame file (the modern
    single-file export modern scanners produce): all geometry and rescale
    live in functional-group sequences (PS3.3 C.7.6.16) — shared
    PlaneOrientation/PixelMeasures/PixelValueTransformation macros plus a
    per-frame PlanePosition — with no top-level IPP/IOP/PixelSpacing, which
    is exactly what exercises the reader's Enhanced path. Same transfer
    choices and the same lossless-for-integral rescale as
    `save_dicom_series`; compressed transfers write one fragment per frame
    (PS3.5 A.4)."""
    if transfer not in ("explicit_le", "deflated", "rle", "jpegll", "jpegls", "j2k"):
        raise ValueError(
            f"transfer must be 'explicit_le', 'deflated', 'rle', 'jpegll', "
            f"'jpegls' or 'j2k', got {transfer!r}"
        )
    if near and transfer != "jpegls":
        raise ValueError("near-lossless (near>0) requires transfer='jpegls'")
    data = np.asarray(volume.data, dtype=np.float32)
    nx, ny, nz = data.shape
    rows, cols = ny, nx
    stored, slope, inter = _rescale_uint16(data) if near else _rescale_int16(data)
    frames = [np.ascontiguousarray(stored[:, :, k].T) for k in range(nz)]
    if transfer in ("explicit_le", "deflated"):  # native pixels (deflate wraps the dataset)
        pixel_el = _el(0x7FE0, 0x0010, b"OW", b"".join(a.tobytes() for a in frames))
    else:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
            pixel_el = _encapsulate(
                list(ex.map(lambda a: _compress_frame(a, transfer, near), frames))
            )

    sx, sy, sz = [float(s) for s in volume.spacing]
    ox, oy, oz = [float(o) for o in volume.origin]
    shared_item = b"".join(
        [
            _sq(0x0020, 0x9116, [_el(0x0020, 0x0037, b"DS", _ds([1, 0, 0, 0, 1, 0]))]),
            _sq(
                0x0028, 0x9110,
                [
                    _el(0x0018, 0x0088, b"DS", _ds([sz]))
                    + _el(0x0028, 0x0030, b"DS", _ds([sy, sx]))
                ],
            ),
            _sq(
                0x0028, 0x9145,
                [
                    _el(0x0028, 0x1052, b"DS", _ds([inter]))
                    + _el(0x0028, 0x1053, b"DS", _ds([slope]))
                ],
            ),
        ]
    )
    perframe_items = [
        _sq(0x0020, 0x9113, [_el(0x0020, 0x0032, b"DS", _ds([ox, oy, oz + sz * k]))])
        for k in range(nz)
    ]

    uid_base = "1.2.826.0.1.3680043.9.7431"
    series_uid = f"{uid_base}.{series_number}.1"
    study_uid = f"{uid_base}.{series_number}.0"
    # UID components must be numeric; ".2" branches off the per-slice
    # writer's f"{series_uid}.{k+1}" instance space
    sop_uid = f"{uid_base}.{series_number}.2"
    body = b"".join(
        [
            _el(0x0008, 0x0016, b"UI", _ENHANCED_MR_STORAGE.encode()),
            _el(0x0008, 0x0018, b"UI", sop_uid.encode()),
            _el(0x0008, 0x0060, b"CS", b"MR"),
            _el(0x0020, 0x000D, b"UI", study_uid.encode()),
            _el(0x0020, 0x000E, b"UI", series_uid.encode()),
            _el(0x0020, 0x0011, b"IS", str(series_number).encode()),
            _el(0x0028, 0x0002, b"US", struct.pack("<H", 1)),
            _el(0x0028, 0x0004, b"CS", b"MONOCHROME2"),
            _el(0x0028, 0x0008, b"IS", str(nz).encode()),
            _el(0x0028, 0x0010, b"US", struct.pack("<H", rows)),
            _el(0x0028, 0x0011, b"US", struct.pack("<H", cols)),
            _el(0x0028, 0x0100, b"US", struct.pack("<H", 16)),
            _el(0x0028, 0x0101, b"US", struct.pack("<H", 16)),
            _el(0x0028, 0x0102, b"US", struct.pack("<H", 15)),
            _el(0x0028, 0x0103, b"US", struct.pack("<H", 0 if near else 1)),
            _sq(0x5200, 0x9229, [shared_item]),
            _sq(0x5200, 0x9230, perframe_items),
            pixel_el,
        ]
    )
    meta_body = b"".join(
        [
            _el(0x0002, 0x0001, b"OB", b"\x00\x01"),
            _el(0x0002, 0x0002, b"UI", _ENHANCED_MR_STORAGE.encode()),
            _el(0x0002, 0x0003, b"UI", sop_uid.encode()),
            _el(
                0x0002, 0x0010, b"UI",
                {
                    "rle": _RLE_LOSSLESS,
                    "jpegll": _JPEG_LL_SV1,
                    "jpegls": _JPEG_LS_NEAR if near else _JPEG_LS,
                    "j2k": _J2K_LL,
                    "explicit_le": _EXPLICIT_LE,
                    "deflated": _DEFLATED_LE,
                }[transfer].encode(),
            ),
        ]
    )
    meta = _el(0x0002, 0x0000, b"UL", struct.pack("<I", len(meta_body))) + meta_body
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"\x00" * 128 + b"DICM" + meta + _deflate_body(body, transfer))
    return path

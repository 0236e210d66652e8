"""JPEG Lossless (ITU T.81 process 14) codec for DICOM pixel data.

The reference inherits compressed-DICOM breadth from Slicer's DICOM stack
(Mamri/Mamri.py:1306 loads whatever the scene ingested); scanner exports are
frequently JPEG Lossless (transfer syntaxes 1.2.840.10008.1.2.4.57 and the
ubiquitous first-order-prediction 1.2.840.10008.1.2.4.70 "SV1"). This module
is a dependency-free implementation of the non-hierarchical lossless process:

- decode: SOI / DHT / SOF3 / (DRI) / SOS marker stream, Huffman-coded
  difference categories (SSSS 0-16), predictors 1-7, point transform,
  2-16 bit precision, byte unstuffing (FF 00) and RST0-7 restart markers.
  Single-component (grayscale) scans only — medical CT/MR; multi-component
  files are rejected loudly.
- encode: selection value 1 (Px = Ra, the SV1 process), canonical Huffman
  table built from the image's own difference-category histogram.

Entropy decoding is sequential by nature; the hot path dispatches to the
native C++ decoder (mamri_tpu_torch.native.jpegll_decode_native) when the toolchain
is available, with this file's pure-Python decoder as the fallback and the
test oracle. Prediction reconstruction in the Python path is vectorized per
predictor (cumulative sums for Px in {1,2,4}; row-at-a-time elsewhere).
"""

from __future__ import annotations

import struct
from typing import Dict, Optional, Tuple

import numpy as np

_SOI, _EOI = 0xFFD8, 0xFFD9
_SOF3, _DHT, _SOS, _DRI = 0xFFC3, 0xFFC4, 0xFFDA, 0xFFDD
_SOF_UNSUPPORTED = tuple(
    m for m in range(0xFFC0, 0xFFD0) if m not in (_SOF3, _DHT, 0xFFC8, 0xFFCC)
)


class JpegLosslessError(ValueError):
    pass


# ------------------------------------------------------------------ decoding
class _Tables:
    """One Huffman table: flat 16-bit-peek lookup (value -> symbol, length)."""

    def __init__(self, counts, symbols):
        if len(counts) != 16 or sum(counts) != len(symbols):
            raise JpegLosslessError("malformed Huffman table")
        self.peek_sym = np.zeros(1 << 16, dtype=np.uint8)
        self.peek_len = np.zeros(1 << 16, dtype=np.uint8)
        code = 0
        k = 0
        for ln in range(1, 17):
            for _ in range(counts[ln - 1]):
                sym = symbols[k]
                k += 1
                lo = code << (16 - ln)
                hi = lo + (1 << (16 - ln))
                if hi > (1 << 16):
                    raise JpegLosslessError("Huffman counts overflow the code space")
                self.peek_sym[lo:hi] = sym
                self.peek_len[lo:hi] = ln
                code += 1
            code <<= 1


def _parse_markers(data: bytes) -> Dict:
    """Walk the marker stream up to (and including) SOS; return frame/scan
    parameters and the offset of the entropy-coded data."""
    if len(data) < 4 or struct.unpack_from(">H", data, 0)[0] != _SOI:
        raise JpegLosslessError("not a JPEG stream (missing SOI)")
    pos = 2
    tables: Dict[int, _Tables] = {}
    frame = None
    restart_interval = 0
    while pos + 4 <= len(data):
        marker, seglen = struct.unpack_from(">HH", data, pos)
        if marker >> 8 != 0xFF:
            raise JpegLosslessError(f"bad marker 0x{marker:04x} at {pos}")
        body = data[pos + 4 : pos + 2 + seglen]
        if seglen < 2 or len(body) != seglen - 2:
            raise JpegLosslessError("truncated marker segment")
        pos += 2 + seglen
        if marker == _SOF3:
            if len(body) < 9:
                raise JpegLosslessError("truncated SOF3 segment")
            prec, lines, cols, ncomp = struct.unpack_from(">BHHB", body, 0)
            if lines * cols > 1 << 26:
                raise JpegLosslessError("image larger than the 64-Mpixel decode cap")
            if ncomp != 1:
                raise JpegLosslessError(
                    f"{ncomp}-component lossless scans unsupported (grayscale only)"
                )
            if lines == 0:
                raise JpegLosslessError("DNL-deferred line count unsupported")
            h_v = body[7]  # per-component params start after P/Y/X/Nf (6 bytes)
            if h_v != 0x11:
                raise JpegLosslessError(f"subsampling {h_v:02x} invalid for lossless")
            frame = {"precision": prec, "rows": lines, "cols": cols}
        elif marker in _SOF_UNSUPPORTED:
            raise JpegLosslessError(
                f"SOF marker 0x{marker:04x} is not lossless process 14 (SOF3)"
            )
        elif marker == _DHT:
            off = 0
            while off < len(body):
                if off + 17 > len(body):
                    raise JpegLosslessError("truncated DHT segment")
                tc_th = body[off]
                counts = list(body[off + 1 : off + 17])
                nsym = sum(counts)
                if off + 17 + nsym > len(body):
                    raise JpegLosslessError("DHT symbol list overruns the segment")
                symbols = list(body[off + 17 : off + 17 + nsym])
                tables[tc_th & 0x0F] = _Tables(counts, symbols)
                off += 17 + nsym
        elif marker == _DRI:
            if len(body) < 2:
                raise JpegLosslessError("truncated DRI segment")
            restart_interval = struct.unpack_from(">H", body, 0)[0]
        elif marker == _SOS:
            if len(body) < 6:
                raise JpegLosslessError("truncated SOS segment")
            ns = body[0]
            if ns != 1:
                raise JpegLosslessError("interleaved multi-component scan unsupported")
            td = body[2] >> 4
            ss, _se, ah_al = body[3], body[4], body[5]
            pt = ah_al & 0x0F
            if frame is None:
                raise JpegLosslessError("SOS before SOF3")
            if not 1 <= ss <= 7:
                raise JpegLosslessError(f"predictor selection {ss} invalid for lossless")
            if td not in tables:
                raise JpegLosslessError(f"scan references undefined Huffman table {td}")
            return {
                **frame,
                "predictor": ss,
                "pt": pt,
                "table": tables[td],
                "restart_interval": restart_interval,
                "scan_offset": pos,
            }
    raise JpegLosslessError("no SOS marker found")


def _entropy_segments(data: bytes, start: int):
    """Split entropy-coded data at RST/EOI markers; yields unstuffed byte
    runs (FF 00 -> FF). Any other marker terminates the scan."""
    segs = []
    pos = start
    cur = bytearray()
    n = len(data)
    while pos < n:
        nxt = data.find(b"\xff", pos)
        if nxt < 0:
            cur += data[pos:]
            break
        cur += data[pos:nxt]
        if nxt + 1 >= n:
            break
        m = data[nxt + 1]
        if m == 0x00:
            cur.append(0xFF)
            pos = nxt + 2
        elif 0xD0 <= m <= 0xD7:  # RSTn
            segs.append(bytes(cur))
            cur = bytearray()
            pos = nxt + 2
        elif m == 0xFF:  # fill byte
            pos = nxt + 1
        else:  # EOI or any other marker ends the scan
            break
    segs.append(bytes(cur))
    return segs


def _decode_diffs(seg: bytes, table: _Tables, count: int) -> np.ndarray:
    """Huffman-decode `count` difference values from one entropy segment:
    SSSS category code then SSSS magnitude bits, Extend() sign rule;
    category 16 means +32768 with no magnitude bits (T.81 H.1.2.2).

    Sliding 16-bit peek against the flat lookup table, small-int bit buffer
    (zero-padded past the end; consuming padding => truncated stream)."""
    out = np.empty(count, dtype=np.int32)
    peek_sym = table.peek_sym
    peek_len = table.peek_len
    real_bits = 8 * len(seg)
    data = seg + b"\x00\x00\x00\x00"
    buf = 0
    nbuf = 0
    pos = 0
    used = 0
    for got in range(count):
        if nbuf < 32:
            buf = (buf << 32) | int.from_bytes(data[pos : pos + 4].ljust(4, b"\x00"), "big")
            pos += 4
            nbuf += 32
        window = (buf >> (nbuf - 16)) & 0xFFFF
        s = int(peek_sym[window])
        ln = int(peek_len[window])
        if ln == 0:
            raise JpegLosslessError("invalid Huffman code in entropy data")
        if s == 0:
            out[got] = 0
            nbuf -= ln
            used += ln
        elif s == 16:
            out[got] = 32768
            nbuf -= ln
            used += ln
        else:
            v = (buf >> (nbuf - ln - s)) & ((1 << s) - 1)
            nbuf -= ln + s
            used += ln + s
            out[got] = v if v >= (1 << (s - 1)) else v - (1 << s) + 1
        buf &= (1 << nbuf) - 1
    if used > real_bits:
        raise JpegLosslessError(
            f"entropy data exhausted after {used - real_bits} bits past the end"
        )
    return out


def _reconstruct(diffs: np.ndarray, rows: int, cols: int, predictor: int, p: int, pt: int) -> np.ndarray:
    """Apply the prediction recurrence to the difference image (mod 2^16).

    Boundary rules (T.81 H.1.1): the very first sample is predicted with
    2^(P-Pt-1); the rest of the first line uses Ra; the first column of
    later lines uses Rb; elsewhere the scan's Px applies.
    """
    d = diffs.reshape(rows, cols).astype(np.int64)
    default = 1 << (p - pt - 1)
    x = np.zeros((rows, cols), dtype=np.int64)
    # first line: x[0] = default + cumsum(d[0]); wrapped immediately — the
    # floor-shift predictors (5-7) read differences of row values, and >>
    # does not commute with the mod-2^16 wrap the way addition does
    x[0] = (default + np.cumsum(d[0])) & 0xFFFF
    if rows == 1:
        return (x & 0xFFFF).astype(np.uint16) << np.uint16(pt)
    if predictor == 1:  # Px = Ra: first column follows Rb, rows are cumsums
        x[:, 0] = default + np.cumsum(d[:, 0])
        x[:, 1:] = x[:, :1] + np.cumsum(d[:, 1:], axis=1)
    elif predictor == 2:  # Px = Rb: columns are cumsums under the first line
        x[1:] = x[0] + np.cumsum(d[1:], axis=0)
    elif predictor == 4:  # Ra + Rb - Rc: d is the 2-D mixed difference
        x = np.cumsum(np.cumsum(d, axis=0), axis=1) + default
    elif predictor == 3:  # Px = Rc: diagonal shift of the previous row
        for i in range(1, rows):
            x[i, 0] = x[i - 1, 0] + d[i, 0]
            x[i, 1:] = x[i - 1, :-1] + d[i, 1:]
            x[i] &= 0xFFFF
    elif predictor == 5:  # Ra + ((Rb - Rc) >> 1): row cumsum of corrected diffs
        for i in range(1, rows):
            x[i, 0] = (x[i - 1, 0] + d[i, 0]) & 0xFFFF
            corr = (x[i - 1, 1:] - x[i - 1, :-1]) >> 1
            x[i, 1:] = x[i, 0] + np.cumsum(d[i, 1:] + corr)
            x[i] &= 0xFFFF
    else:  # 6, 7: Ra enters through a floor-shift — sequential within the row
        for i in range(1, rows):
            x[i, 0] = (x[i - 1, 0] + d[i, 0]) & 0xFFFF
            xprev = x[i - 1]
            row = x[i]
            if predictor == 6:
                for j in range(1, cols):
                    row[j] = (xprev[j] + ((row[j - 1] - xprev[j - 1]) >> 1) + d[i, j]) & 0xFFFF
            else:
                for j in range(1, cols):
                    row[j] = (((row[j - 1] + xprev[j]) >> 1) + d[i, j]) & 0xFFFF
    return ((x & 0xFFFF).astype(np.uint16)) << np.uint16(pt)


def decode_jpeg_lossless(data: bytes, use_native: bool = True) -> Tuple[np.ndarray, int]:
    """Decode one JPEG Lossless codestream -> ((rows, cols) uint16 sample
    bit-patterns, precision). The caller applies DICOM pixel representation
    (view as int16 when signed) and rescale."""
    if use_native:
        from mamri_tpu_torch.native import jpegll_decode_native

        native = jpegll_decode_native(data)
        if native is not None:
            return native
    scan = _parse_markers(data)
    rows, cols = scan["rows"], scan["cols"]
    segs = _entropy_segments(data, scan["scan_offset"])
    ri = scan["restart_interval"]
    total = rows * cols
    if ri:
        expected = -(-total // ri)
        if len(segs) != expected:
            raise JpegLosslessError(
                f"restart interval {ri}: expected {expected} segments, found {len(segs)}"
            )
        if ri % cols != 0:
            raise JpegLosslessError("restart intervals not aligned to line boundaries unsupported")
        chunks = [
            _decode_diffs(seg, scan["table"], min(ri, total - k * ri))
            for k, seg in enumerate(segs)
        ]
        # each restart re-enters the default-prediction state: reconstruct
        # each band independently (its first line is predicted like a top line)
        bands = [
            _reconstruct(c, len(c) // cols, cols, scan["predictor"], scan["precision"], scan["pt"])
            for c in chunks
        ]
        img = np.concatenate(bands, axis=0)
    else:
        diffs = _decode_diffs(segs[0], scan["table"], total)
        img = _reconstruct(diffs, rows, cols, scan["predictor"], scan["precision"], scan["pt"])
    return img, scan["precision"]


# ------------------------------------------------------------------ encoding
def _category(v: np.ndarray) -> np.ndarray:
    """SSSS category = bit length of |diff| (diff 32768 -> 16)."""
    mag = np.abs(v).astype(np.uint32)
    cat = np.zeros(v.shape, dtype=np.uint8)
    nz = mag > 0
    cat[nz] = np.floor(np.log2(mag[nz])).astype(np.uint8) + 1
    return cat


def _build_huffman(hist: np.ndarray) -> Tuple[list, list]:
    """Canonical Huffman (counts-per-length, symbol order) for symbols 0-16
    from their frequencies — JPEG Annex K.2 flow, 16-bit length cap."""
    freq = hist.astype(np.int64).copy()
    # package-merge-free variant: JPEG's adjusting algorithm over code sizes
    freq = np.concatenate([freq, [1]])  # reserved symbol guards all-ones code
    codesize = np.zeros(freq.size, dtype=np.int64)
    others = np.full(freq.size, -1, dtype=np.int64)
    while True:
        active = np.where(freq > 0)[0]
        if active.size < 2:
            if active.size == 1 and codesize[active[0]] == 0:
                codesize[active[0]] = 1
            break
        v1 = active[np.lexsort((active, freq[active]))[0]]
        rest = active[active != v1]
        v2 = rest[np.lexsort((rest, freq[rest]))[0]]
        freq[v1] += freq[v2]
        freq[v2] = 0
        while True:
            codesize[v1] += 1
            if others[v1] < 0:
                break
            v1 = others[v1]
        others[v1] = v2
        while True:
            codesize[v2] += 1
            if others[v2] < 0:
                break
            v2 = others[v2]
    counts = np.zeros(33, dtype=np.int64)
    for cs in codesize:
        if cs > 0:
            counts[min(cs, 32)] += 1
    # limit to 16 bits (Annex K.3 redistribution)
    for ln in range(32, 16, -1):
        while counts[ln] > 0:
            j = ln - 2
            while counts[j] == 0:
                j -= 1
            counts[ln] -= 2
            counts[ln - 1] += 1
            counts[j + 1] += 2
            counts[j] -= 1
    # drop the reserved symbol from the longest used length
    for ln in range(16, 0, -1):
        if counts[ln] > 0:
            counts[ln] -= 1
            break
    order = sorted(range(17), key=lambda s: (codesize[s], s))
    symbols = [s for s in order if codesize[s] > 0]
    return list(counts[1:17]), symbols


def _predict(x: np.ndarray, predictor: int, precision: int, pt: int) -> np.ndarray:
    """Prediction image from the (lossless => known) samples, H.1.1 boundary
    rules: default at [0,0], Ra along the first line, Rb down the first
    column, the scan's Px in the interior."""
    pred = np.empty_like(x)
    pred[0, 0] = 1 << (precision - pt - 1)
    pred[0, 1:] = x[0, :-1]
    if x.shape[0] == 1:
        return pred
    pred[1:, 0] = x[:-1, 0]
    a, b, c = x[1:, :-1], x[:-1, 1:], x[:-1, :-1]
    pred[1:, 1:] = {
        1: lambda: a,
        2: lambda: b,
        3: lambda: c,
        4: lambda: a + b - c,
        5: lambda: a + ((b - c) >> 1),
        6: lambda: b + ((a - c) >> 1),
        7: lambda: (a + b) >> 1,
    }[predictor]()
    return pred


def encode_jpeg_lossless(
    img: np.ndarray,
    precision: int = 16,
    pt: int = 0,
    predictor: int = 1,
    restart_rows: int = 0,
) -> bytes:
    """Encode a (rows, cols) unsigned array as JPEG Lossless (default SV1 —
    predictor Ra, the 1.2.840.10008.1.2.4.70 process) with an image-optimal
    Huffman table. Values must fit in `precision` bits. `restart_rows` > 0
    emits a DRI marker and RST-separated restart intervals of that many
    lines (each re-entering the default-prediction state)."""
    a = np.asarray(img)
    if a.ndim != 2:
        raise JpegLosslessError("expected a 2-D image")
    if not 2 <= precision <= 16:
        raise JpegLosslessError(f"precision {precision} out of range [2, 16]")
    if not 1 <= predictor <= 7:
        raise JpegLosslessError(f"predictor {predictor} out of range [1, 7]")
    x = (a.astype(np.int64) >> pt) & 0xFFFF
    rows, cols = x.shape
    band_rows = restart_rows if restart_rows > 0 else rows
    bands = [x[i : i + band_rows] for i in range(0, rows, band_rows)]
    d = np.concatenate([xb - _predict(xb, predictor, precision, pt) for xb in bands])
    # wrap mod 2^16 into the category-coded range (-32767..32768]
    d = ((d + 32767) & 0xFFFF) - 32767
    cats = _category(d)
    hist = np.bincount(cats.ravel(), minlength=17)
    counts, symbols = _build_huffman(hist)
    # canonical code assignment
    codes: Dict[int, Tuple[int, int]] = {}
    code = 0
    k = 0
    for ln in range(1, 17):
        for _ in range(counts[ln - 1]):
            codes[symbols[k]] = (code, ln)
            code += 1
            k += 1
        code <<= 1

    def emit_band(flat_d, flat_c):
        from mamri_tpu_torch.native import jpegll_emit_native

        code_arr = np.zeros(17, dtype=np.uint32)
        len_arr = np.zeros(17, dtype=np.uint8)
        for sym, (c_, l_) in codes.items():
            code_arr[sym] = c_
            len_arr[sym] = l_
        native = jpegll_emit_native(flat_d, flat_c, code_arr, len_arr)
        if native is not None:
            return bytearray(native)
        acc = 0
        nacc = 0
        body = bytearray()
        for i in range(flat_d.size):
            s = int(flat_c[i])
            c, ln = codes[s]
            acc = (acc << ln) | c
            nacc += ln
            if 0 < s < 16:
                v = int(flat_d[i])
                if v < 0:
                    v += (1 << s) - 1
                acc = (acc << s) | v
                nacc += s
            while nacc >= 8:
                byte = (acc >> (nacc - 8)) & 0xFF
                nacc -= 8
                body.append(byte)
                if byte == 0xFF:
                    body.append(0x00)
            acc &= (1 << nacc) - 1
        if nacc:
            byte = ((acc << (8 - nacc)) | ((1 << (8 - nacc)) - 1)) & 0xFF  # 1-pad
            body.append(byte)
            if byte == 0xFF:
                body.append(0x00)
        return body

    out = bytearray()
    out += struct.pack(">H", _SOI)
    dht = bytes([0x00]) + bytes(counts) + bytes(symbols)
    out += struct.pack(">HH", _DHT, 2 + len(dht)) + dht
    sof = struct.pack(">BHHB", precision, rows, cols, 1) + bytes([1, 0x11, 0])
    out += struct.pack(">HH", _SOF3, 2 + len(sof)) + sof
    if restart_rows > 0:
        out += struct.pack(">HHH", _DRI, 4, restart_rows * cols)
    # Ns=1, comp 1 / DC table 0, Ss=predictor, Se=0, AhAl=Pt
    sos = bytes([1, 1, 0x00, predictor, 0, pt])
    out += struct.pack(">HH", _SOS, 2 + len(sos)) + sos
    nband = band_rows * cols
    flat_d, flat_c = d.ravel(), cats.ravel()
    for k in range(0, flat_d.size, nband):
        if k:
            out += struct.pack(">H", 0xFFD0 + ((k // nband - 1) & 7))
        out += emit_band(flat_d[k : k + nband], flat_c[k : k + nband])
    out += struct.pack(">H", _EOI)
    return bytes(out)

"""Sequential DCT JPEG (ITU-T T.81 processes 1/2) codec, pure Python.

The last image transfer-syntax family in the DICOM compressed-ingest
matrix: Baseline (8-bit, 1.2.840.10008.1.2.4.50) and Extended sequential
(12-bit, .51) lossy JPEG — old MR archives ship .51. The reference ingests
them through Slicer's DICOM stack (GDCM/libjpeg,
Mamri/Mamri.py:1306).

Scope: single-component (grayscale) scans, Huffman entropy coding, one
scan, restart markers supported; progressive (SOF2), arithmetic coding and
multi-component scans are rejected loudly (never emitted for monochrome
MR). The IDCT is the exact float separable transform; libjpeg's integer
islow IDCT differs by at most 1 LSB, which the interop tests allow.

The encoder exists as the test oracle's counterpart (Annex K tables,
quality-scaled luminance quantization) and backs the DICOM writer's
explicit lossy opt-in.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np


class JpegDctError(ValueError):
    pass


_SOI, _EOI = 0xFFD8, 0xFFD9
_SOF0, _SOF1 = 0xFFC0, 0xFFC1
_DHT, _DQT, _SOS, _DRI = 0xFFC4, 0xFFDB, 0xFFDA, 0xFFDD
_REJECT_SOF = {0xFFC2, 0xFFC3, 0xFFC5, 0xFFC6, 0xFFC7, 0xFFC9, 0xFFCA,
               0xFFCB, 0xFFCD, 0xFFCE, 0xFFCF, 0xFFF7}

_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
])

# Annex K.1 luminance quantization table (zigzag order NOT applied here —
# this is natural raster order)
_K1_LUM = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99,
], dtype=np.int64).reshape(8, 8)

# Annex K.3 typical luminance Huffman tables: (bits counts per length 1..16,
# symbol values)
_K3_DC_BITS = [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]
_K3_DC_VALS = list(range(12))
_K3_AC_BITS = [0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]
_K3_AC_VALS = [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
    0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
    0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA,
]


def _dct_matrix() -> np.ndarray:
    k = np.arange(8)[:, None]
    n = np.arange(8)[None, :]
    m = np.cos((2 * n + 1) * k * np.pi / 16.0) * 0.5
    m[0] *= 1.0 / np.sqrt(2.0)
    return m  # X = M @ x @ M.T (forward), x = M.T @ X @ M (inverse)


class _HuffTable:
    """Canonical Huffman per T.81 C.2, decoded via (length, code) walk."""

    def __init__(self, bits: List[int], vals: List[int]):
        if len(bits) != 16 or sum(bits) != len(vals) or sum(bits) > 256:
            raise JpegDctError("malformed Huffman table")
        self.vals = vals
        self.mincode = [0] * 17
        self.maxcode = [-1] * 17
        self.valptr = [0] * 17
        code = 0
        k = 0
        for ln in range(1, 17):
            self.valptr[ln] = k
            self.mincode[ln] = code
            code += bits[ln - 1]
            k += bits[ln - 1]
            if code > (1 << ln):
                raise JpegDctError("Huffman code counts overflow the code space")
            self.maxcode[ln] = code - 1 if bits[ln - 1] else -1
            code <<= 1
        # encoder side: symbol -> (code, length)
        self.enc: Dict[int, Tuple[int, int]] = {}
        code = 0
        k = 0
        for ln in range(1, 17):
            for _ in range(bits[ln - 1]):
                self.enc[vals[k]] = (code, ln)
                code += 1
                k += 1
            code <<= 1


class _ScanReader:
    """Entropy-coded segment reader: FF00 destuffing, RSTn awareness."""

    def __init__(self, data: bytes, pos: int):
        self.data = data
        self.pos = pos
        self.acc = 0
        self.nbits = 0
        self.marker: Optional[int] = None  # pending RST/EOI marker

    def _fill(self):
        d = self.data
        if self.marker is not None or self.pos >= len(d):
            self.acc = (self.acc << 8) | 0  # zero-pad past a marker
            self.nbits += 8
            return
        b = d[self.pos]
        if b == 0xFF:
            nxt = d[self.pos + 1] if self.pos + 1 < len(d) else 0xD9
            if nxt == 0x00:
                self.pos += 2
                self.acc = (self.acc << 8) | 0xFF
                self.nbits += 8
                return
            self.marker = 0xFF00 | nxt  # stop consuming; decoder handles it
            self.acc <<= 8
            self.nbits += 8
            return
        self.pos += 1
        self.acc = (self.acc << 8) | b
        self.nbits += 8

    def bits(self, n: int) -> int:
        while self.nbits < n:
            self._fill()
        self.nbits -= n
        v = (self.acc >> self.nbits) & ((1 << n) - 1)
        self.acc &= (1 << self.nbits) - 1
        return v

    def huff(self, t: _HuffTable) -> int:
        code = self.bits(1)
        for ln in range(1, 17):
            if t.maxcode[ln] >= 0 and code <= t.maxcode[ln]:
                return t.vals[t.valptr[ln] + code - t.mincode[ln]]
            code = (code << 1) | self.bits(1)
        raise JpegDctError("invalid Huffman code in scan")

    def restart(self, n: int):
        """Consume the pending RSTn marker and reset bit state."""
        while self.nbits >= 8:  # drop zero-padding we may have pulled
            self.nbits -= 8
        self.acc &= (1 << self.nbits) - 1
        if self.marker != (0xFFD0 | (n & 7)):
            raise JpegDctError(f"expected RST{n & 7}, found {self.marker}")
        self.marker = None
        self.pos += 2
        self.acc = 0
        self.nbits = 0


def _extend(v: int, t: int) -> int:
    """T.81 F.2.2.1 EXTEND: map t low bits to the signed difference."""
    if t == 0:
        return 0
    return v if v >= (1 << (t - 1)) else v - (1 << t) + 1


def decode_jpeg_dct(data: bytes, use_native: bool = True) -> Tuple[np.ndarray, int]:
    """Decode a sequential-DCT JPEG -> ((rows, cols) uint16, precision).

    The Huffman scan dispatches to the native C++ codec when built (exact
    integer parity with the Python loop); dequant + IDCT are vectorized
    numpy either way."""
    if len(data) < 4 or struct.unpack_from(">H", data, 0)[0] != _SOI:
        raise JpegDctError("not a JPEG stream (missing SOI)")
    pos = 2
    qtabs: Dict[int, np.ndarray] = {}
    dc_tabs: Dict[int, _HuffTable] = {}
    ac_tabs: Dict[int, _HuffTable] = {}
    frame = None
    ri = 0
    while pos + 4 <= len(data):
        marker, seglen = struct.unpack_from(">HH", data, pos)
        if marker >> 8 != 0xFF:
            raise JpegDctError(f"bad marker 0x{marker:04x} at {pos}")
        if marker in _REJECT_SOF or marker in (0xFFC8, 0xFFCC):
            raise JpegDctError(
                f"marker 0x{marker:04x}: only sequential Huffman DCT "
                "(SOF0/SOF1) is supported"
            )
        body = data[pos + 4 : pos + 2 + seglen]
        if len(body) != seglen - 2:
            raise JpegDctError("truncated marker segment")
        pos += 2 + seglen
        if marker in (_SOF0, _SOF1):
            prec, rows, cols, ncomp = struct.unpack_from(">BHHB", body, 0)
            if ncomp != 1:
                raise JpegDctError("multi-component DCT scans unsupported (MR is mono)")
            if rows == 0 or cols == 0:
                raise JpegDctError("empty/DNL-deferred frame unsupported")
            if marker == _SOF0 and prec != 8:
                raise JpegDctError("baseline JPEG must be 8-bit")
            if prec not in (8, 12):
                raise JpegDctError(f"precision {prec} unsupported (8/12-bit DCT)")
            if len(body) < 9 or (body[7] & 0x0F) != 1 or (body[7] >> 4) != 1:
                raise JpegDctError("component subsampling unsupported")
            frame = {"prec": prec, "rows": rows, "cols": cols, "tq": body[8]}
        elif marker == _DQT:
            p = 0
            while p < len(body):
                pq, tq = body[p] >> 4, body[p] & 0x0F
                p += 1
                n = 128 if pq else 64
                if p + n > len(body):
                    raise JpegDctError("truncated DQT")
                if pq:
                    vals = np.frombuffer(body[p : p + n], dtype=">u2").astype(np.int64)
                else:
                    vals = np.frombuffer(body[p : p + n], dtype=np.uint8).astype(np.int64)
                if (vals == 0).any():
                    raise JpegDctError("zero quantization step")
                q = np.zeros(64, dtype=np.int64)
                q[_ZIGZAG] = vals
                qtabs[tq] = q.reshape(8, 8)
                p += n
        elif marker == _DHT:
            p = 0
            while p + 17 <= len(body):
                tc, th = body[p] >> 4, body[p] & 0x0F
                bits = list(body[p + 1 : p + 17])
                nv = sum(bits)
                vals = list(body[p + 17 : p + 17 + nv])
                if len(vals) != nv:
                    raise JpegDctError("truncated DHT")
                (dc_tabs if tc == 0 else ac_tabs)[th] = _HuffTable(bits, vals)
                p += 17 + nv
        elif marker == _DRI:
            ri = struct.unpack_from(">H", body, 0)[0]
        elif marker == _SOS:
            if frame is None:
                raise JpegDctError("SOS before SOF")
            if body[0] != 1:
                raise JpegDctError("interleaved multi-component scan unsupported")
            td, ta = body[2] >> 4, body[2] & 0x0F
            if td not in dc_tabs or ta not in ac_tabs:
                raise JpegDctError("scan references undefined Huffman tables")
            if frame["tq"] not in qtabs:
                raise JpegDctError("frame references an undefined DQT")
            return _decode_scan(
                data, pos, frame, qtabs[frame["tq"]], dc_tabs[td], ac_tabs[ta],
                ri, use_native,
            )
        # APPn / COM / others: skipped structurally
    raise JpegDctError("no SOS marker found")


def _decode_scan(data, pos, frame, qtab, dct_dc, dct_ac, ri, use_native=True):
    rows, cols, prec = frame["rows"], frame["cols"], frame["prec"]
    bw, bh = (cols + 7) // 8, (rows + 7) // 8
    nblocks = bw * bh
    if nblocks > 1 << 22:
        raise JpegDctError("implausible block count")
    coeffs = None
    if use_native:
        from mamri_tpu_torch.native import jpegdct_scan_native

        try:
            native = jpegdct_scan_native(data, nblocks)
        except ValueError as e:
            raise JpegDctError(str(e))
        if native is not None:
            coeffs, nrows, ncols, nprec = native
            if (nrows, ncols, nprec) != (rows, cols, prec) or len(coeffs) != nblocks:
                raise JpegDctError("native scan disagrees with the parsed frame")
    if coeffs is None:
        coeffs = _py_scan(data, pos, nblocks, prec, dct_dc, dct_ac, ri)
    return _reconstruct(coeffs, qtab, rows, cols, prec)


def _py_scan(data, pos, nblocks, prec, dct_dc, dct_ac, ri):
    coeffs = np.zeros((nblocks, 64), dtype=np.int64)
    r = _ScanReader(data, pos)
    pred = 0
    for bi in range(nblocks):
        if ri and bi and bi % ri == 0:
            # eat padding bits, then the RSTn marker; DC predictor resets
            while r.marker is None and r.pos < len(data):
                if r.nbits:
                    r.bits(min(r.nbits, 8))
                else:
                    r._fill()
            r.restart((bi // ri - 1) & 7)
            pred = 0
        t = r.huff(dct_dc)
        if t > 15 or (prec == 8 and t > 11):
            raise JpegDctError("invalid DC category")
        pred += _extend(r.bits(t), t)
        coeffs[bi, 0] = pred
        k = 1
        while k < 64:
            rs = r.huff(dct_ac)
            rr, ss = rs >> 4, rs & 0x0F
            if ss == 0:
                if rr == 15:
                    k += 16  # ZRL
                    continue
                break  # EOB
            k += rr
            if k > 63:
                raise JpegDctError("AC run overflows the block")
            coeffs[bi, k] = _extend(r.bits(ss), ss)
            k += 1
    return coeffs


def _reconstruct(coeffs, qtab, rows, cols, prec):
    bw, bh = (cols + 7) // 8, (rows + 7) // 8
    nblocks = bw * bh
    # dequantize + inverse zigzag + IDCT, vectorized over all blocks
    # (the quant table is raster-order; coeffs are zigzag-order)
    blocks = np.zeros((nblocks, 64), dtype=np.float64)
    qz = qtab.reshape(-1)[_ZIGZAG]  # quant steps in zigzag order
    blocks[:, _ZIGZAG] = coeffs * qz[None, :]
    m = _dct_matrix()
    spatial = np.einsum("ij,njk,lk->nil", m.T, blocks.reshape(nblocks, 8, 8), m.T)
    shift = 1 << (prec - 1)
    spatial = np.clip(np.rint(spatial + shift), 0, (1 << prec) - 1)
    img = np.zeros((bh * 8, bw * 8), dtype=np.uint16)
    img.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)[:] = (
        spatial.reshape(bh, bw, 8, 8).astype(np.uint16)
    )
    return img[:rows, :cols], prec


class _ScanWriter:
    def __init__(self):
        self.out = bytearray()
        self.cur = 0
        self.n = 0

    def put(self, code: int, ln: int):
        for i in range(ln - 1, -1, -1):
            self.cur = (self.cur << 1) | ((code >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.cur)
                if self.cur == 0xFF:
                    self.out.append(0x00)
                self.cur = 0
                self.n = 0

    def flush(self) -> bytes:
        if self.n:
            self.cur = (self.cur << (8 - self.n)) | ((1 << (8 - self.n)) - 1)
            self.out.append(self.cur)
            if self.cur == 0xFF:
                self.out.append(0x00)
            self.cur = 0
            self.n = 0
        return bytes(self.out)


def encode_jpeg_dct(img: np.ndarray, precision: int, quality: int = 90) -> bytes:
    """Encode one grayscale image as sequential DCT JPEG (SOF0 for 8-bit,
    SOF1 for 12-bit), Annex-K tables with libjpeg-style quality scaling."""
    if img.ndim != 2 or img.size == 0:
        raise JpegDctError("only 2-D grayscale images")
    if precision not in (8, 12):
        raise JpegDctError("precision must be 8 or 12")
    if not 1 <= quality <= 100:
        raise JpegDctError("quality in [1, 100]")
    a = np.asarray(img, dtype=np.int64)
    if a.min() < 0 or a.max() >= (1 << precision):
        raise JpegDctError("samples exceed the stated precision")
    rows, cols = a.shape
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    qtab = np.clip((_K1_LUM * scale + 50) // 100, 1, 255 if precision == 8 else 32767)
    if precision == 12:
        qtab = np.minimum(qtab * 16, 32767)  # spread over the wider range

    # 12-bit needs DC categories up to 15. K.3's Kraft headroom is 2^-9;
    # the extras go at lengths 10..13 (sum 15*2^-13), leaving 2^-13 slack —
    # filling the table EXACTLY would make the longest code all 1-bits,
    # which T.81 reserves (libjpeg rejects such tables outright).
    dc_bits = list(_K3_DC_BITS)
    for ln in (10, 11, 12, 13):
        dc_bits[ln - 1] += 1
    dc = _HuffTable(dc_bits, _K3_DC_VALS + [12, 13, 14, 15])
    ac = _HuffTable(_K3_AC_BITS, _K3_AC_VALS)

    bw, bh = (cols + 7) // 8, (rows + 7) // 8
    padded = np.pad(a, ((0, bh * 8 - rows), (0, bw * 8 - cols)), mode="edge")
    blocks = padded.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)
    m = _dct_matrix()
    shift = 1 << (precision - 1)
    f = np.einsum("ij,njk,lk->nil", m, (blocks - shift).astype(np.float64), m)
    qz = qtab.reshape(-1)[_ZIGZAG].astype(np.float64)
    zz = f.reshape(-1, 64)[:, _ZIGZAG]
    quant = np.rint(zz / qz[None, :]).astype(np.int64)

    w = _ScanWriter()
    pred = 0
    for b in quant:
        diff = int(b[0]) - pred
        pred = int(b[0])
        t = int(abs(diff)).bit_length()
        code, ln = dc.enc[t]
        w.put(code, ln)
        if t:
            w.put(diff if diff >= 0 else diff + (1 << t) - 1, t)
        run = 0
        last = 63
        while last > 0 and b[last] == 0:
            last -= 1
        for k in range(1, last + 1):
            v = int(b[k])
            if v == 0:
                run += 1
                continue
            while run > 15:
                code, ln = ac.enc[0xF0]
                w.put(code, ln)
                run -= 16
            s = int(abs(v)).bit_length()
            code, ln = ac.enc[(run << 4) | s]
            w.put(code, ln)
            w.put(v if v >= 0 else v + (1 << s) - 1, s)
            run = 0
        if last < 63:
            code, ln = ac.enc[0x00]
            w.put(code, ln)
    scan = w.flush()

    def seg(marker, body):
        return struct.pack(">HH", marker, len(body) + 2) + body

    out = struct.pack(">H", _SOI)
    if precision == 8:
        dqt = bytes([0x00]) + bytes(int(q) for q in qtab.reshape(-1)[_ZIGZAG])
    else:
        dqt = bytes([0x10]) + b"".join(
            struct.pack(">H", int(q)) for q in qtab.reshape(-1)[_ZIGZAG]
        )
    out += seg(_DQT, dqt)
    out += seg(
        _SOF0 if precision == 8 else _SOF1,
        struct.pack(">BHHB", precision, rows, cols, 1) + bytes([1, 0x11, 0]),
    )
    out += seg(_DHT, bytes([0x00] + dc_bits) + bytes(_K3_DC_VALS + [12, 13, 14, 15]))
    out += seg(_DHT, bytes([0x10] + _K3_AC_BITS) + bytes(_K3_AC_VALS))
    out += seg(_SOS, bytes([1, 1, 0x00, 0, 63, 0]))
    out += scan + struct.pack(">H", _EOI)
    return out

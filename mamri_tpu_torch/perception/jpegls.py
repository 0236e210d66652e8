"""JPEG-LS (ITU-T T.87 / ISO 14495-1) lossless codec, pure Python.

The third common lossless transfer syntax real scanners export besides RLE
and JPEG Lossless process 14 (the reference ingests all of them through
Slicer's DICOM stack, Mamri/Mamri.py:1306). Scope: single-component
(grayscale) scans, lossless NEAR=0 (DICOM 1.2.840.10008.1.2.4.80) and
near-lossless NEAR>0 (.81 — every decoded sample within NEAR of the
original), 2-16 bit precision, default or LSE-preset coding parameters,
restart-marker-free scans (DICOM encoders do not emit DRI/RSTn in practice).

Algorithm (LOCO-I): causal neighborhood {a, b, c, d}, gradient quantization
into 365 signed contexts, median-edge-detector prediction with adaptive bias
cancellation, Golomb-Rice coding with the limited-length escape, and a run
mode (run lengths in MELCODE segments + run-interruption contexts 365/366).
Arithmetic follows the CharLS implementation bit-for-bit (the de-facto
interop target used by dcmtk/pydicom plugins), including the order of the
run-index decrement relative to the interruption-sample limit.

Bitstream framing: SOI / SOF55 / (LSE) / SOS markers, bit-stuffing after
0xFF bytes (the byte following 0xFF carries only 7 payload bits, MSB 0).
"""

from __future__ import annotations

import struct
from typing import Dict, Tuple

import numpy as np


class JpegLsError(ValueError):
    pass


_SOI, _EOI = 0xFFD8, 0xFFD9
_SOF55, _LSE, _SOS, _DRI = 0xFFF7, 0xFFF8, 0xFFDA, 0xFFDD
_SOF_OTHER = tuple(
    m for m in range(0xFFC0, 0xFFD0) if m not in (0xFFC4, 0xFFC8, 0xFFCC)
)

# MELCODE run-length segment orders (T.87 table A.?; 32 entries)
_J = [0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
      4, 4, 5, 5, 6, 6, 7, 7, 8, 9, 10, 11, 12, 13, 14, 15]
_RESET = 64
_MIN_C, _MAX_C = -128, 127


def _default_thresholds(maxval: int, near: int = 0) -> Tuple[int, int, int]:
    """Default T1/T2/T3 (T.87 C.2.4.1.1.1, incl. the NEAR terms)."""
    def clamp(v, lo):
        return min(max(v, lo), maxval)

    lo1 = max(near + 1, 1)
    if maxval >= 128:
        factor = (min(maxval, 4095) + 128) // 256
        t1 = clamp(factor * (3 - 2) + 2 + 3 * near, lo1)
        t2 = clamp(factor * (7 - 3) + 3 + 5 * near, t1)
        t3 = clamp(factor * (21 - 4) + 4 + 7 * near, t2)
    else:
        factor = 256 // (maxval + 1)
        t1 = clamp(max(2, 3 // factor + 3 * near), lo1)
        t2 = clamp(max(3, 7 // factor + 5 * near), t1)
        t3 = clamp(max(4, 21 // factor + 7 * near), t2)
    return t1, t2, t3


class _Params:
    def __init__(self, precision: int, maxval: int, t1: int, t2: int, t3: int,
                 near: int = 0):
        self.maxval = maxval
        self.near = near
        self.range = (maxval + 2 * near) // (2 * near + 1) + 1
        self.qbpp = max(1, (self.range - 1).bit_length())
        bpp = max(2, (maxval + 1 - 1).bit_length())
        self.bpp = bpp
        self.limit = 2 * (bpp + max(8, bpp))
        self.t1, self.t2, self.t3 = t1, t2, t3
        # gradient quantizer LUT over [-maxval, maxval] (A.3.3 with NEAR)
        d = np.arange(-maxval, maxval + 1, dtype=np.int64)
        q = np.zeros_like(d)
        q[d > near] = 1
        q[d >= t1] = 2
        q[d >= t2] = 3
        q[d >= t3] = 4
        q[d < -near] = -1
        q[d <= -t1] = -2
        q[d <= -t2] = -3
        q[d <= -t3] = -4
        self.qlut = q
        self.qoff = maxval


class _State:
    """Adaptive context state: regular contexts 1..364, run-interruption
    contexts 365 (RItype 0) and 366 (RItype 1)."""

    def __init__(self, p: _Params):
        a0 = max(2, (p.range + 32) // 64)
        self.A = [a0] * 367
        self.B = [0] * 367
        self.C = [0] * 367
        self.N = [1] * 367
        self.Nn = [0, 0]  # negative counts for contexts 365/366
        self.run_index = 0


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.cur = 0
        self.curbits = 0
        self.cap = 8

    def _close_byte(self):
        self.out.append(self.cur)
        # a byte following 0xFF carries only 7 bits (stuffed MSB 0)
        self.cap = 7 if self.cur == 0xFF else 8
        self.cur = 0
        self.curbits = 0

    def put(self, value: int, nbits: int):
        for i in range(nbits - 1, -1, -1):
            self.cur = (self.cur << 1) | ((value >> i) & 1)
            self.curbits += 1
            if self.curbits == self.cap:
                self._close_byte()

    def zeros(self, n: int):
        while n > 0:
            take = min(n, self.cap - self.curbits)
            self.cur <<= take
            self.curbits += take
            n -= take
            if self.curbits == self.cap:
                self._close_byte()

    def flush(self) -> bytes:
        if self.curbits:
            self.cur <<= self.cap - self.curbits
            self.out.append(self.cur)
            self.cur = 0
            self.curbits = 0
        return bytes(self.out)


class _BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.acc = 0
        self.nbits = 0
        self.prev_ff = False

    def _fill(self):
        if self.pos < len(self.data):
            b = self.data[self.pos]
            if self.prev_ff:
                if b & 0x80:  # a real marker terminates the scan: zero-pad
                    self.acc <<= 8
                    self.nbits += 8
                    return
                self.pos += 1
                self.acc = (self.acc << 7) | b
                self.nbits += 7
                self.prev_ff = False
            else:
                self.pos += 1
                self.acc = (self.acc << 8) | b
                self.nbits += 8
                self.prev_ff = b == 0xFF
        else:  # past the scan: zero padding
            self.acc <<= 8
            self.nbits += 8

    def bits(self, n: int) -> int:
        while self.nbits < n:
            self._fill()
        self.nbits -= n
        v = (self.acc >> self.nbits) & ((1 << n) - 1)
        self.acc &= (1 << self.nbits) - 1
        return v

    def bit(self) -> int:
        return self.bits(1)

    def unary(self, cap: int) -> int:
        """Count zero bits before the next 1 bit (capped to keep malformed
        streams from spinning)."""
        n = 0
        while n <= cap:
            if self.bits(1):
                return n
            n += 1
        raise JpegLsError("unary run exceeds the limited-length cap")


def _golomb_encode(w: _BitWriter, k: int, val: int, limit: int, qbpp: int):
    high = val >> k
    if high < limit - qbpp - 1:
        w.zeros(high)
        w.put(1, 1)
        if k:
            w.put(val & ((1 << k) - 1), k)
    else:
        w.zeros(limit - qbpp - 1)
        w.put(1, 1)
        w.put(val - 1, qbpp)


def _golomb_decode(r: _BitReader, k: int, limit: int, qbpp: int) -> int:
    u = r.unary(limit)
    if u < limit - qbpp - 1:
        return (u << k) | (r.bits(k) if k else 0)
    if u != limit - qbpp - 1:
        raise JpegLsError("malformed limited Golomb code")
    return r.bits(qbpp) + 1


def _predict(ra: int, rb: int, rc: int) -> int:
    if rc >= (ra if ra >= rb else rb):
        return ra if ra <= rb else rb
    if rc <= (ra if ra <= rb else rb):
        return ra if ra >= rb else rb
    return ra + rb - rc


def _codec(img, shape, p: _Params, writer=None, reader=None):
    """One shared scan pass: encodes `img` when `writer` is given, decodes
    into a fresh array when `reader` is given. Sharing the traversal keeps
    the two directions structurally identical (the usual source of JPEG-LS
    bugs is encoder/decoder divergence in the run-mode edge cases)."""
    H, W = shape
    st = _State(p)
    A, B, C, N, Nn = st.A, st.B, st.C, st.N, st.Nn
    maxval, rng, qbpp, limit = p.maxval, p.range, p.qbpp, p.limit
    near = p.near
    qden = 2 * near + 1
    half = (rng + 1) // 2
    qlut, qoff = p.qlut, p.qoff
    encode = writer is not None
    # near-lossless coding predicts from RECONSTRUCTED samples, so the
    # encoder maintains its own reconstruction buffer; lossless encode
    # writes through (reconstruction == source)
    out = img if (encode and near == 0) else np.zeros((H, W), dtype=np.int64)
    prev = np.zeros(W, dtype=np.int64)
    c_first = 0

    for y in range(H):
        cur = out[y]
        cur_src = img[y] if encode else None
        i = 0
        while i < W:
            ra = cur[i - 1] if i > 0 else prev[0]
            rb = prev[i]
            rc = prev[i - 1] if i > 0 else c_first
            rd = prev[i + 1] if i + 1 < W else prev[W - 1]
            q1 = qlut[rd - rb + qoff]
            q2 = qlut[rb - rc + qoff]
            q3 = qlut[rc - ra + qoff]
            if q1 == 0 and q2 == 0 and q3 == 0:
                # ---- run mode
                ri = st.run_index
                if encode:
                    start = i
                    if near:
                        while i < W and abs(int(cur_src[i]) - ra) <= near:
                            i += 1
                        cur[start:i] = ra  # run samples reconstruct as RA
                    else:
                        while i < W and cur[i] == ra:
                            i += 1
                    cnt = i - start
                    while cnt >= (1 << _J[ri]):
                        writer.put(1, 1)
                        cnt -= 1 << _J[ri]
                        if ri < 31:
                            ri += 1
                    if i == W:
                        if cnt > 0:
                            writer.put(1, 1)
                        st.run_index = ri
                        break
                    writer.put(0, 1)
                    if _J[ri]:
                        writer.put(cnt, _J[ri])
                    x = int(cur_src[i])
                    rb = prev[i]  # neighbors move to the interruption sample
                else:
                    ended = False
                    while True:
                        if reader.bit():
                            seg = 1 << _J[ri]
                            fill = min(seg, W - i)
                            cur[i : i + fill] = ra
                            i += fill
                            if fill == seg:
                                if ri < 31:
                                    ri += 1
                                if i >= W:
                                    ended = True
                                    break
                                continue
                            ended = True  # partial '1' only happens at EOL
                            break
                        cnt = reader.bits(_J[ri]) if _J[ri] else 0
                        if cnt > W - i - 1:
                            raise JpegLsError("run remainder overruns the line")
                        cur[i : i + cnt] = ra
                        i += cnt
                        break
                    if ended:
                        st.run_index = ri
                        break
                    rb = prev[i]
                # ---- run-interruption sample (context 365/366); the Golomb
                # limit uses J[run_index] BEFORE the decrement (CharLS order)
                ritype = 1 if abs(int(ra) - int(rb)) <= near else 0
                if ritype:
                    px, sign = int(ra), 1
                else:
                    px, sign = int(rb), (1 if rb > ra else -1)
                q = 365 + ritype
                temp = A[q] + ((N[q] >> 1) if ritype else 0)
                k = 0
                while (N[q] << k) < temp:
                    k += 1
                rlimit = limit - _J[ri] - 1
                if encode:
                    errval = (x - px) * sign
                    if near:
                        if errval > 0:
                            errval = (errval + near) // qden
                        else:
                            errval = -((near - errval) // qden)
                        rx = px + sign * errval * qden
                        cur[i] = min(max(rx, 0), maxval)
                    if errval < 0:
                        errval += rng
                    if errval >= half:
                        errval -= rng
                    if errval == 0:
                        m = False
                    elif k == 0 and errval > 0 and 2 * Nn[ritype] < N[q]:
                        m = True
                    elif errval < 0 and 2 * Nn[ritype] >= N[q]:
                        m = True
                    elif errval < 0 and k != 0:
                        m = True
                    else:
                        m = False
                    emerr = 2 * abs(errval) - ritype - (1 if m else 0)
                    _golomb_encode(writer, k, emerr, rlimit, qbpp)
                else:
                    emerr = _golomb_decode(reader, k, rlimit, qbpp)
                    t = emerr + ritype
                    m = t & 1
                    evabs = (t + m) // 2
                    neg = (1 if (k != 0 or 2 * Nn[ritype] >= N[q]) else 0) == m
                    errval = -evabs if neg else evabs
                    x = px + sign * errval * qden
                    if x < -near:
                        x += rng * qden
                    elif x > maxval + near:
                        x -= rng * qden
                    if not -near <= x <= maxval + near:
                        raise JpegLsError("corrupt stream: sample out of range")
                    cur[i] = min(max(x, 0), maxval)
                if errval < 0:
                    Nn[ritype] += 1
                A[q] += (emerr + 1 - ritype) >> 1
                if N[q] == _RESET:
                    A[q] >>= 1
                    N[q] >>= 1
                    Nn[ritype] >>= 1
                N[q] += 1
                if ri > 0:
                    ri -= 1
                st.run_index = ri
                i += 1
                continue
            # ---- regular mode
            q = q1 * 81 + q2 * 9 + q3
            sign = 1
            if q < 0:
                q = -q
                sign = -1
            px = _predict(int(ra), int(rb), int(rc)) + sign * C[q]
            if px < 0:
                px = 0
            elif px > maxval:
                px = maxval
            k = 0
            while (N[q] << k) < A[q]:
                k += 1
            special = k == 0 and 2 * B[q] <= -N[q]
            if encode:
                errval = (int(cur_src[i]) - px) * sign
                if near:
                    if errval > 0:
                        errval = (errval + near) // qden
                    else:
                        errval = -((near - errval) // qden)
                    rx = px + sign * errval * qden
                    cur[i] = min(max(rx, 0), maxval)
                if errval < 0:
                    errval += rng
                if errval >= half:
                    errval -= rng
                if special:
                    merr = 2 * errval + 1 if errval >= 0 else -2 * (errval + 1)
                else:
                    merr = 2 * errval if errval >= 0 else -2 * errval - 1
                _golomb_encode(writer, k, merr, limit, qbpp)
            else:
                merr = _golomb_decode(reader, k, limit, qbpp)
                if special:
                    errval = (merr - 1) // 2 if merr & 1 else -(merr // 2) - 1
                else:
                    errval = -(merr + 1) // 2 if merr & 1 else merr // 2
                x = px + sign * errval * qden
                if x < -near:
                    x += rng * qden
                elif x > maxval + near:
                    x -= rng * qden
                if not -near <= x <= maxval + near:
                    raise JpegLsError("corrupt stream: sample out of range")
                cur[i] = min(max(x, 0), maxval)
            B[q] += errval * qden
            A[q] += abs(errval)
            if N[q] == _RESET:
                A[q] >>= 1
                B[q] >>= 1  # arithmetic shift == T.87's -((1-B)>>1) branch
                N[q] >>= 1
            N[q] += 1
            if B[q] <= -N[q]:
                if C[q] > _MIN_C:
                    C[q] -= 1
                B[q] += N[q]
                if B[q] <= -N[q]:
                    B[q] = -N[q] + 1
            elif B[q] > 0:
                if C[q] < _MAX_C:
                    C[q] += 1
                B[q] -= N[q]
                if B[q] > 0:
                    B[q] = 0
            i += 1
        c_first = int(prev[0])
        prev = cur
    return out


def encode_jpeg_ls(
    img: np.ndarray, precision: int, use_native: bool = True, near: int = 0
) -> bytes:
    """Encode a 2-D unsigned image (values < 2**precision) as a
    single-component JPEG-LS codestream: lossless (NEAR=0, DICOM .80) or
    near-lossless (NEAR>0, DICOM .81 — every reconstructed sample within
    NEAR of the source). Dispatches the entropy coding to the native C++
    codec when built (bit-identical output); the Python scan loop below is
    the oracle."""
    if img.ndim != 2:
        raise JpegLsError("only 2-D grayscale images")
    if not 2 <= precision <= 16:
        raise JpegLsError(f"precision {precision} out of range [2, 16]")
    a = np.ascontiguousarray(img, dtype=np.int64)
    maxval = (1 << precision) - 1
    if not 0 <= near <= min(255, maxval // 2):
        raise JpegLsError(f"NEAR={near} out of range [0, min(255, maxval/2)]")
    if a.min() < 0 or a.max() > maxval:
        raise JpegLsError("sample values exceed the stated precision")
    H, W = a.shape
    head = struct.pack(">H", _SOI)
    head += struct.pack(">HHBHHB", _SOF55, 11, precision, H, W, 1)
    head += bytes([1, 0x11, 0])  # component 1, no subsampling, Tq=0
    head += struct.pack(">HH", _SOS, 8) + bytes([1, 1, 0, near, 0, 0])  # ILV=0
    scan = None
    if use_native:
        from mamri_tpu_torch.native import jpegls_encode_native

        scan = jpegls_encode_native(a.astype(np.uint16), precision, near)
    if scan is None:
        p = _Params(precision, maxval, *_default_thresholds(maxval, near), near)
        w = _BitWriter()
        _codec(a, (H, W), p, writer=w)
        scan = w.flush()
    return head + scan + struct.pack(">H", _EOI)


def _parse_markers(data: bytes) -> Dict:
    if len(data) < 4 or struct.unpack_from(">H", data, 0)[0] != _SOI:
        raise JpegLsError("not a JPEG-LS stream (missing SOI)")
    pos = 2
    frame = None
    preset = None
    while pos + 4 <= len(data):
        marker, seglen = struct.unpack_from(">HH", data, pos)
        if marker >> 8 != 0xFF:
            raise JpegLsError(f"bad marker 0x{marker:04x} at {pos}")
        body = data[pos + 4 : pos + 2 + seglen]
        if seglen < 2 or len(body) != seglen - 2:
            raise JpegLsError("truncated marker segment")
        pos += 2 + seglen
        if marker == _SOF55:
            if len(body) < 9:
                raise JpegLsError("truncated SOF55 segment")
            prec, lines, cols, ncomp = struct.unpack_from(">BHHB", body, 0)
            if lines * cols > 1 << 26:
                raise JpegLsError("image larger than the 64-Mpixel decode cap")
            if ncomp != 1:
                raise JpegLsError("multi-component JPEG-LS scans unsupported")
            if lines == 0 or cols == 0:
                raise JpegLsError("DNL-deferred or empty frame unsupported")
            if not 2 <= prec <= 16:
                raise JpegLsError(f"precision {prec} out of range")
            frame = {"precision": prec, "rows": lines, "cols": cols}
        elif marker in _SOF_OTHER or marker == 0xFFC4:
            raise JpegLsError(f"marker 0x{marker:04x} is not JPEG-LS (SOF55)")
        elif marker == _LSE:
            if len(body) < 11:
                raise JpegLsError("truncated LSE segment")
            if body[0] != 1:
                raise JpegLsError(f"LSE preset type {body[0]} unsupported")
            mv, t1, t2, t3, reset = struct.unpack_from(">5H", body, 1)
            preset = (mv, t1, t2, t3, reset)
        elif marker == _DRI:
            if len(body) < 2 or struct.unpack_from(">H", body, 0)[0] != 0:
                raise JpegLsError("JPEG-LS restart intervals unsupported")
        elif marker == _SOS:
            if len(body) < 6:
                raise JpegLsError("truncated SOS segment")
            if body[0] != 1:
                raise JpegLsError("interleaved multi-component scan unsupported")
            near, ilv = body[1 + 2], body[1 + 2 + 1]
            if frame is None:
                raise JpegLsError("SOS before SOF55")
            if ilv != 0:
                raise JpegLsError("interleave modes unsupported for 1 component")
            return {**frame, "preset": preset, "near": near, "scan_offset": pos}
    raise JpegLsError("no SOS marker found")


def decode_jpeg_ls(data: bytes, use_native: bool = True) -> Tuple[np.ndarray, int]:
    """Decode a lossless single-component JPEG-LS codestream ->
    ((rows, cols) uint16 array, precision). Dispatches to the native C++
    decoder when built (mamri_tpu_torch.native.jpegls_decode_native, ~100x the
    Python scan loop); the Python path below is the oracle."""
    if use_native:
        from mamri_tpu_torch.native import jpegls_decode_native

        native = jpegls_decode_native(data)
        if native is not None:
            return native
    scan = _parse_markers(data)
    prec = scan["precision"]
    near = scan["near"]
    maxval = (1 << prec) - 1
    t1, t2, t3 = _default_thresholds(maxval, near)
    if scan["preset"] is not None:
        mv, pt1, pt2, pt3, reset = scan["preset"]
        if mv:
            maxval = mv
            t1, t2, t3 = _default_thresholds(maxval, near)
        if pt1 or pt2 or pt3:
            # a preset value of 0 means "default" PER THRESHOLD; each
            # defaulted value is re-clamped against the EFFECTIVE previous
            # threshold so partial presets stay a consistent T1<=T2<=T3
            # chain (matches the native decoder's clampv(dt, t_prev))
            d1, d2, d3 = t1, t2, t3
            t1 = pt1 or min(max(d1, max(near + 1, 1)), maxval)
            t2 = pt2 or min(max(d2, t1), maxval)
            t3 = pt3 or min(max(d3, t2), maxval)
        if reset and reset != _RESET:
            raise JpegLsError(f"non-default RESET={reset} unsupported")
        if not (1 <= t1 <= t2 <= t3 <= maxval):
            raise JpegLsError(f"inconsistent LSE thresholds ({t1}, {t2}, {t3})")
    if near > min(255, maxval // 2):  # against the (possibly LSE-preset) MAXVAL
        raise JpegLsError(f"NEAR={near} out of range for MAXVAL={maxval}")
    p = _Params(prec, maxval, t1, t2, t3, near)
    r = _BitReader(data[scan["scan_offset"] :])
    out = _codec(None, (scan["rows"], scan["cols"]), p, reader=r)
    return out.astype(np.uint16), prec

"""JPEG 2000 Part 1 (ITU-T T.800 / ISO 15444-1) lossless codec, pure Python.

Raw J2K codestream decode + encode with the reversible 5/3 wavelet, the MQ
arithmetic coder and EBCOT Tier-1/Tier-2 coding — the last compressed DICOM
transfer-syntax family this framework's scanner ingest needs
(1.2.840.10008.1.2.4.90 / .91, wired up in `perception/dicom.py`).

Replaces: the reference inherits JPEG 2000 DICOM ingest from 3D Slicer's
DICOM stack (GDCM/OpenJPEG) when scans are loaded into the scene
(Mamri/Mamri.py:1306 reads the already-decoded volume).

Scope (anything outside it raises ValueError loudly, never crashes):

- decode: both the reversible 5/3 transform (transfer syntax .90 is
  lossless-only, so this covers every valid .90 stream) and the
  irreversible 9/7 with scalar quantization (lossy .91 archives decode
  with conformant midpoint reconstruction — E.1.1 allows any value in the
  quantization interval; near-lossless rates match OpenJPEG within 1 LSB).
  Encode: reversible/lossless only.
- single-component (monochrome) images up to 16 bits, signed or unsigned —
  what MR exports are. Multi-component / MCT streams are rejected.
- arbitrary tile grids, decomposition levels, precinct partitions,
  code-block sizes and layer counts; LRCP / RLCP / RPCL progressions (the
  orders real exports use; with one component they enumerate the same
  packets per tile).
- default code-block style only (no selective bypass / reset / termall /
  vertically-causal / segmentation symbols): what OpenJPEG emits.

Interop is tested against OpenJPEG via Pillow in both directions
(tests/test_jpeg2000.py): our decoder reproduces OpenJPEG-encoded streams
bit-exactly, and OpenJPEG decodes our encoder's output bit-exactly.

The implementation favours clarity over speed (it is the oracle); the MQ /
Tier-1 hot loops have a native C++ port in `native/ccl_native.cpp`
(`use_native=True`, bit-identical streams).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


class Jpeg2000Error(ValueError):
    """Malformed or unsupported JPEG 2000 codestream."""


# --------------------------------------------------------------------------
# MQ arithmetic coder (T.800 Annex C; the same coder as JBIG2).
# Probability state table C.2: (Qe, NMPS, NLPS, SWITCH).
# --------------------------------------------------------------------------

_MQ_TAB = (
    (0x5601, 1, 1, 1), (0x3401, 2, 6, 0), (0x1801, 3, 9, 0), (0x0AC1, 4, 12, 0),
    (0x0521, 5, 29, 0), (0x0221, 38, 33, 0), (0x5601, 7, 6, 1), (0x5401, 8, 14, 0),
    (0x4801, 9, 14, 0), (0x3801, 10, 14, 0), (0x3001, 11, 17, 0), (0x2401, 12, 18, 0),
    (0x1C01, 13, 20, 0), (0x1601, 29, 21, 0), (0x5601, 15, 14, 1), (0x5401, 16, 14, 0),
    (0x5101, 17, 15, 0), (0x4801, 18, 16, 0), (0x3801, 19, 17, 0), (0x3401, 20, 18, 0),
    (0x3001, 21, 19, 0), (0x2801, 22, 19, 0), (0x2401, 23, 20, 0), (0x2201, 24, 21, 0),
    (0x1C01, 25, 22, 0), (0x1801, 26, 23, 0), (0x1601, 27, 24, 0), (0x1401, 28, 25, 0),
    (0x1201, 29, 26, 0), (0x1101, 30, 27, 0), (0x0AC1, 31, 28, 0), (0x09C1, 32, 29, 0),
    (0x08A1, 33, 30, 0), (0x0521, 34, 31, 0), (0x0441, 35, 32, 0), (0x02A1, 36, 33, 0),
    (0x0221, 37, 34, 0), (0x0141, 38, 35, 0), (0x0111, 39, 36, 0), (0x0085, 40, 37, 0),
    (0x0049, 41, 38, 0), (0x0025, 42, 39, 0), (0x0015, 43, 40, 0), (0x0009, 44, 41, 0),
    (0x0005, 45, 42, 0), (0x0001, 45, 43, 0), (0x5601, 46, 46, 0),
)

# EBCOT context numbering used throughout this module:
#   0..8   zero coding      (initial state: ctx 0 -> 4, others 0)
#   9..13  sign coding
#   14..16 magnitude refinement
#   17     run-length        (initial state 3)
#   18     uniform           (initial state 46)
_N_CTX = 19
_CTX_RL = 17
_CTX_UNI = 18


def _fresh_ctx_states() -> Tuple[List[int], List[int]]:
    idx = [0] * _N_CTX
    idx[0] = 4
    idx[_CTX_RL] = 3
    idx[_CTX_UNI] = 46
    return idx, [0] * _N_CTX


class _MQEncoder:
    """T.800 C.2 encoder. One instance per code-block (per-block contexts)."""

    def __init__(self):
        self.idx, self.mps = _fresh_ctx_states()
        self.a = 0x8000
        self.c = 0
        self.ct = 12
        # Leading sentinel byte absorbs a first-byte carry (same device as
        # OpenJPEG's bp = start-1); dropped at flush.
        self.out = bytearray(b"\x00")

    def _byteout(self):
        out = self.out
        if out[-1] == 0xFF:
            out.append((self.c >> 20) & 0xFF)
            self.c &= 0xFFFFF
            self.ct = 7
        elif self.c < 0x8000000:
            out.append((self.c >> 19) & 0xFF)
            self.c &= 0x7FFFF
            self.ct = 8
        else:
            out[-1] += 1  # carry into the previous byte
            if out[-1] == 0xFF:
                self.c &= 0x7FFFFFF
                out.append((self.c >> 20) & 0xFF)
                self.c &= 0xFFFFF
                self.ct = 7
            else:
                out.append((self.c >> 19) & 0xFF)
                self.c &= 0x7FFFF
                self.ct = 8

    def encode(self, ctx: int, bit: int):
        qe, nmps, nlps, switch = _MQ_TAB[self.idx[ctx]]
        self.a -= qe
        if bit == self.mps[ctx]:
            if self.a & 0x8000:
                self.c += qe
                return
            if self.a < qe:
                self.a = qe  # conditional exchange
            else:
                self.c += qe
            self.idx[ctx] = nmps
        else:
            if self.a < qe:
                self.c += qe  # conditional exchange
            else:
                self.a = qe
            if switch:
                self.mps[ctx] ^= 1
            self.idx[ctx] = nlps
        while True:  # RENORME
            self.a = (self.a << 1) & 0xFFFF
            self.c = (self.c << 1) & 0xFFFFFFFF
            self.ct -= 1
            if self.ct == 0:
                self._byteout()
            if self.a & 0x8000:
                break

    def flush(self) -> bytes:
        # SETBITS then two byteouts (C.2.9).
        tempc = self.c + self.a
        self.c |= 0xFFFF
        if self.c >= tempc:
            self.c -= 0x8000
        self.c = (self.c << self.ct) & 0xFFFFFFFF
        self._byteout()
        self.c = (self.c << self.ct) & 0xFFFFFFFF
        self._byteout()
        if self.out[-1] == 0xFF:
            del self.out[-1]  # the decoder synthesizes trailing 0xFF itself
        if self.out[0] != 0:
            raise AssertionError("MQ carry escaped the sentinel byte")
        return bytes(self.out[1:])


class _MQDecoder:
    """T.800 C.3 decoder. Bytes past the end are fed as 0xFF (marker rule)."""

    def __init__(self, data: bytes):
        self.idx, self.mps = _fresh_ctx_states()
        self.data = data
        self.n = len(data)
        self.bp = 0
        b0 = data[0] if self.n else 0xFF
        self.c = b0 << 16
        self._bytein()
        self.c = (self.c << 7) & 0xFFFFFFFF
        self.ct -= 7
        self.a = 0x8000

    def _bytein(self):
        d, n = self.data, self.n
        cur = d[self.bp] if self.bp < n else 0xFF
        if cur == 0xFF:
            nxt = d[self.bp + 1] if self.bp + 1 < n else 0xFF
            if nxt > 0x8F:
                self.c += 0xFF00
                self.ct = 8
            else:
                self.bp += 1
                self.c += nxt << 9
                self.ct = 7
        else:
            self.bp += 1
            nxt = d[self.bp] if self.bp < n else 0xFF
            self.c += nxt << 8
            self.ct = 8

    def decode(self, ctx: int) -> int:
        qe, nmps, nlps, switch = _MQ_TAB[self.idx[ctx]]
        self.a -= qe
        if (self.c >> 16) < qe:
            if self.a < qe:  # conditional exchange: MPS decoded
                d = self.mps[ctx]
                self.idx[ctx] = nmps
            else:
                d = self.mps[ctx] ^ 1
                if switch:
                    self.mps[ctx] ^= 1
                self.idx[ctx] = nlps
            self.a = qe
        else:
            self.c -= qe << 16
            if self.a & 0x8000:
                return self.mps[ctx]
            if self.a < qe:  # conditional exchange: LPS decoded
                d = self.mps[ctx] ^ 1
                if switch:
                    self.mps[ctx] ^= 1
                self.idx[ctx] = nlps
            else:
                d = self.mps[ctx]
                self.idx[ctx] = nmps
        while True:  # RENORMD
            if self.ct == 0:
                self._bytein()
            self.a = (self.a << 1) & 0xFFFF
            self.c = (self.c << 1) & 0xFFFFFFFF
            self.ct -= 1
            if self.a & 0x8000:
                break
        return d


# --------------------------------------------------------------------------
# Packet-header bit I/O with 0xFF bit-stuffing (B.10.1).
# --------------------------------------------------------------------------


class _HeaderWriter:
    def __init__(self):
        self.bytes = bytearray()
        self._cur = 0
        self._nbits = 0  # bits already placed in _cur
        self._cap = 8

    def bit(self, b: int):
        self._cur = (self._cur << 1) | (b & 1)
        self._nbits += 1
        if self._nbits == self._cap:
            self.bytes.append(self._cur)
            self._cap = 7 if self._cur == 0xFF else 8
            self._cur = 0
            self._nbits = 0

    def bits(self, value: int, n: int):
        for i in range(n - 1, -1, -1):
            self.bit((value >> i) & 1)

    def flush(self) -> bytes:
        if self._nbits:
            self.bytes.append(self._cur << (self._cap - self._nbits))
            self._cur = 0
            self._nbits = 0
            self._cap = 7 if self.bytes[-1] == 0xFF else 8
        if self.bytes and self.bytes[-1] == 0xFF:
            self.bytes.append(0x00)  # stuffed terminator
        return bytes(self.bytes)


class _HeaderReader:
    def __init__(self, data: bytes, pos: int):
        self.data = data
        self.pos = pos
        self._cur = 0
        self._left = 0
        self._last = 0  # last fully-loaded byte

    def bit(self) -> int:
        if self._left == 0:
            if self.pos >= len(self.data):
                raise Jpeg2000Error("packet header overruns the codestream")
            b = self.data[self.pos]
            self.pos += 1
            if self._last == 0xFF:
                if b & 0x80:
                    raise Jpeg2000Error("bit-stuffing violation in packet header")
                self._left = 7
            else:
                self._left = 8
            self._cur = b
            self._last = b
        self._left -= 1
        return (self._cur >> self._left) & 1

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def align(self) -> int:
        """Finish the header: drop partial bits, skip a stuffed terminator.

        Returns the byte offset where the packet body starts."""
        self._left = 0
        if self._last == 0xFF:
            if self.pos < len(self.data) and self.data[self.pos] & 0x80 == 0:
                self.pos += 1
        self._last = 0
        return self.pos


# --------------------------------------------------------------------------
# Tag trees (B.10.2) — quadtree over code-blocks in a precinct-band.
# --------------------------------------------------------------------------


class _TagTree:
    def __init__(self, w: int, h: int):
        self.w, self.h = w, h
        sizes = []
        lw, lh = max(w, 1), max(h, 1)
        while True:
            sizes.append((lw, lh))
            if lw == 1 and lh == 1:
                break
            lw, lh = (lw + 1) // 2, (lh + 1) // 2
        self.sizes = sizes  # leaf level first
        self.value = [[0] * (sw * sh) for sw, sh in sizes]
        self.known = [[False] * (sw * sh) for sw, sh in sizes]
        self.low = [[0] * (sw * sh) for sw, sh in sizes]  # encoder-side emitted bound

    def _path(self, x: int, y: int):
        nodes = []
        for lev, (sw, _sh) in enumerate(self.sizes):
            nodes.append((lev, y * sw + x))
            x >>= 1
            y >>= 1
        return nodes  # leaf .. root

    # decoder ---------------------------------------------------------------
    def decode(self, rd: _HeaderReader, x: int, y: int, threshold: int) -> bool:
        """Read bits until `value(x,y) < threshold` is decided; return it."""
        low = 0
        leaf_val = 0
        for lev, i in reversed(self._path(x, y)):
            if self.value[lev][i] < low:
                self.value[lev][i] = low
            while not self.known[lev][i] and self.value[lev][i] < threshold:
                if rd.bit():
                    self.known[lev][i] = True
                else:
                    self.value[lev][i] += 1
            low = self.value[lev][i]
            if not self.known[lev][i]:
                return False  # only a lower bound >= threshold is known
            leaf_val = self.value[lev][i]
        return leaf_val < threshold

    def decode_value(self, rd: _HeaderReader, x: int, y: int) -> int:
        """Fully resolve the leaf value (used for zero-bitplane trees)."""
        t = 1
        while not self.decode(rd, x, y, t):
            t += 1
        lev, i = self._path(x, y)[0]
        return self.value[lev][i]

    # encoder ---------------------------------------------------------------
    def set_value(self, x: int, y: int, v: int):
        lev, i = self._path(x, y)[0]
        self.value[lev][i] = v

    def finalize(self):
        for lev in range(1, len(self.sizes)):
            sw, sh = self.sizes[lev]
            cw, _ch = self.sizes[lev - 1]
            child = self.value[lev - 1]
            for y in range(sh):
                for x in range(sw):
                    best = None
                    for cy in (2 * y, 2 * y + 1):
                        for cx in (2 * x, 2 * x + 1):
                            if cx < cw and cy < self.sizes[lev - 1][1]:
                                v = child[cy * cw + cx]
                                best = v if best is None else min(best, v)
                    self.value[lev][y * sw + x] = 0 if best is None else best

    def encode(self, wr: _HeaderWriter, x: int, y: int, threshold: int):
        low = 0
        for lev, i in reversed(self._path(x, y)):
            if self.low[lev][i] < low:
                self.low[lev][i] = low
            while not self.known[lev][i] and self.low[lev][i] < threshold:
                if self.low[lev][i] < self.value[lev][i]:
                    wr.bit(0)
                    self.low[lev][i] += 1
                else:
                    wr.bit(1)
                    self.known[lev][i] = True
            low = self.low[lev][i]
            if not self.known[lev][i]:
                return

# --------------------------------------------------------------------------
# Tier-1: EBCOT coefficient bit modeling (T.800 Annex D).
# Code-blocks are coded in 4-row stripes, column-major within a stripe.
# --------------------------------------------------------------------------

# Zero-coding context from (h, v, d) neighbor significance counts, per band
# orientation (Table D.1).  LH shares the LL table; HL swaps h and v.


def _zc_ctx_ll(h: int, v: int, d: int) -> int:
    if h == 2:
        return 8
    if h == 1:
        if v >= 1:
            return 7
        return 6 if d >= 1 else 5
    if v == 2:
        return 4
    if v == 1:
        return 3
    return 2 if d >= 2 else d  # d in {0, 1} maps to ctx 0 / 1


def _zc_ctx_hh(h: int, v: int, d: int) -> int:
    hv = h + v
    if d >= 3:
        return 8
    if d == 2:
        return 7 if hv >= 1 else 6
    if d == 1:
        return 5 if hv >= 2 else (4 if hv == 1 else 3)
    return 2 if hv >= 2 else hv  # hv in {0, 1} maps to ctx 0 / 1


# Sign-coding context + XOR bit from clamped H/V sign contributions
# (Table D.3): index by (hc+1)*3 + (vc+1).
_SC_TAB = (
    (13, 1), (12, 1), (11, 1),  # hc = -1
    (10, 1), (9, 0), (10, 0),   # hc = 0
    (11, 0), (12, 0), (13, 0),  # hc = +1
)


class _BlockCoder:
    """Shared scan machinery for Tier-1 decode and encode.

    State per coefficient (flat arrays of size (h+2)*(w+2), 1-cell apron so
    neighbor reads never branch): sigma (significant), sign (1=negative),
    pi (coded in the current significance-propagation pass), refined.
    """

    def __init__(self, w: int, h: int, orient: int):
        self.w, self.h = w, h
        self.stride = w + 2
        n = (w + 2) * (h + 2)
        self.sigma = bytearray(n)
        self.sign = bytearray(n)
        self.pi = bytearray(n)
        self.refined = bytearray(n)
        self.mag = [0] * n
        if orient == 1:  # HL: transpose the h/v roles
            self._zc = lambda h_, v_, d_: _zc_ctx_ll(v_, h_, d_)
        elif orient == 3:  # HH
            self._zc = _zc_ctx_hh
        else:  # LL (0) and LH (2)
            self._zc = _zc_ctx_ll

    def _idx(self, x: int, y: int) -> int:
        return (y + 1) * self.stride + (x + 1)

    def _zc_ctx(self, i: int) -> int:
        s, st = self.sigma, self.stride
        h = s[i - 1] + s[i + 1]
        v = s[i - st] + s[i + st]
        d = s[i - st - 1] + s[i - st + 1] + s[i + st - 1] + s[i + st + 1]
        return self._zc(h, v, d)

    def _has_sig_neighbor(self, i: int) -> bool:
        s, st = self.sigma, self.stride
        return bool(
            s[i - 1] or s[i + 1] or s[i - st] or s[i + st]
            or s[i - st - 1] or s[i - st + 1] or s[i + st - 1] or s[i + st + 1]
        )

    def _sc_ctx(self, i: int) -> Tuple[int, int]:
        s, sg, st = self.sigma, self.sign, self.stride
        hc = vc = 0
        for j in (i - 1, i + 1):
            if s[j]:
                hc += -1 if sg[j] else 1
        for j in (i - st, i + st):
            if s[j]:
                vc += -1 if sg[j] else 1
        hc = max(-1, min(1, hc))
        vc = max(-1, min(1, vc))
        return _SC_TAB[(hc + 1) * 3 + (vc + 1)]

    def _mr_ctx(self, i: int) -> int:
        if self.refined[i]:
            return 16
        return 15 if self._has_sig_neighbor(i) else 14

    def _scan(self):
        """Yield (x, y, i) in the T.800 stripe scan order."""
        w, h = self.w, self.h
        for y0 in range(0, h, 4):
            ylim = min(y0 + 4, h)
            for x in range(w):
                for y in range(y0, ylim):
                    yield x, y, self._idx(x, y)

    def result(self) -> np.ndarray:
        out = np.zeros((self.h, self.w), dtype=np.int32)
        for y in range(self.h):
            base = self._idx(0, y)
            row = out[y]
            for x in range(self.w):
                i = base + x
                if self.sigma[i]:
                    row[x] = -self.mag[i] if self.sign[i] else self.mag[i]
        return out


def t1_decode(
    data: bytes, w: int, h: int, orient: int, bitplanes: int, npasses: int,
    use_native: bool = True,
) -> np.ndarray:
    """Decode one code-block's codeword segment into signed coefficients."""
    if bitplanes <= 0 or npasses <= 0:
        return np.zeros((h, w), dtype=np.int32)
    if npasses > 3 * bitplanes - 2:
        raise Jpeg2000Error(
            f"code-block signals {npasses} passes but only {bitplanes} bitplanes"
        )
    if use_native:
        from mamri_tpu_torch.native import j2k_t1_decode_native

        try:
            native = j2k_t1_decode_native(data, w, h, orient, bitplanes, npasses)
        except ValueError as e:
            raise Jpeg2000Error(str(e))
        if native is not None:
            return native
    cb = _BlockCoder(w, h, orient)
    mq = _MQDecoder(data)
    sigma, pi, refined, mag, sign = cb.sigma, cb.pi, cb.refined, cb.mag, cb.sign
    st = cb.stride
    plane = bitplanes - 1
    passno = 0
    kind = 2  # cleanup first on the MSB plane
    while passno < npasses:
        bit = 1 << plane
        if kind == 0:  # significance propagation
            for _x, _y, i in cb._scan():
                if sigma[i]:
                    pi[i] = 0
                    continue
                if cb._has_sig_neighbor(i):
                    pi[i] = 1
                    if mq.decode(cb._zc_ctx(i)):
                        ctx, xor = cb._sc_ctx(i)
                        sign[i] = mq.decode(ctx) ^ xor
                        sigma[i] = 1
                        mag[i] = bit
                else:
                    pi[i] = 0
        elif kind == 1:  # magnitude refinement
            for _x, _y, i in cb._scan():
                if sigma[i] and not pi[i] and mag[i] != bit:
                    if mq.decode(cb._mr_ctx(i)):
                        mag[i] |= bit
                    refined[i] = 1
        else:  # cleanup
            wdt, hgt = cb.w, cb.h
            for y0 in range(0, hgt, 4):
                full = y0 + 4 <= hgt
                for x in range(wdt):
                    y = y0
                    if full:
                        col = [cb._idx(x, y0 + k) for k in range(4)]
                        if not any(
                            sigma[i] or pi[i] or cb._has_sig_neighbor(i) for i in col
                        ):
                            if not mq.decode(_CTX_RL):
                                continue  # whole column stays insignificant
                            r = (mq.decode(_CTX_UNI) << 1) | mq.decode(_CTX_UNI)
                            i = col[r]
                            ctx, xor = cb._sc_ctx(i)
                            sign[i] = mq.decode(ctx) ^ xor
                            sigma[i] = 1
                            mag[i] = bit
                            y = y0 + r + 1
                    ylim = min(y0 + 4, hgt)
                    while y < ylim:
                        i = cb._idx(x, y)
                        if not sigma[i] and not pi[i]:
                            if mq.decode(cb._zc_ctx(i)):
                                ctx, xor = cb._sc_ctx(i)
                                sign[i] = mq.decode(ctx) ^ xor
                                sigma[i] = 1
                                mag[i] = bit
                        pi[i] = 0
                        y += 1
        passno += 1
        if kind == 2:
            plane -= 1
            if plane < 0 and passno < npasses:
                raise Jpeg2000Error("more coding passes than bitplanes")
            kind = 0
        else:
            kind += 1
    return cb.result()


def t1_encode(coeffs: np.ndarray, orient: int, max_bitplanes: int, use_native: bool = True):
    """Encode one code-block.  Returns (data, zero_bitplanes, npasses)."""
    h, w = coeffs.shape
    mags = np.abs(coeffs.astype(np.int64))
    maxmag = int(mags.max()) if mags.size else 0
    nb = int(maxmag).bit_length()
    if nb > max_bitplanes:
        raise Jpeg2000Error(
            f"coefficient needs {nb} bitplanes but the band allows {max_bitplanes}"
        )
    if nb == 0:
        return b"", max_bitplanes, 0
    if use_native:
        from mamri_tpu_torch.native import j2k_t1_encode_native

        try:
            native = j2k_t1_encode_native(coeffs.astype(np.int32), orient, max_bitplanes)
        except ValueError as e:
            raise Jpeg2000Error(str(e))
        if native is not None:
            return native
    cb = _BlockCoder(w, h, orient)
    # preload target values
    tmag = [0] * len(cb.mag)
    tneg = bytearray(len(cb.mag))
    for y in range(h):
        base = cb._idx(0, y)
        for x in range(w):
            tmag[base + x] = int(mags[y, x])
            tneg[base + x] = 1 if coeffs[y, x] < 0 else 0
    mq = _MQEncoder()
    sigma, pi, refined, mag, sign = cb.sigma, cb.pi, cb.refined, cb.mag, cb.sign
    npasses = 3 * nb - 2
    plane = nb - 1
    kind = 2
    for _p in range(npasses):
        bit = 1 << plane
        if kind == 0:
            for _x, _y, i in cb._scan():
                if sigma[i]:
                    pi[i] = 0
                    continue
                if cb._has_sig_neighbor(i):
                    pi[i] = 1
                    b = 1 if tmag[i] & bit else 0
                    mq.encode(cb._zc_ctx(i), b)
                    if b:
                        ctx, xor = cb._sc_ctx(i)
                        mq.encode(ctx, tneg[i] ^ xor)
                        sign[i] = tneg[i]
                        sigma[i] = 1
                        mag[i] = bit
                else:
                    pi[i] = 0
        elif kind == 1:
            for _x, _y, i in cb._scan():
                if sigma[i] and not pi[i] and mag[i] != bit:
                    mq.encode(cb._mr_ctx(i), 1 if tmag[i] & bit else 0)
                    if tmag[i] & bit:
                        mag[i] |= bit
                    refined[i] = 1
        else:
            for y0 in range(0, h, 4):
                full = y0 + 4 <= h
                for x in range(w):
                    y = y0
                    if full:
                        col = [cb._idx(x, y0 + k) for k in range(4)]
                        if not any(
                            sigma[i] or pi[i] or cb._has_sig_neighbor(i) for i in col
                        ):
                            sigs = [1 if tmag[i] & bit else 0 for i in col]
                            if not any(sigs):
                                mq.encode(_CTX_RL, 0)
                                continue
                            mq.encode(_CTX_RL, 1)
                            r = sigs.index(1)
                            mq.encode(_CTX_UNI, (r >> 1) & 1)
                            mq.encode(_CTX_UNI, r & 1)
                            i = col[r]
                            ctx, xor = cb._sc_ctx(i)
                            mq.encode(ctx, tneg[i] ^ xor)
                            sign[i] = tneg[i]
                            sigma[i] = 1
                            mag[i] = bit
                            y = y0 + r + 1
                    ylim = min(y0 + 4, h)
                    while y < ylim:
                        i = cb._idx(x, y)
                        if not sigma[i] and not pi[i]:
                            b = 1 if tmag[i] & bit else 0
                            mq.encode(cb._zc_ctx(i), b)
                            if b:
                                ctx, xor = cb._sc_ctx(i)
                                mq.encode(ctx, tneg[i] ^ xor)
                                sign[i] = tneg[i]
                                sigma[i] = 1
                                mag[i] = bit
                        pi[i] = 0
                        y += 1
        if kind == 2:
            plane -= 1
            kind = 0
        else:
            kind += 1
    return mq.flush(), max_bitplanes - nb, npasses

# --------------------------------------------------------------------------
# Reversible 5/3 wavelet (T.800 Annex F), vectorized with numpy.
# Forward per level: vertical then horizontal (OpenJPEG order); inverse
# mirrors it (horizontal then vertical).  Band membership of a sample is
# decided by its ABSOLUTE coordinate parity, so each 1D transform takes the
# interval's absolute start index u0.
# --------------------------------------------------------------------------


def _reflect_idx(i: np.ndarray, n: int) -> np.ndarray:
    """Whole-sample symmetric extension indices into [0, n)."""
    if n == 1:
        return np.zeros_like(i)
    p = 2 * n - 2
    i = np.mod(i, p)
    return np.where(i >= n, p - i, i)


def _low_len(u0: int, n: int) -> int:
    """Number of even absolute indices in [u0, u0+n)."""
    u1 = u0 + n
    return (u1 + 1) // 2 - (u0 + 1) // 2


def _fwd53(a: np.ndarray, u0: int) -> Tuple[np.ndarray, np.ndarray]:
    """1D forward 5/3 along axis 0.  Returns (low, high) subband samples."""
    n = a.shape[0]
    if n == 0:
        return a[:0], a[:0]
    if n == 1:
        if u0 % 2 == 0:
            return a.copy(), a[:0]
        return a[:0], a * 2
    ext = a[_reflect_idx(np.arange(-2, n + 2), n)]  # E[k] = x[j = k-2]
    # d at j = m-1 for m in 0..n+1 (odd absolute positions are the valid ones)
    d = ext[1:-1] - (ext[:-2] + ext[2:]) // 2
    # s at j = m for m in 0..n-1 (even absolute positions valid)
    s = ext[2:-2] + (d[:-2] + d[2:] + 2) // 4
    j = np.arange(n)
    odd = ((u0 + j) % 2 == 1)
    sel = odd.reshape((n,) + (1,) * (a.ndim - 1))
    y = np.where(sel, d[1 : n + 1], s)
    return y[~odd], y[odd]


def _inv53(low: np.ndarray, high: np.ndarray, u0: int) -> np.ndarray:
    """1D inverse 5/3 along axis 0 over the interval [u0, u0+n)."""
    n = low.shape[0] + high.shape[0]
    if n == 0:
        return low[:0].astype(np.int64)
    if n == 1:
        return low.copy() if low.shape[0] else high // 2
    tail = low.shape[1:] if low.ndim > 1 else ()
    y = np.empty((n,) + tail, dtype=np.int64)
    j = np.arange(n)
    odd = ((u0 + j) % 2 == 1)
    y[~odd] = low
    y[odd] = high
    ext = y[_reflect_idx(np.arange(-2, n + 2), n)]
    # x at even absolute j (m = j+... ): s'[m] = Y[m] - (Y[m-1]+Y[m+1]+2)//4
    a = ext[1:-1] - (ext[:-2] + ext[2:] + 2) // 4  # valid at even abs, j=-1..n
    b = ext[2:-2] + (a[:-2] + a[2:]) // 2  # valid at odd abs, j=0..n-1
    sel = odd.reshape((n,) + (1,) * (y.ndim - 1))
    return np.where(sel, b, a[1 : n + 1])


def _fdwt53(tile: np.ndarray, tx0: int, ty0: int, levels: int) -> np.ndarray:
    """In-place multi-level forward transform; returns the quadrant layout
    (LL recursively in the top-left)."""
    t = tile.astype(np.int64)
    h, w = t.shape
    x0, y0 = tx0, ty0
    for _lev in range(levels):
        sub = t[:h, :w]
        lo, hi = _fwd53(sub, y0)  # vertical
        sub = np.concatenate([lo, hi], axis=0)
        lo, hi = _fwd53(sub.T, x0)  # horizontal (transpose to reuse axis 0)
        t[:h, :w] = np.concatenate([lo, hi], axis=0).T
        w, h = _low_len(x0, w), _low_len(y0, h)
        x0, y0 = (x0 + 1) // 2, (y0 + 1) // 2
    return t


def _idwt53(t: np.ndarray, tx0: int, ty0: int, levels: int) -> np.ndarray:
    """Inverse of `_fdwt53` on the quadrant layout."""
    th, tw = t.shape
    dims = [(tw, th, tx0, ty0)]
    for _ in range(levels):
        tw, th = _low_len(tx0, tw), _low_len(ty0, th)
        tx0, ty0 = (tx0 + 1) // 2, (ty0 + 1) // 2
        dims.append((tw, th, tx0, ty0))
    out = t.astype(np.int64)
    for lev in range(levels, 0, -1):
        w, h, x0, y0 = dims[lev - 1]
        lw, lh = _low_len(x0, w), _low_len(y0, h)
        sub = out[:h, :w]
        rows = _inv53(sub.T[:lw], sub.T[lw:], x0).T  # horizontal first
        out[:h, :w] = _inv53(rows[:lh], rows[lh:], y0)
    return out


# --------------------------------------------------------------------------
# Codestream geometry (Annex B): tiles, resolutions, bands, precincts,
# code-blocks.  All coordinates are absolute (reference-grid derived).
# --------------------------------------------------------------------------


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


class _Band:
    def __init__(self, orient: int, x0: int, y0: int, x1: int, y1: int, gain: int):
        self.orient = orient  # 0 LL, 1 HL, 2 LH, 3 HH
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.gain = gain

    @property
    def w(self):
        return max(0, self.x1 - self.x0)

    @property
    def h(self):
        return max(0, self.y1 - self.y0)


def _band_coords(tx0, ty0, tx1, ty1, nb, xob, yob):
    sh = 1 << (nb - 1)
    return (
        _ceil_div(tx0 - sh * xob, 1 << nb),
        _ceil_div(ty0 - sh * yob, 1 << nb),
        _ceil_div(tx1 - sh * xob, 1 << nb),
        _ceil_div(ty1 - sh * yob, 1 << nb),
    )


class _CodeBlock:
    __slots__ = ("x0", "y0", "x1", "y1", "px", "py", "data", "npasses", "zbp",
                 "included", "lblock", "nbps")

    def __init__(self, x0, y0, x1, y1, px, py):
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.px, self.py = px, py  # position in the precinct's code-block grid
        self.data = bytearray()
        self.npasses = 0
        self.zbp = -1
        self.included = False
        self.lblock = 3
        self.nbps = 0


class _PrecinctBand:
    """One band's code-blocks inside one precinct, plus its tag trees."""

    def __init__(self, cblocks: List[_CodeBlock], gw: int, gh: int):
        self.cblocks = cblocks
        self.incl = _TagTree(gw, gh)
        self.zbp = _TagTree(gw, gh)


class _Resolution:
    def __init__(self, r, bands, ppx, ppy, npw, nph, precincts):
        self.r = r
        self.bands = bands  # list[_Band]
        self.ppx, self.ppy = ppx, ppy
        self.npw, self.nph = npw, nph
        self.precincts = precincts  # list over precinct index -> list[_PrecinctBand]


# Irreversible 9/7 inverse (T.800 F.4.8.3): float lifting, whole-sample
# symmetric extension, parity by absolute coordinate like the 5/3 path.
_A97 = -1.586134342059924
_B97 = -0.052980118572961
_G97 = 0.882911075530934
_D97 = 0.443506852043971
_K97 = 1.230174104914001


def _inv97(low: np.ndarray, high: np.ndarray, u0: int) -> np.ndarray:
    """1D inverse 9/7 along axis 0 over [u0, u0+n) (float64 in/out)."""
    n = low.shape[0] + high.shape[0]
    if n == 0:
        return low[:0].astype(np.float64)
    if n == 1:
        return (low * _K97).astype(np.float64) if low.shape[0] else high / _K97
    tail = low.shape[1:] if low.ndim > 1 else ()
    y = np.empty((n,) + tail, dtype=np.float64)
    j = np.arange(n)
    odd = ((u0 + j) % 2 == 1)
    y[~odd] = low * _K97        # undo the forward lowpass scale
    y[odd] = high / _K97        # undo the forward highpass scale
    ext = y[_reflect_idx(np.arange(-4, n + 4), n)]  # E[k] = y[j = k-4]
    # undo the four lifting steps in reverse order; each formula is valid
    # at its parity and only reads the other parity at +-1
    s1 = ext[1:-1] - _D97 * (ext[:-2] + ext[2:])        # even abs, j=-3..n+2
    d1 = ext[2:-2] - _G97 * (s1[:-2] + s1[2:])          # odd abs,  j=-2..n+1
    s0 = s1[2:-2] - _B97 * (d1[:-2] + d1[2:])           # even abs, j=-1..n
    d0 = d1[2:-2] - _A97 * (s0[:-2] + s0[2:])           # odd abs,  j=0..n-1
    sel = odd.reshape((n,) + (1,) * (y.ndim - 1))
    return np.where(sel, d0, s0[1 : n + 1])


def _idwt97(t: np.ndarray, tx0: int, ty0: int, levels: int) -> np.ndarray:
    """Inverse of the 9/7 forward transform on the quadrant layout."""
    th, tw = t.shape
    dims = [(tw, th, tx0, ty0)]
    for _ in range(levels):
        tw, th = _low_len(tx0, tw), _low_len(ty0, th)
        tx0, ty0 = (tx0 + 1) // 2, (ty0 + 1) // 2
        dims.append((tw, th, tx0, ty0))
    out = t.astype(np.float64)
    for lev in range(levels, 0, -1):
        w, h, x0, y0 = dims[lev - 1]
        lw, lh = _low_len(x0, w), _low_len(y0, h)
        sub = out[:h, :w]
        rows = _inv97(sub.T[:lw], sub.T[lw:], x0).T  # horizontal first
        out[:h, :w] = _inv97(rows[:lh], rows[lh:], y0)
    return out


def _build_resolutions(
    tx0: int, ty0: int, tx1: int, ty1: int, nl: int,
    xcb: int, ycb: int, prec_sizes: Optional[List[Tuple[int, int]]],
) -> List[_Resolution]:
    """Resolution/band/precinct/code-block structure for one tile (B.5-B.7)."""
    resolutions = []
    for r in range(nl + 1):
        k = nl - r
        trx0, try0 = _ceil_div(tx0, 1 << k), _ceil_div(ty0, 1 << k)
        trx1, try1 = _ceil_div(tx1, 1 << k), _ceil_div(ty1, 1 << k)
        ppx, ppy = (15, 15) if prec_sizes is None else prec_sizes[r]
        if r == 0:
            bands = [_Band(0, trx0, try0, trx1, try1, 0)]
        else:
            nb = nl - r + 1
            bands = [
                _Band(1, *_band_coords(tx0, ty0, tx1, ty1, nb, 1, 0), 1),
                _Band(2, *_band_coords(tx0, ty0, tx1, ty1, nb, 0, 1), 1),
                _Band(3, *_band_coords(tx0, ty0, tx1, ty1, nb, 1, 1), 2),
            ]
        if trx1 > trx0:
            npw = _ceil_div(trx1, 1 << ppx) - (trx0 >> ppx)
        else:
            npw = 0
        if try1 > try0:
            nph = _ceil_div(try1, 1 << ppy) - (try0 >> ppy)
        else:
            nph = 0
        # code-block span inside a precinct, on band coordinates
        if r == 0:
            cbx, cby = min(xcb, ppx), min(ycb, ppy)
            bppx, bppy = ppx, ppy  # precinct size on band grid (log2)
        else:
            cbx, cby = min(xcb, ppx - 1), min(ycb, ppy - 1)
            bppx, bppy = ppx - 1, ppy - 1
        precincts = []
        for pj in range(nph):
            for pi in range(npw):
                pbands = []
                for band in bands:
                    # precinct (pi, pj) region mapped onto this band's grid
                    px0 = ((trx0 >> ppx) + pi) << ppx
                    py0 = ((try0 >> ppy) + pj) << ppy
                    if r == 0:
                        bx0, by0 = px0, py0
                    else:
                        bx0, by0 = px0 >> 1, py0 >> 1
                    bx1, by1 = bx0 + (1 << bppx), by0 + (1 << bppy)
                    x0 = max(band.x0, bx0)
                    y0 = max(band.y0, by0)
                    x1 = min(band.x1, bx1)
                    y1 = min(band.y1, by1)
                    cbs: List[_CodeBlock] = []
                    if x1 > x0 and y1 > y0:
                        gx0, gy0 = x0 >> cbx, y0 >> cby
                        gx1 = _ceil_div(x1, 1 << cbx)
                        gy1 = _ceil_div(y1, 1 << cby)
                        for gy in range(gy0, gy1):
                            for gx in range(gx0, gx1):
                                cbs.append(
                                    _CodeBlock(
                                        max(x0, gx << cbx), max(y0, gy << cby),
                                        min(x1, (gx + 1) << cbx), min(y1, (gy + 1) << cby),
                                        gx - gx0, gy - gy0,
                                    )
                                )
                        gw, gh = gx1 - gx0, gy1 - gy0
                    else:
                        gw = gh = 0
                    pbands.append(_PrecinctBand(cbs, gw, gh))
                precincts.append(pbands)
        resolutions.append(_Resolution(r, bands, ppx, ppy, npw, nph, precincts))
    return resolutions


def _read_npasses(rd: _HeaderReader) -> int:
    """Number-of-coding-passes code (Table B.4)."""
    if not rd.bit():
        return 1
    if not rd.bit():
        return 2
    v = rd.bits(2)
    if v < 3:
        return 3 + v
    v = rd.bits(5)
    if v < 31:
        return 6 + v
    return 37 + rd.bits(7)


def _write_npasses(wr: _HeaderWriter, n: int):
    if n == 1:
        wr.bit(0)
    elif n == 2:
        wr.bits(0b10, 2)
    elif n <= 5:
        wr.bits(0b11, 2)
        wr.bits(n - 3, 2)
    elif n <= 36:
        wr.bits(0b1111, 4)
        wr.bits(n - 6, 5)
    elif n <= 164:
        wr.bits(0b111111111, 9)
        wr.bits(n - 37, 7)
    else:
        raise Jpeg2000Error(f"cannot signal {n} coding passes")


def _decode_packet(
    data: bytes, pos: int, res: _Resolution, pidx: int, layer: int,
    use_sop: bool, use_eph: bool, mbs: List[int],
) -> int:
    """Parse one packet (header + body) at `pos`; returns the new offset.

    `mbs[b]` is Mb (magnitude bitplanes incl. guard) for band index b."""
    if use_sop and data[pos : pos + 2] == b"\xff\x91":
        if pos + 6 > len(data):
            raise Jpeg2000Error("truncated SOP marker")
        pos += 6
    rd = _HeaderReader(data, pos)
    contributions = []
    if rd.bit():  # packet non-empty
        for bi, pband in enumerate(res.precincts[pidx]):
            for cb in pband.cblocks:
                if not cb.included:
                    inc = pband.incl.decode(rd, cb.px, cb.py, layer + 1)
                else:
                    inc = bool(rd.bit())
                if not inc:
                    continue
                if not cb.included:
                    cb.zbp = pband.zbp.decode_value(rd, cb.px, cb.py)
                    cb.nbps = mbs[bi] - cb.zbp
                    if cb.nbps < 0:
                        raise Jpeg2000Error("zero-bitplanes exceed band bitplanes")
                    cb.included = True
                np_ = _read_npasses(rd)
                while rd.bit():
                    cb.lblock += 1
                nbits = cb.lblock + (np_.bit_length() - 1)
                if nbits > 32:
                    raise Jpeg2000Error("implausible code-block segment length")
                seglen = rd.bits(nbits)
                contributions.append((cb, np_, seglen))
    pos = rd.align()
    if use_eph:
        if data[pos : pos + 2] != b"\xff\x92":
            raise Jpeg2000Error("missing EPH marker after packet header")
        pos += 2
    for cb, np_, seglen in contributions:
        if pos + seglen > len(data):
            raise Jpeg2000Error("packet body overruns the codestream")
        cb.data += data[pos : pos + seglen]
        cb.npasses += np_
        pos += seglen
    return pos


def _encode_packet(
    res: _Resolution, pidx: int, layer: int, mbs: List[int]
) -> bytes:
    """Emit one packet for the single-layer encoder (everything in layer 0)."""
    wr = _HeaderWriter()
    body = bytearray()
    any_included = any(
        cb.npasses > 0 for pband in res.precincts[pidx] for cb in pband.cblocks
    )
    if not any_included:
        wr.bit(0)
        return wr.flush()
    wr.bit(1)
    for bi, pband in enumerate(res.precincts[pidx]):
        for cb in pband.cblocks:
            pband.incl.set_value(cb.px, cb.py, 0 if cb.npasses else 1)
            pband.zbp.set_value(cb.px, cb.py, max(cb.zbp, 0))
        pband.incl.finalize()
        pband.zbp.finalize()
        for cb in pband.cblocks:
            pband.incl.encode(wr, cb.px, cb.py, layer + 1)
            if not cb.npasses:
                continue
            pband.zbp.encode(wr, cb.px, cb.py, 999)
            _write_npasses(wr, cb.npasses)
            seglen = len(cb.data)
            nbits_needed = max(seglen.bit_length(), 1)
            passbits = cb.npasses.bit_length() - 1
            extra = max(0, nbits_needed - passbits - cb.lblock)
            for _ in range(extra):
                wr.bit(1)
            cb.lblock += extra
            wr.bit(0)
            wr.bits(seglen, cb.lblock + passbits)
            body += cb.data
    return wr.flush() + bytes(body)


# --------------------------------------------------------------------------
# Codestream level (Annex A markers + Annex B packet sequencing).
# --------------------------------------------------------------------------

_SOC = 0xFF4F
_SIZ = 0xFF51
_COD = 0xFF52
_COC = 0xFF53
_QCD = 0xFF5C
_QCC = 0xFF5D
_RGN = 0xFF5E
_POC = 0xFF5F
_SOT = 0xFF90
_SOD = 0xFF93
_EOC = 0xFFD9
_PPM, _PPT = 0xFF60, 0xFF61  # packed packet headers: relocate the headers
# informational segments we skip (lengths/comments only — PPM/PPT are NOT
# skippable, they move the packet headers out of the tile body)
_SKIPPABLE = {0xFF55, 0xFF57, 0xFF58, 0xFF63, 0xFF64, 0xFF74,
              0xFF75, 0xFF77, 0xFF78, 0xFF50}  # TLM PLM PLT COM CRG PLT... CAP


def _u16(d: bytes, p: int) -> int:
    if p + 2 > len(d):
        raise Jpeg2000Error("truncated codestream")
    return (d[p] << 8) | d[p + 1]


def _u32(d: bytes, p: int) -> int:
    if p + 4 > len(d):
        raise Jpeg2000Error("truncated codestream")
    return int.from_bytes(d[p : p + 4], "big")


class _CodingParams:
    """COD/QCD (optionally overridden by COC/QCC for component 0)."""

    def __init__(self):
        self.progression = 0
        self.layers = 1
        self.mct = 0
        self.levels = 5
        self.xcb = 6
        self.ycb = 6
        self.cb_style = 0
        self.transform = 1
        self.prec_sizes: Optional[List[Tuple[int, int]]] = None
        self.use_sop = False
        self.use_eph = False
        self.guard_bits = 2
        self.quant_style = 0
        self.precision = 16
        self.exponents: List[int] = []
        self.mantissas: List[int] = []

    def parse_cod(self, d: bytes, p: int, ln: int):
        scod = d[p]
        self.use_sop = bool(scod & 2)
        self.use_eph = bool(scod & 4)
        self.progression = d[p + 1]
        self.layers = _u16(d, p + 2)
        self.mct = d[p + 4]
        self.parse_spcod(d, p + 5, bool(scod & 1), ln - 5)

    def parse_spcod(self, d: bytes, p: int, has_prec: bool, ln: int):
        self.levels = d[p]
        if self.levels > 32:
            raise Jpeg2000Error(f"invalid decomposition levels {self.levels}")
        self.xcb = (d[p + 1] & 0x0F) + 2
        self.ycb = (d[p + 2] & 0x0F) + 2
        if self.xcb + self.ycb > 12:
            raise Jpeg2000Error("code-block area exceeds 4096 samples")
        self.cb_style = d[p + 3]
        self.transform = d[p + 4]
        if has_prec:
            sizes = []
            q = p + 5
            for _ in range(self.levels + 1):
                if q >= p + ln:
                    raise Jpeg2000Error("truncated precinct size list")
                sizes.append((d[q] & 0x0F, d[q] >> 4))
                q += 1
            self.prec_sizes = sizes
        else:
            self.prec_sizes = None

    def parse_qcd(self, d: bytes, p: int, ln: int):
        sqcd = d[p]
        style = sqcd & 0x1F
        self.guard_bits = sqcd >> 5
        self.quant_style = style
        if style == 0:  # no quantization (reversible): one byte per subband
            self.exponents = [d[p + 1 + i] >> 3 for i in range(ln - 1)]
            self.mantissas = [0] * len(self.exponents)
        elif style in (1, 2):  # scalar quantization: 16-bit (eps, mantissa)
            npairs = (ln - 1) // 2
            if npairs < 1 or (ln - 1) % 2:
                raise Jpeg2000Error("malformed quantization segment")
            self.exponents = []
            self.mantissas = []
            for i in range(npairs):
                v = _u16(d, p + 1 + 2 * i)
                self.exponents.append(v >> 11)
                self.mantissas.append(v & 0x7FF)
        else:
            raise Jpeg2000Error(f"invalid quantization style {style}")

    def validate(self):
        if self.transform == 1 and self.quant_style != 0:
            raise Jpeg2000Error("scalar quantization with the reversible 5/3 transform")
        if self.transform == 0 and self.quant_style == 0:
            raise Jpeg2000Error("9/7 transform requires scalar quantization")
        if self.transform not in (0, 1):
            raise Jpeg2000Error(f"unknown wavelet transform {self.transform}")
        if self.mct:
            raise Jpeg2000Error("multiple-component transform not supported")
        if self.cb_style:
            raise Jpeg2000Error(
                f"unsupported code-block style 0x{self.cb_style:02x} (bypass/"
                "termall/causal/segmentation variants are not emitted by "
                "standard DICOM encoders)"
            )
        if self.progression > 2:
            raise Jpeg2000Error(
                "PCRL/CPRL progression not supported (LRCP/RLCP/RPCL cover "
                "single-component DICOM streams)"
            )

    def band_quant(self, r: int, orient: int) -> Tuple[int, int]:
        """(exponent, mantissa) for the band, honoring derived quantization
        (style 1: one pair for LL, others derived by level, E.1.1)."""
        nl = self.levels
        if self.quant_style == 1:
            if not self.exponents:
                raise Jpeg2000Error("QCD has no subband entries")
            nb = nl if r == 0 else nl - r + 1  # decomposition level of band
            return self.exponents[0] - nl + nb, self.mantissas[0]
        i = 0 if r == 0 else 3 * (r - 1) + orient  # orient 1,2,3 -> HL,LH,HH
        if i >= len(self.exponents):
            raise Jpeg2000Error("QCD has too few subband entries")
        return self.exponents[i], self.mantissas[i]


def _mb_for(cp: _CodingParams, r: int, orient: int) -> int:
    eps, _mu = cp.band_quant(r, orient)
    return cp.guard_bits + eps - 1


def _packet_order(cp: _CodingParams, resolutions: List[_Resolution], nlayers: int):
    """Yield (layer, resolution, precinct) in progression order (B.12)."""
    nres = len(resolutions)
    if cp.progression == 0:  # LRCP
        for layer in range(nlayers):
            for r in range(nres):
                for pidx in range(len(resolutions[r].precincts)):
                    yield layer, r, pidx
    elif cp.progression == 1:  # RLCP
        for r in range(nres):
            for layer in range(nlayers):
                for pidx in range(len(resolutions[r].precincts)):
                    yield layer, r, pidx
    else:  # RPCL
        for r in range(nres):
            for pidx in range(len(resolutions[r].precincts)):
                for layer in range(nlayers):
                    yield layer, r, pidx


def decode_jpeg2000(data: bytes, use_native: bool = True) -> Tuple[np.ndarray, int]:
    """Decode a raw JPEG 2000 codestream (or a JP2 file wrapping one).

    Returns (image int32 (rows, cols), precision_bits).  Signed components
    come back sign-extended; unsigned get their DC shift re-applied."""
    if len(data) >= 12 and data[4:8] == b"jP  ":
        data = _extract_jp2_codestream(data)
    if len(data) < 4 or _u16(data, 0) != _SOC:
        raise Jpeg2000Error("not a JPEG 2000 codestream (missing SOC)")
    p = 2
    if _u16(data, p) != _SIZ:
        raise Jpeg2000Error("SIZ must immediately follow SOC")
    lsiz = _u16(data, p + 2)
    if p + 2 + lsiz > len(data) or lsiz < 41:
        raise Jpeg2000Error("truncated SIZ segment")
    xsiz, ysiz = _u32(data, p + 6), _u32(data, p + 10)
    xos, yos = _u32(data, p + 14), _u32(data, p + 18)
    xt, yt = _u32(data, p + 22), _u32(data, p + 26)
    xto, yto = _u32(data, p + 30), _u32(data, p + 34)
    ncomp = _u16(data, p + 38)
    if ncomp != 1:
        raise Jpeg2000Error(f"{ncomp}-component JPEG 2000 not supported (MR is monochrome)")
    ssiz = data[p + 40]
    xr, yr = data[p + 41], data[p + 42]
    if xr != 1 or yr != 1:
        raise Jpeg2000Error("component subsampling not supported")
    signed = bool(ssiz & 0x80)
    prec = (ssiz & 0x7F) + 1
    if prec > 16:
        raise Jpeg2000Error(f"precision {prec} > 16 bits not supported")
    if not (0 < xsiz - xos <= 1 << 20 and 0 < ysiz - yos <= 1 << 20):
        raise Jpeg2000Error("invalid image extent")
    if (xsiz - xos) * (ysiz - yos) > 1 << 26:
        raise Jpeg2000Error("image larger than the 64-Mpixel decode cap")
    if xt == 0 or yt == 0 or xto > xos or yto > yos or xto + xt <= xos or yto + yt <= yos:
        raise Jpeg2000Error("invalid tile grid")
    p += 2 + lsiz

    cp = _CodingParams()
    seen_cod = seen_qcd = False
    while True:
        m = _u16(data, p)
        if m == _SOT:
            break
        if m == _EOC:
            raise Jpeg2000Error("no tile data before EOC")
        ln = _u16(data, p + 2)
        if ln < 2 or p + 2 + ln > len(data):
            raise Jpeg2000Error(f"truncated marker segment 0x{m:04x}")
        body = p + 4
        if m == _COD:
            cp.parse_cod(data, body, ln - 2)
            seen_cod = True
        elif m == _QCD:
            cp.parse_qcd(data, body, ln - 2)
            seen_qcd = True
        elif m == _COC:
            # single component: Scoc at body+1 (comp index is 1 byte for <257)
            cp.parse_spcod(data, body + 2, bool(data[body + 1] & 1), ln - 4)
        elif m == _QCC:
            cp.parse_qcd(data, body + 1, ln - 3)
        elif m in (_RGN, _POC, _PPM, _PPT):
            raise Jpeg2000Error(f"unsupported marker 0x{m:04x} (RGN/POC/PPM/PPT)")
        elif m in _SKIPPABLE:
            pass
        else:
            raise Jpeg2000Error(f"unknown marker 0x{m:04x} in main header")
        p += 2 + ln
    if not seen_cod or not seen_qcd:
        raise Jpeg2000Error("main header missing COD or QCD")
    cp.validate()

    ntx = _ceil_div(xsiz - xto, xt)
    nty = _ceil_div(ysiz - yto, yt)
    ntiles = ntx * nty
    if ntiles > 4096:
        raise Jpeg2000Error("implausible tile count")

    # gather tile-part byte ranges in order, per tile
    tile_parts: List[List[bytes]] = [[] for _ in range(ntiles)]
    while True:
        m = _u16(data, p)
        if m == _EOC:
            break
        if m != _SOT:
            raise Jpeg2000Error(f"expected SOT/EOC, found 0x{m:04x}")
        lsot = _u16(data, p + 2)
        if lsot != 10:
            raise Jpeg2000Error("malformed SOT")
        isot = _u16(data, p + 4)
        psot = _u32(data, p + 6)
        if isot >= ntiles:
            raise Jpeg2000Error(f"tile index {isot} out of range")
        q = p + 12
        while _u16(data, q) != _SOD:
            mm = _u16(data, q)
            lln = _u16(data, q + 2)
            if mm in (_COD, _COC, _QCD, _QCC, _POC, _PPT):
                raise Jpeg2000Error("per-tile coding overrides / packed packet "
                                    "headers not supported")
            if mm not in _SKIPPABLE or lln < 2 or q + 2 + lln > len(data):
                raise Jpeg2000Error(f"unexpected marker 0x{mm:04x} in tile header")
            q += 2 + lln
        start = q + 2
        end = p + psot if psot else len(data) - 2
        if end < start or end > len(data):
            raise Jpeg2000Error("tile-part length overruns the codestream")
        tile_parts[isot].append(data[start:end])
        p = end

    cp.precision = prec
    irreversible = cp.transform == 0
    img = np.zeros(
        (ysiz - yos, xsiz - xos), dtype=np.float64 if irreversible else np.int64
    )
    for tj in range(nty):
        for ti in range(ntx):
            tidx = tj * ntx + ti
            tx0 = max(xto + ti * xt, xos)
            ty0 = max(yto + tj * yt, yos)
            tx1 = min(xto + (ti + 1) * xt, xsiz)
            ty1 = min(yto + (tj + 1) * yt, ysiz)
            if tx1 <= tx0 or ty1 <= ty0:
                continue
            tile = _decode_tile(
                b"".join(tile_parts[tidx]), cp, tx0, ty0, tx1, ty1, use_native
            )
            img[ty0 - yos : ty1 - yos, tx0 - xos : tx1 - xos] = tile
    if not signed:
        img += 1 << (prec - 1)
    if irreversible:
        # lossy samples: round and clamp into the declared range
        lo, hi = (-(1 << prec - 1), (1 << prec - 1) - 1) if signed else (0, (1 << prec) - 1)
        img = np.clip(np.rint(img), lo, hi)
    elif not signed and ((img < 0).any() or (img >= 1 << prec).any()):
        raise Jpeg2000Error("decoded samples out of range (corrupt stream)")
    out = img.astype(np.int32)
    return out, prec


def _decode_tile(
    body: bytes, cp: _CodingParams, tx0: int, ty0: int, tx1: int, ty1: int,
    use_native: bool = True,
) -> np.ndarray:
    resolutions = _build_resolutions(
        tx0, ty0, tx1, ty1, cp.levels, cp.xcb, cp.ycb, cp.prec_sizes
    )
    pos = 0
    for layer, r, pidx in _packet_order(cp, resolutions, cp.layers):
        res = resolutions[r]
        mbs = [_mb_for(cp, r, b.orient) for b in res.bands]
        if pos >= len(body):
            raise Jpeg2000Error("tile data ends before all packets were read")
        pos = _decode_packet(body, pos, res, pidx, layer, cp.use_sop, cp.use_eph, mbs)

    # Tier-1 decode each code-block and scatter into the quadrant layout.
    th, tw = ty1 - ty0, tx1 - tx0
    irreversible = cp.transform == 0
    quad = np.zeros((th, tw), dtype=np.float64 if irreversible else np.int64)
    for res in resolutions:
        for pbands in res.precincts:
            for bi, pband in enumerate(pbands):
                band = res.bands[bi]
                for cb in pband.cblocks:
                    if not cb.included or cb.npasses == 0:
                        continue
                    coeffs = t1_decode(
                        bytes(cb.data), cb.x1 - cb.x0, cb.y1 - cb.y0,
                        band.orient, cb.nbps, cb.npasses, use_native,
                    )
                    if irreversible:
                        # dequantize (E.1): step 2^(R_b - eps)(1 + mu/2^11)
                        # with midpoint reconstruction half an ulp of the
                        # lowest decoded bitplane
                        eps, mu = cp.band_quant(res.r, band.orient)
                        rb = cp.precision + band.gain
                        delta = float(2.0 ** (rb - eps)) * (1.0 + mu / 2048.0)
                        p_low = cb.nbps - 1 - (cb.npasses + 1) // 3
                        half = 0.5 * (2.0 ** max(p_low, 0))
                        coeffs = np.where(
                            coeffs > 0, (coeffs + half) * delta,
                            np.where(coeffs < 0, (coeffs - half) * delta, 0.0),
                        )
                    _scatter_band(
                        quad, coeffs, band, cb, res.r, cp.levels, tx0, ty0, tx1, ty1
                    )
    if irreversible:
        return _idwt97(quad, tx0, ty0, cp.levels)
    return _idwt53(quad, tx0, ty0, cp.levels)


def _band_quadrant_origin(
    band: _Band, r: int, nl: int, tx0: int, ty0: int, tx1: int, ty1: int
) -> Tuple[int, int]:
    """Top-left of this band inside the tile's quadrant-layout array."""
    if band.orient == 0:
        return 0, 0
    k = nl - r + 1  # HL/LH/HH of resolution r sit beside LL of level nl-r+1
    llx0 = _ceil_div(tx0, 1 << k)
    lly0 = _ceil_div(ty0, 1 << k)
    llx1 = _ceil_div(tx1, 1 << k)
    lly1 = _ceil_div(ty1, 1 << k)
    lw, lh = llx1 - llx0, lly1 - lly0  # LL quadrant dims one level deeper
    ox = lw if band.orient in (1, 3) else 0
    oy = lh if band.orient in (2, 3) else 0
    return ox, oy


def _scatter_band(quad, coeffs, band, cb, r, nl, tx0, ty0, tx1, ty1):
    ox, oy = _band_quadrant_origin(band, r, nl, tx0, ty0, tx1, ty1)
    y = oy + (cb.y0 - band.y0)
    x = ox + (cb.x0 - band.x0)
    quad[y : y + coeffs.shape[0], x : x + coeffs.shape[1]] = coeffs


def _gather_band(quad, band, cb, r, nl, tx0, ty0, tx1, ty1) -> np.ndarray:
    ox, oy = _band_quadrant_origin(band, r, nl, tx0, ty0, tx1, ty1)
    y = oy + (cb.y0 - band.y0)
    x = ox + (cb.x0 - band.x0)
    return quad[y : y + (cb.y1 - cb.y0), x : x + (cb.x1 - cb.x0)]


def codestream_is_reversible(data: bytes) -> bool:
    """True iff the main-header COD declares the reversible 5/3 transform.

    Used by the DICOM layer to refuse lossy codestreams mislabeled under
    the lossless-only .90 transfer syntax (walks markers only; any
    malformation is deferred to the full decoder)."""
    if len(data) >= 12 and data[4:8] == b"jP  ":
        data = _extract_jp2_codestream(data)
    if len(data) < 4 or _u16(data, 0) != _SOC:
        raise Jpeg2000Error("not a JPEG 2000 codestream (missing SOC)")
    p = 2 + 2 + _u16(data, 4)  # skip SIZ
    while p + 4 <= len(data):
        m = _u16(data, p)
        if m in (_SOT, _EOC):
            break
        ln = _u16(data, p + 2)
        if ln < 2 or p + 2 + ln > len(data):
            raise Jpeg2000Error("truncated marker segment")
        if m == _COD:
            spcod_transform = p + 4 + 5 + 4
            if spcod_transform >= p + 2 + ln:
                raise Jpeg2000Error("truncated COD segment")
            return data[spcod_transform] == 1
        p += 2 + ln
    raise Jpeg2000Error("main header missing COD")


def _extract_jp2_codestream(data: bytes) -> bytes:
    """Pull the contiguous codestream box out of a JP2 container."""
    p = 0
    while p + 8 <= len(data):
        ln = _u32(data, p)
        box = data[p + 4 : p + 8]
        if ln == 1:
            if p + 16 > len(data):
                break
            ln = int.from_bytes(data[p + 8 : p + 16], "big")
            hdr = 16
        else:
            hdr = 8
        if ln == 0:
            ln = len(data) - p
        if ln < hdr or p + ln > len(data):
            raise Jpeg2000Error("malformed JP2 box structure")
        if box == b"jp2c":
            return data[p + hdr : p + ln]
        p += ln
    raise Jpeg2000Error("JP2 container has no codestream box")


# --------------------------------------------------------------------------
# Encoder: single tile, reversible 5/3, one quality layer, LRCP, 64x64
# code-blocks, no precinct partition — the plain lossless profile every
# JPEG 2000 DICOM reader accepts.
# --------------------------------------------------------------------------


def _encode_tile(
    arr: np.ndarray, cp: _CodingParams, tx0: int, ty0: int, tx1: int, ty1: int,
    use_native: bool = True,
) -> bytes:
    """Tier-1 + Tier-2 encode one tile; returns its packet bytes."""
    quad = _fdwt53(arr, tx0, ty0, cp.levels)
    resolutions = _build_resolutions(
        tx0, ty0, tx1, ty1, cp.levels, cp.xcb, cp.ycb, None
    )
    for res in resolutions:
        for pbands in res.precincts:
            for bi, pband in enumerate(pbands):
                band = res.bands[bi]
                mb = _mb_for(cp, res.r, band.orient)
                for cb in pband.cblocks:
                    coeffs = _gather_band(
                        quad, band, cb, res.r, cp.levels, tx0, ty0, tx1, ty1
                    )
                    data, zbp, np_ = t1_encode(
                        coeffs.astype(np.int64), band.orient, mb, use_native
                    )
                    cb.data = bytearray(data)
                    cb.zbp = zbp
                    cb.npasses = np_
    packets = bytearray()
    for layer, r, pidx in _packet_order(cp, resolutions, 1):
        mbs = [_mb_for(cp, r, b.orient) for b in resolutions[r].bands]
        packets += _encode_packet(resolutions[r], pidx, layer, mbs)
    return bytes(packets)


def encode_jpeg2000(
    img: np.ndarray,
    precision: int,
    signed: bool = False,
    levels: Optional[int] = None,
    tile_size: Optional[Tuple[int, int]] = None,
    use_native: bool = True,
) -> bytes:
    """Encode a 2D integer image as a raw lossless JPEG 2000 codestream.

    `tile_size=(tw, th)` splits the image into an independently-coded tile
    grid (defaults to one tile covering the image)."""
    if img.ndim != 2 or img.size == 0:
        raise Jpeg2000Error("image must be a non-empty 2D array")
    if not 1 <= precision <= 16:
        raise Jpeg2000Error(f"precision {precision} out of range [1, 16]")
    h, w = img.shape
    lo, hi = (-(1 << precision - 1), (1 << precision - 1) - 1) if signed else (0, (1 << precision) - 1)
    arr = np.asarray(img, dtype=np.int64)
    if arr.min() < lo or arr.max() > hi:
        raise Jpeg2000Error(f"samples outside the {precision}-bit range")
    xt, yt = (w, h) if tile_size is None else (int(tile_size[0]), int(tile_size[1]))
    if xt <= 0 or yt <= 0:
        raise Jpeg2000Error("tile size must be positive")
    if levels is None:
        levels = max(0, min(5, min(w, h, xt, yt).bit_length() - 1))
    if not signed:
        arr = arr - (1 << (precision - 1))  # DC level shift

    cp = _CodingParams()
    cp.levels = levels
    cp.xcb = cp.ycb = 6
    guard = 2
    nbands = 3 * levels + 1
    exps = [precision]  # LL gain 0
    for _r in range(1, levels + 1):
        exps += [precision + 1, precision + 1, precision + 2]  # HL, LH, HH
    cp.guard_bits = guard
    cp.exponents = exps[:nbands]
    cp.mantissas = [0] * nbands

    out = bytearray()
    out += (0xFF4F).to_bytes(2, "big")  # SOC
    siz = bytearray()
    siz += (0).to_bytes(2, "big")  # Rsiz
    for v in (w, h, 0, 0, xt, yt, 0, 0):
        siz += v.to_bytes(4, "big")
    siz += (1).to_bytes(2, "big")  # Csiz
    siz += bytes([(precision - 1) | (0x80 if signed else 0), 1, 1])
    out += _SIZ.to_bytes(2, "big") + (len(siz) + 2).to_bytes(2, "big") + siz
    cod = bytes([0, 0]) + (1).to_bytes(2, "big") + bytes(
        [0, levels, cp.xcb - 2, cp.ycb - 2, 0, 1]
    )  # Scod=0, LRCP, 1 layer, no MCT, 5/3
    out += _COD.to_bytes(2, "big") + (len(cod) + 2).to_bytes(2, "big") + cod
    qcd = bytes([guard << 5]) + bytes(e << 3 for e in cp.exponents)
    out += _QCD.to_bytes(2, "big") + (len(qcd) + 2).to_bytes(2, "big") + qcd
    ntx, nty = _ceil_div(w, xt), _ceil_div(h, yt)
    if ntx * nty > 4096:
        raise Jpeg2000Error(f"{ntx * nty} tiles exceed the 4096-tile limit")
    for tj in range(nty):
        for ti in range(ntx):
            tx0, ty0 = ti * xt, tj * yt
            tx1, ty1 = min(tx0 + xt, w), min(ty0 + yt, h)
            packets = _encode_tile(
                arr[ty0:ty1, tx0:tx1], cp, tx0, ty0, tx1, ty1, use_native
            )
            psot = 12 + 2 + len(packets)
            out += _SOT.to_bytes(2, "big") + (10).to_bytes(2, "big")
            out += (tj * ntx + ti).to_bytes(2, "big") + psot.to_bytes(4, "big")
            out += bytes([0, 1])
            out += _SOD.to_bytes(2, "big") + packets
    out += _EOC.to_bytes(2, "big")
    return bytes(out)

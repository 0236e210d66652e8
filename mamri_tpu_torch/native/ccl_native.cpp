// Native host-side runtime for mamri_tpu: fast binary STL ingest,
// union-find connected-component labeling, and the DICOM RLE (PackBits)
// codec, plus JPEG Lossless (T.81 process 14) and JPEG-LS (T.87)
// decoders.
//
// Role: the reference delegates its host-side heavy lifting to native C++
// libraries (SimpleITK/VTK and Slicer's DICOM stack). mamri_tpu's device
// path is JAX/Pallas; this library is the native equivalent of the
// host-side pieces — the mesh data-loader feeding collision geometry, an
// independent, allocation-tight CCL used as a CPU golden/fast path
// (scipy-free deployments), and the byte-level RLE codec on the scanner
// ingest path (a pure-Python PackBits loop costs ~100 ms/slice at 256^2).
//
// Exposed via a C ABI for ctypes (no pybind11 in the image).
//
// Build: g++ -O3 -march=native -shared -fPIC ccl_native.cpp -o libmamri_native.so

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- STL ingest
// Parses a binary STL file. Returns the number of triangles and fills
// *out_vertices with a malloc'd [n_tri * 9] float array (v0 v1 v2 per tri).
// Returns -1 on error. Caller frees with mamri_free.
int mamri_parse_stl(const char* path, float** out_vertices) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  unsigned char header[84];
  if (std::fread(header, 1, 84, f) != 84) {
    std::fclose(f);
    return -1;
  }
  uint32_t n_tri;
  std::memcpy(&n_tri, header + 80, 4);
  // 50 bytes per record: 12 floats (normal + 3 vertices) + 2 attribute bytes
  std::vector<unsigned char> rec(50);
  float* verts = static_cast<float*>(std::malloc(sizeof(float) * 9ull * n_tri));
  if (!verts) {
    std::fclose(f);
    return -1;
  }
  for (uint32_t t = 0; t < n_tri; ++t) {
    if (std::fread(rec.data(), 1, 50, f) != 50) {
      std::free(verts);
      std::fclose(f);
      return -1;
    }
    // skip the 12-byte normal; copy the 36 vertex bytes
    std::memcpy(verts + 9ull * t, rec.data() + 12, 36);
  }
  std::fclose(f);
  *out_vertices = verts;
  return static_cast<int>(n_tri);
}

void mamri_free(void* p) { std::free(p); }

// ------------------------------------------------------- union-find 6-conn CCL
// mask: nx*ny*nz uint8 (C order, x-major: index = (i*ny + j)*nz + k).
// labels_out: same extent int32. Background = 0; components numbered 1..K in
// ITK raster order (first voxel in (z, y, x)-lexicographic order), matching
// the device pipeline's label ordering convention.
// Returns K.
namespace {
struct UnionFind {
  std::vector<int32_t> parent;
  int32_t find(int32_t a) {
    while (parent[a] != a) {
      parent[a] = parent[parent[a]];
      a = parent[a];
    }
    return a;
  }
  void unite(int32_t a, int32_t b) {
    a = find(a);
    b = find(b);
    if (a == b) return;
    if (a < b) parent[b] = a;
    else parent[a] = b;
  }
};
}  // namespace

int mamri_label_components(const uint8_t* mask, int nx, int ny, int nz,
                           int32_t* labels_out) {
  const int64_t n = static_cast<int64_t>(nx) * ny * nz;
  // provisional labels = linear index where mask, else -1
  UnionFind uf;
  uf.parent.resize(n);
  for (int64_t i = 0; i < n; ++i) uf.parent[i] = static_cast<int32_t>(i);

  auto at = [&](int i, int j, int k) -> int64_t {
    return (static_cast<int64_t>(i) * ny + j) * nz + k;
  };

  for (int i = 0; i < nx; ++i) {
    for (int j = 0; j < ny; ++j) {
      for (int k = 0; k < nz; ++k) {
        const int64_t idx = at(i, j, k);
        if (!mask[idx]) continue;
        if (i > 0 && mask[at(i - 1, j, k)]) uf.unite(idx, at(i - 1, j, k));
        if (j > 0 && mask[at(i, j - 1, k)]) uf.unite(idx, at(i, j - 1, k));
        if (k > 0 && mask[at(i, j, k - 1)]) uf.unite(idx, at(i, j, k - 1));
      }
    }
  }

  // resolve roots; find each component's first voxel in (z, y, x) raster order
  std::vector<int32_t> order_label(n, 0);
  int32_t next = 0;
  for (int k = 0; k < nz; ++k) {
    for (int j = 0; j < ny; ++j) {
      for (int i = 0; i < nx; ++i) {
        const int64_t idx = at(i, j, k);
        if (!mask[idx]) continue;
        const int32_t root = uf.find(static_cast<int32_t>(idx));
        if (order_label[root] == 0) order_label[root] = ++next;
      }
    }
  }
  for (int64_t idx = 0; idx < n; ++idx) {
    labels_out[idx] = mask[idx] ? order_label[uf.find(static_cast<int32_t>(idx))] : 0;
  }
  return next;
}

// ----------------------------------------------------- DICOM RLE (PackBits)
// Semantics identical to perception.dicom's Python codec (PS3.5 annex G /
// TIFF PackBits): control byte c in [0,127] copies c+1 literal bytes,
// c in [129,255] repeats the next byte 257-c times, 128 is a noop.

// Decode up to `expected` output bytes. Returns bytes written, or -1 when
// the input truncates mid-element.
int64_t mamri_packbits_decode(const uint8_t* in, int64_t n, uint8_t* out,
                              int64_t expected) {
  int64_t i = 0, o = 0;
  while (i < n && o < expected) {
    const uint8_t c = in[i++];
    if (c < 128) {
      const int64_t cnt = static_cast<int64_t>(c) + 1;
      if (i + cnt > n) return -1;
      const int64_t take = cnt < expected - o ? cnt : expected - o;
      std::memcpy(out + o, in + i, static_cast<size_t>(take));
      o += take;
      i += cnt;
    } else if (c > 128) {
      if (i >= n) return -1;
      const int64_t cnt = 257 - static_cast<int64_t>(c);
      const int64_t take = cnt < expected - o ? cnt : expected - o;
      std::memset(out + o, in[i], static_cast<size_t>(take));
      o += take;
      i += 1;
    }
  }
  return o;
}

// Encode with the same greedy (runs >= 2 become replicates; literals break
// at the next >= 3 run) as the Python encoder — byte-identical output.
// `out` must hold >= n + n/128 + 2 bytes. Returns the encoded length.
int64_t mamri_packbits_encode(const uint8_t* in, int64_t n, uint8_t* out) {
  int64_t i = 0, o = 0;
  while (i < n) {
    int64_t j = i;
    while (j + 1 < n && in[j + 1] == in[i] && j - i < 127) ++j;
    const int64_t run = j - i + 1;
    if (run >= 2) {
      out[o++] = static_cast<uint8_t>(257 - run);
      out[o++] = in[i];
      i = j + 1;
    } else {
      int64_t k = i;
      while (k < n && k - i < 128) {
        if (k + 2 < n && in[k + 1] == in[k] && in[k + 2] == in[k]) break;
        ++k;
      }
      out[o++] = static_cast<uint8_t>(k - i - 1);
      std::memcpy(out + o, in + i, static_cast<size_t>(k - i));
      o += k - i;
      i = k;
    }
  }
  return o;
}

// ------------------------------------------------------- JPEG Lossless (SOF3)
// Single-component ITU T.81 process-14 decoder — the hot path behind
// perception/jpegll.py (whose pure-Python decoder is the oracle; both must
// produce identical samples). Predictors 1-7, point transform, restart
// markers, 2-16 bit precision.
int64_t mamri_jpegll_decode(const uint8_t* data, int64_t len, uint16_t* out,
                            int64_t cap, int32_t* rows_out, int32_t* cols_out,
                            int32_t* prec_out) {
  if (len < 4 || data[0] != 0xFF || data[1] != 0xD8) return -1;
  int64_t pos = 2;
  uint8_t* sym_tab[4] = {nullptr, nullptr, nullptr, nullptr};
  uint8_t* len_tab[4] = {nullptr, nullptr, nullptr, nullptr};
  int rows = 0, cols = 0, prec = 0, pred_sel = 0, pt = 0, table = -1;
  int restart = 0;
  bool have_frame = false;
  int64_t scan_off = -1;
  auto cleanup = [&]() {
    for (int i = 0; i < 4; ++i) {
      std::free(sym_tab[i]);
      std::free(len_tab[i]);
    }
  };
  while (pos + 4 <= len) {
    if (data[pos] != 0xFF) { cleanup(); return -1; }
    int marker = 0xFF00 | data[pos + 1];
    int seglen = (data[pos + 2] << 8) | data[pos + 3];
    const uint8_t* body = data + pos + 4;
    int64_t blen = seglen - 2;
    if (pos + 2 + seglen > len) { cleanup(); return -1; }
    pos += 2 + seglen;
    if (marker == 0xFFC3) {  // SOF3
      if (blen < 9) { cleanup(); return -1; }
      prec = body[0];
      rows = (body[1] << 8) | body[2];
      cols = (body[3] << 8) | body[4];
      if (body[5] != 1 || rows == 0 || cols == 0 || body[7] != 0x11 ||
          prec < 2 || prec > 16) { cleanup(); return -1; }
      have_frame = true;
    } else if (marker >= 0xFFC0 && marker < 0xFFD0 && marker != 0xFFC4 &&
               marker != 0xFFC8 && marker != 0xFFCC) {
      cleanup(); return -1;  // a SOF that is not lossless process 14
    } else if (marker == 0xFFC4) {  // DHT
      int64_t off = 0;
      while (off + 17 <= blen) {
        int th = body[off] & 0x0F;
        if (th > 3) { cleanup(); return -1; }
        int nsym = 0;
        for (int i = 0; i < 16; ++i) nsym += body[off + 1 + i];
        if (off + 17 + nsym > blen) { cleanup(); return -1; }
        if (!sym_tab[th]) {
          sym_tab[th] = static_cast<uint8_t*>(std::malloc(1 << 16));
          len_tab[th] = static_cast<uint8_t*>(std::malloc(1 << 16));
          if (!sym_tab[th] || !len_tab[th]) { cleanup(); return -1; }
        }
        std::memset(len_tab[th], 0, 1 << 16);
        int code = 0, k = 0;
        for (int ln = 1; ln <= 16; ++ln) {
          for (int c = 0; c < body[off + ln]; ++c) {
            int sym = body[off + 17 + k++];
            // lossless SSSS categories are 0..16; larger symbols would drive
            // negative shift counts (UB) in the entropy loop
            if (sym > 16) { cleanup(); return -1; }
            int lo = code << (16 - ln);
            int hi = lo + (1 << (16 - ln));
            if (hi > (1 << 16)) { cleanup(); return -1; }
            for (int v = lo; v < hi; ++v) {
              sym_tab[th][v] = static_cast<uint8_t>(sym);
              len_tab[th][v] = static_cast<uint8_t>(ln);
            }
            ++code;
          }
          code <<= 1;
        }
        off += 17 + nsym;
      }
    } else if (marker == 0xFFDD) {  // DRI
      if (blen < 2) { cleanup(); return -1; }
      restart = (body[0] << 8) | body[1];
    } else if (marker == 0xFFDA) {  // SOS
      if (blen < 6 || body[0] != 1 || !have_frame) { cleanup(); return -1; }
      table = body[2] >> 4;
      pred_sel = body[3];
      pt = body[5] & 0x0F;
      if (pred_sel < 1 || pred_sel > 7 || table > 3 || !sym_tab[table] ||
          pt >= prec) {  // def = 1 << (prec-pt-1) must not shift negatively
        cleanup(); return -1;
      }
      scan_off = pos;
      break;
    }
  }
  if (scan_off < 0 || static_cast<int64_t>(rows) * cols > cap) {
    cleanup();
    return scan_off < 0 ? -1 : -2;
  }
  const uint8_t* sym = sym_tab[table];
  const uint8_t* lng = len_tab[table];
  const int64_t total = static_cast<int64_t>(rows) * cols;

  // split the entropy-coded data at RST markers, unstuffing FF 00 -> FF
  std::vector<std::vector<uint8_t>> segs;
  segs.emplace_back();
  segs.back().reserve(static_cast<size_t>(len - scan_off));
  for (int64_t p = scan_off; p < len;) {
    uint8_t b = data[p];
    if (b != 0xFF) { segs.back().push_back(b); ++p; continue; }
    if (p + 1 >= len) break;
    uint8_t m = data[p + 1];
    if (m == 0x00) { segs.back().push_back(0xFF); p += 2; }
    else if (m >= 0xD0 && m <= 0xD7) { segs.emplace_back(); p += 2; }
    else if (m == 0xFF) { ++p; }
    else break;  // EOI / other marker ends the scan
  }
  int64_t nseg_expected = restart ? (total + restart - 1) / restart : 1;
  if (static_cast<int64_t>(segs.size()) != nseg_expected ||
      (restart && restart % cols != 0)) {
    cleanup();
    return -3;
  }

  const int32_t def = 1 << (prec - pt - 1);
  int64_t idx = 0;
  int err = 0;
  for (size_t si = 0; si < segs.size() && !err; ++si) {
    const std::vector<uint8_t>& seg = segs[si];
    int64_t count = restart ? std::min<int64_t>(restart, total - idx) : total;
    uint64_t buf = 0;
    int nbuf = 0;
    size_t bp = 0;
    int64_t used = 0;
    int64_t band_start = idx;
    for (int64_t i = 0; i < count; ++i, ++idx) {
      if (nbuf < 32) {
        uint32_t w = 0;
        for (int k = 0; k < 4; ++k)
          w = (w << 8) | (bp < seg.size() ? seg[bp++] : (++bp, 0));
        buf = (buf << 32) | w;
        nbuf += 32;
      }
      uint32_t window = static_cast<uint32_t>(buf >> (nbuf - 16)) & 0xFFFF;
      int s = sym[window];
      int ln = lng[window];
      if (ln == 0) { err = -3; break; }
      int32_t diff;
      if (s == 0) { diff = 0; nbuf -= ln; used += ln; }
      else if (s == 16) { diff = 32768; nbuf -= ln; used += ln; }
      else {
        int32_t v = static_cast<int32_t>(buf >> (nbuf - ln - s)) & ((1 << s) - 1);
        nbuf -= ln + s;
        used += ln + s;
        diff = (v >= (1 << (s - 1))) ? v : v - (1 << s) + 1;
      }
      buf &= (nbuf == 64) ? ~0ull : ((1ull << nbuf) - 1);
      // prediction (T.81 H.1.1): the band after a restart re-enters the
      // top-of-scan state, so boundary rules use band-relative rows
      int64_t brow = (idx - band_start) / cols;
      int64_t j = idx % cols;
      int32_t px;
      if (brow == 0 && j == 0) px = def;
      else if (brow == 0) px = out[idx - 1];
      else if (j == 0) px = out[idx - cols];
      else {
        int32_t a = out[idx - 1], b = out[idx - cols], c = out[idx - cols - 1];
        switch (pred_sel) {
          case 1: px = a; break;
          case 2: px = b; break;
          case 3: px = c; break;
          case 4: px = a + b - c; break;
          case 5: px = a + ((b - c) >> 1); break;
          case 6: px = b + ((a - c) >> 1); break;
          default: px = (a + b) >> 1; break;
        }
      }
      out[idx] = static_cast<uint16_t>((px + diff) & 0xFFFF);
    }
    if (!err && used > static_cast<int64_t>(seg.size()) * 8) err = -3;
  }
  cleanup();
  if (err) return err;
  if (pt)
    for (int64_t i = 0; i < total; ++i) out[i] = static_cast<uint16_t>(out[i] << pt);
  *rows_out = rows;
  *cols_out = cols;
  *prec_out = prec;
  return total;
}


// ----------------------------------------------- JPEG-LS (T.87) decoder
// Lossless (NEAR=0) and near-lossless (NEAR>0) single-component scans,
// default or LSE-preset coding parameters — the native fast path under
// perception/jpegls.py, whose pure-Python codec is the oracle
// (CharLS-faithful arithmetic in both).
// Returns sample count, or -1 malformed/unsupported, -2 cap too small,
// -3 corrupt entropy stream.
static const int JLS_J[32] = {0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,  2,  3,  3,  3,  3,
                              4, 4, 5, 5, 6, 6, 7, 7, 8, 9, 10, 11, 12, 13, 14, 15};

struct JlsBitReader {
  const uint8_t* data;
  int64_t len, pos;
  uint64_t acc;
  int nbits;
  bool prev_ff;
  void fill() {
    if (pos < len) {
      uint8_t b = data[pos];
      if (prev_ff) {
        if (b & 0x80) {  // real marker terminates the scan: zero-pad
          acc <<= 8;
          nbits += 8;
          return;
        }
        ++pos;
        acc = (acc << 7) | b;
        nbits += 7;
        prev_ff = false;
      } else {
        ++pos;
        acc = (acc << 8) | b;
        nbits += 8;
        prev_ff = (b == 0xFF);
      }
    } else {
      acc <<= 8;
      nbits += 8;
    }
  }
  int bits(int n) {
    while (nbits < n) fill();
    nbits -= n;
    int v = static_cast<int>((acc >> nbits) & ((1u << n) - 1));
    acc &= (nbits == 64) ? ~0ull : ((1ull << nbits) - 1);
    return v;
  }
  int unary(int cap, bool* err) {
    int n = 0;
    while (n <= cap) {
      if (bits(1)) return n;
      ++n;
    }
    *err = true;
    return 0;
  }
};

int64_t mamri_jpegls_decode(const uint8_t* data, int64_t len, uint16_t* out,
                            int64_t cap, int32_t* rows_out, int32_t* cols_out,
                            int32_t* prec_out) {
  if (len < 4 || data[0] != 0xFF || data[1] != 0xD8) return -1;
  int64_t pos = 2;
  int rows = 0, cols = 0, prec = 0, near = 0;
  int maxval = -1, t1 = 0, t2 = 0, t3 = 0;
  bool have_frame = false, have_preset = false;
  int64_t scan_off = -1;
  while (pos + 4 <= len) {
    if (data[pos] != 0xFF) return -1;
    int marker = 0xFF00 | data[pos + 1];
    int seglen = (data[pos + 2] << 8) | data[pos + 3];
    const uint8_t* body = data + pos + 4;
    int64_t blen = seglen - 2;
    if (pos + 2 + seglen > len) return -1;
    pos += 2 + seglen;
    if (marker == 0xFFF7) {  // SOF55
      if (blen < 9) return -1;
      prec = body[0];
      rows = (body[1] << 8) | body[2];
      cols = (body[3] << 8) | body[4];
      if (body[5] != 1 || rows == 0 || cols == 0 || prec < 2 || prec > 16) return -1;
      have_frame = true;
    } else if (marker == 0xFFF8) {  // LSE preset parameters
      if (blen < 11 || body[0] != 1) return -1;
      maxval = (body[1] << 8) | body[2];
      t1 = (body[3] << 8) | body[4];
      t2 = (body[5] << 8) | body[6];
      t3 = (body[7] << 8) | body[8];
      int reset = (body[9] << 8) | body[10];
      if (reset != 0 && reset != 64) return -1;
      have_preset = true;
    } else if (marker == 0xFFDD) {  // DRI: restart intervals unsupported
      if (blen < 2 || ((body[0] << 8) | body[1]) != 0) return -1;
    } else if (marker == 0xFFDA) {  // SOS
      if (blen < 6 || body[0] != 1 || !have_frame) return -1;
      near = body[3];
      if (body[4] != 0) return -1;  // ILV
      scan_off = pos;
      break;
    } else if (marker >= 0xFFC0 && marker < 0xFFD0) {
      return -1;  // a non-JPEG-LS SOF / DHT family marker
    }
  }
  if (scan_off < 0) return -1;
  if (static_cast<int64_t>(rows) * cols > cap) return -2;

  if (maxval <= 0) maxval = (1 << prec) - 1;
  if (near < 0 || near > std::min(255, maxval / 2)) return -1;
  const int qden = 2 * near + 1;
  {
    // default thresholds (T.87 C.2.4.1.1.1 incl. NEAR terms); an LSE preset
    // value of 0 means "use the default" PER THRESHOLD (CharLS convention —
    // matching the Python oracle's `pt1 or t1` substitution)
    int dt1, dt2, dt3;
    if (maxval >= 128) {
      int factor = (std::min(maxval, 4095) + 128) / 256;
      dt1 = factor + 2 + 3 * near;
      dt2 = 4 * factor + 3 + 5 * near;
      dt3 = 17 * factor + 4 + 7 * near;
    } else {
      int factor = 256 / (maxval + 1);
      dt1 = std::max(2, 3 / factor + 3 * near);
      dt2 = std::max(3, 7 / factor + 5 * near);
      dt3 = std::max(4, 21 / factor + 7 * near);
    }
    auto clampv = [&](int v, int lo) { return std::min(std::max(v, lo), maxval); };
    if (t1 == 0) t1 = clampv(dt1, std::max(near + 1, 1));
    if (t2 == 0) t2 = clampv(dt2, t1);
    if (t3 == 0) t3 = clampv(dt3, t2);
    (void)have_preset;
  }
  if (t1 > maxval || t2 > maxval || t3 > maxval || t1 < 1 || t2 < t1 || t3 < t2)
    return -1;  // inconsistent LSE preset
  const int rng = (maxval + 2 * near) / qden + 1;
  int qbpp = 1;
  while ((1 << qbpp) < rng) ++qbpp;
  const int bpp = std::max(2, (maxval > 0 ? 32 - __builtin_clz((unsigned)maxval) : 1));
  const int limit = 2 * (bpp + std::max(8, bpp));

  // gradient quantizer LUT over [-maxval, maxval] (A.3.3 with NEAR)
  std::vector<int8_t> qlut(2 * maxval + 1);
  for (int d = -maxval; d <= maxval; ++d) {
    int q;
    if (d <= -t3) q = -4;
    else if (d <= -t2) q = -3;
    else if (d <= -t1) q = -2;
    else if (d < -near) q = -1;
    else if (d <= near) q = 0;
    else if (d < t1) q = 1;
    else if (d < t2) q = 2;
    else if (d < t3) q = 3;
    else q = 4;
    qlut[d + maxval] = static_cast<int8_t>(q);
  }

  int64_t A[367], B[367], Cc[367], N[367], Nn[2] = {0, 0};
  const int64_t a0 = std::max(2, (rng + 32) / 64);
  for (int i = 0; i < 367; ++i) { A[i] = a0; B[i] = 0; Cc[i] = 0; N[i] = 1; }
  int run_index = 0;

  JlsBitReader br{data, len, scan_off, 0, 0, false};
  std::vector<int32_t> prevline(cols, 0);
  bool err = false;
  int c_first = 0;
  const int half = (rng + 1) / 2;

  for (int y = 0; y < rows && !err; ++y) {
    // decode into a scratch int32 row, then narrow
    static thread_local std::vector<int32_t> currow;
    currow.assign(cols, 0);
    int32_t* cur32 = currow.data();
    int i = 0;
    while (i < cols && !err) {
      int ra = i > 0 ? cur32[i - 1] : prevline[0];
      int rb = prevline[i];
      int rc = i > 0 ? prevline[i - 1] : c_first;
      int rd = (i + 1 < cols) ? prevline[i + 1] : prevline[cols - 1];
      int q1 = qlut[rd - rb + maxval];
      int q2 = qlut[rb - rc + maxval];
      int q3 = qlut[rc - ra + maxval];
      if (q1 == 0 && q2 == 0 && q3 == 0) {
        // run mode
        bool ended = false;
        while (true) {
          if (br.bits(1)) {
            int seg = 1 << JLS_J[run_index];
            int fill = std::min(seg, cols - i);
            for (int k2 = 0; k2 < fill; ++k2) cur32[i + k2] = ra;
            i += fill;
            if (fill == seg) {
              if (run_index < 31) ++run_index;
              if (i >= cols) { ended = true; break; }
              continue;
            }
            ended = true;  // partial '1' only at EOL
            break;
          }
          int cnt = JLS_J[run_index] ? br.bits(JLS_J[run_index]) : 0;
          if (cnt > cols - i - 1) { err = true; break; }
          for (int k2 = 0; k2 < cnt; ++k2) cur32[i + k2] = ra;
          i += cnt;
          break;
        }
        if (ended || err) break;
        rb = prevline[i];
        int ritype = (std::abs(ra - rb) <= near) ? 1 : 0;
        int px = ritype ? ra : rb;
        int sign = (!ritype && rb < ra) ? -1 : 1;
        int q = 365 + ritype;
        int64_t temp = A[q] + (ritype ? (N[q] >> 1) : 0);
        int k = 0;
        while (k < 24 && (N[q] << k) < temp) ++k;
        if (k >= 24) { err = true; break; }  // impossible on valid streams
        int rlimit = limit - JLS_J[run_index] - 1;
        int u = br.unary(rlimit, &err);
        if (err) break;
        int emerr;
        if (u < rlimit - qbpp - 1) emerr = (u << k) | (k ? br.bits(k) : 0);
        else if (u == rlimit - qbpp - 1) emerr = br.bits(qbpp) + 1;
        else { err = true; break; }
        int t = emerr + ritype;
        int m = t & 1;
        int evabs = (t + m) / 2;
        bool negflag = ((k != 0 || 2 * Nn[ritype] >= N[q]) ? 1 : 0) == m;
        int errval = negflag ? -evabs : evabs;
        int x = px + sign * errval * qden;
        if (x < -near) x += rng * qden;
        else if (x > maxval + near) x -= rng * qden;
        if (x < -near || x > maxval + near) { err = true; break; }  // corrupt
        cur32[i] = std::min(std::max(x, 0), maxval);
        if (errval < 0) ++Nn[ritype];
        A[q] += (emerr + 1 - ritype) >> 1;
        if (N[q] == 64) { A[q] >>= 1; N[q] >>= 1; Nn[ritype] >>= 1; }
        ++N[q];
        if (run_index > 0) --run_index;
        ++i;
        continue;
      }
      // regular mode
      int q = q1 * 81 + q2 * 9 + q3;
      int sign = 1;
      if (q < 0) { q = -q; sign = -1; }
      int mn = ra < rb ? ra : rb, mx = ra < rb ? rb : ra;
      int px;
      if (rc >= mx) px = mn;
      else if (rc <= mn) px = mx;
      else px = ra + rb - rc;
      px += sign * static_cast<int>(Cc[q]);
      if (px < 0) px = 0;
      else if (px > maxval) px = maxval;
      int k = 0;
      while (k < 24 && (N[q] << k) < A[q]) ++k;
      if (k >= 24) { err = true; break; }  // impossible on valid streams
      bool special = (k == 0 && 2 * B[q] <= -N[q]);
      int u = br.unary(limit, &err);
      if (err) break;
      int merr;
      if (u < limit - qbpp - 1) merr = (u << k) | (k ? br.bits(k) : 0);
      else if (u == limit - qbpp - 1) merr = br.bits(qbpp) + 1;
      else { err = true; break; }
      int errval;
      if (special) errval = (merr & 1) ? (merr - 1) / 2 : -(merr / 2) - 1;
      else errval = (merr & 1) ? -((merr + 1) / 2) : merr / 2;
      int x = px + sign * errval * qden;
      if (x < -near) x += rng * qden;
      else if (x > maxval + near) x -= rng * qden;
      if (x < -near || x > maxval + near) { err = true; break; }  // corrupt
      cur32[i] = std::min(std::max(x, 0), maxval);
      B[q] += static_cast<int64_t>(errval) * qden;
      A[q] += errval < 0 ? -errval : errval;
      if (N[q] == 64) { A[q] >>= 1; B[q] >>= 1; N[q] >>= 1; }
      ++N[q];
      if (B[q] <= -N[q]) {
        if (Cc[q] > -128) --Cc[q];
        B[q] += N[q];
        if (B[q] <= -N[q]) B[q] = -N[q] + 1;
      } else if (B[q] > 0) {
        if (Cc[q] < 127) ++Cc[q];
        B[q] -= N[q];
        if (B[q] > 0) B[q] = 0;
      }
      ++i;
    }
    if (err) break;
    c_first = prevline[0];
    for (int j = 0; j < cols; ++j) {
      prevline[j] = cur32[j];
      out[static_cast<int64_t>(y) * cols + j] = static_cast<uint16_t>(cur32[j]);
    }
  }
  if (err) return -3;
  *rows_out = rows;
  *cols_out = cols;
  *prec_out = prec;
  return static_cast<int64_t>(rows) * cols;
}


// ----------------------------------------------- JPEG-LS (T.87) encoder
// Entropy-codes one lossless (NEAR=0) or near-lossless (NEAR>0)
// single-component scan with DEFAULT coding parameters; the caller
// (perception/jpegls.py) wraps the marker framing. Bit-identical to the
// Python encoder (same arithmetic, same zero-padded flush; near-lossless
// predicts from the encoder-side reconstruction like the oracle does).
// Returns scan byte count, or -1 bad args, -2 cap.
struct JlsBitWriter {
  uint8_t* out;
  int64_t cap, n;
  uint32_t cur;
  int curbits, capbits;
  bool overflow;
  void close_byte() {
    if (n >= cap) { overflow = true; n = 0; }
    out[n++] = static_cast<uint8_t>(cur);
    capbits = (cur == 0xFF) ? 7 : 8;  // stuff a 0 MSB after FF bytes
    cur = 0;
    curbits = 0;
  }
  void put(uint32_t value, int nbits) {
    for (int i = nbits - 1; i >= 0; --i) {
      cur = (cur << 1) | ((value >> i) & 1);
      if (++curbits == capbits) close_byte();
    }
  }
  void zeros(int nz) {
    while (nz > 0) {
      int take = std::min(nz, capbits - curbits);
      cur <<= take;
      curbits += take;
      nz -= take;
      if (curbits == capbits) close_byte();
    }
  }
  void flush() {
    if (curbits) {
      cur <<= capbits - curbits;
      if (n >= cap) { overflow = true; n = 0; }
      out[n++] = static_cast<uint8_t>(cur);
      cur = 0;
      curbits = 0;
    }
  }
};

static inline void jls_golomb_encode(JlsBitWriter& w, int k, int val, int limit,
                                     int qbpp) {
  int high = val >> k;
  if (high < limit - qbpp - 1) {
    w.zeros(high);
    w.put(1, 1);
    if (k) w.put(val & ((1 << k) - 1), k);
  } else {
    w.zeros(limit - qbpp - 1);
    w.put(1, 1);
    w.put(val - 1, qbpp);
  }
}

int64_t mamri_jpegls_encode(const uint16_t* img, int32_t rows, int32_t cols,
                            int32_t prec, int32_t near, uint8_t* out, int64_t cap) {
  if (rows <= 0 || cols <= 0 || prec < 2 || prec > 16) return -1;
  const int maxval = (1 << prec) - 1;
  if (near < 0 || near > std::min(255, maxval / 2)) return -1;
  const int qden = 2 * near + 1;
  int t1, t2, t3;
  if (maxval >= 128) {
    int factor = (std::min(maxval, 4095) + 128) / 256;
    t1 = factor + 2 + 3 * near;
    t2 = 4 * factor + 3 + 5 * near;
    t3 = 17 * factor + 4 + 7 * near;
  } else {
    int factor = 256 / (maxval + 1);
    t1 = std::max(2, 3 / factor + 3 * near);
    t2 = std::max(3, 7 / factor + 5 * near);
    t3 = std::max(4, 21 / factor + 7 * near);
  }
  auto clampv = [&](int v, int lo) { return std::min(std::max(v, lo), maxval); };
  t1 = clampv(t1, std::max(near + 1, 1));
  t2 = clampv(t2, t1);
  t3 = clampv(t3, t2);
  const int rng = (maxval + 2 * near) / qden + 1;
  int qbpp = 1;
  while ((1 << qbpp) < rng) ++qbpp;
  const int bpp = std::max(2, (maxval > 0 ? 32 - __builtin_clz((unsigned)maxval) : 1));
  const int limit = 2 * (bpp + std::max(8, bpp));
  const int half = (rng + 1) / 2;

  std::vector<int8_t> qlut(2 * maxval + 1);
  for (int d = -maxval; d <= maxval; ++d) {
    int q;
    if (d <= -t3) q = -4;
    else if (d <= -t2) q = -3;
    else if (d <= -t1) q = -2;
    else if (d < -near) q = -1;
    else if (d <= near) q = 0;
    else if (d < t1) q = 1;
    else if (d < t2) q = 2;
    else if (d < t3) q = 3;
    else q = 4;
    qlut[d + maxval] = static_cast<int8_t>(q);
  }
  int64_t A[367], B[367], Cc[367], N[367], Nn[2] = {0, 0};
  const int64_t a0 = std::max(2, (rng + 32) / 64);
  for (int i = 0; i < 367; ++i) { A[i] = a0; B[i] = 0; Cc[i] = 0; N[i] = 1; }
  int run_index = 0;
  int c_first = 0;
  JlsBitWriter w{out, cap, 0, 0, 0, 8, false};

  // near-lossless prediction reads RECONSTRUCTED neighbors; for NEAR=0
  // reconstruction == source, so one code path serves both
  std::vector<int32_t> prevrec(cols, 0), currec(cols, 0);

  for (int y = 0; y < rows; ++y) {
    const uint16_t* cur = img + static_cast<int64_t>(y) * cols;
    int i = 0;
    while (i < cols) {
      int ra = i > 0 ? currec[i - 1] : (y > 0 ? prevrec[0] : 0);
      int rb = y > 0 ? prevrec[i] : 0;
      int rc = i > 0 ? (y > 0 ? prevrec[i - 1] : 0) : c_first;
      int rd = y > 0 ? ((i + 1 < cols) ? prevrec[i + 1] : prevrec[cols - 1]) : 0;
      if (static_cast<unsigned>(cur[i]) > static_cast<unsigned>(maxval)) return -1;
      int q1 = qlut[rd - rb + maxval];
      int q2 = qlut[rb - rc + maxval];
      int q3 = qlut[rc - ra + maxval];
      if (q1 == 0 && q2 == 0 && q3 == 0) {
        // run mode: samples within NEAR of RA reconstruct as RA
        int start = i;
        while (i < cols && std::abs(static_cast<int>(cur[i]) - ra) <= near) ++i;
        for (int k2 = start; k2 < i; ++k2) currec[k2] = ra;
        int cnt = i - start;
        while (cnt >= (1 << JLS_J[run_index])) {
          w.put(1, 1);
          cnt -= 1 << JLS_J[run_index];
          if (run_index < 31) ++run_index;
        }
        if (i == cols) {
          if (cnt > 0) w.put(1, 1);
          break;
        }
        w.put(0, 1);
        if (JLS_J[run_index]) w.put(cnt, JLS_J[run_index]);
        int x = cur[i];
        if (x > maxval) return -1;  // the loop-top check covered run entry only
        rb = y > 0 ? prevrec[i] : 0;
        int ritype = (std::abs(ra - rb) <= near) ? 1 : 0;
        int px = ritype ? ra : rb;
        int sign = (!ritype && rb < ra) ? -1 : 1;
        int q = 365 + ritype;
        int64_t temp = A[q] + (ritype ? (N[q] >> 1) : 0);
        int k = 0;
        while ((N[q] << k) < temp) ++k;
        int errval = (x - px) * sign;
        if (near) {
          if (errval > 0) errval = (errval + near) / qden;
          else errval = -((near - errval) / qden);
          int rx = px + sign * errval * qden;
          currec[i] = std::min(std::max(rx, 0), maxval);
        } else {
          currec[i] = x;
        }
        if (errval < 0) errval += rng;
        if (errval >= half) errval -= rng;
        bool m;
        if (errval == 0) m = false;
        else if (k == 0 && errval > 0 && 2 * Nn[ritype] < N[q]) m = true;
        else if (errval < 0 && 2 * Nn[ritype] >= N[q]) m = true;
        else if (errval < 0 && k != 0) m = true;
        else m = false;
        int emerr = 2 * (errval < 0 ? -errval : errval) - ritype - (m ? 1 : 0);
        jls_golomb_encode(w, k, emerr, limit - JLS_J[run_index] - 1, qbpp);
        if (errval < 0) ++Nn[ritype];
        A[q] += (emerr + 1 - ritype) >> 1;
        if (N[q] == 64) { A[q] >>= 1; N[q] >>= 1; Nn[ritype] >>= 1; }
        ++N[q];
        if (run_index > 0) --run_index;
        ++i;
        continue;
      }
      // regular mode
      int q = q1 * 81 + q2 * 9 + q3;
      int sign = 1;
      if (q < 0) { q = -q; sign = -1; }
      int mn = ra < rb ? ra : rb, mx = ra < rb ? rb : ra;
      int px;
      if (rc >= mx) px = mn;
      else if (rc <= mn) px = mx;
      else px = ra + rb - rc;
      px += sign * static_cast<int>(Cc[q]);
      if (px < 0) px = 0;
      else if (px > maxval) px = maxval;
      int k = 0;
      while ((N[q] << k) < A[q]) ++k;
      bool special = (k == 0 && 2 * B[q] <= -N[q]);
      int errval = (cur[i] - px) * sign;
      if (near) {
        if (errval > 0) errval = (errval + near) / qden;
        else errval = -((near - errval) / qden);
        int rx = px + sign * errval * qden;
        currec[i] = std::min(std::max(rx, 0), maxval);
      } else {
        currec[i] = cur[i];
      }
      if (errval < 0) errval += rng;
      if (errval >= half) errval -= rng;
      int merr;
      if (special) merr = errval >= 0 ? 2 * errval + 1 : -2 * (errval + 1);
      else merr = errval >= 0 ? 2 * errval : -2 * errval - 1;
      jls_golomb_encode(w, k, merr, limit, qbpp);
      B[q] += static_cast<int64_t>(errval) * qden;
      A[q] += errval < 0 ? -errval : errval;
      if (N[q] == 64) { A[q] >>= 1; B[q] >>= 1; N[q] >>= 1; }
      ++N[q];
      if (B[q] <= -N[q]) {
        if (Cc[q] > -128) --Cc[q];
        B[q] += N[q];
        if (B[q] <= -N[q]) B[q] = -N[q] + 1;
      } else if (B[q] > 0) {
        if (Cc[q] < 127) ++Cc[q];
        B[q] -= N[q];
        if (B[q] > 0) B[q] = 0;
      }
      ++i;
    }
    c_first = y > 0 ? prevrec[0] : 0;
    prevrec.swap(currec);
    if (w.overflow) return -2;
  }
  w.flush();
  if (w.overflow) return -2;
  return w.n;
}

// ------------------------------------------ JPEG 2000 Tier-1 (T.800 C + D)
// Bit-identical port of perception/jpeg2000.py's MQ coder and EBCOT block
// coder (the Python implementation is the oracle; parity is test-enforced).

static const uint16_t J2K_QE[47] = {
    0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401, 0x4801,
    0x3801, 0x3001, 0x2401, 0x1C01, 0x1601, 0x5601, 0x5401, 0x5101, 0x4801,
    0x3801, 0x3401, 0x3001, 0x2801, 0x2401, 0x2201, 0x1C01, 0x1801, 0x1601,
    0x1401, 0x1201, 0x1101, 0x0AC1, 0x09C1, 0x08A1, 0x0521, 0x0441, 0x02A1,
    0x0221, 0x0141, 0x0111, 0x0085, 0x0049, 0x0025, 0x0015, 0x0009, 0x0005,
    0x0001, 0x5601};
static const uint8_t J2K_NMPS[47] = {1,  2,  3,  4,  5,  38, 7,  8,  9,  10, 11, 12,
                                     13, 29, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24,
                                     25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36,
                                     37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46};
static const uint8_t J2K_NLPS[47] = {1,  6,  9,  12, 29, 33, 6,  14, 14, 14, 17, 18,
                                     20, 21, 14, 14, 15, 16, 17, 18, 19, 19, 20, 21,
                                     22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33,
                                     34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 46};
static const uint8_t J2K_SW[47] = {1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1, 0,
                                   0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                   0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
static const uint8_t J2K_SC_CTX[9] = {13, 12, 11, 10, 9, 10, 11, 12, 13};
static const uint8_t J2K_SC_XOR[9] = {1, 1, 1, 1, 0, 0, 0, 0, 0};

struct J2kCtxState {
  int idx[19];
  int mps[19];
  void init() {
    for (int i = 0; i < 19; ++i) { idx[i] = 0; mps[i] = 0; }
    idx[0] = 4; idx[17] = 3; idx[18] = 46;
  }
};

struct J2kMqEnc : J2kCtxState {
  uint32_t a, c;
  int ct;
  std::vector<uint8_t> out;  // leading sentinel byte absorbs a carry
  void begin() { init(); a = 0x8000; c = 0; ct = 12; out.assign(1, 0); }
  void byteout() {
    if (out.back() == 0xFF) {
      out.push_back((c >> 20) & 0xFF); c &= 0xFFFFF; ct = 7;
    } else if (c < 0x8000000u) {
      out.push_back((c >> 19) & 0xFF); c &= 0x7FFFF; ct = 8;
    } else {
      ++out.back();
      if (out.back() == 0xFF) {
        c &= 0x7FFFFFF; out.push_back((c >> 20) & 0xFF); c &= 0xFFFFF; ct = 7;
      } else {
        out.push_back((c >> 19) & 0xFF); c &= 0x7FFFF; ct = 8;
      }
    }
  }
  void encode(int ctx, int bit) {
    const uint32_t qe = J2K_QE[idx[ctx]];
    const int nm = J2K_NMPS[idx[ctx]], nl = J2K_NLPS[idx[ctx]], sw = J2K_SW[idx[ctx]];
    a -= qe;
    if (bit == mps[ctx]) {
      if (a & 0x8000) { c += qe; return; }
      if (a < qe) a = qe; else c += qe;  // conditional exchange
      idx[ctx] = nm;
    } else {
      if (a < qe) c += qe; else a = qe;  // conditional exchange
      if (sw) mps[ctx] ^= 1;
      idx[ctx] = nl;
    }
    do {
      a = (a << 1) & 0xFFFF;
      c <<= 1;
      if (--ct == 0) byteout();
    } while (!(a & 0x8000));
  }
  int flush() {  // 0 ok, <0 internal error
    uint32_t tempc = c + a;
    c |= 0xFFFF;
    if (c >= tempc) c -= 0x8000;
    c <<= ct; byteout();
    c <<= ct; byteout();
    if (out.back() == 0xFF) out.pop_back();
    return out[0] == 0 ? 0 : -1;
  }
};

struct J2kMqDec : J2kCtxState {
  const uint8_t* d;
  int64_t n, bp;
  uint32_t a, c;
  int ct;
  void begin(const uint8_t* data, int64_t len) {
    init(); d = data; n = len; bp = 0;
    c = (uint32_t)(n ? d[0] : 0xFF) << 16;
    bytein();
    c <<= 7; ct -= 7; a = 0x8000;
  }
  void bytein() {
    const uint32_t cur = bp < n ? d[bp] : 0xFF;
    if (cur == 0xFF) {
      const uint32_t nxt = bp + 1 < n ? d[bp + 1] : 0xFF;
      if (nxt > 0x8F) { c += 0xFF00; ct = 8; }
      else { ++bp; c += nxt << 9; ct = 7; }
    } else {
      ++bp;
      const uint32_t nxt = bp < n ? d[bp] : 0xFF;
      c += nxt << 8; ct = 8;
    }
  }
  int decode(int ctx) {
    const uint32_t qe = J2K_QE[idx[ctx]];
    const int nm = J2K_NMPS[idx[ctx]], nl = J2K_NLPS[idx[ctx]], sw = J2K_SW[idx[ctx]];
    a -= qe;
    int bit;
    if ((c >> 16) < qe) {
      if (a < qe) { bit = mps[ctx]; idx[ctx] = nm; }
      else { bit = mps[ctx] ^ 1; if (sw) mps[ctx] ^= 1; idx[ctx] = nl; }
      a = qe;
    } else {
      c -= qe << 16;
      if (a & 0x8000) return mps[ctx];
      if (a < qe) { bit = mps[ctx] ^ 1; if (sw) mps[ctx] ^= 1; idx[ctx] = nl; }
      else { bit = mps[ctx]; idx[ctx] = nm; }
    }
    do {
      if (ct == 0) bytein();
      a = (a << 1) & 0xFFFF;
      c <<= 1;
      --ct;
    } while (!(a & 0x8000));
    return bit;
  }
};

static inline int j2k_zc_ll(int h, int v, int d) {
  if (h == 2) return 8;
  if (h == 1) { if (v >= 1) return 7; return d >= 1 ? 6 : 5; }
  if (v == 2) return 4;
  if (v == 1) return 3;
  return d >= 2 ? 2 : d;
}
static inline int j2k_zc_hh(int h, int v, int d) {
  const int hv = h + v;
  if (d >= 3) return 8;
  if (d == 2) return hv >= 1 ? 7 : 6;
  if (d == 1) return hv >= 2 ? 5 : (hv == 1 ? 4 : 3);
  return hv >= 2 ? 2 : hv;
}

// Per-coefficient flag word: neighbor significance/sign is PUSHED into a
// cell's word when the neighbor becomes significant, so every coding
// decision reads one word + a LUT instead of eight neighbor loads.
enum : uint32_t {
  J2K_F_SIG_W = 1u << 0, J2K_F_SIG_E = 1u << 1,
  J2K_F_SIG_N = 1u << 2, J2K_F_SIG_S = 1u << 3,
  J2K_F_SIG_NW = 1u << 4, J2K_F_SIG_NE = 1u << 5,
  J2K_F_SIG_SW = 1u << 6, J2K_F_SIG_SE = 1u << 7,
  J2K_F_NB = 0xFFu,
  J2K_F_SGN_W = 1u << 8, J2K_F_SGN_E = 1u << 9,
  J2K_F_SGN_N = 1u << 10, J2K_F_SGN_S = 1u << 11,
  J2K_F_SIG = 1u << 12, J2K_F_PI = 1u << 13,
  J2K_F_REF = 1u << 14, J2K_F_NEG = 1u << 15,
};

struct J2kBlock {
  int w, h, st, orient;
  std::vector<uint32_t> flags;
  std::vector<uint32_t> mag;
  uint8_t zclut[256];
  uint8_t scctx[256], scxor[256];
  void begin(int w_, int h_, int orient_) {
    w = w_; h = h_; st = w + 2; orient = orient_;
    const size_t nn = (size_t)st * (h + 2);
    flags.assign(nn, 0);
    mag.assign(nn, 0);
    for (int p = 0; p < 256; ++p) {
      const int hh = !!(p & J2K_F_SIG_W) + !!(p & J2K_F_SIG_E);
      const int vv = !!(p & J2K_F_SIG_N) + !!(p & J2K_F_SIG_S);
      const int dd = !!(p & J2K_F_SIG_NW) + !!(p & J2K_F_SIG_NE) +
                     !!(p & J2K_F_SIG_SW) + !!(p & J2K_F_SIG_SE);
      int zc;
      if (orient == 1) zc = j2k_zc_ll(vv, hh, dd);
      else if (orient == 3) zc = j2k_zc_hh(hh, vv, dd);
      else zc = j2k_zc_ll(hh, vv, dd);
      zclut[p] = static_cast<uint8_t>(zc);
    }
    // SC LUT over [sig W,E,N,S | sgn W,E,N,S] (sgn bits shifted down by 4)
    static const uint8_t sc_ctx_tab[9] = {13, 12, 11, 10, 9, 10, 11, 12, 13};
    static const uint8_t sc_xor_tab[9] = {1, 1, 1, 1, 0, 0, 0, 0, 0};
    for (int p = 0; p < 256; ++p) {
      int hc = 0, vc = 0;
      if (p & 0x01) hc += (p & 0x10) ? -1 : 1;  // W
      if (p & 0x02) hc += (p & 0x20) ? -1 : 1;  // E
      if (p & 0x04) vc += (p & 0x40) ? -1 : 1;  // N
      if (p & 0x08) vc += (p & 0x80) ? -1 : 1;  // S
      hc = hc < -1 ? -1 : (hc > 1 ? 1 : hc);
      vc = vc < -1 ? -1 : (vc > 1 ? 1 : vc);
      const int k = (hc + 1) * 3 + (vc + 1);
      scctx[p] = sc_ctx_tab[k];
      scxor[p] = sc_xor_tab[k];
    }
  }
  inline int at(int x, int y) const { return (y + 1) * st + (x + 1); }
  inline int sc(uint32_t f, int* xr) const {
    const int idx = (f & 0x0F) | ((f >> 4) & 0xF0);
    *xr = scxor[idx];
    return scctx[idx];
  }
  inline void set_significant(int i, int neg) {
    uint32_t* f = flags.data();
    f[i] |= J2K_F_SIG | (neg ? J2K_F_NEG : 0u);
    if (neg) {
      f[i - 1] |= J2K_F_SIG_E | J2K_F_SGN_E;
      f[i + 1] |= J2K_F_SIG_W | J2K_F_SGN_W;
      f[i - st] |= J2K_F_SIG_S | J2K_F_SGN_S;
      f[i + st] |= J2K_F_SIG_N | J2K_F_SGN_N;
    } else {
      f[i - 1] |= J2K_F_SIG_E;
      f[i + 1] |= J2K_F_SIG_W;
      f[i - st] |= J2K_F_SIG_S;
      f[i + st] |= J2K_F_SIG_N;
    }
    f[i - st - 1] |= J2K_F_SIG_SE;
    f[i - st + 1] |= J2K_F_SIG_SW;
    f[i + st - 1] |= J2K_F_SIG_NE;
    f[i + st + 1] |= J2K_F_SIG_NW;
  }
};

int64_t mamri_j2k_t1_decode(const uint8_t* data, int64_t len, int32_t w, int32_t h,
                            int32_t orient, int32_t bitplanes, int32_t npasses,
                            int32_t* out) {
  if (w <= 0 || h <= 0 || w > 4096 || h > 4096) return -1;
  memset(out, 0, (size_t)w * h * sizeof(int32_t));
  if (bitplanes <= 0 || npasses <= 0) return 0;
  if (npasses > 3 * bitplanes - 2 || bitplanes > 31) return -1;
  J2kBlock b; b.begin(w, h, orient);
  J2kMqDec mq; mq.begin(data, len);
  uint32_t* F = b.flags.data();
  uint32_t* M = b.mag.data();
  const int st = b.st;
  int plane = bitplanes - 1, kind = 2, passno = 0;
  while (passno < npasses) {
    const uint32_t bit = 1u << plane;
    if (kind == 0) {  // significance propagation
      for (int y0 = 0; y0 < h; y0 += 4)
        for (int x = 0; x < w; ++x) {
          const int ylim = y0 + 4 < h ? y0 + 4 : h;
          int i = b.at(x, y0);
          for (int y = y0; y < ylim; ++y, i += st) {
            const uint32_t fi = F[i];
            if (fi & J2K_F_SIG) { F[i] = fi & ~J2K_F_PI; continue; }
            if (fi & J2K_F_NB) {
              F[i] = fi | J2K_F_PI;
              if (mq.decode(b.zclut[fi & J2K_F_NB])) {
                int xr; const int ctx = b.sc(fi, &xr);
                const int neg = mq.decode(ctx) ^ xr;
                b.set_significant(i, neg);
                F[i] |= J2K_F_PI;  // set_significant rewrote the word
                M[i] = bit;
              }
            } else F[i] = fi & ~J2K_F_PI;
          }
        }
    } else if (kind == 1) {  // magnitude refinement
      for (int y0 = 0; y0 < h; y0 += 4)
        for (int x = 0; x < w; ++x) {
          const int ylim = y0 + 4 < h ? y0 + 4 : h;
          int i = b.at(x, y0);
          for (int y = y0; y < ylim; ++y, i += st) {
            const uint32_t fi = F[i];
            if ((fi & (J2K_F_SIG | J2K_F_PI)) == J2K_F_SIG && M[i] != bit) {
              const int ctx = (fi & J2K_F_REF) ? 16 : ((fi & J2K_F_NB) ? 15 : 14);
              if (mq.decode(ctx)) M[i] |= bit;
              F[i] = fi | J2K_F_REF;
            }
          }
        }
    } else {  // cleanup
      for (int y0 = 0; y0 < h; y0 += 4) {
        const bool full = y0 + 4 <= h;
        for (int x = 0; x < w; ++x) {
          int y = y0;
          const int base = b.at(x, y0);
          if (full) {
            if (!((F[base] | F[base + st] | F[base + 2 * st] | F[base + 3 * st])
                  & (J2K_F_SIG | J2K_F_PI | J2K_F_NB))) {
              if (!mq.decode(17)) continue;
              const int r = (mq.decode(18) << 1) | mq.decode(18);
              const int i = base + r * st;
              int xr; const int ctx = b.sc(F[i], &xr);
              const int neg = mq.decode(ctx) ^ xr;
              b.set_significant(i, neg);
              M[i] = bit;
              y = y0 + r + 1;
            }
          }
          const int ylim = y0 + 4 < h ? y0 + 4 : h;
          int i = base + (y - y0) * st;
          for (; y < ylim; ++y, i += st) {
            const uint32_t fi = F[i];
            if (!(fi & (J2K_F_SIG | J2K_F_PI))) {
              if (mq.decode(b.zclut[fi & J2K_F_NB])) {
                int xr; const int ctx = b.sc(fi, &xr);
                const int neg = mq.decode(ctx) ^ xr;
                b.set_significant(i, neg);
                M[i] = bit;
              }
            }
            F[i] &= ~J2K_F_PI;
          }
        }
      }
    }
    ++passno;
    if (kind == 2) {
      if (--plane < 0 && passno < npasses) return -1;
      kind = 0;
    } else ++kind;
  }
  for (int y = 0; y < h; ++y) {
    int i = b.at(0, y);
    for (int x = 0; x < w; ++x, ++i)
      if (F[i] & J2K_F_SIG)
        out[(int64_t)y * w + x] =
            (F[i] & J2K_F_NEG) ? -(int32_t)M[i] : (int32_t)M[i];
  }
  return 0;
}

int64_t mamri_j2k_t1_encode(const int32_t* coeffs, int32_t w, int32_t h,
                            int32_t orient, int32_t max_bitplanes, uint8_t* out,
                            int64_t cap, int32_t* zbp_out, int32_t* npasses_out) {
  if (w <= 0 || h <= 0 || w > 4096 || h > 4096 || max_bitplanes > 31) return -1;
  uint32_t maxmag = 0;
  for (int64_t i = 0; i < (int64_t)w * h; ++i) {
    const uint32_t m = coeffs[i] < 0 ? (uint32_t)(-(int64_t)coeffs[i]) : (uint32_t)coeffs[i];
    if (m > maxmag) maxmag = m;
  }
  int nb = 0;
  while ((1u << nb) <= maxmag && nb < 32) ++nb;
  if (nb > max_bitplanes) return -2;
  if (nb == 0) { *zbp_out = max_bitplanes; *npasses_out = 0; return 0; }
  J2kBlock b; b.begin(w, h, orient);
  uint32_t* F = b.flags.data();
  uint32_t* M = b.mag.data();
  const int st = b.st;
  const size_t nn = b.mag.size();
  std::vector<uint32_t> tmag(nn, 0);
  std::vector<uint8_t> tneg(nn, 0);
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) {
      const int32_t v = coeffs[(int64_t)y * w + x];
      const int i = b.at(x, y);
      tmag[i] = v < 0 ? (uint32_t)(-(int64_t)v) : (uint32_t)v;
      tneg[i] = v < 0;
    }
  J2kMqEnc mq; mq.begin();
  const int npasses = 3 * nb - 2;
  int plane = nb - 1, kind = 2;
  for (int p = 0; p < npasses; ++p) {
    const uint32_t bit = 1u << plane;
    if (kind == 0) {
      for (int y0 = 0; y0 < h; y0 += 4)
        for (int x = 0; x < w; ++x) {
          const int ylim = y0 + 4 < h ? y0 + 4 : h;
          int i = b.at(x, y0);
          for (int y = y0; y < ylim; ++y, i += st) {
            const uint32_t fi = F[i];
            if (fi & J2K_F_SIG) { F[i] = fi & ~J2K_F_PI; continue; }
            if (fi & J2K_F_NB) {
              F[i] = fi | J2K_F_PI;
              const int sb = (tmag[i] & bit) ? 1 : 0;
              mq.encode(b.zclut[fi & J2K_F_NB], sb);
              if (sb) {
                int xr; const int ctx = b.sc(fi, &xr);
                mq.encode(ctx, tneg[i] ^ xr);
                b.set_significant(i, tneg[i]);
                F[i] |= J2K_F_PI;
                M[i] = bit;
              }
            } else F[i] = fi & ~J2K_F_PI;
          }
        }
    } else if (kind == 1) {
      for (int y0 = 0; y0 < h; y0 += 4)
        for (int x = 0; x < w; ++x) {
          const int ylim = y0 + 4 < h ? y0 + 4 : h;
          int i = b.at(x, y0);
          for (int y = y0; y < ylim; ++y, i += st) {
            const uint32_t fi = F[i];
            if ((fi & (J2K_F_SIG | J2K_F_PI)) == J2K_F_SIG && M[i] != bit) {
              const int ctx = (fi & J2K_F_REF) ? 16 : ((fi & J2K_F_NB) ? 15 : 14);
              mq.encode(ctx, (tmag[i] & bit) ? 1 : 0);
              if (tmag[i] & bit) M[i] |= bit;
              F[i] = fi | J2K_F_REF;
            }
          }
        }
    } else {
      for (int y0 = 0; y0 < h; y0 += 4) {
        const bool full = y0 + 4 <= h;
        for (int x = 0; x < w; ++x) {
          int y = y0;
          const int base = b.at(x, y0);
          if (full) {
            if (!((F[base] | F[base + st] | F[base + 2 * st] | F[base + 3 * st])
                  & (J2K_F_SIG | J2K_F_PI | J2K_F_NB))) {
              int r = -1;
              for (int k = 0; k < 4; ++k)
                if (tmag[base + k * st] & bit) { r = k; break; }
              if (r < 0) { mq.encode(17, 0); continue; }
              mq.encode(17, 1);
              mq.encode(18, (r >> 1) & 1);
              mq.encode(18, r & 1);
              const int i = base + r * st;
              int xr; const int ctx = b.sc(F[i], &xr);
              mq.encode(ctx, tneg[i] ^ xr);
              b.set_significant(i, tneg[i]);
              M[i] = bit;
              y = y0 + r + 1;
            }
          }
          const int ylim = y0 + 4 < h ? y0 + 4 : h;
          int i = base + (y - y0) * st;
          for (; y < ylim; ++y, i += st) {
            const uint32_t fi = F[i];
            if (!(fi & (J2K_F_SIG | J2K_F_PI))) {
              const int sb = (tmag[i] & bit) ? 1 : 0;
              mq.encode(b.zclut[fi & J2K_F_NB], sb);
              if (sb) {
                int xr; const int ctx = b.sc(fi, &xr);
                mq.encode(ctx, tneg[i] ^ xr);
                b.set_significant(i, tneg[i]);
                M[i] = bit;
              }
            }
            F[i] &= ~J2K_F_PI;
          }
        }
      }
    }
    if (kind == 2) { --plane; kind = 0; } else ++kind;
  }
  if (mq.flush() != 0) return -3;
  const int64_t nbytes = (int64_t)mq.out.size() - 1;  // drop the sentinel
  if (nbytes > cap) return -4;
  memcpy(out, mq.out.data() + 1, (size_t)nbytes);
  *zbp_out = max_bitplanes - nb;
  *npasses_out = npasses;
  return nbytes;
}

// -------------------------------- sequential-DCT JPEG Huffman scan (T.81)
// Entropy-decodes one single-component SOF0/SOF1 scan into zigzag-order
// quantized coefficients (nblocks x 64 int32); perception/jpegdct.py does
// the (vectorized numpy) dequant + IDCT, so parity with the Python scan
// loop is exact integers. Returns nblocks, or -1 malformed/unsupported,
// -2 cap too small, -3 corrupt entropy data.

struct JdctHuff {
  int32_t mincode[17];
  int32_t maxcode[17];
  int32_t valptr[17];
  uint8_t vals[256];
  int nvals = 0;
  bool ok = false;
  bool build(const uint8_t* bits, const uint8_t* v, int nv) {
    if (nv > 256) return false;
    nvals = nv;
    memcpy(vals, v, nv);
    int code = 0, k = 0;
    for (int ln = 1; ln <= 16; ++ln) {
      valptr[ln] = k;
      mincode[ln] = code;
      code += bits[ln - 1];
      k += bits[ln - 1];
      maxcode[ln] = bits[ln - 1] ? code - 1 : -1;
      if (code > (1 << ln)) return false;
      code <<= 1;
    }
    ok = (k == nv);
    return ok;
  }
};

struct JdctReader {
  const uint8_t* d;
  int64_t len, pos;
  uint64_t acc = 0;
  int nbits = 0;
  int marker = 0;  // pending 0xFFxx marker (0 = none)
  void fill() {
    if (marker || pos >= len) { acc <<= 8; nbits += 8; return; }
    uint8_t b = d[pos];
    if (b == 0xFF) {
      uint8_t nxt = pos + 1 < len ? d[pos + 1] : 0xD9;
      if (nxt == 0x00) { pos += 2; acc = (acc << 8) | 0xFF; nbits += 8; return; }
      marker = 0xFF00 | nxt;
      acc <<= 8; nbits += 8;
      return;
    }
    ++pos;
    acc = (acc << 8) | b;
    nbits += 8;
  }
  int bits(int n) {
    while (nbits < n) fill();
    nbits -= n;
    int v = (int)((acc >> nbits) & ((1ull << n) - 1));
    acc &= (nbits >= 64) ? ~0ull : ((1ull << nbits) - 1);
    return v;
  }
  int huff(const JdctHuff& t, bool* err) {
    int code = bits(1);
    for (int ln = 1; ln <= 16; ++ln) {
      if (t.maxcode[ln] >= 0 && code <= t.maxcode[ln])
        return t.vals[t.valptr[ln] + code - t.mincode[ln]];
      code = (code << 1) | bits(1);
    }
    *err = true;
    return 0;
  }
};

static inline int jdct_extend(int v, int t) {
  if (t == 0) return 0;
  return v >= (1 << (t - 1)) ? v : v - (1 << t) + 1;
}

int64_t mamri_jpegdct_scan(const uint8_t* data, int64_t len, int32_t* out,
                           int64_t max_blocks, int32_t* rows_out,
                           int32_t* cols_out, int32_t* prec_out) {
  if (len < 4 || data[0] != 0xFF || data[1] != 0xD8) return -1;
  int64_t pos = 2;
  int rows = 0, cols = 0, prec = 0, ri = 0, td = -1, ta = -1;
  bool have_frame = false;
  JdctHuff dc_tabs[4], ac_tabs[4];
  int64_t scan_off = -1;
  while (pos + 4 <= len) {
    if (data[pos] != 0xFF) return -1;
    int marker = 0xFF00 | data[pos + 1];
    int seglen = (data[pos + 2] << 8) | data[pos + 3];
    const uint8_t* body = data + pos + 4;
    int64_t blen = seglen - 2;
    if (seglen < 2 || pos + 2 + seglen > len) return -1;
    pos += 2 + seglen;
    if (marker == 0xFFC0 || marker == 0xFFC1) {
      if (blen < 9) return -1;
      prec = body[0];
      rows = (body[1] << 8) | body[2];
      cols = (body[3] << 8) | body[4];
      if (body[5] != 1 || rows == 0 || cols == 0) return -1;
      if ((marker == 0xFFC0 && prec != 8) || (prec != 8 && prec != 12)) return -1;
      if ((body[7] & 0x0F) != 1 || (body[7] >> 4) != 1) return -1;
      have_frame = true;
    } else if ((marker >= 0xFFC2 && marker <= 0xFFCF && marker != 0xFFC4 &&
                marker != 0xFFC8 && marker != 0xFFCC) || marker == 0xFFF7) {
      return -1;  // progressive / arithmetic / lossless / JPEG-LS
    } else if (marker == 0xFFC4) {
      int64_t p2 = 0;
      while (p2 + 17 <= blen) {
        int tc = body[p2] >> 4, th = body[p2] & 0x0F;
        if (th > 3) return -1;
        const uint8_t* bits = body + p2 + 1;
        int nv = 0;
        for (int i = 0; i < 16; ++i) nv += bits[i];
        if (p2 + 17 + nv > blen) return -1;
        JdctHuff& t = tc == 0 ? dc_tabs[th] : ac_tabs[th];
        if (!t.build(bits, body + p2 + 17, nv)) return -1;
        p2 += 17 + nv;
      }
    } else if (marker == 0xFFDD) {
      if (blen < 2) return -1;
      ri = (body[0] << 8) | body[1];
    } else if (marker == 0xFFDA) {
      if (blen < 6 || body[0] != 1 || !have_frame) return -1;
      td = body[2] >> 4;
      ta = body[2] & 0x0F;
      if (td > 3 || ta > 3 || !dc_tabs[td].ok || !ac_tabs[ta].ok) return -1;
      scan_off = pos;
      break;
    }
  }
  if (scan_off < 0) return -1;
  const int64_t bw = (cols + 7) / 8, bh = (rows + 7) / 8;
  const int64_t nblocks = bw * bh;
  if (nblocks > max_blocks || nblocks > (1 << 22)) return -2;
  memset(out, 0, (size_t)nblocks * 64 * sizeof(int32_t));
  JdctReader r{data, len, scan_off};
  const JdctHuff& dct_dc = dc_tabs[td];
  const JdctHuff& dct_ac = ac_tabs[ta];
  bool err = false;
  int pred = 0;
  for (int64_t bi = 0; bi < nblocks; ++bi) {
    if (ri && bi && bi % ri == 0) {
      // drop pad bits, then consume the RSTn marker
      while (r.marker == 0 && r.pos < len) {
        if (r.nbits) r.bits(r.nbits < 8 ? r.nbits : 8);
        else r.fill();
      }
      while (r.nbits >= 8) { r.nbits -= 8; }
      r.acc &= (r.nbits >= 64) ? ~0ull : ((1ull << r.nbits) - 1);
      if (r.marker != (0xFFD0 | (int)(((bi / ri) - 1) & 7))) return -3;
      r.marker = 0;
      r.pos += 2;
      r.acc = 0;
      r.nbits = 0;
      pred = 0;
    }
    int t = r.huff(dct_dc, &err);
    if (err || t > 15 || (prec == 8 && t > 11)) return -3;
    pred += jdct_extend(r.bits(t), t);
    int32_t* blk = out + bi * 64;
    blk[0] = pred;
    int k = 1;
    while (k < 64) {
      int rs = r.huff(dct_ac, &err);
      if (err) return -3;
      int rr = rs >> 4, ss = rs & 0x0F;
      if (ss == 0) {
        if (rr == 15) { k += 16; continue; }
        break;
      }
      k += rr;
      if (k > 63) return -3;
      blk[k] = jdct_extend(r.bits(ss), ss);
      ++k;
    }
  }
  *rows_out = rows;
  *cols_out = cols;
  *prec_out = prec;
  return nblocks;
}

// ----------------------------- JPEG Lossless (SOF3) scan bit-emitter
// The encoder's only hot loop: Huffman-code the per-pixel (category, diff)
// stream with FF00 stuffing and 1-bit final padding, byte-identical to
// perception/jpegll.py's emit_band. codes/lens are indexed by category
// symbol 0..16. Returns byte count, or -1 bad args, -2 cap too small.
int64_t mamri_jpegll_emit(const int32_t* diffs, const uint8_t* cats, int64_t n,
                          const uint32_t* codes, const uint8_t* lens,
                          uint8_t* out, int64_t cap) {
  uint64_t acc = 0;
  int nacc = 0;
  int64_t m = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int s = cats[i];
    if (s > 16 || lens[s] == 0) return -1;
    acc = (acc << lens[s]) | codes[s];
    nacc += lens[s];
    if (s > 0 && s < 16) {
      int32_t v = diffs[i];
      if (v < 0) v += (1 << s) - 1;
      acc = (acc << s) | (uint32_t)v;
      nacc += s;
    }
    while (nacc >= 8) {
      const uint8_t byte = (uint8_t)((acc >> (nacc - 8)) & 0xFF);
      nacc -= 8;
      if (m + 2 > cap) return -2;
      out[m++] = byte;
      if (byte == 0xFF) out[m++] = 0x00;
    }
    acc &= (1ull << nacc) - 1;
  }
  if (nacc) {
    const uint8_t byte = (uint8_t)(((acc << (8 - nacc)) | ((1u << (8 - nacc)) - 1)) & 0xFF);
    if (m + 2 > cap) return -2;
    out[m++] = byte;
    if (byte == 0xFF) out[m++] = 0x00;
  }
  return m;
}

}  // extern "C"

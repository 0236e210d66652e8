// Threshold + exact ball(2) closing + CCL label init.
//
// Replaces mamri_tpu/perception/pallas_ops.py:211 `fused_threshold_close_init`
// (kernel `_close_kernel` :177 with `_ball2_pass` :157).
//
// Semantics (safe-border closing, mamri_tpu/perception/segmentation.py:166):
// a voxel is in band iff lo <= v <= hi; NaN and every voxel outside the
// volume are out of band. The dilation is evaluated on the volume grown by 2
// on every side (so it never clips at the border), the erosion at each
// in-volume voxel. ball(2) is the 3x3x3 box plus the six axis points at
// distance 2 (33 offsets). The label of a closed voxel is its (z, y, x)
// raster index k*lnx*lny + j*lnx + i; background gets INT32_MAX. (lnx, lny)
// are the block's own (nx, ny) unless the caller gives other multipliers
// (`label_dims`, pallas_ops.py:224-227): a halo-extended shard of a volume
// sharded along x labels with the whole volume's (nx, ny) and shifts the
// labels by its x offset. The arithmetic is uint32; the halo's extra x
// planes alias into the next row, and the caller keeps only the interior.
//
// What bounds it on the card: bytes. One f32 read and one int8 + one int32
// write a voxel (9 B); a per-voxel stencil of 2 x 33 loads makes it
// instruction-bound instead. So the band is packed along z, 32 voxels to a
// uint32 word (bit b of word w of row (x, y) is z = 32 w + b), and a ball(2)
// pass over 32 voxels is a few word operations:
//   * close_band_kernel: one warp per (x, y) row, one f32 a lane per step,
//     __ballot_sync packs the in-band tests into a word: an (nx, ny, W)
//     uint32 band (W = ceil(nz / 32); 2 MB at 256^3, kept by L2);
//   * close_init_kernel: a block owns an 8 x 16-row patch and 8 words of z.
//     It stages the band words of the patch with a halo of 4 rows and 2
//     words (zero outside the volume) in shared memory; builds the z-box
//     (w | w << 1 | w >> 1, neighbour words' edge bits carried in), ORs it
//     over 3x3 rows and adds the six +-2 axis points (w << 2, w >> 2, rows at
//     x +- 2, y +- 2): the dilation of the patch plus 2 rows and 1 word,
//     which covers z = -2, -1, nz, nz + 1 and the rows at -2, -1, n, n + 1,
//     computed, never assumed 0. The erosion is the same shape with AND.
//     Each bit then becomes the int8 mask and int32 label, 4 voxels a lane
//     (4 B + 16 B stores) where nz % 4 == 0; (i, j, k) come from the block
//     and thread indices, with 32-bit arithmetic and no division by a
//     runtime value.
// The band's halo re-reads (3x the rows) hit L2; device memory sees the
// 9 B a voxel plus the 2 MB band written once and read once.

#include "common.cuh"

#define CI_TX 8   // x rows of a patch
#define CI_TY 16  // y rows of a patch
#define CI_TW 8   // z words of a patch
#define CI_THREADS 256

// staged extents: band (rows -4.., words -2..), z-box of the band (rows -3..,
// words -1..), dilation (rows -2.., words -1..), z-box of the dilation (rows
// -1.., words 0..), relative to the patch origin
constexpr int CI_BX = CI_TX + 8, CI_BY = CI_TY + 8, CI_BW = CI_TW + 4;
constexpr int CI_ZX = CI_TX + 6, CI_ZY = CI_TY + 6, CI_ZW = CI_TW + 2;
constexpr int CI_DX = CI_TX + 4, CI_DY = CI_TY + 4, CI_DW = CI_TW + 2;
constexpr int CI_EX = CI_TX + 2, CI_EY = CI_TY + 2, CI_EW = CI_TW;

__global__ void __launch_bounds__(CI_THREADS)
    close_band_kernel(const float* __restrict__ data, uint32_t* __restrict__ band, long long rows,
                      int nz, int words, float lo, float hi) {
  const int lane = threadIdx.x & 31;
  const long long row = ((long long)blockIdx.x * CI_THREADS + threadIdx.x) >> 5;
  if (row >= rows) return;  // the whole warp
  const float* p = data + row * nz;
  for (int w0 = 0; w0 < words; w0 += 32) {
    const int cnt = min(32, words - w0);
    uint32_t mine = 0u;
    for (int t = 0; t < cnt; t += 8) {
      float v[8];
      bool live[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int k = (w0 + t + u) * 32 + lane;
        live[u] = t + u < cnt && k < nz;
        v[u] = live[u] ? p[k] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const uint32_t b = __ballot_sync(0xffffffffu, live[u] && v[u] >= lo && v[u] <= hi);  // NaN: out
        if (lane == t + u) mine = b;
      }
    }
    if (lane < cnt) band[row * words + w0 + lane] = mine;
  }
}

__global__ void __launch_bounds__(CI_THREADS)
    close_init_kernel(const uint32_t* __restrict__ band, int8_t* __restrict__ mask,
                      int32_t* __restrict__ lab, int nx, int ny, int nz, int words, int lnx,
                      int lny) {
  __shared__ uint32_t s_band[CI_BX * CI_BY * CI_BW];  // later the erosion words
  __shared__ uint32_t s_zbox[CI_ZX * CI_ZY * CI_ZW];  // later the dilation's z-box
  __shared__ uint32_t s_dil[CI_DX * CI_DY * CI_DW];
  uint32_t* s_ero = s_band;
  uint32_t* s_dbox = s_zbox;
  const int x0 = blockIdx.x * CI_TX, y0 = blockIdx.y * CI_TY, w0 = blockIdx.z * CI_TW;

  for (int t = threadIdx.x; t < CI_BX * CI_BY * CI_BW; t += CI_THREADS) {
    const int w = w0 - 2 + t % CI_BW, r = t / CI_BW;
    const int x = x0 - 4 + r / CI_BY, y = y0 - 4 + r % CI_BY;
    uint32_t b = 0u;
    if (x >= 0 && x < nx && y >= 0 && y < ny && w >= 0 && w < words)
      b = band[((long long)x * ny + y) * words + w];
    s_band[t] = b;
  }
  __syncthreads();

  // z-box of the band: z-1, z, z+1
  for (int t = threadIdx.x; t < CI_ZX * CI_ZY * CI_ZW; t += CI_THREADS) {
    const int wl = t % CI_ZW, r = t / CI_ZW;
    const uint32_t* b = s_band + ((r / CI_ZY + 1) * CI_BY + r % CI_ZY + 1) * CI_BW + wl + 1;
    const uint32_t c = b[0];
    s_zbox[t] = c | (c << 1) | (b[-1] >> 31) | (c >> 1) | (b[1] << 31);
  }
  __syncthreads();

  // dilation: the z-box over 3x3 rows, then the six +-2 axis points
  for (int t = threadIdx.x; t < CI_DX * CI_DY * CI_DW; t += CI_THREADS) {
    const int wl = t % CI_DW, r = t / CI_DW;
    const int xl = r / CI_DY, yl = r % CI_DY;
    uint32_t d = 0u;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) d |= s_zbox[((xl + dx) * CI_ZY + yl + dy) * CI_ZW + wl];
    const uint32_t* b = s_band + ((xl + 2) * CI_BY + yl + 2) * CI_BW + wl + 1;
    const uint32_t c = b[0];
    d |= b[-2 * CI_BY * CI_BW] | b[2 * CI_BY * CI_BW] | b[-2 * CI_BW] | b[2 * CI_BW];
    d |= (c << 2) | (b[-1] >> 30) | (c >> 2) | (b[1] << 30);
    s_dil[t] = d;
  }
  __syncthreads();

  // z-box of the dilation, with AND
  for (int t = threadIdx.x; t < CI_EX * CI_EY * CI_EW; t += CI_THREADS) {
    const int wl = t % CI_EW, r = t / CI_EW;
    const uint32_t* d = s_dil + ((r / CI_EY + 1) * CI_DY + r % CI_EY + 1) * CI_DW + wl + 1;
    const uint32_t c = d[0];
    s_dbox[t] = c & ((c << 1) | (d[-1] >> 31)) & ((c >> 1) | (d[1] << 31));
  }
  __syncthreads();

  // erosion of the patch
  for (int t = threadIdx.x; t < CI_TX * CI_TY * CI_TW; t += CI_THREADS) {
    const int wl = t % CI_TW, r = t / CI_TW;
    const int xl = r / CI_TY, yl = r % CI_TY;
    uint32_t e = 0xffffffffu;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) e &= s_dbox[((xl + dx) * CI_EY + yl + dy) * CI_EW + wl];
    const uint32_t* d = s_dil + ((xl + 2) * CI_DY + yl + 2) * CI_DW + wl + 1;
    const uint32_t c = d[0];
    e &= d[-2 * CI_DY * CI_DW] & d[2 * CI_DY * CI_DW] & d[-2 * CI_DW] & d[2 * CI_DW];
    e &= ((c << 2) | (d[-1] >> 30)) & ((c >> 2) | (d[1] << 30));
    s_ero[t] = e;
  }
  __syncthreads();

  // bits -> int8 mask + int32 label; row (x, y) of the patch is r = xl * TY + yl
  const uint32_t nxy = (uint32_t)lnx * (uint32_t)lny;
  if (nz % 4 == 0) {
    for (int t = threadIdx.x; t < CI_TX * CI_TY * CI_TW * 8; t += CI_THREADS) {
      const int qq = t % (CI_TW * 8), r = t / (CI_TW * 8);
      const int x = x0 + r / CI_TY, y = y0 + r % CI_TY, z = (w0 + qq / 8) * 32 + 4 * (qq % 8);
      if (x >= nx || y >= ny || z >= nz) continue;
      const uint32_t bits = (s_ero[r * CI_TW + qq / 8] >> (4 * (qq % 8))) & 0xfu;
      const long long off = ((long long)x * ny + y) * nz + z;
      const uint32_t lin = (uint32_t)z * nxy + (uint32_t)y * (uint32_t)lnx + (uint32_t)x;
      *reinterpret_cast<uint32_t*>(mask + off) =
          (bits & 1u) | ((bits >> 1) & 1u) << 8 | ((bits >> 2) & 1u) << 16 | (bits >> 3) << 24;
      *reinterpret_cast<int4*>(lab + off) = make_int4(
          (bits & 1u) ? (int)lin : MAMRI_BIG, (bits & 2u) ? (int)(lin + nxy) : MAMRI_BIG,
          (bits & 4u) ? (int)(lin + 2 * nxy) : MAMRI_BIG, (bits & 8u) ? (int)(lin + 3 * nxy) : MAMRI_BIG);
    }
  } else {
    for (int t = threadIdx.x; t < CI_TX * CI_TY * CI_TW * 32; t += CI_THREADS) {
      const int zl = t % (CI_TW * 32), r = t / (CI_TW * 32);
      const int x = x0 + r / CI_TY, y = y0 + r % CI_TY, z = w0 * 32 + zl;
      if (x >= nx || y >= ny || z >= nz) continue;
      const bool on = (s_ero[r * CI_TW + zl / 32] >> (zl % 32)) & 1u;
      const long long off = ((long long)x * ny + y) * nz + z;
      mask[off] = on ? 1 : 0;
      lab[off] = on ? (int)((uint32_t)z * nxy + (uint32_t)y * (uint32_t)lnx + (uint32_t)x) : MAMRI_BIG;
    }
  }
}

extern "C" int mamri_close_init(const float* data, uint32_t* band, int8_t* mask, int32_t* lab,
                                int nx, int ny, int nz, float lo, float hi, int lnx, int lny,
                                cudaStream_t stream) {
  const int words = (nz + 31) / 32;
  const long long rows = (long long)nx * ny;
  const unsigned band_blocks = (unsigned)((rows * 32 + CI_THREADS - 1) / CI_THREADS);
  close_band_kernel<<<band_blocks, CI_THREADS, 0, stream>>>(data, band, rows, nz, words, lo, hi);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nx + CI_TX - 1) / CI_TX, (ny + CI_TY - 1) / CI_TY, (words + CI_TW - 1) / CI_TW);
  close_init_kernel<<<grid, CI_THREADS, 0, stream>>>(band, mask, lab, nx, ny, nz, words, lnx, lny);
  return (int)cudaGetLastError();
}

extern "C" const char* mamri_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

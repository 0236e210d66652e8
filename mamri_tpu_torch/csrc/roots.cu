// Root candidates per 8-x slab: the k smallest roots and the exact count.
//
// Replaces mamri_tpu/perception/pallas_ops.py:503 `extract_root_candidates`
// (kernel `_roots_kernel` :484).
//
// A voxel (i, j, k) of the padded (nxp, nyp, nzp) label volume is a root iff
// its label is not the sentinel and equals its own (z, y, x) raster index
// k*nx*ny + j*nx + i, taken with the UNPADDED nx and ny (padded voxels hold
// the sentinel and can never be roots). Slab s is x in [8s, 8s + 8); its row
// of the (nblocks, k + 1) output holds its k smallest roots in ascending
// order (the sentinel in unused places) and then its exact root count, which
// may exceed k: that overflow is how the caller learns the list is cut.
//
// What bounds it on the card: one read of the labels (0.020 ms at 256^3).
// A slab is 8*nyp rows of nzp contiguous cells. The grid is (slab, chunk of
// `rows` rows), so the card is full (2,048 blocks at 256^3, not the 32 slabs):
// a warp takes a row at a time, lanes across z, 16 bytes a lane where nzp is a
// multiple of 4 and the labels start on a 16-byte boundary (4 bytes a lane
// otherwise), two loads a lane in flight. The row gives (i, j), advanced as
// the warp steps over rows with no division, so a cell's test is one 64-bit
// compare with a target the lane adds nx*ny to from cell to cell.
//
// Roots are rare. A warp appends its roots to a list in shared memory with one
// atomic a ballot, and the block counts them exactly. The wrapper sizes a chunk
// to at most ROOTS_LIST_CAP cells, so the list overflows only where one z line
// is longer than that; such a chunk picks in rounds of a block-wide minimum
// over its cells, which are still in L2. A list of up to ROOTS_RANK_MAX roots
// places each root by the number of smaller ones (an earlier place breaks a
// tie), a longer one picks in rounds of a block-wide minimum over the list.
// Each block writes its picks and count to a scratch row; the last block of a
// slab to finish (a per-slab ticket, cleared by the entry's memset) merges the
// slab's rows the same way and writes the output row. A slab of one chunk
// writes the output row directly. So a call is a memset and one kernel.

#include "common.cuh"

#define ROOTS_THREADS 256
#define ROOTS_WARPS (ROOTS_THREADS / 32)
#define ROOTS_MAX_K 64
#define ROOTS_LIST_CAP 8192  // roots a block keeps in shared memory (32 KB)
#define ROOTS_RANK_MAX 256   // a list up to this long is placed by rank
#define ROOTS_LOADS 2        // loads a lane keeps in flight (4 and 8 read slower: more registers, fewer blocks)
#define ROOTS_FULL 0xffffffffu

struct RootsShared {
  int32_t list[ROOTS_LIST_CAP];
  unsigned long long warp_key[ROOTS_WARPS];
  int count;
  int total;
};

// The lanes whose `hit` is set append `value` to the list; every lane of the
// warp calls it. The count goes on past the list's capacity.
__device__ __forceinline__ void roots_append(RootsShared& sh, bool hit, int32_t value) {
  const unsigned b = __ballot_sync(ROOTS_FULL, hit);
  if (b == 0u) return;
  const int lane = threadIdx.x & 31, leader = __ffs(b) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(&sh.count, __popc(b));
  base = __shfl_sync(ROOTS_FULL, base, leader);
  if (hit) {
    const int at = base + __popc(b & ((1u << lane) - 1u));
    if (at < ROOTS_LIST_CAP) sh.list[at] = value;
  }
}

__device__ __forceinline__ unsigned long long roots_block_min(unsigned long long v, RootsShared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int d = 16; d > 0; d >>= 1) {
    const unsigned long long o = __shfl_xor_sync(ROOTS_FULL, v, d);
    v = o < v ? o : v;
  }
  if (lane == 0) sh.warp_key[warp] = v;
  __syncthreads();
  v = sh.warp_key[0];
  for (int w = 1; w < ROOTS_WARPS; ++w) v = sh.warp_key[w] < v ? sh.warp_key[w] : v;
  __syncthreads();
  return v;
}

// dst[0..k) = the k smallest non-sentinel value(p), p in [0, m), ascending,
// the sentinel where there are fewer: round t takes the least key
// (value << 32 | p) above the last one taken, so equal values are taken one
// by one, as a top-k takes them.
template <typename Value>
__device__ void roots_pick_rounds(Value value, int m, int k, int32_t* dst, RootsShared& sh) {
  unsigned long long lo = 0ULL;
  for (int t = 0; t < k; ++t) {
    unsigned long long best = ~0ULL;
    for (int p = threadIdx.x; p < m; p += ROOTS_THREADS) {
      const int32_t v = value(p);
      const unsigned long long key = ((unsigned long long)(uint32_t)v << 32) | (uint32_t)p;
      if (v != MAMRI_BIG && key >= lo && key < best) best = key;
    }
    best = roots_block_min(best, sh);
    if (best == ~0ULL) {  // no value left: the same in every thread
      for (int u = t + threadIdx.x; u < k; u += ROOTS_THREADS) dst[u] = MAMRI_BIG;
      return;
    }
    if (threadIdx.x == 0) dst[t] = (int32_t)(best >> 32);
    lo = best + 1;
  }
}

// dst[0..k) from the n <= ROOTS_LIST_CAP values of the list.
__device__ void roots_pick_list(RootsShared& sh, int n, int k, int32_t* dst) {
  if (n > ROOTS_RANK_MAX) {
    roots_pick_rounds([&](int p) { return sh.list[p]; }, n, k, dst, sh);
    return;
  }
  for (int t = (n < k ? n : k) + threadIdx.x; t < k; t += ROOTS_THREADS) dst[t] = MAMRI_BIG;
  for (int i = threadIdx.x; i < n; i += ROOTS_THREADS) {
    const int32_t v = sh.list[i];
    int rank = 0;
    for (int q = 0; q < n && rank < k; ++q) {
      const int32_t w = sh.list[q];
      rank += w < v || (w == v && q < i);
    }
    if (rank < k) dst[rank] = v;
  }
}

// The root at (i, j, kk) with label l, or the sentinel. `target` is
// kk*nx*ny + j*nx + i.
__device__ __forceinline__ int32_t roots_test(int32_t l, long long target) {
  return l != MAMRI_BIG && (long long)l == target ? l : MAMRI_BIG;
}

// blockIdx.x = slab * chunks + chunk; the chunk is rows [chunk*rows, ...) of
// the slab's 8*nyp rows. scratch: (slabs, chunks, k + 1) rows, then the
// slabs' tickets (zero on entry where chunks > 1).
template <bool VEC>
__global__ void __launch_bounds__(ROOTS_THREADS)
    roots_kernel(const int32_t* __restrict__ lab, int32_t* __restrict__ out, int32_t* __restrict__ scratch,
                 unsigned int* __restrict__ tickets, int nyp, int nzp, int nx, int ny, int k, int rows,
                 int chunks) {
  __shared__ RootsShared sh;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slab = blockIdx.x / chunks, chunk = blockIdx.x - slab * chunks;
  const int row0 = chunk * rows;
  const int nrows = min(rows, 8 * nyp - row0);
  const long long nxny = (long long)nx * ny;
  const int32_t* chunk_lab = lab + ((long long)slab * 8 * nyp + row0) * nzp;
  if (threadIdx.x == 0) sh.count = 0;
  __syncthreads();

  // the warp's rows are warp, warp + ROOTS_WARPS, ...; item (m, u) is the u-th
  // load of a lane in the warp's m-th row, taken in order ROOTS_LOADS at a time
  constexpr int W = VEC ? 4 : 1;  // cells a load
  const int per_row = (nzp / W + 31) >> 5;
  const int my_rows = nrows > warp ? (nrows - warp + ROOTS_WARPS - 1) / ROOTS_WARPS : 0;
  const int items = my_rows * per_row;
  int u = 0, r = warp;                                   // the next item's load and row in the chunk
  int gi = (row0 + warp) / nyp, gj = (row0 + warp) % nyp;  // that row's x within the slab, and y
  for (int q0 = 0; q0 < items; q0 += ROOTS_LOADS) {
    int32_t v[ROOTS_LOADS][W];
    long long target[ROOTS_LOADS];
#pragma unroll
    for (int s = 0; s < ROOTS_LOADS; ++s) {
      const int kk = (u * 32 + lane) * W;
      target[s] = (long long)kk * nxny + (long long)gj * nx + (slab * 8 + gi);
#pragma unroll
      for (int c = 0; c < W; ++c) v[s][c] = MAMRI_BIG;
      if (q0 + s < items && kk < nzp) {
        const int32_t* p = chunk_lab + (long long)r * nzp + kk;
        if constexpr (VEC) {
          const int4 x = *reinterpret_cast<const int4*>(p);
          v[s][0] = x.x, v[s][1] = x.y, v[s][2] = x.z, v[s][3] = x.w;
        } else {
          v[s][0] = *p;
        }
      }
      if (++u == per_row) {  // on to the warp's next row: ROOTS_WARPS rows on
        u = 0;
        r += ROOTS_WARPS;
        gj += ROOTS_WARPS;
        while (gj >= nyp) gj -= nyp, ++gi;
      }
    }
    bool any = false;
#pragma unroll
    for (int s = 0; s < ROOTS_LOADS; ++s)
#pragma unroll
      for (int c = 0; c < W; ++c) {
        v[s][c] = roots_test(v[s][c], target[s] + c * nxny);
        any |= v[s][c] != MAMRI_BIG;
      }
    if (__any_sync(ROOTS_FULL, any)) {
#pragma unroll
      for (int s = 0; s < ROOTS_LOADS; ++s)
#pragma unroll
        for (int c = 0; c < W; ++c) roots_append(sh, v[s][c] != MAMRI_BIG, v[s][c]);
    }
  }
  __syncthreads();

  const int n = sh.count;
  int32_t* dst = chunks == 1 ? out + (long long)slab * (k + 1) : scratch + (long long)blockIdx.x * (k + 1);
  if (n <= ROOTS_LIST_CAP) {
    roots_pick_list(sh, n, k, dst);
  } else {
    const auto cell = [&](int p) {  // the root at cell p of the chunk, or the sentinel
      const int rr = p / nzp, kk = p - rr * nzp;
      const int g = row0 + rr, i = slab * 8 + g / nyp, j = g % nyp;
      return roots_test(chunk_lab[p], (long long)kk * nxny + (long long)j * nx + i);
    };
    roots_pick_rounds(cell, nrows * nzp, k, dst, sh);
  }
  if (threadIdx.x == 0) dst[k] = n;
  if (chunks == 1 || !mamri_last_block(tickets + slab, (unsigned int)chunks)) return;

  // the slab's merge: its chunks' picks are the candidates, their counts sum
  const int32_t* part = scratch + (long long)slab * chunks * (k + 1);
  if (threadIdx.x == 0) sh.count = 0, sh.total = 0;
  __syncthreads();
  int total = 0;
  for (int c = threadIdx.x; c < chunks; c += ROOTS_THREADS) total += __ldcg(part + (long long)c * (k + 1) + k);
  if (total) atomicAdd(&sh.total, total);
  const int m = chunks * k;
  const auto candidate = [&](int p) {
    const int c = p / k;
    return __ldcg(part + (long long)c * (k + 1) + (p - c * k));
  };
  for (int p0 = 0; p0 < m; p0 += ROOTS_THREADS) {  // warp-uniform bounds: every lane appends
    const int p = p0 + threadIdx.x;
    const int32_t val = p < m ? candidate(p) : MAMRI_BIG;
    roots_append(sh, val != MAMRI_BIG, val);
  }
  __syncthreads();
  int32_t* row = out + (long long)slab * (k + 1);
  if (sh.count <= ROOTS_LIST_CAP) roots_pick_list(sh, sh.count, k, row);
  else roots_pick_rounds(candidate, m, k, row, sh);
  if (threadIdx.x == 0) row[k] = sh.total;
}

// scratch: slabs * chunks * (k + 1) + slabs words, chunks = ceil(8*nyp / rows).
extern "C" int mamri_root_candidates(const int32_t* lab, int32_t* out, int32_t* scratch, int slabs, int nyp,
                                     int nzp, int nx, int ny, int k, int rows, cudaStream_t stream) {
  if (k < 1 || k > ROOTS_MAX_K || rows < 1 || slabs < 1 || nyp < 1 || nzp < 1) return (int)cudaErrorInvalidValue;
  const int chunks = (8 * nyp + rows - 1) / rows;
  unsigned int* tickets = (unsigned int*)(scratch + (long long)slabs * chunks * (k + 1));
  if (chunks > 1) {
    const cudaError_t err = cudaMemsetAsync(tickets, 0, (size_t)slabs * sizeof(unsigned int), stream);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned int blocks = (unsigned int)((long long)slabs * chunks);
  if (nzp % 4 == 0 && ((uintptr_t)lab & 15) == 0)
    roots_kernel<true><<<blocks, ROOTS_THREADS, 0, stream>>>(lab, out, scratch, tickets, nyp, nzp, nx, ny, k,
                                                             rows, chunks);
  else
    roots_kernel<false><<<blocks, ROOTS_THREADS, 0, stream>>>(lab, out, scratch, tickets, nyp, nzp, nx, ny, k,
                                                              rows, chunks);
  return (int)cudaGetLastError();
}

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
// One block per slab, as the TPU's grid. A slab is contiguous in memory, so
// thread t reads cells t, t + blockDim, ... (coalesced) and decodes (i, j, k)
// only for foreground cells. Each thread keeps its own k smallest roots in a
// sorted list (roots are rare, so insertions are rare); the block then picks
// the slab's k smallest in k rounds of a block-wide min over the threads'
// list heads (roots are unique raster indices: exactly one thread advances).
//
// What bounds it on the card: one read of the labels. With one block per
// slab the grid is nxp/8 blocks (32 at 256^3), under the 132 SMs, so a slab
// is read by one SM at its own rate; splitting a slab over several blocks
// with a merge pass is the obvious next step.

#include "common.cuh"

#define ROOTS_THREADS 1024
#define ROOTS_MAX_K 64

__global__ void __launch_bounds__(ROOTS_THREADS)
    roots_kernel(const int32_t* __restrict__ lab, int32_t* __restrict__ out, int nyp, int nzp,
                 int nx, int ny, int k) {
  __shared__ int32_t warp_min[32];
  __shared__ int32_t round_min;
  __shared__ int32_t block_count;

  const int slab = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) block_count = 0;
  __syncthreads();

  const long long plane = (long long)nyp * nzp;
  const long long cells = 8 * plane;
  const int32_t* slab_lab = lab + (long long)slab * cells;
  const long long nxny = (long long)nx * ny;

  int32_t mine[ROOTS_MAX_K];  // this thread's smallest roots, ascending
  int held = 0, count = 0;
  for (long long t = threadIdx.x; t < cells; t += ROOTS_THREADS) {
    const int32_t l = slab_lab[t];
    if (l == MAMRI_BIG) continue;
    const long long i = slab * 8 + t / plane;
    const long long rem = t % plane;
    const long long j = rem / nzp, kk = rem % nzp;
    if ((long long)l != kk * nxny + j * nx + i) continue;
    ++count;
    if (held == k && l >= mine[k - 1]) continue;
    int p = held < k ? held++ : k - 1;  // insert l, dropping the largest when full
    while (p > 0 && mine[p - 1] > l) {
      mine[p] = mine[p - 1];
      --p;
    }
    mine[p] = l;
  }
  if (count) atomicAdd(&block_count, count);

  int32_t* row = out + (long long)slab * (k + 1);
  int head = 0;
  for (int t = 0; t < k; ++t) {
    int32_t v = head < held ? mine[head] : MAMRI_BIG;
    v = __reduce_min_sync(0xffffffffu, v);
    if (lane == 0) warp_min[warp] = v;
    __syncthreads();
    if (warp == 0) {
      v = __reduce_min_sync(0xffffffffu, warp_min[lane]);
      if (lane == 0) round_min = v;
    }
    __syncthreads();
    const int32_t m = round_min;
    if (threadIdx.x == 0) row[t] = m;
    if (m != MAMRI_BIG && head < held && mine[head] == m) ++head;
  }
  __syncthreads();
  if (threadIdx.x == 0) row[k] = block_count;
}

extern "C" int mamri_root_candidates(const int32_t* lab, int32_t* out, int nblocks, int nyp, int nzp,
                                     int nx, int ny, int k, cudaStream_t stream) {
  if (k < 1 || k > ROOTS_MAX_K) return (int)cudaErrorInvalidValue;
  roots_kernel<<<nblocks, ROOTS_THREADS, 0, stream>>>(lab, out, nyp, nzp, nx, ny, k);
  return (int)cudaGetLastError();
}

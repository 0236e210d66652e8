// Per-component voxel statistics [count, sum_i, sum_j, sum_k] per root.
//
// Replaces, in mamri_tpu/perception/pallas_ops.py:
//   :1046 component_stats_matmul_xyz (`_stats_kernel_xyz` :1000) -> order 0
//   :964  component_stats_matmul     (`_stats_kernel` :935)      -> order 1
//
// Labels come flattened either in the volume's own (x, y, z) C-order (order
// 0: f = (i*ny + j)*nz + k) or in (z, y, x) raster order (order 1: f =
// (k*ny + j)*nx + i); (i, j, k) is decoded from the flat position. A voxel
// counts towards the roots equal to its label. The TPU contracts an (R,
// block) one-hot with the features on the MXU, exact only while partial sums
// stay below 2^24; here every sum is an exact int64 and is rounded to f32
// once, at the end.
//
// Each voxel finds its row by binary search in the ascending copy of the
// roots (`sorted`, made by the wrapper). Blocks accumulate in shared memory
// (R x 4 int64, 128 KB at R = 4096), so a large component's voxels do not
// serialise on four global counters: a warp whose 32 voxels share one row
// adds its warp-reduced sums with one shared atomic per feature, other warps
// add per voxel. At the end each block adds its non-zero rows to the global
// int64 accumulator, and a last pass writes row r of the f32 output from the
// first occurrence of roots[r] in `sorted`, so a repeated root gets its
// value's stats in every row, as the one-hot product gives. Rows whose root
// is the sentinel are zero (sentinel voxels are skipped): on the TPU they
// count background and a block-size-dependent padding that no caller reads.
//
// What bounds it on the card: one read of the labels (4 bytes a voxel); the
// search touches only the few-KB roots array, which stays in L1.

#include "common.cuh"

#define STATS_THREADS 512

__device__ __forceinline__ int stats_lower_bound(const int32_t* __restrict__ a, int n, int32_t v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(STATS_THREADS)
    stats_kernel(const int32_t* __restrict__ lab, long long n, const int32_t* __restrict__ sorted,
                 int num_roots, int nx, int ny, int nz, int order,
                 unsigned long long* __restrict__ acc) {
  extern __shared__ unsigned long long sacc[];  // (num_roots, 4)
  for (int r = threadIdx.x; r < 4 * num_roots; r += STATS_THREADS) sacc[r] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (STATS_THREADS / 32);
  const long long chunks = (n + 31) / 32;
  for (long long c = (long long)blockIdx.x * (STATS_THREADS / 32) + (threadIdx.x >> 5); c < chunks;
       c += warps) {
    const long long f = c * 32 + lane;
    int row = -1;
    int gi = 0, gj = 0, gk = 0;
    if (f < n) {
      const int32_t l = lab[f];
      if (l != MAMRI_BIG) {
        const int r = stats_lower_bound(sorted, num_roots, l);
        if (r < num_roots && sorted[r] == l) {
          row = r;
          if (order == 0) {
            gi = (int)(f / ((long long)ny * nz));
            const long long rem = f - (long long)gi * ny * nz;
            gj = (int)(rem / nz);
            gk = (int)(rem - (long long)gj * nz);
          } else {
            gi = (int)(f % nx);
            gj = (int)((f / nx) % ny);
            gk = (int)(f / ((long long)nx * ny));
          }
        }
      }
    }
    const int row0 = __shfl_sync(0xffffffffu, row, 0);
    if (__all_sync(0xffffffffu, row == row0)) {
      if (row0 < 0) continue;
      // 32 voxels of one row: the sums fit in 32 bits
      const unsigned int si = __reduce_add_sync(0xffffffffu, (unsigned int)gi);
      const unsigned int sj = __reduce_add_sync(0xffffffffu, (unsigned int)gj);
      const unsigned int sk = __reduce_add_sync(0xffffffffu, (unsigned int)gk);
      if (lane == 0) {
        unsigned long long* a = sacc + 4 * row0;
        atomicAdd(a + 0, 32ULL);
        atomicAdd(a + 1, (unsigned long long)si);
        atomicAdd(a + 2, (unsigned long long)sj);
        atomicAdd(a + 3, (unsigned long long)sk);
      }
    } else if (row >= 0) {
      unsigned long long* a = sacc + 4 * row;
      atomicAdd(a + 0, 1ULL);
      atomicAdd(a + 1, (unsigned long long)gi);
      atomicAdd(a + 2, (unsigned long long)gj);
      atomicAdd(a + 3, (unsigned long long)gk);
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < num_roots; r += STATS_THREADS) {
    const unsigned long long* a = sacc + 4 * r;
    if (a[0] == 0) continue;
    for (int c = 0; c < 4; ++c) atomicAdd(acc + 4LL * r + c, a[c]);
  }
}

__global__ void stats_finalize_kernel(const unsigned long long* __restrict__ acc,
                                      const int32_t* __restrict__ roots,
                                      const int32_t* __restrict__ sorted, int num_roots,
                                      float* __restrict__ out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= num_roots) return;
  const int32_t v = roots[r];
  const int first = stats_lower_bound(sorted, num_roots, v);
  for (int c = 0; c < 4; ++c)
    out[4 * r + c] = v == MAMRI_BIG ? 0.0f : (float)(long long)acc[4LL * first + c];
}

extern "C" int mamri_component_stats(const int32_t* lab, long long n, const int32_t* roots,
                                     const int32_t* sorted, int num_roots, int nx, int ny, int nz,
                                     int order, unsigned long long* acc, float* out,
                                     cudaStream_t stream) {
  const size_t smem = (size_t)num_roots * 4 * sizeof(unsigned long long);
  cudaError_t err = cudaFuncSetAttribute(stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  // a few blocks per SM; each zeroes and flushes its (R, 4) table once
  const long long chunks = (n + 31) / 32;
  long long blocks = (chunks + STATS_THREADS / 32 - 1) / (STATS_THREADS / 32);
  const long long most = 4LL * (sms > 0 ? sms : 132);
  if (blocks > most) blocks = most;
  if (blocks < 1) blocks = 1;
  stats_kernel<<<(unsigned int)blocks, STATS_THREADS, smem, stream>>>(lab, n, sorted, num_roots, nx,
                                                                      ny, nz, order, acc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stats_finalize_kernel<<<mamri_blocks(num_roots), MAMRI_THREADS, 0, stream>>>(acc, roots, sorted,
                                                                              num_roots, out);
  return (int)cudaGetLastError();
}

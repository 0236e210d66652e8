// z-run tables, root candidates and per-component run statistics.
//
// Replaces, in mamri_tpu/perception/pallas_ops.py:
//   :713 extract_z_runs           (`_runs_kernel` :632)              -> z_runs
//   :816 run_stats_matmul         (`_run_stats_kernel` :783)         -> run_stats (dense)
//   :893 run_stats_matmul_compact (`_run_stats_compact_kernel` :865) -> run_stats (compact)
//
// z_runs: one CUDA block per (8 x-lines x 128 y-lines) block of the padded
// volume -- the TPU's grid, so `block_counts`, the `cand_ok` certificate and
// `num_components` mean the same thing. One thread walks one z line and
// writes its first k maximal runs as (label at the start, z0, len = dbz at
// the start) into (nxp, k, nyq) tables, nyq = ny padded to 128 (the padding
// lines are written empty without being read). A run is its component's root
// run iff its label equals z0*nx*ny + y*nx + (x + x_off): the root is the
// component's minimum raster index, and a root has no -z neighbour in its
// component, so it starts a run. The block then picks its cand_k smallest
// roots: a line's roots ascend with z0, so each thread offers its smallest
// unpicked root and a block-wide min picks one per round (cand_k rounds).
// The maximum number of runs in any line goes to one atomicMax.
//
// run_stats: one thread per run slot; binary search of the label in the
// ascending roots; atomicAdd of the four features [len, i*len, j*len,
// z0*len + len*(len-1)/2] in int64, so every sum is exact (the TPU's f32
// one-hot matmul is exact only below 2^24). A last pass writes f32 (R, 4),
// giving repeated roots the row of their first occurrence, as the one-hot
// product would.
//
// What bounds them on the card: z_runs is one read of the labels and the two
// z distance arrays (each thread walks contiguous memory; runs are skipped
// in one step from their length) plus the small tables; run_stats reads the
// tables once and its atomics land on few addresses only for large
// components, whose runs are spread over many lines.

#include "common.cuh"

#define Z_BLOCK_X 8
#define Z_BLOCK_Y 128

__global__ void __launch_bounds__(Z_BLOCK_X * Z_BLOCK_Y)
    z_runs_kernel(const int32_t* __restrict__ lab, const int16_t* __restrict__ dfz,
                  const int16_t* __restrict__ dbz, int32_t* lab_tab, int32_t* z0_tab,
                  int32_t* len_tab, int32_t* __restrict__ root_tab, int32_t* __restrict__ max_runs,
                  int nyp, int nz, int nyq, int k, int cand_k, int nx, int ny, int x_off) {
  __shared__ int32_t warp_min[32];
  __shared__ int32_t round_min;
  __shared__ int32_t block_roots;
  __shared__ int32_t block_max_runs;

  const int row = blockIdx.x;
  const int nby = nyq / Z_BLOCK_Y;
  const int x = (row / nby) * Z_BLOCK_X + threadIdx.x / Z_BLOCK_Y;
  const int y = (row % nby) * Z_BLOCK_Y + threadIdx.x % Z_BLOCK_Y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    block_roots = 0;
    block_max_runs = 0;
  }
  __syncthreads();

  const long long nxny = (long long)nx * ny;
  const long long lin_xy = (long long)y * nx + (x + x_off);  // raster index minus z0*nx*ny
  const long long slot0 = (long long)x * k * nyq + y;        // slot r is slot0 + r*nyq
  int runs = 0, roots = 0, head_rank = -1;
  int32_t head = MAMRI_BIG;  // this line's smallest root not picked yet
  if (y < nyp) {
    const long long base = ((long long)x * nyp + y) * nz;
    int z = 0;
    while (z < nz) {
      if (dfz[base + z] != 1) {  // not a run start
        ++z;
        continue;
      }
      const int len = dbz[base + z];
      if (runs < k) {
        const int32_t l = lab[base + z];
        const long long s = slot0 + (long long)runs * nyq;
        lab_tab[s] = l;
        z0_tab[s] = z;
        len_tab[s] = len;
        if (l != MAMRI_BIG && (long long)l == z * nxny + lin_xy) {
          ++roots;
          if (head == MAMRI_BIG) {
            head = l;
            head_rank = runs;
          }
        }
      }
      ++runs;
      z += len > 0 ? len : 1;
    }
  }
  for (int r = runs; r < k; ++r) {
    const long long s = slot0 + (long long)r * nyq;
    lab_tab[s] = MAMRI_BIG;
    z0_tab[s] = 0;
    len_tab[s] = 0;
  }
  if (roots) atomicAdd(&block_roots, roots);
  atomicMax(&block_max_runs, runs);

  int32_t* out = root_tab + (long long)row * (cand_k + 1);
  const int filled = runs < k ? runs : k;
  for (int t = 0; t < cand_k; ++t) {
    int32_t v = __reduce_min_sync(0xffffffffu, head);
    if (lane == 0) warp_min[warp] = v;
    __syncthreads();
    if (warp == 0) {
      v = __reduce_min_sync(0xffffffffu, warp_min[lane]);
      if (lane == 0) round_min = v;
    }
    __syncthreads();
    const int32_t m = round_min;
    if (threadIdx.x == 0) out[t] = m;
    if (m == MAMRI_BIG) {  // uniform across the block: every later pick is empty too
      if (threadIdx.x == 0)
        for (int u = t + 1; u < cand_k; ++u) out[u] = MAMRI_BIG;
      break;
    }
    if (head == m) {  // roots are unique raster indices: exactly one thread advances
      head = MAMRI_BIG;
      for (int r = head_rank + 1; r < filled; ++r) {
        const long long s = slot0 + (long long)r * nyq;
        const int32_t l = lab_tab[s];
        if (l != MAMRI_BIG && (long long)l == z0_tab[s] * nxny + lin_xy) {
          head = l;
          head_rank = r;
          break;
        }
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    out[cand_k] = block_roots;
    atomicMax(max_runs, block_max_runs);
  }
}

__device__ __forceinline__ int mamri_lower_bound(const int32_t* __restrict__ a, int n, int32_t v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// gi/gj null: dense (nxp, k, nyq) table, coordinates from the slot position
// (gi = p / (k*nyq), gj = p % nyq); otherwise a compacted table carrying them.
__global__ void run_stats_kernel(const int32_t* __restrict__ lab, const int32_t* __restrict__ len,
                                 const int32_t* __restrict__ z0, const int32_t* __restrict__ gi_c,
                                 const int32_t* __restrict__ gj_c, long long m, int kny, int nyq,
                                 const int32_t* __restrict__ roots, int num_roots,
                                 unsigned long long* __restrict__ acc) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= m) return;
  const long long l = len[p];
  if (l <= 0) return;  // empty slot: every feature is 0
  const int32_t label = lab[p];
  const int r = mamri_lower_bound(roots, num_roots, label);
  if (r == num_roots || roots[r] != label) return;
  const long long gi = gi_c ? (long long)gi_c[p] : p / kny;
  const long long gj = gj_c ? (long long)gj_c[p] : p % nyq;
  unsigned long long* a = acc + 4LL * r;
  atomicAdd(a + 0, (unsigned long long)l);
  atomicAdd(a + 1, (unsigned long long)(gi * l));
  atomicAdd(a + 2, (unsigned long long)(gj * l));
  atomicAdd(a + 3, (unsigned long long)((long long)z0[p] * l + l * (l - 1) / 2));
}

__global__ void run_stats_finalize_kernel(const unsigned long long* __restrict__ acc,
                                          const int32_t* __restrict__ roots, int num_roots,
                                          float* __restrict__ out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= num_roots) return;
  const int first = mamri_lower_bound(roots, num_roots, roots[r]);
  for (int c = 0; c < 4; ++c) out[4 * r + c] = (float)(long long)acc[4LL * first + c];
}

extern "C" int mamri_z_runs(const int32_t* lab, const int16_t* dfz, const int16_t* dbz,
                            int32_t* lab_tab, int32_t* z0_tab, int32_t* len_tab, int32_t* root_tab,
                            int32_t* max_runs, int nxp, int nyp, int nz, int nyq, int k,
                            int cand_k, int nx, int ny, int x_off, cudaStream_t stream) {
  const unsigned int blocks = (unsigned int)((nxp / Z_BLOCK_X) * (nyq / Z_BLOCK_Y));
  z_runs_kernel<<<blocks, Z_BLOCK_X * Z_BLOCK_Y, 0, stream>>>(lab, dfz, dbz, lab_tab, z0_tab,
                                                              len_tab, root_tab, max_runs, nyp, nz,
                                                              nyq, k, cand_k, nx, ny, x_off);
  return (int)cudaGetLastError();
}

extern "C" int mamri_run_stats(const int32_t* lab, const int32_t* len, const int32_t* z0,
                               const int32_t* gi_c, const int32_t* gj_c, long long m, int kny,
                               int nyq, const int32_t* roots, int num_roots,
                               unsigned long long* acc, float* out, cudaStream_t stream) {
  run_stats_kernel<<<mamri_blocks(m), MAMRI_THREADS, 0, stream>>>(lab, len, z0, gi_c, gj_c, m, kny,
                                                                  nyq, roots, num_roots, acc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  run_stats_finalize_kernel<<<mamri_blocks(num_roots), MAMRI_THREADS, 0, stream>>>(
      acc, roots, num_roots, out);
  return (int)cudaGetLastError();
}

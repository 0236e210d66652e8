// z-run tables, root candidates and per-component run statistics.
//
// Replaces, in mamri_tpu/perception/pallas_ops.py:
//   :713 extract_z_runs           (`_runs_kernel` :632)              -> z_runs
//   :816 run_stats_matmul         (`_run_stats_kernel` :783)         -> run_stats (dense)
//   :893 run_stats_matmul_compact (`_run_stats_compact_kernel` :865) -> run_stats (compact)
//
// z_runs: the first k maximal runs of every z line as (label at the start,
// z0, len = dbz at the start) in (nxp, k, nyq) tables, nyq = ny padded to 128
// (the padding lines are written empty without being read), the cand_k
// smallest roots and the root count of every (8 x-lines x 128 y-lines) block
// of the padded volume -- the TPU's grid, so `block_counts`, the `cand_ok`
// certificate and `num_components` mean the same thing -- and the maximum
// number of runs in any line (one atomicMax a warp at most). A run is its
// component's root run iff its label equals z0*nx*ny + y*nx + (x + x_off):
// the root is the component's minimum raster index, and a root has no -z
// neighbour in its component, so it starts a run. Two launches: the scan is
// cut into warp tasks of 32 lines so that it fills the card whatever the
// number of (8, 128) blocks, and the roots are picked per (8, 128) block from
// the tables it wrote.
//
// run_stats: every run adds the four features [len, i*len, j*len,
// z0*len + len*(len-1)/2] to the row its label has among the ascending roots,
// in int64, so every sum is exact (the TPU's f32 one-hot matmul is exact only
// below 2^24). One kernel behind a memset: blocks sum in shared memory, and
// the one that finishes last writes f32 (R, 4), giving repeated roots the row
// of their first occurrence, as the one-hot product would.
//
// What bounds them on the card: bytes. z_runs' contract moves 8 B a voxel
// (labels, dfz, dbz) plus the tables; the scan reads dfz alone, coalesced,
// and fetches labels and dbz only at the starts of the runs it keeps, and
// the table rows are written 128 B a warp. run_stats reads the lengths once,
// 16 bytes a thread, and the rest of a slot only where a run stands (most
// slots are empty); at a few MB its time is its launches and the chain of
// dependent memory round trips in it, so it is one kernel behind a memset,
// and a large component's runs meet in a warp reduction and a block's
// shared-memory row before they reach global memory.

#include "common.cuh"

#define Z_BLOCK_X 8
#define Z_BLOCK_Y 128
#define ZR_SCAN_WARPS 4     // warp tasks (32 lines each) per block of the scan
#define ZR_LOADS 8          // dfz loads a lane keeps in flight
#define ZR_RANKS 8          // ranks a lane resolves before it fetches their labels
#define ZR_PICK_THREADS 1024
#define ZR_PICK_LOADS 8     // table slots a thread reads at a time
#define ZR_LIST_CAP 8192    // roots of one block kept in shared memory for the pick
#define ZR_FULL 0xffffffffu

// Scan: a warp owns 32 lines of neighbouring y at one x. It reads their dfz
// 8 bytes a lane (128 voxels a warp load), packs "a run starts here"
// (dfz == 1) into words of 32 voxels (a lane's 4 bits, ORed over 8 lanes) and
// keeps them in shared memory, [word][line] with a padded row. Then lane j
// takes line y0 + j: rank after rank it finds its next start with __ffs,
// fetches that run's label and dbz, and the warp writes the rank's slots of
// its 32 lines as one row.
__global__ void __launch_bounds__(ZR_SCAN_WARPS * 32)
    z_runs_scan_kernel(const int32_t* __restrict__ lab, const int16_t* __restrict__ dfz,
                       const int16_t* __restrict__ dbz, int32_t* __restrict__ lab_tab,
                       int32_t* __restrict__ z0_tab, int32_t* __restrict__ len_tab,
                       int32_t* __restrict__ max_runs, int nxp, int nyp, int nz, int nyq, int k) {
  extern __shared__ uint32_t zr_smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwords = nz >> 5, steps = nz >> 7, tiles_y = nyq >> 5;
  const long long task = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (task >= (long long)nxp * tiles_y) return;  // the whole warp; the block never meets
  const int x = (int)(task / tiles_y), y0 = (int)(task % tiles_y) * 32;
  uint32_t* masks = zr_smem + (size_t)warp * nwords * 33;

  for (int t0 = 0; t0 < 32 * steps; t0 += ZR_LOADS) {  // t = line * steps + step
    uint2 w[ZR_LOADS];
#pragma unroll
    for (int u = 0; u < ZR_LOADS; ++u) {
      const int j = (t0 + u) / steps, s = (t0 + u) - j * steps;
      w[u] = make_uint2(0u, 0u);
      if (y0 + j < nyp)
        w[u] = *reinterpret_cast<const uint2*>(dfz + ((long long)x * nyp + y0 + j) * nz + s * 128 +
                                               4 * lane);
    }
#pragma unroll
    for (int u = 0; u < ZR_LOADS; ++u) {
      const int j = (t0 + u) / steps, s = (t0 + u) - j * steps;
      uint32_t bits = ((w[u].x & 0xffffu) == 1u ? 1u : 0u) | ((w[u].x >> 16) == 1u ? 2u : 0u) |
                      ((w[u].y & 0xffffu) == 1u ? 4u : 0u) | ((w[u].y >> 16) == 1u ? 8u : 0u);
      bits <<= 4 * (lane & 7);
      bits |= __shfl_xor_sync(ZR_FULL, bits, 1);
      bits |= __shfl_xor_sync(ZR_FULL, bits, 2);
      bits |= __shfl_xor_sync(ZR_FULL, bits, 4);
      if ((lane & 7) == 0) masks[(s * 4 + (lane >> 3)) * 33 + j] = bits;
    }
  }
  __syncwarp();

  const int y = y0 + lane;
  int total = 0;
  for (int wd = 0; wd < nwords; ++wd) total += __popc(masks[wd * 33 + lane]);
  total = __reduce_max_sync(ZR_FULL, total);
  if (lane == 0 && total > *(volatile int32_t*)max_runs) atomicMax(max_runs, total);

  const long long base = ((long long)x * nyp + y) * nz;  // read only where the line has a start
  const long long slot0 = (long long)x * k * nyq + y;    // slot r is slot0 + r*nyq
  int wd = 0;
  uint32_t m = masks[lane];
  for (int r0 = 0; r0 < k; r0 += ZR_RANKS) {
    int z[ZR_RANKS];
#pragma unroll
    for (int u = 0; u < ZR_RANKS; ++u) {
      while (m == 0u && wd + 1 < nwords) m = masks[(++wd) * 33 + lane];
      z[u] = -1;
      if (m) {
        z[u] = wd * 32 + __ffs(m) - 1;
        m &= m - 1u;
      }
    }
    int32_t l[ZR_RANKS], ln[ZR_RANKS];
#pragma unroll
    for (int u = 0; u < ZR_RANKS; ++u) {
      l[u] = z[u] >= 0 ? lab[base + z[u]] : MAMRI_BIG;
      ln[u] = z[u] >= 0 ? (int32_t)dbz[base + z[u]] : 0;
    }
#pragma unroll
    for (int u = 0; u < ZR_RANKS; ++u) {
      if (r0 + u < k) {
        const long long s = slot0 + (long long)(r0 + u) * nyq;
        lab_tab[s] = l[u];
        z0_tab[s] = z[u] >= 0 ? z[u] : 0;
        len_tab[s] = ln[u];
      }
    }
  }
}

__device__ __forceinline__ int32_t zr_block_min(int32_t v, int32_t* warp_min) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = __reduce_min_sync(ZR_FULL, v);
  if (lane == 0) warp_min[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = __reduce_min_sync(ZR_FULL, lane < (blockDim.x >> 5) ? warp_min[lane] : MAMRI_BIG);
    if (lane == 0) warp_min[0] = v;
  }
  __syncthreads();
  v = warp_min[0];
  __syncthreads();
  return v;
}

// Roots: one block per (8 x, 128 y)-line block reads its slots of the tables
// (still in L2), gathers the roots into a list in shared memory and counts
// them. Roots are distinct raster indices, so a root's place among the picks
// is the number of smaller roots: each thread counts that for its roots and
// gives up at cand_k. Only a block with more than ZR_LIST_CAP roots picks in
// cand_k rounds of a block-wide minimum over the tables.
__global__ void __launch_bounds__(ZR_PICK_THREADS)
    z_runs_roots_kernel(const int32_t* __restrict__ lab_tab, const int32_t* __restrict__ z0_tab,
                        int32_t* __restrict__ cands, int32_t* __restrict__ counts,
                        int32_t* __restrict__ num_roots, int nyq, int k, int cand_k, int nx, int ny,
                        int x_off) {
  __shared__ int32_t list[ZR_LIST_CAP];
  __shared__ int32_t warp_min[32];
  __shared__ int count;
  const int row = blockIdx.x, nby = nyq / Z_BLOCK_Y;
  const int x0 = (row / nby) * Z_BLOCK_X, y0 = (row % nby) * Z_BLOCK_Y;
  const int slots = Z_BLOCK_X * k * Z_BLOCK_Y;  // slot p = (xx * k + r) * 128 + yy
  const long long nxny = (long long)nx * ny;
  if (threadIdx.x == 0) count = 0;
  __syncthreads();
  // the root at slot p of the block, or BIG
  auto root_at = [&](int p) -> int32_t {
    const int yy = p & (Z_BLOCK_Y - 1), xr = p / Z_BLOCK_Y;  // xr = xx * k + r
    const int x = x0 + xr / k, y = y0 + yy;
    const long long s = ((long long)x0 * k + xr) * nyq + y;
    const int32_t l = lab_tab[s];
    if (l == MAMRI_BIG) return MAMRI_BIG;
    return (long long)l == z0_tab[s] * nxny + (long long)y * nx + (x + x_off) ? l : MAMRI_BIG;
  };
  for (int p0 = threadIdx.x; p0 < slots; p0 += ZR_PICK_LOADS * blockDim.x) {
    int32_t l[ZR_PICK_LOADS];
#pragma unroll
    for (int u = 0; u < ZR_PICK_LOADS; ++u) {
      const int p = p0 + u * blockDim.x;
      l[u] = p < slots ? root_at(p) : MAMRI_BIG;
    }
#pragma unroll
    for (int u = 0; u < ZR_PICK_LOADS; ++u) {
      if (l[u] != MAMRI_BIG) {
        const int at = atomicAdd(&count, 1);
        if (at < ZR_LIST_CAP) list[at] = l[u];
      }
    }
  }
  __syncthreads();
  const int n = count;
  int32_t* out = cands + (long long)row * cand_k;
  if (threadIdx.x == 0) {
    counts[row] = n;
    if (n) atomicAdd(num_roots, n);
  }
  for (int t = (n < cand_k ? n : cand_k) + threadIdx.x; t < cand_k; t += blockDim.x) out[t] = MAMRI_BIG;
  if (n <= ZR_LIST_CAP) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int32_t v = list[i];
      int rank = 0;
      for (int j = 0; j < n && rank < cand_k; ++j) rank += list[j] < v;
      if (rank < cand_k) out[rank] = v;
    }
    return;
  }
  long long prev = -1;  // the last pick
  for (int t = 0; t < cand_k; ++t) {  // a round with no root left picks BIG
    int32_t best = MAMRI_BIG;
    for (int p = threadIdx.x; p < slots; p += blockDim.x) {
      const int32_t l = root_at(p);
      if (l > prev && l < best) best = l;
    }
    best = zr_block_min(best, warp_min);
    if (threadIdx.x == 0) out[t] = best;
    prev = best;
  }
}

// run_stats. A thread takes four neighbouring slots: their lengths come as one
// 16-byte load, and label, z0 (and gi, gj of a compacted table) are fetched
// only where the length is positive. The lane sums its slots of one root, the
// warp reduces where all its lanes hold the same root (a large component's
// neighbouring lines), and a block sums in shared memory ((R, 4) int64 beside
// the roots, 36 bytes a root) and adds its non-zero rows to the global
// accumulator once; the block that finishes last writes the f32 rows. Above
// RS_SHARED_ROOTS roots a block searches and adds in global memory.
// gi/gj null: dense (nxp, k, nyq) table, coordinates from the slot position
// (gi = p / (k*nyq), gj = p % nyq); otherwise a compacted table carrying them.
#define RS_THREADS 1024
#define RS_SLOTS 4            // slots a thread takes at a time
#define RS_SHARED_ROOTS 4096  // 144 KB of shared memory

__device__ __forceinline__ void run_stats_add(unsigned long long* __restrict__ tab, int row,
                                              const unsigned long long* f) {
  for (int c = 0; c < 4; ++c) atomicAdd(tab + 4LL * row + c, f[c]);
}

// the lengths of slots p .. p + 3 (0 past the end of the table)
__device__ __forceinline__ int4 run_stats_lengths(const int32_t* __restrict__ len, long long m, long long p) {
  int4 l = make_int4(0, 0, 0, 0);
  if (p + RS_SLOTS <= m && ((uintptr_t)(len + p) & 15) == 0) {
    l = *reinterpret_cast<const int4*>(len + p);
  } else {
    if (p + 0 < m) l.x = len[p + 0];
    if (p + 1 < m) l.y = len[p + 1];
    if (p + 2 < m) l.z = len[p + 2];
    if (p + 3 < m) l.w = len[p + 3];
  }
  return l;
}

__global__ void __launch_bounds__(RS_THREADS)
    run_stats_kernel(const int32_t* __restrict__ lab, const int32_t* __restrict__ len,
                     const int32_t* __restrict__ z0, const int32_t* __restrict__ gi_c,
                     const int32_t* __restrict__ gj_c, long long m, int kny, int nyq,
                     const int32_t* __restrict__ roots, int num_roots, int in_shared,
                     unsigned long long* __restrict__ acc, unsigned int* __restrict__ ticket,
                     float* __restrict__ out) {
  extern __shared__ unsigned long long rs_smem[];  // (R, 4) sums, then the R roots
  const long long step = (long long)gridDim.x * RS_THREADS * RS_SLOTS;
  // p0: the warp's first slot, so that a warp stays together
  long long p0 = ((long long)blockIdx.x * RS_THREADS + (threadIdx.x & ~31)) * RS_SLOTS;
  const int lane_slot = (threadIdx.x & 31) * RS_SLOTS;
  int4 l = run_stats_lengths(len, m, p0 + lane_slot);  // in flight while the block sets up its table
  unsigned long long* tab = acc;
  const int32_t* srt = roots;
  if (in_shared) {
    tab = rs_smem;
    int32_t* mine = (int32_t*)(rs_smem + 4LL * num_roots);
    for (int r = threadIdx.x; r < num_roots; r += RS_THREADS) mine[r] = roots[r];
    for (int r = threadIdx.x; r < 4 * num_roots; r += RS_THREADS) tab[r] = 0ULL;
    srt = mine;
    __syncthreads();
  }

  for (; p0 < m; p0 += step, l = run_stats_lengths(len, m, p0 + lane_slot)) {
    const long long p = p0 + lane_slot;
    const int32_t ln[RS_SLOTS] = {l.x, l.y, l.z, l.w};
    int32_t label[RS_SLOTS], start[RS_SLOTS], gi[RS_SLOTS], gj[RS_SLOTS];
#pragma unroll
    for (int q = 0; q < RS_SLOTS; ++q) {
      label[q] = MAMRI_BIG, start[q] = 0, gi[q] = 0, gj[q] = 0;
      if (ln[q] > 0) {  // an empty slot adds nothing
        label[q] = lab[p + q];
        start[q] = z0[p + q];
        gi[q] = gi_c ? gi_c[p + q] : (int32_t)((p + q) / kny);
        gj[q] = gj_c ? gj_c[p + q] : (int32_t)((p + q) % nyq);
      }
    }
    int row = -1;  // the root the lane is summing for, and its sums
    unsigned long long f[4] = {0ULL, 0ULL, 0ULL, 0ULL};
    bool searched = false;  // the last label looked up, and where it stands (-1: among no root)
    int32_t seen = MAMRI_BIG;
    int seen_row = -1;
#pragma unroll
    for (int q = 0; q < RS_SLOTS; ++q) {
      if (ln[q] <= 0) continue;
      if (!searched || label[q] != seen) {
        searched = true;
        seen = label[q];
        seen_row = mamri_lower_bound(srt, num_roots, seen);
        if (seen_row == num_roots || srt[seen_row] != seen) seen_row = -1;
      }
      const int r = seen_row;
      if (r < 0) continue;
      if (r != row) {
        if (row >= 0) run_stats_add(tab, row, f);
        row = r;
        f[0] = f[1] = f[2] = f[3] = 0ULL;
      }
      const long long n = ln[q];
      f[0] += (unsigned long long)n;
      f[1] += (unsigned long long)(gi[q] * n);
      f[2] += (unsigned long long)(gj[q] * n);
      f[3] += (unsigned long long)(start[q] * n + n * (n - 1) / 2);
    }
    const int row0 = __shfl_sync(ZR_FULL, row, 0);
    if (__all_sync(ZR_FULL, row == row0)) {
      if (row0 < 0) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        for (int d = 16; d > 0; d >>= 1) f[c] += __shfl_xor_sync(ZR_FULL, f[c], d);
      if ((threadIdx.x & 31) == 0) run_stats_add(tab, row0, f);
    } else if (row >= 0) {
      run_stats_add(tab, row, f);
    }
  }
  if (in_shared) {
    __syncthreads();
    for (int r = threadIdx.x; r < num_roots; r += RS_THREADS)
      if (tab[4LL * r] != 0ULL) run_stats_add(acc, r, tab + 4LL * r);  // no run: every sum is 0
  }
  if (!mamri_last_block(ticket)) return;
  // entry e = 4 * r + c of the output; a repeated root (the sentinel padding above all) reads the
  // row of its first occurrence. RS_SLOTS entries a thread at a time: their reads fly together
  const int first_big = mamri_lower_bound(srt, num_roots, MAMRI_BIG);
  for (int e0 = threadIdx.x; e0 < 4 * num_roots; e0 += RS_SLOTS * RS_THREADS) {
    unsigned long long sum[RS_SLOTS];
#pragma unroll
    for (int u = 0; u < RS_SLOTS; ++u) {
      const int e = e0 + u * RS_THREADS, r = e >> 2;
      if (e >= 4 * num_roots) continue;
      int first = r;
      if (srt[r] == MAMRI_BIG) first = first_big;
      else if (r > 0 && srt[r - 1] == srt[r]) first = mamri_lower_bound(srt, num_roots, srt[r]);
      sum[u] = __ldcg(acc + 4LL * first + (e & 3));
    }
#pragma unroll
    for (int u = 0; u < RS_SLOTS; ++u)
      if (e0 + u * RS_THREADS < 4 * num_roots) out[e0 + u * RS_THREADS] = (float)(long long)sum[u];
  }
}

// root_tab: the candidates of every (8, 128) block, cand_k each, then the
// blocks' root counts. totals: [max runs in a line, number of roots], zero on
// entry.
extern "C" int mamri_z_runs(const int32_t* lab, const int16_t* dfz, const int16_t* dbz,
                            int32_t* lab_tab, int32_t* z0_tab, int32_t* len_tab, int32_t* root_tab,
                            int32_t* totals, int nxp, int nyp, int nz, int nyq, int k,
                            int cand_k, int nx, int ny, int x_off, cudaStream_t stream) {
  if ((uintptr_t)dfz % 8 != 0) return (int)cudaErrorMisalignedAddress;  // 8-byte loads
  const size_t per_warp = (size_t)(nz / 32) * 33 * sizeof(uint32_t);
  int warps = ZR_SCAN_WARPS;
  while (warps > 1 && warps * per_warp > 48 * 1024) warps >>= 1;  // long lines: fewer a block
  const size_t smem = warps * per_warp;  // at most 135 KB: nz < 32767
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        z_runs_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long tasks = (long long)nxp * (nyq / 32);
  z_runs_scan_kernel<<<(unsigned)((tasks + warps - 1) / warps), warps * 32, smem, stream>>>(
      lab, dfz, dbz, lab_tab, z0_tab, len_tab, totals, nxp, nyp, nz, nyq, k);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((nxp / Z_BLOCK_X) * (nyq / Z_BLOCK_Y));
  z_runs_roots_kernel<<<blocks, ZR_PICK_THREADS, 0, stream>>>(
      lab_tab, z0_tab, root_tab, root_tab + (long long)blocks * cand_k, totals + 1, nyq, k, cand_k,
      nx, ny, x_off);
  return (int)cudaGetLastError();
}

// acc: 4 * num_roots + 1 words of 64 bits (the sums, then the ticket), nothing
// in them on entry. They are cleared here, ahead of the one kernel: its blocks
// start in no order, so none of them could clear what the others add to.
extern "C" int mamri_run_stats(const int32_t* lab, const int32_t* len, const int32_t* z0,
                               const int32_t* gi_c, const int32_t* gj_c, long long m, int kny,
                               int nyq, const int32_t* roots, int num_roots,
                               unsigned long long* acc, float* out, cudaStream_t stream) {
  if (m < 1 || num_roots < 1 || kny < 1 || nyq < 1) return (int)cudaErrorInvalidValue;
  const int in_shared = num_roots <= RS_SHARED_ROOTS;
  const size_t smem = in_shared ? (size_t)num_roots * (4 * sizeof(unsigned long long) + sizeof(int32_t)) : 0;
  cudaError_t err = cudaFuncSetAttribute(run_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(acc, 0, (4 * (size_t)num_roots + 1) * sizeof(unsigned long long), stream);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  // a block per 4096 slots, at most two an SM: few blocks add a large component's row to `acc`
  const long long per_block = (long long)RS_THREADS * RS_SLOTS;
  long long blocks = (m + per_block - 1) / per_block;
  const long long most = 2LL * (sms > 0 ? sms : 132);
  if (blocks > most) blocks = most;
  run_stats_kernel<<<(unsigned int)blocks, RS_THREADS, smem, stream>>>(
      lab, len, z0, gi_c, gj_c, m, kny, nyq, roots, num_roots, in_shared, acc,
      (unsigned int*)(acc + 4LL * num_roots), out);
  return (int)cudaGetLastError();
}

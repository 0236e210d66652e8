// Per-component voxel statistics [count, sum_i, sum_j, sum_k] per root.
//
// Replaces, in mamri_tpu/perception/pallas_ops.py:
//   :1046 component_stats_matmul_xyz (`_stats_kernel_xyz` :1000) -> order 0
//   :964  component_stats_matmul     (`_stats_kernel` :935)      -> order 1
//
// Labels come flattened either in the volume's own (x, y, z) C-order (order
// 0: f = (i*ny + j)*nz + k) or in (z, y, x) raster order (order 1: f =
// (k*ny + j)*nx + i). A voxel counts towards the roots equal to its label.
// The TPU contracts an (R, block) one-hot with the features on the MXU, exact
// only while partial sums stay below 2^24; here every sum is an exact integer
// (32 bits within a block, 64 across blocks) and is rounded to f32 once, at
// the end. Roots come in any order and may repeat: row r of the output holds
// the sums of the value roots[r], as the one-hot product gives. Rows whose
// root is the sentinel are zero (sentinel voxels are skipped): on the TPU they
// count background and a block-size-dependent padding that no caller reads.
//
// What bounds it on the card: one read of the labels (4 bytes a voxel). The
// design keeps everything else off that stream:
//   - The flat order is cut into lines along its fastest axis (z for order 0,
//     x for order 1) and lines into segments of 128 labels. A warp takes a batch
//     of four consecutive segments at a time, 16 bytes a lane each, all four
//     loads in flight before the first is looked at; a batch that is all sentinel
//     passes on one vote. Two coordinates are constant over a segment (one
//     32-bit division per batch finds the line, two more decode it, and only
//     for segments that hold foreground); the third is the offset in the line.
//     (A second batch in flight per warp measured slower on the H100: the
//     registers it takes cost more warps than the loads gain.)
//   - Within a segment, lanes whose four labels are equal join their
//     neighbours into stretches (one shuffle, one ballot); the head of a
//     stretch searches the sorted roots once and adds L, L*c1, L*c2 and
//     s*L + L(L-1)/2 for its L voxels starting at offset s. A lane that holds
//     an edge adds its own (at most four) runs. No stretch crosses a segment,
//     so none crosses the end of a line, where c1 and c2 change.
//   - A block sums in shared memory, R x 4 counters of 32 bits beside the
//     sorted roots (20 bytes a root: 2.5 KB at R = 128, 80 KB at 4096, two
//     blocks an SM). The launcher sizes the grid so that no block's sums can
//     pass 2^32 (see `stats_blocks`). At its end a block adds its non-zero
//     rows to the global 64-bit accumulator, and the block that finishes last
//     writes the f32 rows.
//   - The roots are sorted by a counting rank with first-index ties. Up to 256
//     of them every block sorts for itself while its first loads are in
//     flight (roots that come ascending, as a top-k's do, are taken as they
//     are), behind a memset of the accumulator and the ticket; more than
//     that are ranked once by a small launch ahead, which also clears. No
//     sort, zero fill or finalize launch around the kernel.

#include "common.cuh"

#define ST_THREADS 512
#define ST_SEG 128            // labels of one warp load: 4 a lane
#define ST_LOADS 4            // segments of one batch
#define ST_MAX_ROOTS 7168     // gpu_ops.STATS_MAX_ROOTS
#define ST_RANK_IN_BLOCK 256  // up to so many roots every block sorts for itself
#define ST_TAIL 8             // output entries a thread of the last block reads at a time
#define ST_FULL 0xffffffffu

// The scratch buffer, carved by both kernels and the launcher alike:
// (R, 4) uint64 sums, the ticket (in a 64-bit slot), R sorted roots.
struct StatsScratch {
  unsigned long long* acc;
  unsigned int* ticket;
  int32_t* sorted;
};

__host__ __device__ __forceinline__ StatsScratch stats_scratch(void* base, int num_roots) {
  StatsScratch s;
  s.acc = (unsigned long long*)base;
  s.ticket = (unsigned int*)(s.acc + 4LL * num_roots);
  s.sorted = (int32_t*)(s.acc + 4LL * num_roots + 1);
  return s;
}

// Where vals[r] stands in ascending order: the values below it, then the
// equal values before it. Counted over j = from, from + step, ...
__device__ __forceinline__ int stats_rank(const int32_t* __restrict__ vals, int num_roots, int r,
                                          int from, int step) {
  const int32_t v = vals[r];
  int below = 0, before = 0;
  for (int j = from; j < num_roots; j += step) {
    const int32_t w = vals[j];
    below += w < v;
    before += (w == v) & (j < r);
  }
  return below + before;
}

// More than ST_RANK_IN_BLOCK roots: a launch of its own sorts them and clears
// the sums and the ticket. A block ranks 32 roots, 8 lanes a root, each lane
// counting every 8th value (neighbouring words of shared memory).
__global__ void __launch_bounds__(ST_THREADS)
    stats_rank_kernel(const int32_t* __restrict__ roots, int num_roots, void* scratch) {
  __shared__ int32_t vals[ST_MAX_ROOTS];
  const StatsScratch s = stats_scratch(scratch, num_roots);
  for (int j = threadIdx.x; j < num_roots; j += ST_THREADS) vals[j] = roots[j];
  __syncthreads();
  const int r = blockIdx.x * (ST_THREADS / 8) + (threadIdx.x >> 3), part = threadIdx.x & 7;
  if (r == 0 && part == 0) *s.ticket = 0u;
  int rank = r < num_roots ? stats_rank(vals, num_roots, r, part, 8) : 0;
  rank += __shfl_xor_sync(ST_FULL, rank, 1);
  rank += __shfl_xor_sync(ST_FULL, rank, 2);
  rank += __shfl_xor_sync(ST_FULL, rank, 4);
  if (r < num_roots) {
    if (part == 0) s.sorted[rank] = vals[r];
    if (part < 4) s.acc[4LL * r + part] = 0ULL;
  }
}

// `len` voxels of `label` from offset `start` of a line whose other two
// coordinates are c1 (the slowest) and c2
__device__ __forceinline__ void stats_add(const int32_t* __restrict__ srt, uint32_t* __restrict__ tab,
                                          int num_roots, int order, int32_t label, uint32_t c1,
                                          uint32_t c2, uint32_t start, uint32_t len) {
  const int r = mamri_lower_bound(srt, num_roots, label);
  if (r == num_roots || srt[r] != label) return;
  uint32_t* t = tab + 4 * r;
  const uint32_t along = start * len + len * (len - 1u) / 2u;
  atomicAdd(t + 0, len);
  atomicAdd(t + 1, order == 0 ? c1 * len : along);
  atomicAdd(t + 2, c2 * len);
  atomicAdd(t + 3, order == 0 ? along : c1 * len);
}

__device__ __forceinline__ bool stats_foreground(const int4 w) {
  return w.x != MAMRI_BIG || w.y != MAMRI_BIG || w.z != MAMRI_BIG || w.w != MAMRI_BIG;
}

// The flat order as lines of `line_len` labels, each cut into `spl` segments.
struct StatsLines {
  const int32_t* lab;
  long long n;
  uint32_t line_len, spl, lines;
};

// Batch b: its ST_LOADS segments, 4 labels a lane (BIG past the end of a line)
__device__ __forceinline__ void stats_load(const StatsLines& g, uint32_t b, uint32_t lane,
                                           int4 (&v)[ST_LOADS]) {
  uint32_t line = b * ST_LOADS / g.spl, sg = b * ST_LOADS - line * g.spl;
#pragma unroll
  for (int u = 0; u < ST_LOADS; ++u) {
    v[u] = make_int4(MAMRI_BIG, MAMRI_BIG, MAMRI_BIG, MAMRI_BIG);
    if (line < g.lines) {
      const long long base = (long long)line * g.line_len + sg * ST_SEG;
      long long left = g.n - base;  // the last line may be cut short
      if (left > (long long)(g.line_len - sg * ST_SEG)) left = g.line_len - sg * ST_SEG;
      const int mine = (int)(left > ST_SEG ? ST_SEG : left) - 4 * (int)lane;  // labels of this lane
      const int32_t* p = g.lab + base + 4 * lane;
      if (mine >= 4 && ((uintptr_t)p & 15) == 0) {
        v[u] = *reinterpret_cast<const int4*>(p);
      } else {  // the end of a line, or a line that starts off a 16-byte boundary
        if (mine > 0) v[u].x = p[0];
        if (mine > 1) v[u].y = p[1];
        if (mine > 2) v[u].z = p[2];
        if (mine > 3) v[u].w = p[3];
      }
    }
    if (++sg == g.spl) {
      sg = 0;
      ++line;
    }
  }
}

__global__ void __launch_bounds__(ST_THREADS)
    stats_kernel(const int32_t* __restrict__ lab, long long n, uint32_t line_len, uint32_t ny,
                 int order, const int32_t* __restrict__ roots, int num_roots, void* scratch,
                 float* __restrict__ out) {
  extern __shared__ uint32_t st_smem[];  // R sorted roots, then (R, 4) sums
  const StatsScratch s = stats_scratch(scratch, num_roots);
  int32_t* srt = (int32_t*)st_smem;
  uint32_t* tab = st_smem + num_roots;
  const uint32_t lane = threadIdx.x & 31;
  StatsLines g;
  g.lab = lab, g.n = n, g.line_len = line_len;
  g.spl = (line_len + ST_SEG - 1) / ST_SEG;
  g.lines = (uint32_t)((n + line_len - 1) / line_len);
  const uint32_t segs = g.lines * g.spl;  // < 2^31: checked by the launcher
  const uint32_t batches = (segs + ST_LOADS - 1) / ST_LOADS;
  const uint32_t warps = gridDim.x * (ST_THREADS / 32);
  uint32_t b = blockIdx.x * (ST_THREADS / 32) + (threadIdx.x >> 5);
  int4 v[ST_LOADS];
  if (b < batches) stats_load(g, b, lane, v);  // in flight while the block sets up its table

  if (num_roots <= ST_RANK_IN_BLOCK) {  // sort here: the unsorted roots wait in the table's room
    int32_t* vals = (int32_t*)tab;
    const int r = threadIdx.x;
    if (r < num_roots) vals[r] = roots[r];
    __syncthreads();
    // roots that come ascending (a top-k's do) are taken as they are
    const bool ascending = __syncthreads_and(r + 1 >= num_roots || vals[r] <= vals[r + 1]);
    if (r < num_roots) srt[ascending ? r : stats_rank(vals, num_roots, r, 0, 1)] = vals[r];
    __syncthreads();
  } else {
    for (int r = threadIdx.x; r < num_roots; r += ST_THREADS) srt[r] = s.sorted[r];
  }
  for (int r = threadIdx.x; r < 4 * num_roots; r += ST_THREADS) tab[r] = 0u;
  __syncthreads();

  for (; b < batches; b += warps) {
    bool any = false;
#pragma unroll
    for (int u = 0; u < ST_LOADS; ++u) any |= stats_foreground(v[u]);
    if (__any_sync(ST_FULL, any)) {
      uint32_t line = b * ST_LOADS / g.spl, sg = b * ST_LOADS - line * g.spl;
#pragma unroll
      for (int u = 0; u < ST_LOADS; ++u) {
        const int4 w = v[u];
        const bool fg = stats_foreground(w);
        if (__any_sync(ST_FULL, fg)) {
          const uint32_t c1 = line / ny, c2 = line - c1 * ny;
          const uint32_t off = sg * ST_SEG + 4 * lane;
          const bool uniform = w.x == w.y && w.y == w.z && w.z == w.w;
          // a lane leads a stretch unless it only continues the lane before it
          const int32_t before = __shfl_up_sync(ST_FULL, w.w, 1);
          const bool before_uniform = __shfl_up_sync(ST_FULL, (int)uniform, 1) != 0;
          const bool head = lane == 0 || !uniform || !before_uniform || before != w.x;
          const uint32_t heads = __ballot_sync(ST_FULL, head);
          if (fg && uniform && head) {
            const uint32_t above = lane == 31 ? 0u : heads & ~((2u << lane) - 1u);
            const uint32_t end = above ? (uint32_t)__ffs(above) - 1u : 32u;
            stats_add(srt, tab, num_roots, order, w.x, c1, c2, off, 4u * (end - lane));
          } else if (fg && !uniform) {
            int32_t cur = w.x;  // the lane's own runs, closed where the next label differs
            uint32_t from = 0;
#pragma unroll
            for (uint32_t q = 1; q <= 4; ++q) {
              const int32_t next = q == 1 ? w.y : q == 2 ? w.z : w.w;
              if (q < 4 && next == cur) continue;
              if (cur != MAMRI_BIG) stats_add(srt, tab, num_roots, order, cur, c1, c2, off + from, q - from);
              cur = next;
              from = q;
            }
          }
        }
        if (++sg == g.spl) {
          sg = 0;
          ++line;
        }
      }
    }
    if (b + warps < batches) stats_load(g, b + warps, lane, v);
  }
  __syncthreads();
  for (int r = threadIdx.x; r < num_roots; r += ST_THREADS) {
    const uint32_t* t = tab + 4 * r;
    if (t[0] == 0u) continue;  // no voxel: every sum is 0
    for (int c = 0; c < 4; ++c) atomicAdd(s.acc + 4LL * r + c, (unsigned long long)t[c]);
  }
  if (!mamri_last_block(s.ticket)) return;
  // entry e = 4 * r + c of the output: the sum c of the row where roots[r]'s value first stands;
  // ST_TAIL entries a thread at a time, so that their reads of `acc` are in flight together
  for (int e0 = threadIdx.x; e0 < 4 * num_roots; e0 += ST_TAIL * ST_THREADS) {
    unsigned long long sum[ST_TAIL];
#pragma unroll
    for (int u = 0; u < ST_TAIL; ++u) {
      const int e = e0 + u * ST_THREADS;
      sum[u] = 0ULL;  // a sentinel root's row
      if (e < 4 * num_roots && roots[e >> 2] != MAMRI_BIG)
        sum[u] = __ldcg(s.acc + 4LL * mamri_lower_bound(srt, num_roots, roots[e >> 2]) + (e & 3));
    }
#pragma unroll
    for (int u = 0; u < ST_TAIL; ++u)
      if (e0 + u * ST_THREADS < 4 * num_roots) out[e0 + u * ST_THREADS] = (float)(long long)sum[u];
  }
}

// The number of blocks: as many as the card holds at once, and at least so
// many that a block's sums fit its 32-bit counters. A block takes at most
// ceil(batches / (blocks * warps)) * warps batches of ST_LOADS * ST_SEG voxels,
// and a voxel adds less than `extent` (the largest coordinate + 1) to a sum.
static long long stats_blocks(long long batches, long long resident, long long extent) {
  const long long warps = ST_THREADS / 32, per_batch = (long long)ST_LOADS * ST_SEG;
  const long long most = (batches + warps - 1) / warps;  // one batch a warp
  long long blocks = resident < most ? resident : most;
  if (blocks < 1) blocks = 1;
  while (blocks < most &&
         ((batches + blocks * warps - 1) / (blocks * warps)) * warps * per_batch * extent >= (1LL << 32))
    blocks *= 2;
  return blocks < most ? blocks : most;
}

// scratch: 8 * (4 * num_roots + 1) + 4 * num_roots bytes, 8-byte aligned,
// nothing in it on entry. Up to ST_RANK_IN_BLOCK roots it is cleared here and
// every block sorts the roots for itself: one kernel behind a memset.
extern "C" int mamri_component_stats(const int32_t* lab, long long n, const int32_t* roots,
                                     int num_roots, int nx, int ny, int nz, int order, void* scratch,
                                     float* out, cudaStream_t stream) {
  const long long line_len = order == 0 ? nz : nx;
  if (n < 1 || n > 0x7fffffffLL || line_len < 1 || ny < 1 || num_roots < 1 || num_roots > ST_MAX_ROOTS)
    return (int)cudaErrorInvalidValue;
  const long long lines = (n + line_len - 1) / line_len;
  const long long segs = lines * ((line_len + ST_SEG - 1) / ST_SEG);
  if (segs > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  long long extent = line_len > ny ? line_len : ny;
  if ((lines + ny - 1) / ny > extent) extent = (lines + ny - 1) / ny;
  if ((long long)(ST_THREADS / 32) * ST_LOADS * ST_SEG * extent >= (1LL << 32))
    return (int)cudaErrorInvalidValue;  // the sums of a block that takes one batch a warp

  const size_t smem = (size_t)num_roots * 5 * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stats_kernel, ST_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long batches = (segs + ST_LOADS - 1) / ST_LOADS;
  const long long blocks = stats_blocks(batches, (long long)(sms > 0 ? sms : 132) * per_sm, extent);

  if (num_roots <= ST_RANK_IN_BLOCK) {
    err = cudaMemsetAsync(scratch, 0, (4 * (size_t)num_roots + 1) * sizeof(unsigned long long), stream);
  } else {
    stats_rank_kernel<<<(num_roots + ST_THREADS / 8 - 1) / (ST_THREADS / 8), ST_THREADS, 0, stream>>>(
        roots, num_roots, scratch);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return (int)err;
  stats_kernel<<<(unsigned int)blocks, ST_THREADS, smem, stream>>>(
      lab, n, (uint32_t)line_len, (uint32_t)ny, order, roots, num_roots, scratch, out);
  return (int)cudaGetLastError();
}

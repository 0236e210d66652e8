// Run-length CCL: reset distances, run-bounded min sweeps, fixed-point check.
//
// Replaces, in mamri_tpu/perception/pallas_ops.py:
//   :295 compute_reset_distances (`_dist_kernel` :269)       -> reset_distances
//   :408 ccl_half_sweep_yz       (`_sweep_dist_kernel` :335) -> run_min(y), run_min(z)
//   :408 ccl_half_sweep_yz(with_check=True) (`_sweep_check_yz_kernel` :369)
//                                                            -> run_min(y, z), check(y, z)
//   :447 ccl_half_sweep_x        (`_sweep_dist_kernel`)      -> run_min(x)
//   :562 ccl_check_consistency   (`_check_kernel` :539)      -> check(y, z, x)
//   :604 ccl_check_consistency_x (`_check_kernel`)           -> check(x)
//
// Each TPU kernel is the same line operation along a chosen axis, written as
// log2(n) roll-and-select steps because Mosaic has no sequential scan. On the
// card:
//   * reset_distances: df = distance to the last background voxel at or
//     before the voxel (i + 1 where there is none), db = to the next one
//     at or after it (n - i where there is none), both int16. Bound by
//     bytes: 1 B read and 4 B written a voxel. A thread walking a whole
//     line makes z loads 32 lines apart (a sector per byte) and leaves too
//     few lines in flight along x and y, so lines become bit masks instead:
//     along the contiguous axis a warp owns a line, reads 128 B a step and
//     packs them with __ballot_sync; along a strided axis a block owns 128
//     columns and splits the axis into 8 warp segments of 32-index mask
//     words. df and db are then __clz / __ffs of a masked word plus a carry,
//     written 8 B a lane (reset_dist_lines_kernel, reset_dist_strips_kernel);
//   * run_min (one thread per line): every voxel of a maximal foreground
//     run (bounded by df/db) gets the minimum label of that run -- exactly
//     what the TPU's doubling ladder computes. A change ORs 1 into a device
//     flag. Labels only ever
//     decrease, so the flags ORed over axes mean "anything changed";
//   * check: one thread per voxel; bad iff df >= 2 (the -axis neighbour is in
//     the same run) and the two labels differ. 0 over all axes certifies the
//     exact CCL fixed point.
//
// What bounds run_min and check: memory traffic, one pass over labels (read +
// write) and the two int16 distance arrays per axis. Lines along x and y are
// numbered so that neighbouring threads touch neighbouring z addresses
// (coalesced); along z each thread walks contiguous memory and relies on L1.
// A run is read twice (min, then write), which keeps the thread's state to a
// few registers.

#include "common.cuh"

// ------------------------------------------------------------ reset_distances
// A line along `axis` is read as (outer, len, inner): element (o, i, c) sits
// at (o * len + i) * inner + c. Bit r of a mask word says "index r resets".

#define RD_LINE_WARPS 8  // lines (one warp each) per block of the contiguous kernel
#define RD_MAX_SEGS 8    // axis segments (one warp each) per block of the strided kernel
#define RD_FULL 0xffffffffu

template <int V>
__device__ __forceinline__ uint32_t rd_load(const int8_t* p) {
  if constexpr (V == 4) {
    return *reinterpret_cast<const uint32_t*>(p);
  } else {
    return (uint32_t)(uint8_t)*p;
  }
}

template <int V>
__device__ __forceinline__ void rd_store(int16_t* p, const int (&d)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2((uint32_t)(uint16_t)d[0] | ((uint32_t)(uint16_t)d[1] << 16),
                   (uint32_t)(uint16_t)d[2] | ((uint32_t)(uint16_t)d[3] << 16));
  } else {
    *p = (int16_t)d[0];
  }
}

// The highest / lowest v whose ballot b[v] has bit h set (one of them has).
template <int V>
__device__ __forceinline__ int rd_high_byte(const uint32_t (&b)[V], int h) {
  int r = 0;
#pragma unroll
  for (int v = 0; v < V; ++v)
    if ((b[v] >> h) & 1u) r = v;
  return r;
}

template <int V>
__device__ __forceinline__ int rd_low_byte(const uint32_t (&b)[V], int h) {
  int r = V - 1;
#pragma unroll
  for (int v = V - 1; v >= 0; --v)
    if ((b[v] >> h) & 1u) r = v;
  return r;
}

// Contiguous lines (inner == 1): one warp per line, V bytes a lane, so a warp
// reads CH = 32 V consecutive bytes per step. Ballot v has bit l set iff index
// p0 + V l + v resets; the V ballots are the chunk's mask. The forward walk
// writes df and keeps the masks in shared memory; the backward walk writes db
// from them alone.
template <int V>
__global__ void __launch_bounds__(RD_LINE_WARPS * 32)
    reset_dist_lines_kernel(const int8_t* __restrict__ reset, int16_t* __restrict__ df,
                            int16_t* __restrict__ db, long long lines, int len) {
  extern __shared__ uint32_t rd_smem[];
  constexpr int CH = 32 * V;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long line = (long long)blockIdx.x * RD_LINE_WARPS + warp;
  if (line >= lines) return;  // the whole warp
  const int nchunks = (len + CH - 1) / CH;
  uint32_t* masks = rd_smem + warp * nchunks * V;
  const long long base = line * len;
  const uint32_t below = (1u << lane) - 1u, above = ~below << 1;

  int carry = -1;  // the last reset of the chunks already walked
  uint32_t word = V * lane < len ? rd_load<V>(reset + base + V * lane) : 0u;
  for (int c = 0; c < nchunks; ++c) {
    const int p0 = c * CH, pos = p0 + V * lane;
    const uint32_t next = pos + CH < len ? rd_load<V>(reset + base + pos + CH) : 0u;
    uint32_t b[V], any = 0u, own = 0u;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      b[v] = __ballot_sync(RD_FULL, (word >> (8 * v)) & 0xffu);
      any |= b[v];
      own |= ((b[v] >> lane) & 1u) << v;
      if (lane == v) masks[c * V + v] = b[v];
    }
    int last = carry;
    if (any & below) {
      const int h = 31 - __clz(any & below);
      last = p0 + V * h + rd_high_byte<V>(b, h);
    }
    if (pos < len) {
      int d[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if ((own >> v) & 1u) last = pos + v;
        d[v] = pos + v - last;
      }
      rd_store<V>(df + base + pos, d);
    }
    if (any) {
      const int h = 31 - __clz(any);
      carry = p0 + V * h + rd_high_byte<V>(b, h);
    }
    word = next;
  }
  __syncwarp();

  carry = len;  // the first reset of the chunks already walked
  for (int c = nchunks - 1; c >= 0; --c) {
    const int p0 = c * CH, pos = p0 + V * lane;
    uint32_t b[V], any = 0u, own = 0u;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      b[v] = masks[c * V + v];
      any |= b[v];
      own |= ((b[v] >> lane) & 1u) << v;
    }
    int nxt = carry;
    if (any & above) {
      const int h = __ffs(any & above) - 1;
      nxt = p0 + V * h + rd_low_byte<V>(b, h);
    }
    if (pos < len) {
      int d[V];
#pragma unroll
      for (int v = V - 1; v >= 0; --v) {
        if ((own >> v) & 1u) nxt = pos + v;
        d[v] = nxt - pos - v;
      }
      rd_store<V>(db + base + pos, d);
    }
    if (any) {
      const int h = __ffs(any) - 1;
      carry = p0 + V * h + rd_low_byte<V>(b, h);
    }
  }
}

// Strided lines (inner > 1): a block owns C = 32 V consecutive columns (V a
// lane: one warp load is 32 V consecutive bytes of one line index) and splits
// the axis into `segs` segments of whole 32-index chunks, one warp each. Pass
// 1 packs each column's chunk into a mask word in shared memory and records
// the segment's last and first reset per column; after the barrier each warp
// takes its carries from the other segments' records, and pass 2 writes df
// (forward) and db (backward) from the mask words alone.
template <int V>
__global__ void __launch_bounds__(RD_MAX_SEGS * 32)
    reset_dist_strips_kernel(const int8_t* __restrict__ reset, int16_t* __restrict__ df,
                             int16_t* __restrict__ db, long long cols, int len, long long inner) {
  extern __shared__ uint32_t rd_smem[];
  constexpr int C = 32 * V;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, segs = blockDim.x >> 5;
  const int nchunks = (len + 31) >> 5;
  uint32_t* masks = rd_smem;                      // [chunk][v][lane]
  int* seg_last = (int*)(rd_smem + nchunks * C);  // [segment][v][lane]
  int* seg_first = seg_last + segs * C;
  const long long q = (long long)blockIdx.x * C + V * lane;  // the lane's first column
  const bool live = q < cols;
  const long long o = q / inner;
  const long long base = o * len * inner + (q - o * inner);  // element (o, 0, c)
  const int c0 = warp * nchunks / segs, c1 = (warp + 1) * nchunks / segs;

  int last[V], first[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    last[v] = -1;
    first[v] = len;
  }
  for (int c = c0; c < c1; ++c) {
    uint32_t m[V];
#pragma unroll
    for (int v = 0; v < V; ++v) m[v] = 0u;
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const int i = c * 32 + r;
      if (live && i < len) {
        const uint32_t word = rd_load<V>(reset + base + (long long)i * inner);
#pragma unroll
        for (int v = 0; v < V; ++v) m[v] |= (((word >> (8 * v)) & 0xffu) ? 1u : 0u) << r;
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      masks[(c * V + v) * 32 + lane] = m[v];
      if (m[v]) {
        last[v] = c * 32 + 31 - __clz(m[v]);
        if (first[v] == len) first[v] = c * 32 + __ffs(m[v]) - 1;
      }
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    seg_last[(warp * V + v) * 32 + lane] = last[v];
    seg_first[(warp * V + v) * 32 + lane] = first[v];
  }
  __syncthreads();
  if (!live) return;

  int cf[V], cb[V];  // the last reset before / first reset after the segment
#pragma unroll
  for (int v = 0; v < V; ++v) {
    cf[v] = -1;
    cb[v] = len;
  }
  for (int s = 0; s < segs; ++s) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (s < warp) cf[v] = max(cf[v], seg_last[(s * V + v) * 32 + lane]);
      if (s > warp) cb[v] = min(cb[v], seg_first[(s * V + v) * 32 + lane]);
    }
  }
  for (int c = c0; c < c1; ++c) {
    uint32_t m[V];
#pragma unroll
    for (int v = 0; v < V; ++v) m[v] = masks[(c * V + v) * 32 + lane];
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const int i = c * 32 + r;
      if (i < len) {
        int d[V];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const uint32_t at_or_before = m[v] & (RD_FULL >> (31 - r));
          d[v] = i - (at_or_before ? c * 32 + 31 - __clz(at_or_before) : cf[v]);
        }
        rd_store<V>(df + base + (long long)i * inner, d);
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (m[v]) cf[v] = c * 32 + 31 - __clz(m[v]);
  }
  for (int c = c1 - 1; c >= c0; --c) {
    uint32_t m[V];
#pragma unroll
    for (int v = 0; v < V; ++v) m[v] = masks[(c * V + v) * 32 + lane];
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const int i = c * 32 + r;
      if (i < len) {
        int d[V];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const uint32_t at_or_after = m[v] & (RD_FULL << r);
          d[v] = (at_or_after ? c * 32 + __ffs(at_or_after) - 1 : cb[v]) - i;
        }
        rd_store<V>(db + base + (long long)i * inner, d);
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (m[v]) cb[v] = c * 32 + __ffs(m[v]) - 1;
  }
}
__global__ void run_min_kernel(int32_t* __restrict__ lab, const int16_t* __restrict__ df,
                               const int16_t* __restrict__ db, int n0, int n1, int n2, int axis,
                               int32_t* __restrict__ changed) {
  long long line = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (line >= mamri_num_lines(axis, n0, n1, n2)) return;
  long long base, stride;
  int len;
  mamri_line(axis, n0, n1, n2, line, &base, &stride, &len);
  bool chg = false;
  int i = 0;
  while (i < len) {
    const long long p = base + i * stride;
    if (df[p] == 0) {  // background
      ++i;
      continue;
    }
    int run = db[p];  // the run is [i, i + run)
    if (run < 1) run = 1;
    if (run > len - i) run = len - i;
    int32_t m = lab[p];
    for (int q = 1; q < run; ++q) m = min(m, lab[p + q * stride]);
    for (int q = 0; q < run; ++q) {
      const long long pq = p + q * stride;
      if (lab[pq] != m) {
        lab[pq] = m;
        chg = true;
      }
    }
    i += run;
  }
  if (chg) atomicOr(changed, 1);
}

__global__ void check_kernel(const int32_t* __restrict__ lab, const int16_t* __restrict__ df,
                             int n0, int n1, int n2, int axis, int32_t* __restrict__ bad) {
  const long long n = (long long)n0 * n1 * n2;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = axis == 2 ? 1 : axis == 1 ? (long long)n2 : (long long)n1 * n2;
  const bool is_bad = t < n && df[t] >= 2 && lab[t] != lab[t - stride];
  // one atomic per warp at most
  if (__any_sync(0xffffffffu, is_bad) && (threadIdx.x & 31) == 0) atomicOr(bad, 1);
}

extern "C" int mamri_reset_distances(const int8_t* reset, int16_t* df, int16_t* db, int n0, int n1,
                                     int n2, int axis, cudaStream_t stream) {
  const long long outer = axis == 2 ? (long long)n0 * n1 : axis == 1 ? n0 : 1;
  const int len = axis == 2 ? n2 : axis == 1 ? n1 : n0;
  const long long inner = axis == 2 ? 1 : axis == 1 ? n2 : (long long)n1 * n2;
  const bool aligned = ((uintptr_t)reset & 3) == 0;  // a view may start at any byte
  if (inner == 1) {
    const bool vec = aligned && len % 4 == 0;  // 4-byte aligned lines
    const int ch = vec ? 128 : 32;
    const size_t smem = (size_t)RD_LINE_WARPS * ((len + ch - 1) / ch) * (vec ? 4 : 1) * sizeof(uint32_t);
    const unsigned blocks = (unsigned)((outer + RD_LINE_WARPS - 1) / RD_LINE_WARPS);
    if (vec) {
      reset_dist_lines_kernel<4><<<blocks, RD_LINE_WARPS * 32, smem, stream>>>(reset, df, db, outer, len);
    } else {
      reset_dist_lines_kernel<1><<<blocks, RD_LINE_WARPS * 32, smem, stream>>>(reset, df, db, outer, len);
    }
    return (int)cudaGetLastError();
  }
  const long long cols = outer * inner;
  const int nchunks = (len + 31) / 32;
  const int segs = nchunks < RD_MAX_SEGS ? nchunks : RD_MAX_SEGS;
  const size_t smem4 = (size_t)(nchunks + 2 * segs) * 128 * sizeof(uint32_t);
  if (aligned && inner % 4 == 0 && smem4 <= 48 * 1024) {
    const unsigned blocks = (unsigned)((cols + 127) / 128);
    reset_dist_strips_kernel<4><<<blocks, segs * 32, smem4, stream>>>(reset, df, db, cols, len, inner);
    return (int)cudaGetLastError();
  }
  const size_t smem1 = smem4 / 4;  // at most 135 KB: every side is < 32767
  if (smem1 > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        reset_dist_strips_kernel<1>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned blocks = (unsigned)((cols + 31) / 32);
  reset_dist_strips_kernel<1><<<blocks, segs * 32, smem1, stream>>>(reset, df, db, cols, len, inner);
  return (int)cudaGetLastError();
}
extern "C" int mamri_run_min(int32_t* lab, const int16_t* df, const int16_t* db, int n0, int n1,
                             int n2, int axis, int32_t* changed, cudaStream_t stream) {
  const long long lines = mamri_num_lines(axis, n0, n1, n2);
  run_min_kernel<<<mamri_blocks(lines), MAMRI_THREADS, 0, stream>>>(lab, df, db, n0, n1, n2, axis,
                                                                     changed);
  return (int)cudaGetLastError();
}

extern "C" int mamri_check(const int32_t* lab, const int16_t* df, int n0, int n1, int n2, int axis,
                           int32_t* bad, cudaStream_t stream) {
  const long long n = (long long)n0 * n1 * n2;
  check_kernel<<<mamri_blocks(n), MAMRI_THREADS, 0, stream>>>(lab, df, n0, n1, n2, axis, bad);
  return (int)cudaGetLastError();
}

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
//   * run_min: every voxel of a maximal foreground run (bounded by df/db)
//     gets the minimum label of that run -- exactly what the TPU's doubling
//     ladder computes. A change ORs 1 into a device flag. Labels only ever
//     decrease, so the flags ORed over axes mean "anything changed". Bound
//     by bytes: 12 B a voxel by its contract (label in and out, df, db). A
//     thread walking a whole line diverges from its warp at every run
//     boundary, chains its loads and, along z, touches a sector per label;
//     so along z a warp owns a line and joins its lanes with a segmented
//     shuffle scan, and along x and y a block owns a strip of columns whose
//     rows its warps walk in step, one coalesced row a load
//     (run_min_lines_kernel, run_min_strips_kernel). Each label and df is
//     read once, db never, and only the labels that change are written;
//   * check: one thread per voxel; bad iff df >= 2 (the -axis neighbour is in
//     the same run) and the two labels differ. 0 over all axes certifies the
//     exact CCL fixed point. Bound by bytes: 6 B a voxel, neighbouring
//     threads on neighbouring addresses for every axis.

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

// -------------------------------------------------------------------- run_min
// A voxel starts a run iff df <= 1 (df == 0 is background, a run of its own
// that keeps its label), so a run ends where the next voxel starts one or the
// line ends: df alone bounds the runs and db is never read by the two kernels
// below. Both make one forward walk that leaves f = the minimum from the
// run's start up to the voxel in shared memory (with a bit per voxel for "a
// start" and for "f differs from the label"), and one backward walk
// g = next voxel starts ? f : min(f, g) that turns f into the run's minimum.
// A voxel is written iff its label changes: g != f or the forward bit.
// Scans are mostly background, so both walks take a whole warp step in a few
// instructions where a vote finds every voxel of it a run of its own: a
// volume of runs everywhere is bound by the walks' instructions instead.

#define RM_MAX_SEGS 16    // axis segments (one warp each) per block of the strided kernel
#define RM_ROWS 8         // rows a lane of the strided kernel loads before it looks at them
#define RM_LINE_WARPS 8   // lines (one warp each) per block of the contiguous kernel
#define RM_SMEM_MAX (227 * 1024)
#define RM_SMEM_SHARE (74 * 1024)  // three blocks on an SM

// V labels and their V df, two to a word. df >= 0, so a voxel starts a run
// (df <= 1) iff its df has no bit above the lowest.
template <int V>
__device__ __forceinline__ void rm_load(const int32_t* lab, const int16_t* df, int32_t (&l)[V],
                                        uint32_t (&d)[(V + 1) / 2]) {
  if constexpr (V == 4) {
    const int4 t = *reinterpret_cast<const int4*>(lab);
    const uint2 w = *reinterpret_cast<const uint2*>(df);
    l[0] = t.x, l[1] = t.y, l[2] = t.z, l[3] = t.w;
    d[0] = w.x, d[1] = w.y;
  } else if constexpr (V == 2) {
    const int2 t = *reinterpret_cast<const int2*>(lab);
    l[0] = t.x, l[1] = t.y;
    d[0] = *reinterpret_cast<const uint32_t*>(df);
  } else {
    l[0] = *lab;
    d[0] = (uint16_t)*df;
  }
}

template <int V>
__device__ __forceinline__ bool rm_start(const uint32_t (&d)[(V + 1) / 2], int v) {
  return ((d[v / 2] >> (16 * (v & 1))) & 0xfffeu) == 0u;
}

template <int V>
__device__ __forceinline__ void rm_load(const int32_t* lab, const int16_t* df, int32_t (&l)[V],
                                        bool (&s)[V]) {
  uint32_t d[(V + 1) / 2];
  rm_load<V>(lab, df, l, d);
#pragma unroll
  for (int v = 0; v < V; ++v) s[v] = rm_start<V>(d, v);
}

__device__ __forceinline__ void rm_flag(bool chg, int32_t* changed) {
  // one atomic per block at most, and none once the flag is up
  if (__syncthreads_or(chg) && threadIdx.x == 0 && *(volatile int32_t*)changed == 0)
    atomicOr(changed, 1);
}

// Strided lines (inner > 1), read as (outer, len, inner) like reset_distances:
// a block owns C = 32 V consecutive columns and all `len` rows of them, and
// splits the rows into `segs` segments of whole 32-row chunks, one warp each.
// A lane walks its V columns down the segment (one warp load is 32 V
// consecutive labels of one row). The segments then exchange, per column,
// the minimum of their leading open run (`head`, the rows before the first
// start), of their trailing one (`tail`) and whether they hold a start, and
// each folds its neighbours' records into the carries cf (what the run holds
// before the segment) and cb (after it, the backward walk's first g).
template <int V>
__global__ void __launch_bounds__(RM_MAX_SEGS * 32)
    run_min_strips_kernel(int32_t* __restrict__ lab, const int16_t* __restrict__ df, long long cols,
                          int len, long long inner, int32_t* __restrict__ changed) {
  extern __shared__ uint32_t rd_smem[];
  constexpr int C = 32 * V, W = (V + 1) / 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, segs = blockDim.x >> 5;
  const int nchunks = (len + 31) >> 5;
  int32_t* tile = (int32_t*)rd_smem;                          // [row][v][lane]: f
  uint32_t* masks = rd_smem + (size_t)len * C;                // [chunk][start, dirty][v][lane]
  int32_t* seg_head = (int32_t*)(masks + (size_t)nchunks * 2 * C);  // [segment][v][lane]
  int32_t* seg_tail = seg_head + segs * C;
  int32_t* seg_start = seg_tail + segs * C;  // bit 0: holds a start, bit 1: its first row is one
  const long long q = (long long)blockIdx.x * C + V * lane;  // the lane's first column
  const bool live = q < cols;
  const long long o = q / inner;
  const long long base = o * len * inner + (q - o * inner);  // element (o, 0, c)
  const int c0 = warp * nchunks / segs, c1 = (warp + 1) * nchunks / segs;

  int32_t m[V], head[V];
  int first[V];  // the segment's first start
#pragma unroll
  for (int v = 0; v < V; ++v) {
    m[v] = head[v] = MAMRI_BIG;
    first[v] = len;
  }
  for (int c = c0; c < c1; ++c) {
    uint32_t st[V], dirty[V];
#pragma unroll
    for (int v = 0; v < V; ++v) st[v] = dirty[v] = 0u;
#pragma unroll
    for (int r0 = 0; r0 < 32; r0 += RM_ROWS) {
      int32_t l[RM_ROWS][V];
      uint32_t d[RM_ROWS][W], any = 0u;
#pragma unroll
      for (int u = 0; u < RM_ROWS; ++u) {
        const int i = c * 32 + r0 + u;
#pragma unroll
        for (int v = 0; v < V; ++v) l[u][v] = MAMRI_BIG;
#pragma unroll
        for (int w = 0; w < W; ++w) d[u][w] = 0u;  // rows past the end: background
        if (live && i < len)
          rm_load<V>(lab + base + (long long)i * inner, df + base + (long long)i * inner, l[u], d[u]);
#pragma unroll
        for (int w = 0; w < W; ++w) any |= d[u][w];
      }
      // whole rows of background and 1-row runs: f is the label
      if (c * 32 + r0 + RM_ROWS <= len && __all_sync(RD_FULL, (any & 0xfffefffeu) == 0u)) {
#pragma unroll
        for (int u = 0; u < RM_ROWS; ++u) {
#pragma unroll
          for (int v = 0; v < V; ++v)
            tile[((size_t)(c * 32 + r0 + u) * V + v) * 32 + lane] = l[u][v];
        }
#pragma unroll
        for (int v = 0; v < V; ++v) {
          m[v] = l[RM_ROWS - 1][v];
          st[v] |= ((1u << RM_ROWS) - 1u) << r0;
        }
        continue;
      }
#pragma unroll
      for (int u = 0; u < RM_ROWS; ++u) {
        const int i = c * 32 + r0 + u;
        if (i < len) {
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const bool s = rm_start<V>(d[u], v);
            m[v] = s ? l[u][v] : min(m[v], l[u][v]);
            st[v] |= (s ? 1u : 0u) << (r0 + u);
            dirty[v] |= (m[v] != l[u][v] ? 1u : 0u) << (r0 + u);
            tile[((size_t)i * V + v) * 32 + lane] = m[v];
          }
        }
      }
    }
    if (len - c * 32 < 32) {  // no start bits past the end of the line
#pragma unroll
      for (int v = 0; v < V; ++v) st[v] &= (1u << (len - c * 32)) - 1u;
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      masks[((size_t)(c * 2 + 0) * V + v) * 32 + lane] = st[v];
      masks[((size_t)(c * 2 + 1) * V + v) * 32 + lane] = dirty[v];
      if (first[v] == len && st[v]) first[v] = c * 32 + __ffs(st[v]) - 1;
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    // no start before `first`, so f of the row before it is the leading run's minimum
    if (live && first[v] > c0 * 32)
      head[v] = first[v] == len ? m[v] : tile[((size_t)(first[v] - 1) * V + v) * 32 + lane];
    seg_head[(warp * V + v) * 32 + lane] = head[v];
    seg_tail[(warp * V + v) * 32 + lane] = m[v];
    seg_start[(warp * V + v) * 32 + lane] = (first[v] != len ? 1 : 0) | (first[v] == c0 * 32 ? 2 : 0);
  }
  __syncthreads();

  bool chg = false;
  int32_t cf[V], g[V];
  uint32_t nxt[V];  // the row after the chunk at hand starts a run
#pragma unroll
  for (int v = 0; v < V; ++v) {
    cf[v] = g[v] = MAMRI_BIG;
    nxt[v] = warp + 1 < segs ? (uint32_t)seg_start[((warp + 1) * V + v) * 32 + lane] >> 1 : 1u;
    for (int s = warp - 1; s >= 0; --s) {
      cf[v] = min(cf[v], seg_tail[(s * V + v) * 32 + lane]);
      if (seg_start[(s * V + v) * 32 + lane]) break;
    }
    for (int s = warp + 1; s < segs; ++s) {
      g[v] = min(g[v], seg_head[(s * V + v) * 32 + lane]);
      if (seg_start[(s * V + v) * 32 + lane]) break;
    }
  }
  for (int c = c1 - 1; c >= c0; --c) {
    uint32_t st[V], dirty[V], ends[V];
    bool quiet = true;  // every row a run of its own, the last one too: nothing to write
#pragma unroll
    for (int v = 0; v < V; ++v) {
      st[v] = masks[((size_t)(c * 2 + 0) * V + v) * 32 + lane];
      quiet &= (st[v] == RD_FULL && nxt[v]) || !live;
    }
    if (__all_sync(RD_FULL, quiet)) continue;  // (nxt stays 1, and g is not read past a start)
    if (live) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        dirty[v] = masks[((size_t)(c * 2 + 1) * V + v) * 32 + lane];
        ends[v] = (st[v] >> 1) | (nxt[v] << 31);  // bit r: row r + 1 starts a run
        nxt[v] = st[v] & 1u;
      }
#pragma unroll
      for (int r = 31; r >= 0; --r) {
        const int i = c * 32 + r;
        if (i < len) {
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const int32_t f = tile[((size_t)i * V + v) * 32 + lane];
            g[v] = (ends[v] >> r) & 1u ? f : min(f, g[v]);
            const int32_t out = i < first[v] ? min(g[v], cf[v]) : g[v];
            if (out != f || ((dirty[v] >> r) & 1u)) {
              lab[base + (long long)i * inner + v] = out;
              chg = true;
            }
          }
        }
      }
    }
  }
  rm_flag(chg, changed);
}

// Contiguous lines (inner == 1): one warp per line, V labels a lane, so a
// warp reads CH = 32 V consecutive labels per step. A lane scans its V
// voxels, a 5-step segmented shuffle scan joins the lanes (a lane takes from
// the lanes below it only while none of them holds a start), and the chunk's
// last lane carries the open run into the next chunk; the backward walk is
// the mirror image over f and the start ballots kept in shared memory. Cells
// past the end of the line act as background.
template <int V>
__global__ void __launch_bounds__(RM_LINE_WARPS * 32)
    run_min_lines_kernel(int32_t* __restrict__ lab, const int16_t* __restrict__ df, long long lines,
                         int len, int32_t* __restrict__ changed) {
  extern __shared__ uint32_t rd_smem[];
  constexpr int CH = 32 * V;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long line = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  const int nchunks = (len + CH - 1) / CH;
  int32_t* tile = (int32_t*)rd_smem + (size_t)warp * nchunks * (CH + 2 * V);  // [chunk][v][lane]: f
  uint32_t* masks = (uint32_t*)(tile + (size_t)nchunks * CH);  // [chunk][start, dirty][v]: ballots
  const long long base = line * len;
  bool chg = false;
  if (line < lines) {  // the whole warp
    int32_t carry = MAMRI_BIG;  // the open run's minimum at the end of the chunks already walked
    int32_t l[V], ln[V];
    bool s[V], sn[V];
#pragma unroll
    for (int v = 0; v < V; ++v) l[v] = MAMRI_BIG, s[v] = true;
    if (V * lane < len) rm_load<V>(lab + base + V * lane, df + base + V * lane, l, s);
    for (int c = 0; c < nchunks; ++c) {
      const int pos = c * CH + V * lane;
#pragma unroll
      for (int v = 0; v < V; ++v) ln[v] = MAMRI_BIG, sn[v] = true;
      if (pos + CH < len) rm_load<V>(lab + base + pos + CH, df + base + pos + CH, ln, sn);
      bool lone = true;
#pragma unroll
      for (int v = 0; v < V; ++v) lone &= s[v];
      if (__all_sync(RD_FULL, lone)) {  // background, 1-voxel runs: f is the label
#pragma unroll
        for (int v = 0; v < V; ++v) {
          tile[((size_t)c * V + v) * 32 + lane] = l[v];
          if (lane == 0) {
            masks[(c * 2 + 0) * V + v] = RD_FULL;
            masks[(c * 2 + 1) * V + v] = 0u;
          }
        }
        carry = __shfl_sync(RD_FULL, l[V - 1], 31);
#pragma unroll
        for (int v = 0; v < V; ++v) l[v] = ln[v], s[v] = sn[v];
        continue;
      }
      int32_t f[V], mv = MAMRI_BIG;
      int lead = V;  // the lane's voxels before its first start
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (s[v] && lead == V) lead = v;
        mv = s[v] ? l[v] : min(mv, l[v]);
        f[v] = mv;
      }
      int fl = lead < V;  // lanes 0..lane hold a start
      for (int d = 1; d < 32; d <<= 1) {
        const int32_t vs = __shfl_up_sync(RD_FULL, mv, d);
        const int fs = __shfl_up_sync(RD_FULL, fl, d);
        if (lane >= d) {
          if (!fl) mv = min(mv, vs);
          fl |= fs;
        }
      }
      int32_t in = __shfl_up_sync(RD_FULL, mv, 1);  // the open run's minimum before this lane
      const int in_fl = __shfl_up_sync(RD_FULL, fl, 1);
      if (lane == 0) in = carry;
      else if (!in_fl) in = min(in, carry);
      const int32_t top = __shfl_sync(RD_FULL, mv, 31);
      carry = __shfl_sync(RD_FULL, fl, 31) ? top : min(top, carry);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (v < lead) f[v] = min(f[v], in);
        tile[((size_t)c * V + v) * 32 + lane] = f[v];
        const uint32_t bs = __ballot_sync(RD_FULL, s[v]);
        const uint32_t bd = __ballot_sync(RD_FULL, f[v] != l[v]);
        if (lane == 0) {
          masks[(c * 2 + 0) * V + v] = bs;
          masks[(c * 2 + 1) * V + v] = bd;
        }
        l[v] = ln[v], s[v] = sn[v];
      }
    }
    __syncwarp();

    carry = MAMRI_BIG;      // the rest of the open run in the chunks already walked
    uint32_t nxt = 1u;      // the voxel after the chunk at hand starts a run
    for (int c = nchunks - 1; c >= 0; --c) {
      const int pos = c * CH + V * lane;
      bool quiet = nxt;  // every voxel a run of its own, the last one too: nothing to write
#pragma unroll
      for (int v = 0; v < V; ++v)
        quiet &= masks[(c * 2 + 0) * V + v] == RD_FULL && masks[(c * 2 + 1) * V + v] == 0u;
      if (quiet) continue;  // (nxt stays 1, and a chunk that ends in a start reads no carry)
      int32_t f[V], g[V], mv = MAMRI_BIG;
      bool ends[V], dirty[V];
      int trail = -1;  // the lane's last voxel that ends a run
#pragma unroll
      for (int v = 0; v < V; ++v) {
        f[v] = tile[((size_t)c * V + v) * 32 + lane];
        dirty[v] = (masks[(c * 2 + 1) * V + v] >> lane) & 1u;
      }
      const uint32_t first = masks[(c * 2 + 0) * V];  // start bits of every lane's voxel 0
#pragma unroll
      for (int v = 0; v < V - 1; ++v) ends[v] = (masks[(c * 2 + 0) * V + v + 1] >> lane) & 1u;
      ends[V - 1] = lane == 31 ? nxt : (first >> (lane + 1)) & 1u;
      nxt = first & 1u;
#pragma unroll
      for (int v = V - 1; v >= 0; --v) {
        if (ends[v] && trail < 0) trail = v;
        mv = ends[v] ? f[v] : min(f[v], mv);
        g[v] = mv;
      }
      int fl = trail >= 0;  // lanes lane..31 hold the end of a run
      for (int d = 1; d < 32; d <<= 1) {
        const int32_t vs = __shfl_down_sync(RD_FULL, mv, d);
        const int fs = __shfl_down_sync(RD_FULL, fl, d);
        if (lane + d < 32) {
          if (!fl) mv = min(mv, vs);
          fl |= fs;
        }
      }
      int32_t in = __shfl_down_sync(RD_FULL, mv, 1);
      const int in_fl = __shfl_down_sync(RD_FULL, fl, 1);
      if (lane == 31) in = carry;
      else if (!in_fl) in = min(in, carry);
      const int32_t bottom = __shfl_sync(RD_FULL, mv, 0);
      carry = __shfl_sync(RD_FULL, fl, 0) ? bottom : min(bottom, carry);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (v > trail) g[v] = min(g[v], in);
        if (pos + v < len && (g[v] != f[v] || dirty[v])) {
          lab[base + pos + v] = g[v];
          chg = true;
        }
      }
    }
  }
  rm_flag(chg, changed);
}

// Strided lines too long for a strip in shared memory: one thread per line
// walks it run by run (the run's length from db), reading each run twice.
__global__ void run_min_walk_kernel(int32_t* __restrict__ lab, const int16_t* __restrict__ df,
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
template <int V>
static int rm_launch_lines(int32_t* lab, const int16_t* df, long long lines, int len,
                           int32_t* changed, cudaStream_t stream) {
  const size_t per_warp = (size_t)((len + 32 * V - 1) / (32 * V)) * (32 * V + 2 * V) * sizeof(int32_t);
  int warps = RM_LINE_WARPS;
  while (warps > 1 && warps * per_warp > 48 * 1024) warps >>= 1;  // long lines: fewer a block
  const size_t smem = warps * per_warp;  // one line of 32,766 is 139 KB
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        run_min_lines_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned blocks = (unsigned)((lines + warps - 1) / warps);
  run_min_lines_kernel<V><<<blocks, warps * 32, smem, stream>>>(lab, df, lines, len, changed);
  return (int)cudaGetLastError();
}

static size_t rm_strip_smem(int v, int len, int segs) {
  return ((size_t)len + (size_t)((len + 31) / 32) * 2 + 3 * segs) * 32 * v * sizeof(int32_t);
}

template <int V>
static int rm_launch_strips(int32_t* lab, const int16_t* df, long long cols, int len,
                            long long inner, int segs, int32_t* changed, cudaStream_t stream) {
  const size_t smem = rm_strip_smem(V, len, segs);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        run_min_strips_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned blocks = (unsigned)((cols + 32 * V - 1) / (32 * V));
  run_min_strips_kernel<V><<<blocks, segs * 32, smem, stream>>>(lab, df, cols, len, inner, changed);
  return (int)cudaGetLastError();
}

extern "C" int mamri_run_min(int32_t* lab, const int16_t* df, const int16_t* db, int n0, int n1,
                             int n2, int axis, int32_t* changed, cudaStream_t stream) {
  const long long outer = axis == 2 ? (long long)n0 * n1 : axis == 1 ? n0 : 1;
  const int len = axis == 2 ? n2 : axis == 1 ? n1 : n0;
  const long long inner = axis == 2 ? 1 : axis == 1 ? n2 : (long long)n1 * n2;
  // V voxels a lane need lines (or columns) in whole groups of V and vector
  // loads on their natural boundaries; a view may start anywhere
  const long long unit = inner == 1 ? len : inner;
  const uintptr_t at = (uintptr_t)lab | ((uintptr_t)df << 1);
  const int widest = unit % 4 == 0 && at % 16 == 0 ? 4 : unit % 2 == 0 && at % 8 == 0 ? 2 : 1;
  if (inner == 1) {
    if (widest == 4) return rm_launch_lines<4>(lab, df, outer, len, changed, stream);
    if (widest == 2) return rm_launch_lines<2>(lab, df, outer, len, changed, stream);
    return rm_launch_lines<1>(lab, df, outer, len, changed, stream);
  }
  const int nchunks = (len + 31) / 32;
  const int segs = nchunks < RM_MAX_SEGS ? nchunks : RM_MAX_SEGS;
  // the widest strip that leaves room for three blocks on an SM, else the
  // narrowest: it is the one that fits the longest lines
  int v = widest;
  while (v > 1 && rm_strip_smem(v, len, segs) > RM_SMEM_SHARE) v >>= 1;
  const long long cols = outer * inner;
  if (rm_strip_smem(v, len, segs) <= RM_SMEM_MAX) {
    if (v == 4) return rm_launch_strips<4>(lab, df, cols, len, inner, segs, changed, stream);
    if (v == 2) return rm_launch_strips<2>(lab, df, cols, len, inner, segs, changed, stream);
    return rm_launch_strips<1>(lab, df, cols, len, inner, segs, changed, stream);
  }
  const long long lines = mamri_num_lines(axis, n0, n1, n2);
  run_min_walk_kernel<<<mamri_blocks(lines), MAMRI_THREADS, 0, stream>>>(lab, df, db, n0, n1, n2,
                                                                          axis, changed);
  return (int)cudaGetLastError();
}

extern "C" int mamri_check(const int32_t* lab, const int16_t* df, int n0, int n1, int n2, int axis,
                           int32_t* bad, cudaStream_t stream) {
  const long long n = (long long)n0 * n1 * n2;
  check_kernel<<<mamri_blocks(n), MAMRI_THREADS, 0, stream>>>(lab, df, n0, n1, n2, axis, bad);
  return (int)cudaGetLastError();
}

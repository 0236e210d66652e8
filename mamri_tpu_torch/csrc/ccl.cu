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
// card one thread walks one line:
//   * reset_distances: df = distance to the last background voxel at or
//     before the voxel (i + 1 where there is none), db = to the next one
//     at or after it (n - i where there is none), both int16;
//   * run_min: every voxel of a maximal foreground run (bounded by df/db)
//     gets the minimum label of that run -- exactly what the TPU's doubling
//     ladder computes. A change ORs 1 into a device flag. Labels only ever
//     decrease, so the flags ORed over axes mean "anything changed";
//   * check: one thread per voxel; bad iff df >= 2 (the -axis neighbour is in
//     the same run) and the two labels differ. 0 over all axes certifies the
//     exact CCL fixed point.
//
// What bounds it on the card: memory traffic, one pass over labels (read +
// write) and the two int16 distance arrays per axis. Lines along x and y are
// numbered so that neighbouring threads touch neighbouring z addresses
// (coalesced); along z each thread walks contiguous memory and relies on L1.
// A run is read twice (min, then write), which keeps the thread's state to a
// few registers.

#include "common.cuh"

__global__ void reset_distances_kernel(const int8_t* __restrict__ reset, int16_t* __restrict__ df,
                                       int16_t* __restrict__ db, int n0, int n1, int n2,
                                       int axis) {
  long long line = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (line >= mamri_num_lines(axis, n0, n1, n2)) return;
  long long base, stride;
  int len;
  mamri_line(axis, n0, n1, n2, line, &base, &stride, &len);
  int c = -1;
  for (int i = 0; i < len; ++i) {
    const long long p = base + i * stride;
    if (reset[p]) c = i;
    df[p] = (int16_t)(i - c);
  }
  c = len;
  for (int i = len - 1; i >= 0; --i) {
    const long long p = base + i * stride;
    if (reset[p]) c = i;
    db[p] = (int16_t)(c - i);
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
  const long long lines = mamri_num_lines(axis, n0, n1, n2);
  reset_distances_kernel<<<mamri_blocks(lines), MAMRI_THREADS, 0, stream>>>(reset, df, db, n0, n1,
                                                                             n2, axis);
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

// Shared helpers of the segmentation kernels (plain C interface, bound with
// ctypes from mamri_tpu_torch/perception/gpu_ops.py).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define MAMRI_BIG 2147483647  // background label sentinel (INT32_MAX)
#define MAMRI_THREADS 256

static inline unsigned int mamri_blocks(long long n) {
  return (unsigned int)((n + MAMRI_THREADS - 1) / MAMRI_THREADS);
}

// First position in the ascending a[0..n) whose value is not below v (n where
// every value is): the row of a label among sorted roots.
__device__ __forceinline__ int mamri_lower_bound(const int32_t* __restrict__ a, int n, int32_t v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// The block that finishes last of `blocks` blocks sharing a ticket (by
// default the whole grid), for blocks that write partial results and whose
// last one reads them all: every thread fences its writes, then one thread
// takes a ticket from a counter that was zero before the launch. True in
// every thread of the one block that drew the last ticket; that block then
// reads the partial results past L1 (__ldcg).
__device__ __forceinline__ bool mamri_last_block(unsigned int* ticket, unsigned int blocks) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == blocks - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

__device__ __forceinline__ bool mamri_last_block(unsigned int* ticket) {
  return mamri_last_block(ticket, gridDim.x);
}

// Geometry of one line along `axis` of a C-contiguous (n0, n1, n2) volume:
// its first element, the stride between neighbours and its length. Lines are
// numbered so that neighbouring line ids sit at neighbouring addresses
// wherever the axis allows it (coalesced walks for axes 0 and 1).
__device__ __forceinline__ void mamri_line(int axis, int n0, int n1, int n2, long long line,
                                           long long* base, long long* stride, int* len) {
  if (axis == 2) {
    *base = line * n2;
    *stride = 1;
    *len = n2;
  } else if (axis == 1) {
    long long i = line / n2, k = line % n2;
    *base = i * (long long)n1 * n2 + k;
    *stride = n2;
    *len = n1;
  } else {
    *base = line;
    *stride = (long long)n1 * n2;
    *len = n0;
  }
}

__host__ __device__ __forceinline__ long long mamri_num_lines(int axis, int n0, int n1, int n2) {
  return axis == 2 ? (long long)n0 * n1 : axis == 1 ? (long long)n0 * n2 : (long long)n1 * n2;
}

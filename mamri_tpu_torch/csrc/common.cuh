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

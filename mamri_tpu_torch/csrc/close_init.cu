// Threshold + exact ball(2) closing + CCL label init.
//
// Replaces mamri_tpu/perception/pallas_ops.py:211 `fused_threshold_close_init`
// (kernel `_close_kernel` :177 with `_ball2_pass` :157).
//
// Semantics (safe-border closing, mamri_tpu/perception/segmentation.py:166):
// a voxel is in band iff lo <= v <= hi; NaN and every voxel outside the
// volume are out of band. The dilation is evaluated on the volume grown by 2
// on every side (so it never clips at the border), the erosion at each
// in-volume voxel. ball(2) is the 3x3x3 box plus the six axis points at
// distance 2 (33 offsets). The label of a closed voxel is its (z, y, x)
// raster index k*nx*ny + j*nx + i; background gets INT32_MAX.
//
// What bounds it on the card: memory traffic. One read of the f32 volume,
// one int8 write + read of the dilation scratch, one int8 + one int32 write.
// The 33-offset stencils hit L1/L2, not device memory: neighbouring threads
// read neighbouring addresses along z. Two launches (dilate, then erode) in
// place of the TPU's 3-slab VMEM window: a grid-wide dependency between the
// passes is cheaper as a kernel boundary than as a halo exchange.

#include "common.cuh"

__device__ __forceinline__ bool in_band(const float* data, int nx, int ny, int nz, int i, int j,
                                        int k, float lo, float hi) {
  if (i < 0 || j < 0 || k < 0 || i >= nx || j >= ny || k >= nz) return false;
  float v = data[((long long)i * ny + j) * nz + k];
  return v >= lo && v <= hi;  // false for NaN
}

__global__ void close_dilate_kernel(const float* __restrict__ data, int8_t* __restrict__ dil,
                                    int nx, int ny, int nz, float lo, float hi) {
  const long long gy = ny + 4, gz = nz + 4;
  const long long n = (long long)(nx + 4) * gy * gz;
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const int k = (int)(t % gz) - 2;
  const long long r = t / gz;
  const int j = (int)(r % gy) - 2;
  const int i = (int)(r / gy) - 2;
  bool hit = false;
  for (int dx = -1; dx <= 1 && !hit; ++dx)
    for (int dy = -1; dy <= 1 && !hit; ++dy)
      for (int dz = -1; dz <= 1 && !hit; ++dz)
        hit = in_band(data, nx, ny, nz, i + dx, j + dy, k + dz, lo, hi);
  hit = hit || in_band(data, nx, ny, nz, i - 2, j, k, lo, hi) ||
        in_band(data, nx, ny, nz, i + 2, j, k, lo, hi) ||
        in_band(data, nx, ny, nz, i, j - 2, k, lo, hi) ||
        in_band(data, nx, ny, nz, i, j + 2, k, lo, hi) ||
        in_band(data, nx, ny, nz, i, j, k - 2, lo, hi) ||
        in_band(data, nx, ny, nz, i, j, k + 2, lo, hi);
  dil[t] = hit ? 1 : 0;
}

__global__ void close_erode_kernel(const int8_t* __restrict__ dil, int8_t* __restrict__ mask,
                                   int32_t* __restrict__ lab, int nx, int ny, int nz) {
  const long long n = (long long)nx * ny * nz;
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const int k = (int)(t % nz);
  const long long r = t / nz;
  const int j = (int)(r % ny);
  const int i = (int)(r / ny);
  const long long gy = ny + 4, gz = nz + 4;
  // (i, j, k) in the grown grid is (i + 2, j + 2, k + 2)
  const long long c = ((long long)(i + 2) * gy + (j + 2)) * gz + (k + 2);
  bool all = true;
  for (int dx = -1; dx <= 1 && all; ++dx)
    for (int dy = -1; dy <= 1 && all; ++dy)
      for (int dz = -1; dz <= 1 && all; ++dz) all = dil[c + (dx * gy + dy) * gz + dz] != 0;
  all = all && dil[c - 2 * gy * gz] && dil[c + 2 * gy * gz] && dil[c - 2 * gz] &&
        dil[c + 2 * gz] && dil[c - 2] && dil[c + 2];
  mask[t] = all ? 1 : 0;
  lab[t] = all ? (int32_t)((long long)k * nx * ny + (long long)j * nx + i) : MAMRI_BIG;
}

extern "C" int mamri_close_init(const float* data, int8_t* dil_scratch, int8_t* mask,
                                int32_t* lab, int nx, int ny, int nz, float lo, float hi,
                                cudaStream_t stream) {
  const long long grown = (long long)(nx + 4) * (ny + 4) * (nz + 4);
  close_dilate_kernel<<<mamri_blocks(grown), MAMRI_THREADS, 0, stream>>>(data, dil_scratch, nx,
                                                                          ny, nz, lo, hi);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)nx * ny * nz;
  close_erode_kernel<<<mamri_blocks(n), MAMRI_THREADS, 0, stream>>>(dil_scratch, mask, lab, nx,
                                                                     ny, nz);
  return (int)cudaGetLastError();
}

extern "C" const char* mamri_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

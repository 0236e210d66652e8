// Bidirectional segmented min along the last axis of an (L, N) int32 array.
//
// Replaces mamri_tpu/perception/pallas_ops.py:93 `segmented_min_scan_lines`
// (kernel `_scan_lines_kernel` :53); `ccl_sweep_pallas` (:125) is this kernel
// run along z, y and x with transposes between the runs.
//
// Semantics, exactly the reference's associative scan: a cell with reset = 1
// starts a segment and keeps its own value; fwd[i] = lab[i] at a reset, else
// min(fwd[i-1], lab[i]); bwd the same from the right; out = min(fwd, bwd,
// lab). So every cell gets the minimum over its segment, the reset cells that
// bound it included (they hold the background sentinel in the CCL callers).
//
// The TPU's Hillis-Steele ladder exists because Mosaic has no sequential
// scan. Here one warp owns one line and walks it in chunks of 32 cells: each
// lane loads one cell (neighbouring lanes, neighbouring addresses), a 5-step
// shuffle scan combines the chunk, and the chunk's last (first) lane carries
// the running value into the next chunk of the forward (backward) walk. The
// forward walk writes fwd to `out`; the backward walk reads it back (the same
// lane wrote the same cell) and writes the minimum. Lanes beyond N act as
// reset cells holding the sentinel, which changes no real cell. Any L and N.
//
// What bounds it on the card: memory traffic. Each cell's lab and reset are
// read twice (once per direction) and out is written twice and read once,
// 28 bytes per cell against the 12 of the bound; a later version can keep
// short lines in registers and read everything once.

#include "common.cuh"

#define SCAN_WARPS 8

__global__ void __launch_bounds__(SCAN_WARPS * 32)
    scan_lines_kernel(const int32_t* __restrict__ lab, const int32_t* __restrict__ reset,
                      int32_t* __restrict__ out, long long num_lines, int n) {
  const int lane = threadIdx.x & 31;
  const long long line = (long long)blockIdx.x * SCAN_WARPS + (threadIdx.x >> 5);
  if (line >= num_lines) return;  // uniform across the warp
  const long long base = line * n;
  const int chunks = (n + 31) / 32;

  int32_t carry = MAMRI_BIG;  // min is the identity on the sentinel
  for (int c = 0; c < chunks; ++c) {
    const int i = c * 32 + lane;
    int32_t v = MAMRI_BIG;
    int f = 1;
    if (i < n) {
      v = lab[base + i];
      f = reset[base + i] != 0;
    }
    for (int d = 1; d < 32; d <<= 1) {  // inclusive scan from lane 0
      const int32_t vs = __shfl_up_sync(0xffffffffu, v, d);
      const int fs = __shfl_up_sync(0xffffffffu, f, d);
      if (lane >= d) {
        if (!f) v = min(v, vs);
        f |= fs;
      }
    }
    if (!f) v = min(v, carry);  // no reset in lanes 0..lane: the segment goes on
    carry = __shfl_sync(0xffffffffu, v, 31);
    if (i < n) out[base + i] = v;
  }

  carry = MAMRI_BIG;
  for (int c = chunks - 1; c >= 0; --c) {
    const int i = c * 32 + lane;
    int32_t v = MAMRI_BIG;
    int f = 1;
    if (i < n) {
      v = lab[base + i];
      f = reset[base + i] != 0;
    }
    for (int d = 1; d < 32; d <<= 1) {  // inclusive scan from lane 31
      const int32_t vs = __shfl_down_sync(0xffffffffu, v, d);
      const int fs = __shfl_down_sync(0xffffffffu, f, d);
      if (lane + d < 32) {
        if (!f) v = min(v, vs);
        f |= fs;
      }
    }
    if (!f) v = min(v, carry);
    carry = __shfl_sync(0xffffffffu, v, 0);
    if (i < n) out[base + i] = min(out[base + i], v);
  }
}

extern "C" int mamri_scan_lines(const int32_t* lab, const int32_t* reset, int32_t* out,
                                long long num_lines, int n, cudaStream_t stream) {
  const unsigned int blocks = (unsigned int)((num_lines + SCAN_WARPS - 1) / SCAN_WARPS);
  scan_lines_kernel<<<blocks, SCAN_WARPS * 32, 0, stream>>>(lab, reset, out, num_lines, n);
  return (int)cudaGetLastError();
}

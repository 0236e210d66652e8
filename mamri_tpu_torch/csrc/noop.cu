// The launch floor: an empty kernel, launched `launches` times in a row on one
// stream. Its time behind the same flush and spin as the other kernels is the
// least any wrapper of that many dependent launches can take on this card,
// whatever its bytes; chip_smoke.py prints it beside the kernels whose byte
// bound lies below one launch. It replaces no TPU kernel and no wrapper of the
// port launches it.

#include "common.cuh"

__global__ void noop_kernel() {}

extern "C" int mamri_noop(int launches, cudaStream_t stream) {
  for (int i = 0; i < launches; ++i) noop_kernel<<<1, 32, 0, stream>>>();
  return (int)cudaGetLastError();
}

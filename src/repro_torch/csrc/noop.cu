// A kernel that does nothing, launched with K1's launch shape for T rows
// in the given variant (csrc/gating.cuh, the shape functions gating.cu
// launches through: 128 threads and one row per thread for the row variant
// the path runs).  Its device time is the card's fixed cost of running any
// kernel of that shape, the floor under K1's time (chip_smoke.py times
// both).
#include <cuda_runtime.h>

#include "gating.cuh"

namespace {

__global__ void noop_kernel() {}

}  // namespace

extern "C" int noop_launch(int T, int variant, void* stream) {
  if (T <= 0 || (variant != kRowVariant && variant != kWarpVariant))
    return cudaErrorInvalidValue;
  noop_kernel<<<gating_blocks(T, variant), gating_threads(variant), 0,
                (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

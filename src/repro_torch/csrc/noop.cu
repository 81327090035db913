// A kernel that does nothing, launched with K1's launch shape (256 threads,
// one block per 8 rows: csrc/gating.cu).  Its device time is the card's
// fixed cost of running any kernel of that shape, the floor under K1's
// time (chip_smoke.py times both).
#include <cuda_runtime.h>

namespace {

__global__ void noop_kernel() {}

}  // namespace

extern "C" int noop_launch(int T, void* stream) {
  if (T <= 0) return cudaErrorInvalidValue;
  const int threads = 256;                 // as gating_launch
  const int blocks = (T + threads / 32 - 1) / (threads / 32);
  noop_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

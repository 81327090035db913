// Fused MoE router: softmax / sigmoid / raw logits, k rounds of masked
// argmax (ties to the lowest index), then the gate transform.
//
// Replaces: src/repro/kernels/gating/kernel.py::gating (Pallas `_kernel`).
//
// Bound on the H100: bytes.  A row is E <= 256 float32 logits and the
// work per byte is a handful of exp/compare operations, far below the
// card's ~295 operations per byte, so the (T, E) read and the (T, E)
// probability write set the time.  At the main path's shapes (E = 8,
// T <= 512) the whole call moves a few tens of KB and is launch-bound.
//
// Design: one warp per row.  Each lane holds ceil(E/32) columns in
// registers, so the softmax reductions and every argmax round are warp
// shuffles with no shared memory and no block synchronisation; a row is
// read from device memory once.  The kernel also writes the (T, E) router
// probabilities that `route` returns, so they are not computed twice.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxE = 256;
constexpr int kPerLane = kMaxE / 32;
constexpr int kMaxK = 16;
constexpr float kNeg = -1e30f;   // the Pallas kernel's finite mask value

enum RouterType { kSoftmaxTopk = 0, kTopkSoftmax = 1, kSigmoid = 2 };

__global__ void gating_kernel(const float* __restrict__ logits,
                              float* __restrict__ gates,
                              int* __restrict__ idx,
                              float* __restrict__ probs,
                              int T, int E, int k, int router_type,
                              int renormalize) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= T) return;
  const float* x = logits + (size_t)row * E;

  float v[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int c = lane + 32 * j;
    v[j] = (c < E) ? x[c] : kNeg;
  }
  // softmax over the row (also needed by topk_softmax for `probs`)
  float m = kNeg;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) m = fmaxf(m, v[j]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  float ex[kPerLane];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int c = lane + 32 * j;
    ex[j] = (c < E) ? expf(v[j] - m) : 0.f;
    s += ex[j];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);

  float w[kPerLane];   // the values the argmax rounds select over
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int c = lane + 32 * j;
    const float p = (router_type == kSigmoid) ? 1.f / (1.f + expf(-v[j]))
                                              : ex[j] / s;
    if (c < E) {
      if (probs != nullptr) probs[(size_t)row * E + c] = p;
      w[j] = (router_type == kTopkSoftmax) ? v[j] : p;
    } else {
      w[j] = -INFINITY;   // never selected, not even over masked columns
    }
  }

  float gv[kMaxK];
  int gi[kMaxK];
  for (int r = 0; r < k; ++r) {
    float best = -INFINITY;
    int bi = 0x7fffffff;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {   // columns ascend with j
      if (w[j] > best) { best = w[j]; bi = lane + 32 * j; }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (ob > best || (ob == best && oi < bi)) { best = ob; bi = oi; }
    }
    gv[r] = best;
    gi[r] = bi;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j)
      if (lane + 32 * j == bi) w[j] = kNeg;
  }

  if (lane != 0) return;
  if (router_type == kTopkSoftmax) {
    float gm = gv[0];
    for (int r = 1; r < k; ++r) gm = fmaxf(gm, gv[r]);
    float gs = 0.f;
    for (int r = 0; r < k; ++r) { gv[r] = expf(gv[r] - gm); gs += gv[r]; }
    for (int r = 0; r < k; ++r) gv[r] /= gs;
  } else if (router_type == kSoftmaxTopk && renormalize) {
    float gs = 0.f;
    for (int r = 0; r < k; ++r) gs += gv[r];
    for (int r = 0; r < k; ++r) gv[r] /= (gs + 1e-9f);
  }
  for (int r = 0; r < k; ++r) {
    gates[(size_t)row * k + r] = gv[r];
    idx[(size_t)row * k + r] = gi[r];
  }
}

}  // namespace

extern "C" int gating_launch(const void* logits, void* gates, void* idx,
                             void* probs, int T, int E, int k,
                             int router_type, int renormalize,
                             void* stream) {
  if (E > kMaxE || k > kMaxK || k > E || T <= 0) return cudaErrorInvalidValue;
  const int threads = 256;                 // 8 rows per block
  const int blocks = (T + threads / 32 - 1) / (threads / 32);
  gating_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)logits, (float*)gates, (int*)idx, (float*)probs, T, E, k,
      router_type, renormalize);
  return (int)cudaGetLastError();
}

// Fused MoE router (K1): softmax / sigmoid / raw logits, k rounds of
// masked argmax (ties to the lowest index), then the gate transform.
//
// Replaces: src/repro/kernels/gating/kernel.py:72 (`gating`, the Pallas
// `_kernel`).
//
// Bound on the H100: the launch floor.  A call moves a few KB to a few
// hundred KB (T rows of E <= 256 float32 logits in; the (T, E)
// probabilities and the (T, k) gates and indices out) and does a handful
// of operations per byte, so its byte bound is nanoseconds.  The least
// time it can take is what any kernel of its launch shape costs the card:
// the no-op kernel of csrc/noop.cu, launched through the same shape
// functions (csrc/gating.cuh).  Above that floor a call's time is the
// length of the chain of dependent steps each row goes through.
//
// Design against that chain:
// - Row variant (E <= 32; the path's Mixtral router has E = 8): one thread
//   owns one row in registers, 128 rows per block, so a decode batch is
//   one block.  Templated on the padded width W (8, 16 or 32; pad columns
//   are -inf and never selected) and on the router type, so for
//   topk_softmax the argmax rounds over the logits do not wait for the
//   softmax.  In the full form (E == W, aligned rows; templated on k too)
//   the row comes in as float4 vectors (neighbouring threads hold
//   neighbouring rows, so a warp's loads are contiguous) and probs, gates
//   and idx leave as vector stores, with nothing predicated on E.  Max,
//   exp and sum are unrolled trees.  Each argmax round is a tree over the
//   columns in ascending order in which the higher-index side wins only
//   when strictly greater, so ties go to the lowest index.  No shuffles,
//   no shared memory, no barriers.
// - Warp variant (E > 32): one warp per row, ceil(E/32) columns per lane
//   in registers (a template argument), warp shuffles for the reductions
//   and the argmax rounds.
// kernels/gating/ops.py::plan picks the variant and width from (E, k).
//
// Accuracy: the values the argmax rounds select over (the probabilities
// written to `probs`) use IEEE expf and division, as torch.softmax does,
// so `idx` equals the plain version's exactly; no fast-math intrinsics.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gating.cuh"

namespace {

constexpr int kMaxE = 256;
constexpr int kMaxK = 16;
constexpr float kNeg = -1e30f;   // the Pallas kernel's finite mask value

enum RouterType { kSoftmaxTopk = 0, kTopkSoftmax = 1, kSigmoid = 2 };

struct Args {
  const float* logits;
  float* gates;
  int* idx;
  float* probs;
  int T, E, k, router_type, renormalize;
};

// topk_softmax: softmax over the k selected logits; softmax_topk with
// renormalize: the selected probabilities over their sum (+1e-9).  Only
// g[0 .. k) are read and written.
template <int N>
__device__ __forceinline__ void gate_transform(float (&g)[N], int k,
                                               int router_type,
                                               int renormalize) {
  if (router_type == kTopkSoftmax) {
    float gm = g[0];
#pragma unroll
    for (int r = 1; r < N; ++r)
      if (r < k) gm = fmaxf(gm, g[r]);
    float gs = 0.f;
#pragma unroll
    for (int r = 0; r < N; ++r)
      if (r < k) { g[r] = expf(g[r] - gm); gs += g[r]; }
#pragma unroll
    for (int r = 0; r < N; ++r)
      if (r < k) g[r] /= gs;
  } else if (router_type == kSoftmaxTopk && renormalize) {
    float gs = 0.f;
#pragma unroll
    for (int r = 0; r < N; ++r)
      if (r < k) gs += g[r];
#pragma unroll
    for (int r = 0; r < N; ++r)
      if (r < k) g[r] /= (gs + 1e-9f);
  }
}

// ---------------------------------------------------------------- row variant

// Unrolled trees: each level pairs element 2j with 2j + 1 (template
// recursion, so every loop has a constant trip count and the arrays stay in
// registers).
template <int N>
__device__ __forceinline__ float tree_max(const float (&v)[N]) {
  if constexpr (N == 1) {
    return v[0];
  } else {
    float t[N / 2];
#pragma unroll
    for (int j = 0; j < N / 2; ++j) t[j] = fmaxf(v[2 * j], v[2 * j + 1]);
    return tree_max(t);
  }
}

template <int N>
__device__ __forceinline__ float tree_sum(const float (&v)[N]) {
  if constexpr (N == 1) {
    return v[0];
  } else {
    float t[N / 2];
#pragma unroll
    for (int j = 0; j < N / 2; ++j) t[j] = v[2 * j] + v[2 * j + 1];
    return tree_sum(t);
  }
}

// The first column holding the maximum of b (columns i, ascending), and
// that maximum: of each pair the higher-index side wins only when strictly
// greater.
template <int N>
__device__ __forceinline__ int tree_argmax(const float (&b)[N],
                                           const int (&i)[N], float& best) {
  if constexpr (N == 1) {
    best = b[0];
    return i[0];
  } else {
    float nb[N / 2];
    int ni[N / 2];
#pragma unroll
    for (int j = 0; j < N / 2; ++j) {
      const bool hi = b[2 * j + 1] > b[2 * j];
      nb[j] = hi ? b[2 * j + 1] : b[2 * j];
      ni[j] = hi ? i[2 * j + 1] : i[2 * j];
    }
    return tree_argmax(nb, ni, best);
  }
}

__device__ __forceinline__ float4 make4(float a, float b, float c, float d) {
  return make_float4(a, b, c, d);
}
__device__ __forceinline__ int4 make4(int a, int b, int c, int d) {
  return make_int4(a, b, c, d);
}
__device__ __forceinline__ float2 make2(float a, float b) {
  return make_float2(a, b);
}
__device__ __forceinline__ int2 make2(int a, int b) { return make_int2(a, b); }

// K values to dst (16-byte aligned when K % 4 == 0, 8-byte when K % 2 == 0)
template <int K, typename T>
__device__ __forceinline__ void store_row(T* dst, const T (&v)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int q = 0; q < K / 4; ++q) {
      auto t = make4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
      *reinterpret_cast<decltype(t)*>(dst + 4 * q) = t;
    }
  } else if constexpr (K % 2 == 0) {
#pragma unroll
    for (int q = 0; q < K / 2; ++q) {
      auto t = make2(v[2 * q], v[2 * q + 1]);
      *reinterpret_cast<decltype(t)*>(dst + 2 * q) = t;
    }
  } else {
#pragma unroll
    for (int r = 0; r < K; ++r) dst[r] = v[r];
  }
}

// K > 0, the full form: E == W, logits and probs 16-byte aligned, k == K.
// The row is W / 4 float4 vectors and nothing is predicated on E.  K == 0,
// the padded form (E < W or unaligned logits; the path never takes it):
// scalar loads and stores predicated on E, pad columns -inf, k a runtime
// bound on min(W, kMaxK) unrolled rounds.  Splitting the two keeps the
// path's kernel free of predicates without a second instantiation per k.
template <int W, int K, int RT>
__global__ void __launch_bounds__(kRowThreads)
gating_row_kernel(const Args a) {
  constexpr bool kFull = K > 0;
  constexpr int NK = kFull ? K : (W < kMaxK ? W : kMaxK);
  const int row = blockIdx.x * kRowThreads + threadIdx.x;
  if (row >= a.T) return;
  const int E = kFull ? W : a.E;
  const int k = kFull ? K : a.k;
  const float* x = a.logits + (size_t)row * E;
  float v[W];
  if constexpr (kFull) {
#pragma unroll
    for (int q = 0; q < W / 4; ++q) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(x) + q);
      v[4 * q] = t.x;
      v[4 * q + 1] = t.y;
      v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < W; ++c) v[c] = (c < E) ? __ldg(x + c) : -INFINITY;
  }

  float p[W];   // the router probabilities; pad columns come out 0
  if constexpr (RT == kSigmoid) {
#pragma unroll
    for (int c = 0; c < W; ++c) p[c] = 1.f / (1.f + expf(-v[c]));
  } else {
    const float m = tree_max(v);
#pragma unroll
    for (int c = 0; c < W; ++c) p[c] = expf(v[c] - m);
    const float s = tree_sum(p);
#pragma unroll
    for (int c = 0; c < W; ++c) p[c] = p[c] / s;
  }
  float* out = a.probs + (size_t)row * E;
  if constexpr (kFull) {
#pragma unroll
    for (int q = 0; q < W / 4; ++q)
      reinterpret_cast<float4*>(out)[q] =
          make_float4(p[4 * q], p[4 * q + 1], p[4 * q + 2], p[4 * q + 3]);
  } else {
#pragma unroll
    for (int c = 0; c < W; ++c)
      if (c < E) out[c] = p[c];
  }

  float w[W];   // the values the argmax rounds select over
#pragma unroll
  for (int c = 0; c < W; ++c)
    w[c] = (!kFull && c >= E) ? -INFINITY : (RT == kTopkSoftmax ? v[c] : p[c]);
  int col[W];
#pragma unroll
  for (int c = 0; c < W; ++c) col[c] = c;
  float g[NK];
  int gi[NK];
#pragma unroll
  for (int r = 0; r < NK; ++r) {
    if (r < k) {
      gi[r] = tree_argmax(w, col, g[r]);
#pragma unroll
      for (int c = 0; c < W; ++c)
        if (c == gi[r]) w[c] = kNeg;
    }
  }
  gate_transform(g, k, RT, a.renormalize);
  if constexpr (kFull) {
    store_row(a.gates + (size_t)row * K, g);
    store_row(a.idx + (size_t)row * K, gi);
  } else {
#pragma unroll
    for (int r = 0; r < NK; ++r)
      if (r < k) {
        a.gates[(size_t)row * k + r] = g[r];
        a.idx[(size_t)row * k + r] = gi[r];
      }
  }
}

// --------------------------------------------------------------- warp variant

template <int PL>
__global__ void __launch_bounds__(kWarpThreads)
gating_warp_kernel(const Args a) {
  const int row = (blockIdx.x * kWarpThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= a.T) return;   // whole warps: the row is the warp's
  const int E = a.E, k = a.k;
  const float* x = a.logits + (size_t)row * E;

  float v[PL];
#pragma unroll
  for (int j = 0; j < PL; ++j) {
    const int c = lane + 32 * j;
    v[j] = (c < E) ? x[c] : kNeg;
  }
  // softmax over the row (also needed by topk_softmax for `probs`)
  float m = kNeg;
#pragma unroll
  for (int j = 0; j < PL; ++j) m = fmaxf(m, v[j]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  float ex[PL];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < PL; ++j) {
    const int c = lane + 32 * j;
    ex[j] = (c < E) ? expf(v[j] - m) : 0.f;
    s += ex[j];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);

  float w[PL];   // the values the argmax rounds select over
#pragma unroll
  for (int j = 0; j < PL; ++j) {
    const int c = lane + 32 * j;
    const float p = (a.router_type == kSigmoid) ? 1.f / (1.f + expf(-v[j]))
                                                : ex[j] / s;
    if (c < E) {
      a.probs[(size_t)row * E + c] = p;
      w[j] = (a.router_type == kTopkSoftmax) ? v[j] : p;
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
    for (int j = 0; j < PL; ++j) {   // columns ascend with j
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
    for (int j = 0; j < PL; ++j)
      if (lane + 32 * j == bi) w[j] = kNeg;
  }

  if (lane != 0) return;
  gate_transform(gv, k, a.router_type, a.renormalize);
  for (int r = 0; r < k; ++r) {
    a.gates[(size_t)row * k + r] = gv[r];
    a.idx[(size_t)row * k + r] = gi[r];
  }
}

// ------------------------------------------------------------------ launches

template <int W, int RT, int K = 1>
int launch_row_full(const Args& a, cudaStream_t s) {
  if constexpr (K > W || K > kMaxK) {
    return cudaErrorInvalidValue;
  } else {
    if (a.k != K) return launch_row_full<W, RT, K + 1>(a, s);
    gating_row_kernel<W, K, RT><<<gating_blocks(a.T, kRowVariant),
                                  kRowThreads, 0, s>>>(a);
    return (int)cudaGetLastError();
  }
}

template <int W, int RT>
int launch_row(const Args& a, bool full, cudaStream_t s) {
  if (full) return launch_row_full<W, RT>(a, s);
  gating_row_kernel<W, 0, RT><<<gating_blocks(a.T, kRowVariant), kRowThreads,
                                0, s>>>(a);
  return (int)cudaGetLastError();
}

template <int W>
int launch_row_width(const Args& a, bool full, cudaStream_t s) {
  switch (a.router_type) {
    case kSoftmaxTopk: return launch_row<W, kSoftmaxTopk>(a, full, s);
    case kTopkSoftmax: return launch_row<W, kTopkSoftmax>(a, full, s);
    default: return launch_row<W, kSigmoid>(a, full, s);
  }
}

template <int PL = 2>
int launch_warp(const Args& a, int width, cudaStream_t s) {
  if constexpr (PL > kMaxE / 32) {
    return cudaErrorInvalidValue;
  } else {
    if (width != PL) return launch_warp<PL + 1>(a, width, s);
    gating_warp_kernel<PL><<<gating_blocks(a.T, kWarpVariant), kWarpThreads,
                             0, s>>>(a);
    return (int)cudaGetLastError();
  }
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

}  // namespace

// variant, width: kernels/gating/ops.py::plan -- kRowVariant with the padded
// row width (8, 16, 32), or kWarpVariant with the columns per lane (2..8).
extern "C" int gating_launch(const void* logits, void* gates, void* idx,
                             void* probs, int T, int E, int k,
                             int router_type, int renormalize, int variant,
                             int width, void* stream) {
  if (T <= 0 || E < 1 || E > kMaxE || k < 1 || k > kMaxK || k > E ||
      router_type < kSoftmaxTopk || router_type > kSigmoid)
    return cudaErrorInvalidValue;
  const Args a{(const float*)logits, (float*)gates, (int*)idx, (float*)probs,
               T, E, k, router_type, renormalize};
  const cudaStream_t s = (cudaStream_t)stream;
  if (variant == kRowVariant) {
    if (E > width || !aligned16(gates) || !aligned16(idx))
      return cudaErrorInvalidValue;
    const bool full = E == width && aligned16(logits) && aligned16(probs);
    switch (width) {
      case 8: return launch_row_width<8>(a, full, s);
      case 16: return launch_row_width<16>(a, full, s);
      case 32: return launch_row_width<32>(a, full, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (variant == kWarpVariant && E <= 32 * width)
    return launch_warp(a, width, s);
  return cudaErrorInvalidValue;
}

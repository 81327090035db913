// Grouped gated expert FFN: for each row group g with weight set
// e = expert_ids[g] (or g), y_g = (act(x_g Wg_e) * (x_g Wu_e)) Wd_e.
// Rows at or beyond counts[g] are zero on the way in and on the way out.
//
// Replaces: src/repro/kernels/expert_ffn/kernel.py::expert_ffn, all three
// Pallas variants: `_kernel` (counts == nullptr: every row valid),
// `_kernel_ragged` (counts) and `_kernel_grouped` (counts + expert_ids).
//
// Bound on the H100: bytes at the main path's shapes.  One Mixtral expert
// is 3 * 4096 * 14336 * 2 B = 352 MB of weights against 2 * 3 * d * f
// FLOPs per token row, i.e. 3 FLOPs per weight byte per row: decode
// (<= 8 rows per expert) and short prefill (C = 80 at Sb = 256) sit far
// below the ~295 FLOPs per byte where the tensor cores would bound it.
//
// Design:
//  * Two launches per call.  Launch 1 computes h = act(x Wg) * (x Wu) per
//    (row tile, f tile) and stores h in the input dtype, exactly where the
//    Pallas kernel rounds it (`h.astype(wd.dtype)`).  Launch 2 computes
//    y = h Wd per (row tile, d tile), accumulating in float32 across every
//    f tile inside the block: the TPU grid's sequential f axis becomes a
//    loop, and nothing is carried between blocks.
//  * A row tile wholly at or past counts[g] returns before it loads any
//    weight (launch 2 zero-fills its output rows), so an expert without
//    tokens costs no weight bytes; the Pallas version still streamed them.
//  * Blocks walk row tiles fastest, so the row tiles of one weight tile run
//    back to back and re-read that tile from L2 rather than device memory.
//  * bf16 tensor-core products through WMMA 16x16x16 with float32
//    accumulators; operands stage through shared memory in 16-byte loads,
//    the next chunk's loads issued before the current chunk's products.
//    (wgmma and TMA are later work.)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BC = 16;       // token rows per tile (one WMMA M)
constexpr int BK = 32;       // contraction chunk per shared-memory stage
constexpr int BN = 64;       // output columns per block: 4 warps x 16
constexpr int THREADS = 128;
constexpr int XS = BK + 8;   // padded shared-memory row strides (elements)
constexpr int WS = BN + 8;
constexpr int OS = BN + 4;

__device__ __forceinline__ float act_fn(float x, int act) {
  if (act == 0) return x / (1.f + expf(-x));                    // silu
  if (act == 1) {                                               // gelu (tanh)
    const float c = 0.7978845608028654f;                        // sqrt(2/pi)
    return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
  }
  return fmaxf(x, 0.f);                                         // relu
}

__device__ __forceinline__ int valid_rows(const int* counts, int g, int C) {
  return counts != nullptr ? min(max(counts[g], 0), C) : C;
}

// ---------------------------------------------------------------------------
// launch 1: h[g, c, n] = act(x Wg)[c, n] * (x Wu)[c, n]
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
ffn_gate_up_kernel(const bf16* __restrict__ xe, const bf16* __restrict__ wg,
                   const bf16* __restrict__ wu,
                   const int* __restrict__ counts,
                   const int* __restrict__ expert_ids,
                   bf16* __restrict__ h, int C, int d, int f, int act) {
  const int c0 = blockIdx.x * BC;
  const int n0 = blockIdx.y * BN;
  const int g = blockIdx.z;
  const int nv = valid_rows(counts, g, C);
  if (c0 >= nv) return;                 // skip-empty: no loads, no products
  const int e = expert_ids != nullptr ? expert_ids[g] : g;

  __shared__ __align__(128) bf16 xs[BC][XS];
  __shared__ __align__(128) bf16 gs[BK][WS];
  __shared__ __align__(128) bf16 us[BK][WS];
  __shared__ __align__(128) float og[BC][OS];
  __shared__ __align__(128) float ou[BC][OS];

  const int t = threadIdx.x;
  const int warp = t >> 5;
  const bf16* xg = xe + (size_t)g * C * d;
  const bf16* wge = wg + (size_t)e * d * f;
  const bf16* wue = wu + (size_t)e * d * f;

  // per-thread 16-byte load slots: x tile 16x32 (64 slots), weight tiles
  // 32x64 (256 slots each: two per thread)
  const int xr = t >> 2, xc = (t & 3) * 8;
  const bool x_on = t < 64 && (c0 + xr) < nv;
  int wr[2], wc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = t + THREADS * i;
    wr[i] = s >> 3;
    wc[i] = (s & 7) * 8;
  }
  const int4 zero4 = make_int4(0, 0, 0, 0);
  int4 rx = zero4, rg[2], ru[2];
  auto load = [&](int k0) {
    rx = x_on ? *reinterpret_cast<const int4*>(xg + (size_t)(c0 + xr) * d + k0 + xc)
              : zero4;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const size_t off = (size_t)(k0 + wr[i]) * f + n0 + wc[i];
      rg[i] = *reinterpret_cast<const int4*>(wge + off);
      ru[i] = *reinterpret_cast<const int4*>(wue + off);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> accg, accu;
  wmma::fill_fragment(accg, 0.f);
  wmma::fill_fragment(accu, 0.f);
  load(0);
  for (int k0 = 0; k0 < d; k0 += BK) {
    if (t < 64) *reinterpret_cast<int4*>(&xs[xr][xc]) = rx;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      *reinterpret_cast<int4*>(&gs[wr[i]][wc[i]]) = rg[i];
      *reinterpret_cast<int4*>(&us[wr[i]][wc[i]]) = ru[i];
    }
    __syncthreads();
    if (k0 + BK < d) load(k0 + BK);     // next chunk in flight during the MMAs
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, &xs[0][kk], XS);
      wmma::load_matrix_sync(b, &gs[kk][warp * 16], WS);
      wmma::mma_sync(accg, a, b, accg);
      wmma::load_matrix_sync(b, &us[kk][warp * 16], WS);
      wmma::mma_sync(accu, a, b, accu);
    }
    __syncthreads();
  }
  wmma::store_matrix_sync(&og[0][warp * 16], accg, OS, wmma::mem_row_major);
  wmma::store_matrix_sync(&ou[0][warp * 16], accu, OS, wmma::mem_row_major);
  __syncthreads();

  // epilogue: 8 consecutive columns per thread, one 16-byte store
  const int r = t >> 3, cc = (t & 7) * 8;
  const int c = c0 + r;
  if (c < C) {
    __align__(16) bf16 out[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      out[j] = __float2bfloat16(act_fn(og[r][cc + j], act) * ou[r][cc + j]);
    *reinterpret_cast<int4*>(h + ((size_t)g * C + c) * f + n0 + cc) =
        *reinterpret_cast<const int4*>(out);
  }
}

// ---------------------------------------------------------------------------
// launch 2: y[g, c, n] = sum_f h[g, c, f] Wd[e, f, n], float32 accumulation
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
ffn_down_kernel(const bf16* __restrict__ h, const bf16* __restrict__ wd,
                const int* __restrict__ counts,
                const int* __restrict__ expert_ids,
                bf16* __restrict__ y, int C, int d, int f) {
  const int c0 = blockIdx.x * BC;
  const int n0 = blockIdx.y * BN;
  const int g = blockIdx.z;
  const int nv = valid_rows(counts, g, C);
  const int t = threadIdx.x;
  const int r = t >> 3, cc = (t & 7) * 8;
  bf16* yrow = y + ((size_t)g * C + c0 + r) * d + n0 + cc;
  const int4 zero4 = make_int4(0, 0, 0, 0);
  if (c0 >= nv) {                       // skip-empty: zero rows, no loads
    if (c0 + r < C) *reinterpret_cast<int4*>(yrow) = zero4;
    return;
  }
  const int e = expert_ids != nullptr ? expert_ids[g] : g;

  __shared__ __align__(128) bf16 hs[BC][XS];
  __shared__ __align__(128) bf16 ws[BK][WS];
  __shared__ __align__(128) float os[BC][OS];

  const int warp = t >> 5;
  const bf16* hg = h + (size_t)g * C * f;
  const bf16* wde = wd + (size_t)e * f * d;
  const int xr = t >> 2, xc = (t & 3) * 8;
  const bool h_on = t < 64 && (c0 + xr) < nv;
  int wr[2], wc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = t + THREADS * i;
    wr[i] = s >> 3;
    wc[i] = (s & 7) * 8;
  }
  int4 rh = zero4, rw[2];
  auto load = [&](int k0) {
    rh = h_on ? *reinterpret_cast<const int4*>(hg + (size_t)(c0 + xr) * f + k0 + xc)
              : zero4;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      rw[i] = *reinterpret_cast<const int4*>(
          wde + (size_t)(k0 + wr[i]) * d + n0 + wc[i]);
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fill_fragment(acc, 0.f);
  load(0);
  for (int k0 = 0; k0 < f; k0 += BK) {
    if (t < 64) *reinterpret_cast<int4*>(&hs[xr][xc]) = rh;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<int4*>(&ws[wr[i]][wc[i]]) = rw[i];
    __syncthreads();
    if (k0 + BK < f) load(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, &hs[0][kk], XS);
      wmma::load_matrix_sync(b, &ws[kk][warp * 16], WS);
      wmma::mma_sync(acc, a, b, acc);
    }
    __syncthreads();
  }
  wmma::store_matrix_sync(&os[0][warp * 16], acc, OS, wmma::mem_row_major);
  __syncthreads();
  const int c = c0 + r;
  if (c < C) {
    __align__(16) bf16 out[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      out[j] = __float2bfloat16(c < nv ? os[r][cc + j] : 0.f);
    *reinterpret_cast<int4*>(yrow) = *reinterpret_cast<const int4*>(out);
  }
}

}  // namespace

// counts and expert_ids are device pointers and may be null; h is a
// (G, C, f) scratch buffer the caller allocates.  Requires d % 64 == 0,
// f % 64 == 0 and 16-byte-aligned contiguous tensors (checked by the
// Python wrapper).
extern "C" int expert_ffn_launch(const void* xe, const void* wg,
                                 const void* wu, const void* wd,
                                 const void* counts, const void* expert_ids,
                                 void* h, void* y, int G, int C, int d, int f,
                                 int act, void* stream) {
  if (G <= 0 || C <= 0 || d % BN || f % BN) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int ct = (C + BC - 1) / BC;
  ffn_gate_up_kernel<<<dim3(ct, f / BN, G), THREADS, 0, s>>>(
      (const bf16*)xe, (const bf16*)wg, (const bf16*)wu, (const int*)counts,
      (const int*)expert_ids, (bf16*)h, C, d, f, act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ffn_down_kernel<<<dim3(ct, d / BN, G), THREADS, 0, s>>>(
      (const bf16*)h, (const bf16*)wd, (const int*)counts,
      (const int*)expert_ids, (bf16*)y, C, d, f);
  return (int)cudaGetLastError();
}

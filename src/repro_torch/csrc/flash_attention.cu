// GQA flash attention (forward): causal mask, sliding window (k > q - w)
// and tanh softcap, with query i at key position Sk - Sq + i.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py::flash_attention
// (Pallas `_kernel`).
//
// Bound on the H100: operations at prefill lengths.  Causal attention does
// ~2 * Sq * Sk * D * Hq multiply-adds over (Sq*Hq + 2*Sk*Hkv + Sq*Hq) * D * 2
// bytes; with Hq / Hkv = 4 and D = 128 that is ~Sq/2 FLOPs per byte, above
// the ~295 FLOPs-per-byte ridge from Sq ~ 600 and close to it at the
// 128-512 admission buckets, so both bounds are within a small factor.
//
// Design (FA2-style):
//  * One block per (batch x kv head, query tile).  The block holds all G
//    query heads of its kv head: 64 rows = (64 / G) positions x G heads, so
//    each K/V tile is loaded once for the G heads that share it.
//  * The TPU grid's sequential k axis becomes a loop over 64-key tiles with
//    the online-softmax state (running max, normaliser, float32 output
//    accumulator) in shared memory; k tiles that the causal mask or the
//    window hides from every row of the block are not visited.
//  * Q K^T and P V run on bf16 tensor cores (WMMA 16x16x16, float32
//    accumulators), one warp per 16 rows; the softmax runs in float32 with
//    the Pallas kernel's finite -1e30 mask.
//  * Ragged tails are masked, not asserted: query rows past Sq are never
//    written and key rows past Sk load as zeros with -1e30 scores, so any
//    admission bucket length works.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int ROWS = 64;      // query rows per block (positions x G heads)
constexpr int BKV = 64;       // keys per tile
constexpr int THREADS = 128;  // 4 warps x 16 rows
constexpr int SS = BKV + 4;   // float score row stride
constexpr int PS = BKV + 8;   // bf16 probability row stride
constexpr float kNeg = -1e30f;

__host__ __device__ constexpr size_t align128(size_t n) {
  return (n + 127) / 128 * 128;
}

__host__ __device__ inline size_t smem_bytes(int D) {
  const size_t qkv = align128((size_t)ROWS * (D + 8) * sizeof(bf16));
  return 3 * qkv + align128((size_t)ROWS * SS * sizeof(float)) +
         align128((size_t)ROWS * PS * sizeof(bf16)) +
         align128((size_t)ROWS * (D + 4) * sizeof(float)) +
         2 * align128(ROWS * sizeof(float));
}

__global__ void __launch_bounds__(THREADS)
flash_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ o,
             int Sq, int Sk, int Hq, int Hkv, int D, int causal, int window,
             float softcap, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int G = Hq / Hkv;
  const int BQ = ROWS / G;               // query positions per block
  const int bh = blockIdx.y;
  const int b = bh / Hkv, kvh = bh % Hkv;
  const int q0 = blockIdx.x * BQ;
  const int DS = D + 8, OS = D + 4;

  size_t off = 0;
  bf16* qs = reinterpret_cast<bf16*>(smem + off);
  off += align128((size_t)ROWS * DS * sizeof(bf16));
  bf16* ks = reinterpret_cast<bf16*>(smem + off);
  off += align128((size_t)ROWS * DS * sizeof(bf16));
  bf16* vs = reinterpret_cast<bf16*>(smem + off);
  off += align128((size_t)ROWS * DS * sizeof(bf16));
  float* ss = reinterpret_cast<float*>(smem + off);
  off += align128((size_t)ROWS * SS * sizeof(float));
  bf16* ps = reinterpret_cast<bf16*>(smem + off);
  off += align128((size_t)ROWS * PS * sizeof(bf16));
  float* os = reinterpret_cast<float*>(smem + off);
  off += align128((size_t)ROWS * OS * sizeof(float));
  float* corr_s = reinterpret_cast<float*>(smem + off);
  off += align128(ROWS * sizeof(float));
  float* l_s = reinterpret_cast<float*>(smem + off);

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int vec = D / 8;                 // 16-byte slots per row
  const int4 zero4 = make_int4(0, 0, 0, 0);

  // Q tile: row r -> position q0 + r / G, head kvh * G + r % G
  for (int s = t; s < ROWS * vec; s += THREADS) {
    const int r = s / vec, c = (s % vec) * 8;
    const int qi = q0 + r / G;
    int4 val = zero4;
    if (qi < Sq)
      val = *reinterpret_cast<const int4*>(
          q + (((size_t)b * Sq + qi) * Hq + kvh * G + r % G) * D + c);
    *reinterpret_cast<int4*>(qs + r * DS + c) = val;
  }
  for (int s = t; s < ROWS * OS; s += THREADS) os[s] = 0.f;
  __syncthreads();

  // this thread's softmax row (2 lanes per row, 32 columns each)
  const int my_row = warp * 16 + (lane >> 1);
  const int half = lane & 1;
  const int my_qpos = Sk - Sq + q0 + my_row / G;
  float m_run = kNeg, l_run = 0.f;

  // k tiles some row of this block can see
  const int last_q = min(q0 + BQ, Sq) - 1;
  const int first_qpos = Sk - Sq + q0, last_qpos = Sk - Sq + last_q;
  const int n_kt = (Sk + BKV - 1) / BKV;
  int kt_end = n_kt;
  if (causal) kt_end = min(n_kt, max(0, last_qpos / BKV + 1));
  int kt_begin = 0;
  if (window) {
    const int lo = first_qpos - window + 1;  // first key any row can see
    kt_begin = lo > 0 ? lo / BKV : 0;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BKV;
    __syncthreads();                     // previous tile's readers are done
    for (int s = t; s < BKV * vec; s += THREADS) {
      const int r = s / vec, c = (s % vec) * 8;
      const int kp = k0 + r;
      int4 kv = zero4, vv = zero4;
      if (kp < Sk) {
        const size_t g = (((size_t)b * Sk + kp) * Hkv + kvh) * D + c;
        kv = *reinterpret_cast<const int4*>(k + g);
        vv = *reinterpret_cast<const int4*>(v + g);
      }
      *reinterpret_cast<int4*>(ks + r * DS + c) = kv;
      *reinterpret_cast<int4*>(vs + r * DS + c) = vv;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows
    for (int j = 0; j < BKV / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bk;
        wmma::load_matrix_sync(a, qs + warp * 16 * DS + kk, DS);
        wmma::load_matrix_sync(bk, ks + j * 16 * DS + kk, DS);
        wmma::mma_sync(acc, a, bk, acc);
      }
      wmma::store_matrix_sync(ss + warp * 16 * SS + j * 16, acc, SS,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this row's 64 scores (32 per lane)
    float* srow = ss + my_row * SS + half * 32;
    float mx = kNeg;
    for (int j = 0; j < 32; ++j) {
      const int kp = k0 + half * 32 + j;
      float sc = srow[j] * scale;
      if (softcap != 0.f) sc = softcap * tanhf(sc / softcap);
      bool ok = kp < Sk;
      if (causal) ok = ok && kp <= my_qpos;
      if (window) ok = ok && kp > my_qpos - window;
      sc = ok ? sc : kNeg;
      srow[j] = sc;
      mx = fmaxf(mx, sc);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_run, mx);
    const float corr = expf(m_run - m_new);
    float sum = 0.f;
    bf16* prow = ps + my_row * PS + half * 32;
    for (int j = 0; j < 32; ++j) {
      const float p = expf(srow[j] - m_new);
      sum += p;
      prow[j] = __float2bfloat16(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_run = l_run * corr + sum;
    m_run = m_new;
    if (half == 0) corr_s[my_row] = corr;
    __syncwarp();

    // O = O * corr + P V for this warp's rows
    for (int s = lane; s < 16 * D; s += 32) {
      const int r = warp * 16 + s / D;
      os[r * OS + s % D] *= corr_s[r];
    }
    __syncwarp();
    for (int jd = 0; jd < D / 16; ++jd) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      float* optr = os + warp * 16 * OS + jd * 16;
      wmma::load_matrix_sync(acc, optr, OS, wmma::mem_row_major);
      for (int kk = 0; kk < BKV; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
        wmma::load_matrix_sync(a, ps + warp * 16 * PS + kk, PS);
        wmma::load_matrix_sync(bv, vs + kk * DS + jd * 16, DS);
        wmma::mma_sync(acc, a, bv, acc);
      }
      wmma::store_matrix_sync(optr, acc, OS, wmma::mem_row_major);
    }
    __syncwarp();
  }

  if (half == 0) l_s[my_row] = l_run;
  __syncwarp();
  for (int s = lane; s < 16 * vec; s += 32) {
    const int r = warp * 16 + s / vec, c = (s % vec) * 8;
    const int qi = q0 + r / G;
    if (qi >= Sq) continue;
    const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
    __align__(16) bf16 out[8];
    for (int j = 0; j < 8; ++j)
      out[j] = __float2bfloat16(os[r * OS + c + j] * inv);
    *reinterpret_cast<int4*>(
        o + (((size_t)b * Sq + qi) * Hq + kvh * G + r % G) * D + c) =
        *reinterpret_cast<const int4*>(out);
  }
}

}  // namespace

// q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D), o (B, Sq, Hq, D), all bf16 and
// contiguous.  Requires D % 16 == 0, D <= 128 and 64 % (Hq / Hkv) == 0
// (checked by the Python wrapper).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Sk, int Hq, int Hkv, int D,
                                      int causal, int window, float softcap,
                                      float scale, void* stream) {
  if (D % 16 || D > 128 || Hq % Hkv || ROWS % (Hq / Hkv) || B <= 0 ||
      Sq <= 0 || Sk <= 0)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int BQ = ROWS / (Hq / Hkv);
  dim3 grid((Sq + BQ - 1) / BQ, B * Hkv);
  flash_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, Sq, Sk, Hq,
      Hkv, D, causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

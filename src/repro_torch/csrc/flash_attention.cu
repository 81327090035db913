// GQA flash attention (forward): causal mask, sliding window (k > q - w)
// and tanh softcap, with query i at key position Sk - Sq + i.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py::flash_attention
// (Pallas `_kernel`).
//
// Bound on the H100: neither bytes nor tensor-core operations.  At the
// admission buckets (S = 32..256, Hq / Hkv = 4, D = 128) both take a few
// microseconds; a call is bound by latency: the chain of 64-key tiles
// (load, Q K^T, softmax, P V) that the block with the longest causal row
// walks, plus each block's fixed start and finish, and at S >= 512 by two
// blocks sharing each SM's tensor cores and special-function units.  The
// same holds at DeepSeek-V2-Lite's MLA prefill (B = 1, 16 heads, D = 192
// with the 128-wide values zero-padded, S = 128..512): S / 64 x 16 blocks
// of one warpgroup each, at most one wave on 132 SMs.
//
// Design (in the manner of FlashAttention-3):
//  * One block per (query tile, batch x kv head): one consumer warpgroup
//    for 64 rows = (64 / G) positions x the G query heads of one kv head,
//    so each K/V tile is read once for the G heads, and one producer warp.
//    Blocks take work longest causal chain first; where two blocks share
//    an SM (D <= 128) and the grid is at most two blocks per SM, the
//    second block of an SM takes the shortest remaining chain, so no SM
//    runs two long ones.
//  * The producer loads Q once and streams 64-key K/V tiles into a
//    three-stage ring, all by TMA, paced by full/empty mbarriers: the
//    consumers never issue a load or wait on a block-wide barrier in the
//    loop.  Q's tensor map is 4-D over (B, Sq, Hq, D) with a box of
//    (BQ positions, G heads, 64 columns), which is the block's 64 rows in
//    order; K/V's is 3-D over (B, Sk, Hkv * D), so a key past Sk reads
//    zeros, never the next batch's rows, and its score is masked to -1e30
//    as in the Pallas kernel.  Two blocks fit on an SM at D <= 128; at
//    D = 192 (MLA's q/k head width, 168 KB) and D = 256 (224 KB) one does,
//    and the block may then hold up to 255 registers a thread: O takes
//    NSL x 32 of them (96 at D = 192) beside S's 32.
//  * S = Q K^T by wgmma into registers; the online softmax runs in
//    registers with one multiply, one subtraction and one ex2 per score
//    (row max and sum across the 4 threads sharing a row, by shuffles);
//    only tiles that cross Sk, the causal diagonal or the window's edge
//    are masked.  P is rounded to bf16 in registers and is the register A
//    operand of the P V wgmma (V MN-major in shared memory).  O stays in
//    registers and is written once, divided by the row sum, through Q's
//    shared memory and a TMA store that clips the ragged edges.
//  * k tiles that the causal mask or the window hides from every row of the
//    block are not visited.  D up to 256 (the Pallas kernel's range) in
//    one to four 64-column slabs; a D that is not a multiple of 64 reads
//    zeros past it in Q, so the neighbouring head's K columns that the
//    last slab loads add nothing to S, and the TMA store clips O there.
#include "hopper.cuh"

#include <limits.h>
#include <math.h>

using namespace hop;

namespace {

constexpr int ROWS = 64;       // query rows per block (positions x G heads)
constexpr int BKV = 64;        // keys per tile
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

constexpr int STAGES = 3;      // K/V ring depth
constexpr int CONSUMERS = 128; // one consumer warpgroup
constexpr int THREADS = CONSUMERS + 32;   // + one producer warp

// Q, then the K and V stages, then full and empty barriers.  No alignment
// slack: the dynamic shared memory of a block without static shared
// memory starts 1024-byte aligned (checked on entry), which lets two blocks
// with a three-stage ring share an SM at D = 128 and one block with a
// three-stage ring fit at D = 256 (229,432 of 232,448 bytes).
template <int NSL>
constexpr size_t smem_bytes() {
  return (size_t)(1 + 2 * STAGES) * NSL * SLAB_BYTES +
         (2 * STAGES + 1) * sizeof(uint64_t);
}

// 2^x on the special-function unit, denormal results flushed to zero
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// blocks that share an SM: two up to two slabs, one above
template <int NSL>
constexpr int kBlocksPerSm = NSL <= 2 ? 2 : 1;

template <int NSL>
__global__ void __launch_bounds__(THREADS, kBlocksPerSm<NSL>)
flash_kernel(__grid_constant__ const CUtensorMap qmap,
             __grid_constant__ const CUtensorMap kmap,
             __grid_constant__ const CUtensorMap vmap,
             __grid_constant__ const CUtensorMap omap, int Sq, int Sk,
             int Hq, int Hkv, int D, int causal, int window, float softcap,
             float scale, int sms) {
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* qs = smem;                                // NSL slabs
  unsigned char* ks = qs + NSL * SLAB_BYTES;               // STAGES x NSL
  unsigned char* vs = ks + STAGES * NSL * SLAB_BYTES;      // STAGES x NSL
  uint64_t* full = reinterpret_cast<uint64_t*>(vs + STAGES * NSL * SLAB_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  const int G = Hq / Hkv;
  const int BQ = ROWS / G;                 // query positions per block
  // Work items (batch x kv head, query tile) go to blocks longest causal
  // chain first.  Where two blocks share an SM and the grid is at most two
  // blocks per SM, the second block of each SM takes the rest shortest
  // first, so that an SM pairs a long chain with a short one instead of
  // two long ones.  With one block per SM the order stays longest first.
  const int nx = gridDim.x, n_items = nx * gridDim.y;
  int item = blockIdx.y * nx + blockIdx.x;
  if (kBlocksPerSm<NSL> == 2 && n_items <= 2 * sms && item >= sms)
    item = sms + (n_items - 1 - item);
  const int b = (item % nx) / Hkv, kvh = (item % nx) % Hkv;
  const int q0 = (gridDim.y - 1 - item / nx) * BQ;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int gs = 31 - __clz(G);            // G divides 64: a power of two
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
  const int n_tiles = kt_end - kt_begin;

  if (t == CONSUMERS) {
    if (smem_u32(smem) & 1023) __trap();   // the swizzle needs 1024 B
    prefetch_map(&qmap);
    prefetch_map(&kmap);
    prefetch_map(&vmap);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {            // producer warp: Q, K/V by TMA
    if (lane == 0) {
      // Q: a box of (64 columns, G heads, BQ positions) per slab is the
      // block's 64 rows in order, 128-byte swizzled; positions past Sq
      // and columns past D read zeros
      mbar_expect_tx(qbar, NSL * SLAB_BYTES);
      for (int s = 0; s < NSL; ++s)
        tma_load_4d(qs + s * SLAB_BYTES, &qmap, qbar, 64 * s, kvh * G, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % STAGES;
        if (i >= STAGES) mbar_wait(&empty[st], (i / STAGES - 1) & 1);
        mbar_expect_tx(&full[st], 2 * NSL * SLAB_BYTES);
#pragma unroll
        for (int s = 0; s < NSL; ++s) {
          const int col = kvh * D + 64 * s, row = (kt_begin + i) * BKV;
          tma_load_3d(ks + (st * NSL + s) * SLAB_BYTES, &kmap, &full[st], col,
                      row, b);
          tma_load_3d(vs + (st * NSL + s) * SLAB_BYTES, &vmap, &full[st], col,
                      row, b);
        }
      }
    }
    return;
  }

  mbar_wait(qbar, 0);

  // this thread's two rows and its columns inside each 8-column group
  const int r0 = warp * 16 + (lane >> 2), c2 = (lane & 3) * 2;
  const int qpos0 = Sk - Sq + q0 + (r0 >> gs);
  const int qpos1 = Sk - Sq + q0 + ((r0 + 8) >> gs);
  // per row: keys kp with lo < kp <= hi (and kp < Sk) are visible
  const int hi0 = causal ? qpos0 : INT_MAX, hi1 = causal ? qpos1 : INT_MAX;
  const int lo0 = window ? qpos0 - window : INT_MIN;
  const int lo1 = window ? qpos1 - window : INT_MIN;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;
  float oacc[NSL][32], sacc[32];
  uint32_t pa[4][4];
#pragma unroll
  for (int s = 0; s < NSL; ++s)
#pragma unroll
    for (int i = 0; i < 32; ++i) oacc[s][i] = 0.f;

  auto wait_tile = [&](int i) {
    mbar_wait(&full[i % STAGES], (i / STAGES) & 1);
  };
  auto release = [&](int i) { mbar_arrive(&empty[i % STAGES]); };
  // S = Q K^T (64 x 64) for tile i, contraction over D in 16-deep steps
  auto qk = [&](int i) {
#pragma unroll
    for (int j = 0; j < 32; ++j) sacc[j] = 0.f;
    fence_regs(sacc);
    wgmma_fence();
    const unsigned char* kst = ks + (i % STAGES) * NSL * SLAB_BYTES;
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<0>(sacc, desc_kmajor(qs + (kk >> 2) * SLAB_BYTES, kk & 3),
                  desc_kmajor(kst + (kk >> 2) * SLAB_BYTES, kk & 3));
    wgmma_commit();
  };
  // O += P V for tile i, P (bf16) as the register A operand
  auto pv = [&](int i, const uint32_t (&p)[4][4]) {
#pragma unroll
    for (int s = 0; s < NSL; ++s) fence_regs(oacc[s]);
    wgmma_fence();
    const unsigned char* vst = vs + (i % STAGES) * NSL * SLAB_BYTES;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int s = 0; s < NSL; ++s)
        wgmma_rs<1>(oacc[s], p[kk], desc_mnmajor(vst + s * SLAB_BYTES, kk));
    wgmma_commit();
  };
  auto fence_o = [&]() {
#pragma unroll
    for (int s = 0; s < NSL; ++s) fence_regs(oacc[s]);
  };
  // online softmax of S for tile i (masked scores are -1e30): updates m
  // and l, writes P to p, returns the factors by which O has to be
  // rescaled.  m stays in raw score units; exp(scale (s - m)) is
  // ex2(s c - m c) with c = scale log2(e).  Not a fused multiply-add: a
  // row masked so far has s = m = -1e30, and only equal roundings of s c
  // and m c give its exact 0 (P = 1, as in the Pallas kernel).
  const float c = scale * kLog2e;
  auto softmax = [&](int i, uint32_t (&p)[4][4], float& corr0,
                     float& corr1) {
    const int k0 = (kt_begin + i) * BKV;
    if (softcap != 0.f) {    // s -> softcap tanh(s scale / softcap) / scale
      const float inv = scale / softcap, back = softcap / scale;
#pragma unroll
      for (int j = 0; j < 32; ++j) sacc[j] = back * tanhf(sacc[j] * inv);
    }
    // only tiles that reach past Sk, the causal diagonal or the window's
    // edge for some row of the block need the mask
    if (k0 + BKV > Sk || (causal && k0 + BKV - 1 > first_qpos) ||
        (window && k0 <= last_qpos - window)) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = k0 + 8 * j + c2 + e;
          if (!(kp < Sk && kp <= hi0 && kp > lo0)) sacc[4 * j + e] = kNeg;
          if (!(kp < Sk && kp <= hi1 && kp > lo1)) sacc[4 * j + 2 + e] = kNeg;
        }
    }
    float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sacc[4 * j], sacc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sacc[4 * j + 2], sacc[4 * j + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    corr0 = ex2((m0 - mn0) * c);
    corr1 = ex2((m1 - mn1) * c);
    m0 = mn0;
    m1 = mn1;
    const float mc0 = __fmul_rn(mn0, c), mc1 = __fmul_rn(mn1, c);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p0 = ex2(__fmul_rn(sacc[4 * j + e], c) - mc0);
        const float p1 = ex2(__fmul_rn(sacc[4 * j + 2 + e], c) - mc1);
        sacc[4 * j + e] = p0;
        sacc[4 * j + 2 + e] = p1;
        sum0 += p0;
        sum1 += p1;
      }
    l0 = l0 * corr0 + sum0;                  // partial: this thread's columns
    l1 = l1 * corr1 + sum1;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      p[kk][0] = pack_bf16(sacc[8 * kk + 0], sacc[8 * kk + 1]);
      p[kk][1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
      p[kk][2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
      p[kk][3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
    }
  };
  auto rescale = [&](float corr0, float corr1) {
#pragma unroll
    for (int s = 0; s < NSL; ++s)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        oacc[s][4 * j + 0] *= corr0;
        oacc[s][4 * j + 1] *= corr0;
        oacc[s][4 * j + 2] *= corr1;
        oacc[s][4 * j + 3] *= corr1;
      }
  };

  for (int i = 0; i < n_tiles; ++i) {
    float corr0, corr1;
    wait_tile(i);
    qk(i);
    wgmma_wait();
    fence_regs(sacc);
    softmax(i, pa, corr0, corr1);
    rescale(corr0, corr1);
    pv(i, pa);
    wgmma_wait();
    fence_o();
    release(i);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  // O / l in bf16, staged in Q's slabs in the layout of Q's box, then
  // written by one TMA store per slab, which clips positions past Sq and
  // columns past D
  consumers_sync();                        // every read of Q is done
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    const float inv = 1.f / fmaxf(h ? l1 : l0, 1e-30f);
#pragma unroll
    for (int s = 0; s < NSL; ++s)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(qs + s * SLAB_BYTES + r * 128 +
                                     ((j ^ (r & 7)) << 4) + c2 * 2) =
            pack_bf16(oacc[s][4 * j + 2 * h] * inv,
                      oacc[s][4 * j + 2 * h + 1] * inv);
  }
  fence_async_smem();
  consumers_sync();
  if (t == 0) {
    for (int s = 0; s < NSL; ++s)
      tma_store_4d(&omap, qs + s * SLAB_BYTES, 64 * s, kvh * G, q0, b);
    tma_store_wait();
  }
}

template <int NSL>
int launch(const CUtensorMap& qmap, const CUtensorMap& kmap,
           const CUtensorMap& vmap, const CUtensorMap& omap, int B, int Sq,
           int Sk, int Hq, int Hkv, int D, int causal, int window,
           float softcap, float scale, int sms, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<NSL>();
  static const cudaError_t attr = cudaFuncSetAttribute(   // once per process
      flash_kernel<NSL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const int BQ = ROWS / (Hq / Hkv);
  const dim3 grid(B * Hkv, (Sq + BQ - 1) / BQ);
  flash_kernel<NSL><<<grid, THREADS, smem, stream>>>(
      qmap, kmap, vmap, omap, Sq, Sk, Hq, Hkv, D, causal, window, softcap,
      scale, sms);
  return (int)cudaGetLastError();
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

}  // namespace

// q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D), o (B, Sq, Hq, D), all bf16,
// contiguous and 16-byte aligned.  Requires D % 16 == 0, D <= 256 and
// 64 % (Hq / Hkv) == 0 (checked by the Python wrapper).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Sk, int Hq, int Hkv, int D,
                                      int causal, int window, float softcap,
                                      float scale, void* stream) {
  if (D % 16 || D > 256 || Hq % Hkv || ROWS % (Hq / Hkv) || B <= 0 ||
      Sq <= 0 || Sk <= 0 || ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                             (uintptr_t)o) % 16)
    return cudaErrorInvalidValue;
  // q and o as (B, Sq, Hq, D) with boxes of (64, G, BQ, 1); k and v as
  // (B, Sk, Hkv * D) with boxes of 64 keys
  CUtensorMap qmap, kmap, vmap, omap;
  const uint32_t G = Hq / Hkv;
  const uint64_t qd[4] = {(uint64_t)D, (uint64_t)Hq, (uint64_t)Sq,
                          (uint64_t)B};
  const uint64_t qst[3] = {(uint64_t)D, (uint64_t)Hq * D,
                           (uint64_t)Sq * Hq * D};
  const uint32_t qbox[4] = {64, G, ROWS / G, 1};
  const uint64_t row = (uint64_t)Hkv * D;
  int err;
  if ((err = tensor_map(&qmap, q, 4, qd, qst, qbox)) ||
      (err = tensor_map(&omap, o, 4, qd, qst, qbox)) ||
      (err = tensor_map_3d(&kmap, k, row, Sk, B, row, row * Sk, BKV)) ||
      (err = tensor_map_3d(&vmap, v, row, Sk, B, row, row * Sk, BKV)))
    return err;
  static const int sms = sm_count();
  const int nsl = (D + 63) / 64;
  return (nsl == 1 ? launch<1> : nsl == 2 ? launch<2> : nsl == 3 ? launch<3>
                                                                  : launch<4>)(
      qmap, kmap, vmap, omap, B, Sq, Sk, Hq, Hkv, D, causal, window, softcap,
      scale, sms, (cudaStream_t)stream);
}

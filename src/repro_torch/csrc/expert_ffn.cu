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
// (<= 8 rows per expert) and short prefill (C <= 80 at Sb <= 256) sit far
// below the ~295 FLOPs per byte where the tensor cores would bound it.  So
// each weight byte has to leave device memory once per call, with enough
// of them in flight to keep the memory busy.
//
// Design:
//  * Two launches per call.  Launch 1 computes h = act(x Wg) * (x Wu) per
//    (f tile, group) and stores h in the input dtype, exactly where the
//    Pallas kernel rounds it (`h.astype(wd.dtype)`).  Launch 2 computes
//    y = h Wd per (d tile, group), accumulating in float32 across every f
//    chunk inside the block: the TPU grid's sequential f axis becomes a
//    loop, nothing is carried between blocks, and there are no atomics.
//  * A block's M tile covers the group's whole capacity bucket up to 128
//    rows (one consumer warpgroup per 64 rows), so each weight tile is read
//    from device memory once per call; larger buckets loop over M tiles.
//  * A producer warp streams x / h and weight tiles by TMA into a ring of
//    shared-memory stages (2 to 8, as many as the block's budget holds),
//    paced by full/empty mbarriers.  The consumer warpgroups run wgmma
//    with A (x or h) K-major and B (weights, N contiguous) MN-major from
//    128-byte-swizzled shared memory, float32 accumulators in registers.
//  * The tile plan (rows per M tile, N tile width) comes from the Python
//    wrapper (`expert_ffn.ops.plan`): 64 rows at decode shapes, so that
//    two blocks share an SM, 128 rows above; 128 columns wherever they
//    divide d and f (two adjacent 128-byte TMA boxes per weight row).
//  * A group with no valid rows loads no weight: launch 1 returns at once
//    and launch 2 only writes its zero rows.  The grouped form indexes the
//    weight set by expert_ids, so repeated ids read one set twice.
#include "hopper.cuh"

#include <math.h>

using namespace hop;

namespace {

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

// Shared-memory ring: per stage MW A slabs (64 rows x 64 deep each) and NB
// B slabs (64 deep x 64 columns each), then the full/empty barriers.  A
// 64-row block keeps its ring under 98 KB so that two share an SM.  The
// dynamic shared memory of a block without static shared memory starts
// 1024-byte aligned, as the swizzle needs (checked on entry).
template <int MW, int NB>
struct Ring {
  static constexpr int STAGE = (MW + NB) * SLAB_BYTES;
  static constexpr int BUDGET = MW == 2 ? 196 * 1024 : 98 * 1024;
  static constexpr int STAGES = BUDGET / STAGE > 8 ? 8 : BUDGET / STAGE;
  static constexpr size_t SMEM = (size_t)STAGES * STAGE +
                                 2 * STAGES * sizeof(uint64_t);
  static constexpr int THREADS = MW * 128 + 32;   // + one producer warp
  unsigned char* base;
  uint64_t* full;
  uint64_t* empty;
  __device__ explicit Ring(unsigned char* raw) {
    base = raw;
    full = reinterpret_cast<uint64_t*>(base + STAGES * STAGE);
    empty = full + STAGES;
  }
  __device__ unsigned char* a(int st, int w) const {
    return base + st * STAGE + w * SLAB_BYTES;
  }
  __device__ unsigned char* b(int st, int i) const {
    return base + st * STAGE + (MW + i) * SLAB_BYTES;
  }
  __device__ void init() const {
    if (smem_u32(base) & 1023) __trap();
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], MW * 128);
    }
    mbar_fence_init();
  }
};

// A block's tile: group g (blockIdx.y), output columns n0.. (blockIdx.x),
// its valid rows nv and its weight set e.
struct Tile {
  int g, n0, nv, e;
};
__device__ __forceinline__ Tile block_tile(int bn, const int* counts,
                                           const int* expert_ids, int C) {
  Tile tl;
  tl.g = blockIdx.y;
  tl.n0 = blockIdx.x * bn;
  tl.nv = valid_rows(counts, tl.g, C);
  tl.e = expert_ids != nullptr ? expert_ids[tl.g] : tl.g;
  return tl;
}

// ---------------------------------------------------------------------------
// launch 1: h[g, c, n] = act(x Wg)[c, n] * (x Wu)[c, n]
// ---------------------------------------------------------------------------
template <int MW, int NS>
__global__ void __launch_bounds__(Ring<MW, 2 * NS>::THREADS, 1)
ffn_gate_up_kernel(__grid_constant__ const CUtensorMap xmap,
                   __grid_constant__ const CUtensorMap gmap,
                   __grid_constant__ const CUtensorMap umap,
                   const int* __restrict__ counts,
                   const int* __restrict__ expert_ids, bf16* __restrict__ h,
                   int C, int d, int f, int act) {
  using R = Ring<MW, 2 * NS>;
  constexpr int MT = 64 * MW;
  const Tile tl = block_tile(64 * NS, counts, expert_ids, C);
  if (tl.nv == 0) return;               // skip-empty: no loads, no products
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const R ring(smem_raw);
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  if (t == 0) ring.init();
  __syncthreads();

  if (warp == MW * 4) {                 // producer warp
    if (lane != 0) return;
    int it = 0;                         // ring uses, across M tiles
    for (int m0 = 0; m0 < tl.nv; m0 += MT)
      for (int k0 = 0; k0 < d; k0 += 64, ++it) {
        const int st = it % R::STAGES, rnd = it / R::STAGES;
        if (rnd > 0) mbar_wait(&ring.empty[st], (rnd - 1) & 1);
        mbar_expect_tx(&ring.full[st], R::STAGE);
        tma_load_3d(ring.a(st, 0), &xmap, &ring.full[st], k0, m0, tl.g);
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          tma_load_3d(ring.b(st, s), &gmap, &ring.full[st], tl.n0 + 64 * s,
                      k0, tl.e);
          tma_load_3d(ring.b(st, NS + s), &umap, &ring.full[st],
                      tl.n0 + 64 * s, k0, tl.e);
        }
      }
    return;
  }

  const int w = warp >> 2;              // consumer warpgroup
  const int r0 = (warp & 3) * 16 + (lane >> 2), c2 = (lane & 3) * 2;
  float ga[NS][32], ua[NS][32];
  int it = 0;
  for (int m0 = 0; m0 < tl.nv; m0 += MT) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
#pragma unroll
      for (int i = 0; i < 32; ++i) ga[s][i] = ua[s][i] = 0.f;
      fence_regs(ga[s]);
      fence_regs(ua[s]);
    }
    const int rbase = m0 + 64 * w;
    const bool live = rbase < tl.nv;    // this warpgroup has valid rows
    for (int k0 = 0; k0 < d; k0 += 64, ++it) {
      const int st = it % R::STAGES;
      mbar_wait(&ring.full[st], (it / R::STAGES) & 1);
      if (live) {
        wgmma_fence();
#pragma unroll
        for (int k16 = 0; k16 < 4; ++k16) {
          const uint64_t da = desc_kmajor(ring.a(st, w), k16);
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            wgmma_ss<1>(ga[s], da, desc_mnmajor(ring.b(st, s), k16));
            wgmma_ss<1>(ua[s], da, desc_mnmajor(ring.b(st, NS + s), k16));
          }
        }
        wgmma_commit();
        wgmma_wait();
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          fence_regs(ga[s]);
          fence_regs(ua[s]);
        }
      }
      mbar_arrive(&ring.empty[st]);
    }
    if (!live) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = rbase + r0 + 8 * hh;
      if (r >= tl.nv) continue;
      bf16* hrow = h + ((size_t)tl.g * C + r) * f + tl.n0;
#pragma unroll
      for (int s = 0; s < NS; ++s)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int i = 4 * j + 2 * hh;
          *reinterpret_cast<uint32_t*>(hrow + 64 * s + 8 * j + c2) =
              pack_bf16(act_fn(ga[s][i], act) * ua[s][i],
                        act_fn(ga[s][i + 1], act) * ua[s][i + 1]);
        }
    }
  }
}

// ---------------------------------------------------------------------------
// launch 2: y[g, c, n] = sum_f h[g, c, f] Wd[e, f, n], float32 accumulation
// ---------------------------------------------------------------------------
template <int MW, int NS>
__global__ void __launch_bounds__(Ring<MW, NS>::THREADS, 1)
ffn_down_kernel(__grid_constant__ const CUtensorMap hmap,
                __grid_constant__ const CUtensorMap dmap,
                const int* __restrict__ counts,
                const int* __restrict__ expert_ids, bf16* __restrict__ y,
                int C, int d, int f) {
  using R = Ring<MW, NS>;
  constexpr int MT = 64 * MW, BN = 64 * NS;
  const Tile tl = block_tile(BN, counts, expert_ids, C);
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  // rows nv..C-1 of this block's columns are zero, whatever h holds
  constexpr int CH = BN / 8;            // 16-byte chunks per row
  for (int s = t; s < (C - tl.nv) * CH; s += R::THREADS)
    *reinterpret_cast<int4*>(y + ((size_t)tl.g * C + tl.nv + s / CH) * d +
                             tl.n0 + (s % CH) * 8) = make_int4(0, 0, 0, 0);
  if (tl.nv == 0) return;               // skip-empty: zero rows, no loads
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const R ring(smem_raw);
  if (t == 0) ring.init();
  __syncthreads();

  if (warp == MW * 4) {                 // producer warp
    if (lane != 0) return;
    int it = 0;
    for (int m0 = 0; m0 < tl.nv; m0 += MT)
      for (int k0 = 0; k0 < f; k0 += 64, ++it) {
        const int st = it % R::STAGES, rnd = it / R::STAGES;
        if (rnd > 0) mbar_wait(&ring.empty[st], (rnd - 1) & 1);
        mbar_expect_tx(&ring.full[st], R::STAGE);
        tma_load_3d(ring.a(st, 0), &hmap, &ring.full[st], k0, m0, tl.g);
#pragma unroll
        for (int s = 0; s < NS; ++s)
          tma_load_3d(ring.b(st, s), &dmap, &ring.full[st], tl.n0 + 64 * s,
                      k0, tl.e);
      }
    return;
  }

  const int w = warp >> 2;
  const int r0 = (warp & 3) * 16 + (lane >> 2), c2 = (lane & 3) * 2;
  float acc[NS][32];
  int it = 0;
  for (int m0 = 0; m0 < tl.nv; m0 += MT) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[s][i] = 0.f;
      fence_regs(acc[s]);
    }
    const int rbase = m0 + 64 * w;
    const bool live = rbase < tl.nv;
    for (int k0 = 0; k0 < f; k0 += 64, ++it) {
      const int st = it % R::STAGES;
      mbar_wait(&ring.full[st], (it / R::STAGES) & 1);
      if (live) {
        wgmma_fence();
#pragma unroll
        for (int k16 = 0; k16 < 4; ++k16) {
          const uint64_t da = desc_kmajor(ring.a(st, w), k16);
#pragma unroll
          for (int s = 0; s < NS; ++s)
            wgmma_ss<1>(acc[s], da, desc_mnmajor(ring.b(st, s), k16));
        }
        wgmma_commit();
        wgmma_wait();
#pragma unroll
        for (int s = 0; s < NS; ++s) fence_regs(acc[s]);
      }
      mbar_arrive(&ring.empty[st]);
    }
    if (!live) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = rbase + r0 + 8 * hh;
      if (r >= tl.nv) continue;
      bf16* yrow = y + ((size_t)tl.g * C + r) * d + tl.n0;
#pragma unroll
      for (int s = 0; s < NS; ++s)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<uint32_t*>(yrow + 64 * s + 8 * j + c2) =
              pack_bf16(acc[s][4 * j + 2 * hh], acc[s][4 * j + 2 * hh + 1]);
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int MW, int NS>
int launch_gate_up(const CUtensorMap& xm, const CUtensorMap& gm,
                   const CUtensorMap& um, const int* counts, const int* eids,
                   bf16* h, int G, int C, int d, int f, int act,
                   cudaStream_t s) {
  using R = Ring<MW, 2 * NS>;
  static const cudaError_t attr =       // once per process
      allow_smem(ffn_gate_up_kernel<MW, NS>, R::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  ffn_gate_up_kernel<MW, NS><<<dim3(f / (64 * NS), G), R::THREADS, R::SMEM,
                               s>>>(xm, gm, um, counts, eids, h, C, d, f, act);
  return (int)cudaGetLastError();
}

template <int MW, int NS>
int launch_down(const CUtensorMap& hm, const CUtensorMap& dm,
                const int* counts, const int* eids, bf16* y, int G, int C,
                int d, int f, cudaStream_t s) {
  using R = Ring<MW, NS>;
  static const cudaError_t attr = allow_smem(ffn_down_kernel<MW, NS>, R::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  ffn_down_kernel<MW, NS><<<dim3(d / (64 * NS), G), R::THREADS, R::SMEM,
                            s>>>(hm, dm, counts, eids, y, C, d, f);
  return (int)cudaGetLastError();
}

}  // namespace

// counts and expert_ids are device pointers and may be null; h is a
// (G, C, f) scratch buffer the caller allocates; E is the number of weight
// sets.  The plan: rows per M tile 64 * mw (mw 1 or 2) and N tiles of
// 64 * ns_up (launch 1) and 64 * ns_down (launch 2) columns; mw == 1 takes
// only 64-column tiles.  Requires d % 64 == 0, f % 64 == 0, N tiles that
// divide f and d, and 16-byte-aligned contiguous tensors (checked by the
// Python wrapper).
extern "C" int expert_ffn_launch(const void* xe, const void* wg,
                                 const void* wu, const void* wd,
                                 const void* counts, const void* expert_ids,
                                 void* h, void* y, int G, int E, int C, int d,
                                 int f, int act, int mw, int ns_up,
                                 int ns_down, void* stream) {
  const bool plan_ok = (mw == 1 || mw == 2) && (ns_up == 1 || ns_up == 2) &&
                       (ns_down == 1 || ns_down == 2);
  if (G <= 0 || C <= 0 || E <= 0 || d % 64 || f % 64 || !plan_ok ||
      f % (64 * ns_up) || d % (64 * ns_down) ||
      ((uintptr_t)xe | (uintptr_t)wg | (uintptr_t)wu | (uintptr_t)wd |
       (uintptr_t)h | (uintptr_t)y) % 16)
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* cnt = (const int*)counts;
  const int* eids = (const int*)expert_ids;
  const uint64_t df = (uint64_t)d * f;
  CUtensorMap xm, gm, um, hm, dm;
  int err;
  if ((err = tensor_map_3d(&xm, xe, d, C, G, d, (uint64_t)C * d, 64 * mw)) ||
      (err = tensor_map_3d(&gm, wg, f, d, E, f, df, 64)) ||
      (err = tensor_map_3d(&um, wu, f, d, E, f, df, 64)) ||
      (err = tensor_map_3d(&hm, h, f, C, G, f, (uint64_t)C * f, 64 * mw)) ||
      (err = tensor_map_3d(&dm, wd, d, f, E, d, df, 64)))
    return err;
  bf16* hp = (bf16*)h;
  bf16* yp = (bf16*)y;
  auto up = mw == 1
                ? (ns_up == 1 ? launch_gate_up<1, 1> : launch_gate_up<1, 2>)
                : (ns_up == 1 ? launch_gate_up<2, 1> : launch_gate_up<2, 2>);
  auto down = mw == 1 ? (ns_down == 1 ? launch_down<1, 1> : launch_down<1, 2>)
                      : (ns_down == 1 ? launch_down<2, 1> : launch_down<2, 2>);
  if ((err = up(xm, gm, um, cnt, eids, hp, G, C, d, f, act, s))) return err;
  return down(hm, dm, cnt, eids, yp, G, C, d, f, s);
}

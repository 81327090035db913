// Hopper building blocks shared by the port's kernels, as raw PTX: TMA
// tensor loads, mbarriers, and warpgroup matrix multiplies (wgmma) on
// bfloat16 operands with float32 accumulators; plus the host side's tensor
// map encoder and cache.
//
// Shared-memory tiles are 128-byte-swizzled "slabs": rows of 64 bf16
// values (128 bytes), 8 rows per 1024-byte swizzle atom, slabs aligned to
// 1024 bytes.  A TMA box of 64 columns with CU_TENSOR_MAP_SWIZZLE_128B
// writes exactly that layout, and the descriptors below read it as
//  * K-major (the contraction dimension is the 64 columns: A, or B^T):
//    a 16-deep step is +32 bytes inside the row, 8-row groups 1024 apart;
//  * MN-major (the contraction dimension runs down the rows: B stored
//    (K, N) with N contiguous, wgmma's transpose flag): a 16-deep step is
//    +16 rows = +2048 bytes, and one instruction covers one slab (N = 64).
#pragma once
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

#include <mutex>
#include <unordered_map>

namespace hop {

typedef __nv_bfloat16 bf16;

constexpr int SLAB_BYTES = 64 * 128;   // one 64 x 64 bf16 tile

// ---------------------------------------------------------------------------
// device side
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// generic-proxy writes to shared memory become visible to wgmma / TMA
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// spin until the phase of parity `parity` has completed.  A wait that
// lasts 4 s is a protocol fault: trap, so that the launch fails with an
// error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint64_t t0 = 0;
  while (true) {
    uint32_t done;
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    uint64_t now;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
    if (t0 == 0) t0 = now;
    else if (now - t0 > 4000000000ull) __trap();
  }
}

// one TMA box of a 4-D tensor map into shared memory; completes on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// one box from shared memory into a 4-D tensor map (elements out of the
// tensor's bounds are not written); then commit and wait until the shared
// memory has been read
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.tile.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.commit_group;\n"
               "cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// one TMA box of a 3-D tensor map into shared memory; completes on `bar`
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr, uint32_t lbo,
                                               uint32_t sbo) {
  uint64_t d = 0;
  d |= (uint64_t)((saddr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo & 0x3FFFF) >> 4) << 16;
  d |= (uint64_t)((sbo & 0x3FFFF) >> 4) << 32;
  d |= (uint64_t)1 << 62;                                  // SWIZZLE_128B
  return d;
}
// K-major slab, 16-deep step k16 (0..3 within the slab)
__device__ __forceinline__ uint64_t desc_kmajor(const void* slab, int k16) {
  return desc_sw128(smem_u32(slab) + 32 * k16, 16, 1024);
}
// MN-major slab (rows = contraction), 16-deep step k16 (0..3 per 64 rows).
// One instruction never crosses a slab, so the leading offset (the stride
// between 64-wide MN atoms) is unused; it is set equal to the 8-row group
// stride.
__device__ __forceinline__ uint64_t desc_mnmajor(const void* slab, int k16) {
  return desc_sw128(smem_u32(slab) + 2048 * k16, 1024, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until every committed wgmma group has completed
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accumulator reads or writes across a wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

#define HOP_D32(d)                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),              \
  "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),          \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),          \
  "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),          \
  "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),          \
  "+f"(d[31])
#define HOP_R32                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d[64 x 64] += A[64 x 16] B[16 x 64], A and B from shared memory.
// TB = 0: B is K-major; TB = 1: B is MN-major.  Accumulator layout: thread
// t of the warpgroup holds rows 16 (t / 32) + (t % 32) / 4 (+ 8) and
// columns 8 j + 2 (t % 4) (+ 1): d[4 j + 2 h + e] = (row + 8 h, col + e).
template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %35, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOP_R32
      ", %32, %33, p, 1, 1, 0, %34;\n}\n"
      : HOP_D32(d)
      : "l"(da), "l"(db), "n"(TB), "r"(1));
}

// the same with A in registers (mma.m16n8k16's A fragment for each warp's
// 16 rows): a[0] = (row, k 2c..2c+1), a[1] = (row + 8, same k),
// a[2] = (row, k 8 + 2c..), a[3] = (row + 8, k 8 + 2c..)
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %38, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOP_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %37;\n}\n"
      : HOP_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(TB),
        "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// host side: cuTensorMapEncodeTiled through the runtime's driver entry
// point (the library links only cudart), and a cache of encoded maps keyed
// by everything the map encodes, so a weight's map is encoded once.
// ---------------------------------------------------------------------------
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

struct MapKey {
  uint64_t v[13];
  bool operator==(const MapKey& o) const { return !memcmp(v, o.v, sizeof v); }
};
struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    uint64_t h = 1469598103934665603ull;
    for (uint64_t x : k.v) { h ^= x; h *= 1099511628211ull; }
    return (size_t)h;
  }
};

static std::mutex g_map_lock;
static EncodeTiledFn g_encode = nullptr;
static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> g_maps;

// bf16 tensor of rank 3 or 4: dims innermost first, strides of dims 1..
// in elements, box sizes; 128-byte swizzle (the box's inner size is 64
// elements), zero fill out of bounds.
static int tensor_map(CUtensorMap* out, const void* ptr, int rank,
                      const uint64_t* dims, const uint64_t* strides,
                      const uint32_t* box) {
  MapKey key{};
  key.v[0] = (uint64_t)ptr;
  key.v[1] = (uint64_t)rank;
  for (int i = 0; i < rank; ++i) {
    key.v[2 + i] = dims[i];
    key.v[6 + i] = box[i];
    if (i) key.v[9 + i] = strides[i - 1];
  }
  std::lock_guard<std::mutex> guard(g_map_lock);
  auto it = g_maps.find(key);
  if (it != g_maps.end()) {
    *out = it->second;
    return 0;
  }
  if (g_encode == nullptr) {
    cudaDriverEntryPointQueryResult q;
    void* fn = nullptr;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                            cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess || !fn)
      return e != cudaSuccess ? (int)e : (int)cudaErrorSymbolNotFound;
    g_encode = (EncodeTiledFn)fn;
  }
  cuuint64_t gdims[4], gstrides[3];
  cuuint32_t gbox[4], estr[4] = {1, 1, 1, 1};
  for (int i = 0; i < rank; ++i) {
    gdims[i] = dims[i];
    gbox[i] = box[i];
    if (i) gstrides[i - 1] = strides[i - 1] * sizeof(bf16);
  }
  CUtensorMap m;
  const CUresult r = g_encode(
      &m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr),
      gdims, gstrides, gbox, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  if (g_maps.size() >= 4096) g_maps.clear();
  g_maps.emplace(key, m);
  *out = m;
  return 0;
}

// 3-D: dims (d0, d1, d2), row strides s1, s2; box (64, box1, 1)
static int tensor_map_3d(CUtensorMap* out, const void* ptr, uint64_t d0,
                         uint64_t d1, uint64_t d2, uint64_t s1, uint64_t s2,
                         uint32_t box1) {
  const uint64_t dims[3] = {d0, d1, d2}, strides[2] = {s1, s2};
  const uint32_t box[3] = {64, box1, 1};
  return tensor_map(out, ptr, 3, dims, strides, box);
}

}  // namespace hop

// Hopper (sm_90a) building blocks of the flash-attention forward and
// backward: a ring of asynchronously filled tiles in shared memory (K and V,
// or in the dK/dV kernel Q and dO; by cp.async, or by TMA with mbarriers),
// ldmatrix fragment loads, ex2, and warpgroup matrix multiplies (wgmma, bf16
// and s8) with A in registers.
//
// Every tile is kTile rows x D bf16, row-major ([key][d] or [query][d]), in the layout
// that wgmma's swizzled canonical forms expect: the 16-byte chunk c of row r
// sits at chunk c ^ ((r / (8 / C)) % C) of its row, C = D / 8 chunks per row.
// For D = 64 that is the 128-byte swizzle (chunk ^= r % 8), for D = 32 the
// 64-byte one (chunk ^= (r / 2) % 4), for D = 16 the 32-byte one; D = 8 is
// unswizzled. The swizzle is a function of the shared-memory address, so each
// tile starts on a 1024-byte boundary. The same layout makes every 8x8
// ldmatrix read (8 rows of one chunk) touch 8 distinct 16-byte bank groups.
// The int8 forward's tiles follow the same rule by their row width in bytes:
// a [kTile][32] int8 K tile takes the 32-byte swizzle, [kTile][64] and the
// transposed [D][kTile] int8 V tile the 64-byte one.

#pragma once

#include <cuda.h>  // CUtensorMap (the encoder is taken from the runtime: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace flash {

constexpr float kLog2e = 1.4426950408889634f;

// shared-memory (state space) address of a generic pointer into shared memory
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------ the K/V ring

// element offset of chunk c (8 bf16) of row r in a swizzled [kTile][D] tile
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int C = D / 8;
  return r * D + ((c ^ ((r / (8 / C)) % C)) * 8);
}

// 16-byte asynchronous copy; with valid = false the destination is zero-filled
// and nothing is read (src must still be a mapped address)
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// the same for 4 bytes (src 4-byte aligned), through L1
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Starts the copy of rows [r0, r0 + R) of two (n, D) f32 matrices a and b (one
// batch, row-major) into the row-major shared tiles at and bt ([R][D] f32
// each) by 16-byte cp.async from the block's kThreads threads (the caller
// commits the group); rows past n are zero-filled. R * D / 4 is a multiple of
// kThreads. The f32 kernels' K/V (and Q/dO) tiles.
template <int D, int R, int kThreads>
__device__ __forceinline__ void load_rows_f32(const float* __restrict__ a,
                                              const float* __restrict__ b, int r0, int n,
                                              float* at, float* bt) {
  constexpr int kChunks = R * D / 4;
  static_assert(kChunks % kThreads == 0, "whole chunks per thread");
#pragma unroll
  for (int it = 0; it < kChunks / kThreads; ++it) {
    const int i = it * kThreads + threadIdx.x;
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    const bool valid = r0 + r < n;
    const size_t off = valid ? static_cast<size_t>(r0 + r) * D + c : 0;
    cp_async_16(at + r * D + c, a + off, valid);
    cp_async_16(bt + r * D + c, b + off, valid);
  }
}


// Starts the copy of keys [key0, key0 + kTile) of K and V (each (n, D) bf16,
// one batch) into the swizzled tiles k_tile and v_tile, kThreads threads
// sharing the 16-byte chunks; keys past n are zero-filled.
template <int D, int kThreads>
__device__ __forceinline__ void load_kv_async(const __nv_bfloat16* __restrict__ k,
                                              const __nv_bfloat16* __restrict__ v, int key0, int n,
                                              __nv_bfloat16* k_tile, __nv_bfloat16* v_tile) {
  constexpr int C = D / 8;
  constexpr int kChunks = kTile * C;  // per matrix
#pragma unroll
  for (int it = 0; it < (2 * kChunks + kThreads - 1) / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    if (2 * kChunks % kThreads != 0 && i >= 2 * kChunks) break;
    const bool is_v = i >= kChunks;
    const int ci = is_v ? i - kChunks : i;
    const int r = ci / C, c = ci % C;
    const bool ok = key0 + r < n;
    const __nv_bfloat16* src = (is_v ? v : k) + static_cast<size_t>(ok ? key0 + r : 0) * D + c * 8;
    cp_async_16((is_v ? v_tile : k_tile) + swz<D>(r, c), src, ok);
  }
}

// ------------------------------------------------------------ TMA and mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// makes the barriers' initialisation visible to the async proxy (the TMA unit)
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrives on `bar` and adds `bytes` to the transfer count its phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// waits until the phase of `bar` with this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// TMA copy of the box at coordinates (c0, c1, c2) of a 3-D tensor map into
// shared memory; completes `bytes` of `bar`'s transfer count
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
      : "memory");
}

// the TMA swizzle that writes a tile of kRowBytes-wide rows (32, 64 or 128
// bytes: one swizzle atom per row) in the layout above
template <int kRowBytes>
constexpr CUtensorMapSwizzle tma_swizzle() {
  static_assert(kRowBytes == 32 || kRowBytes == 64 || kRowBytes == 128,
                "swizzled rows are 32, 64 or 128 bytes");
  return kRowBytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
         : kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B;
}

// Host: the tensor map of a contiguous (batch, rows, row_elems) tensor of
// `type` (elem_bytes each) whose box is [box_rows][kRowBytes / elem_bytes] of
// one batch, written by TMA in the swizzled tile layout of kRowBytes-wide
// rows; rows past `rows` read as zeros. Returns 0 or a CUDA error code.
template <int kRowBytes>
inline int encode_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
                      const void* base, int batch, int rows, int row_elems, int box_rows) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static const Encode encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      fn = nullptr;
    }
    return reinterpret_cast<Encode>(fn);
  }();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t row = static_cast<cuuint64_t>(row_elems) * elem_bytes;  // bytes
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(row_elems), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {row, static_cast<cuuint64_t>(rows) * row};  // bytes, dims 1, 2
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kRowBytes / elem_bytes),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  const CUresult rc = encode(map, type, 3, const_cast<void*>(base), dims, strides, box, steps,
                             CU_TENSOR_MAP_INTERLEAVE_NONE, tma_swizzle<kRowBytes>(),
                             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Host: the tensor map of a contiguous (batch, n, D) bf16 tensor whose box is
// one [kTile][D] tile of one batch (D = 32: 64-byte swizzle, D = 64: 128-byte).
template <int D>
inline int encode_tile_map(CUtensorMap* map, const void* base, int batch, int n) {
  static_assert(D == 32 || D == 64, "TMA tiles are 32 or 64 wide");
  return encode_map<2 * D>(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, batch, n, D, kTile);
}

// ------------------------------------------------------------ the TMA ring

constexpr int kStages = 4;  // ring depth (tiles)
constexpr int kAhead = 2;   // tiles in flight ahead of the one being computed

// dynamic shared memory of a ring of two [kTile][D] tiles per slot, with room
// to align it to 1024 bytes
template <int D>
constexpr int ring_bytes() {
  return kStages * 2 * kTile * D * 2 + 1024;
}

__device__ __forceinline__ __nv_bfloat16* ring_base(uint8_t* raw) {
  return reinterpret_cast<__nv_bfloat16*>(raw + ((1024 - (smem_addr(raw) & 1023)) & 1023));
}

// the first tile of ring slot `slot` (its second tile follows it)
template <int D>
__device__ __forceinline__ __nv_bfloat16* slot_tile(__nv_bfloat16* ring, int slot) {
  return ring + 2 * slot * kTile * D;
}

// One thread stages tile `tile` of this block's batch of two (batch, n, D)
// tensors (amap's, then bmap's) into its ring slot by TMA; the slot's barrier
// completes when both have landed.
template <int D>
__device__ __forceinline__ void stage_tma(const CUtensorMap* amap, const CUtensorMap* bmap,
                                          int tile, __nv_bfloat16* ring, uint64_t* full) {
  __nv_bfloat16* at = slot_tile<D>(ring, tile % kStages);
  uint64_t* bar = full + tile % kStages;
  mbar_expect_tx(bar, 2 * kTile * D * 2);
  tma_load_3d(at, amap, 0, tile * kTile, blockIdx.y, bar);
  tma_load_3d(at + kTile * D, bmap, 0, tile * kTile, blockIdx.y, bar);
}

// Host: lets `kernel` use `bytes` of dynamic shared memory, once per instance
// (and again if the current device changes); returns the CUDA error code.
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes, int& set_for_device) {
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess && set_for_device != dev) {
    rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (rc == cudaSuccess) set_for_device = dev;
  }
  return static_cast<int>(rc);
}

// ------------------------------------------------------------ ldmatrix

// four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row))
               : "memory");
}

// the same, each matrix transposed
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row))
               : "memory");
}

// ------------------------------------------------------------ exponentials

// 2^x; inputs below -126 flush to 0, -inf gives 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the low and high bf16 halves of a packed pair, as f32 (exact)
__device__ __forceinline__ float bf16_lo(uint32_t x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t x) { return __uint_as_float(x & 0xffff0000u); }

// ------------------------------------------------------------ wgmma

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// makes this thread's generic-proxy writes to shared memory visible to the
// async proxy (TMA, wgmma's shared-memory operands); before the barrier that
// hands them over
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of an accumulator register
// across the asynchronous products
__device__ __forceinline__ void fence_reg(float& x) { asm volatile("" : "+f"(x)::"memory"); }

// Shared-memory matrix descriptor of a swizzled tile of kRowBytes-wide rows
// (32, 64 or 128 bytes, one swizzle atom wide), K-major along its rows or
// MN-major through the transpose bit: groups of 8 rows are 8 * kRowBytes
// apart; the other offset is unused (1, as CUTLASS sets it). The layout field
// is 1 for the 128-byte swizzle, 2 for 64-byte, 3 for 32-byte.
template <int kRowBytes>
__device__ __forceinline__ uint64_t swizzled_desc(const void* tile) {
  static_assert(kRowBytes == 32 || kRowBytes == 64 || kRowBytes == 128,
                "swizzled rows are 32, 64 or 128 bytes");
  constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  constexpr uint64_t kSbo = (8 * kRowBytes) >> 4;
  return static_cast<uint64_t>((smem_addr(tile) & 0x3ffff) >> 4) | (uint64_t{1} << 16) |
         (kSbo << 32) | (kLayout << 62);
}

// Shared-memory matrix descriptor of a swizzled [kTile][D] tile (D = 32: 64-byte
// swizzle, D = 64: 128-byte), for both uses: as the K-major B of Q K^T (K
// contiguous along d) and as the MN-major B of P V (V contiguous along d, the
// transpose bit set). Either way the stride between groups of 8 rows is
// 8 * 2D bytes, and the tile is one swizzle atom wide, so the other offset is
// unused (1, as CUTLASS sets it).
template <int D>
__device__ __forceinline__ uint64_t tile_desc(const __nv_bfloat16* tile) {
  static_assert(D == 32 || D == 64, "wgmma tiles are 32 or 64 wide");
  return swizzled_desc<2 * D>(tile);
}

// c (64 x 64 f32, the warpgroup's accumulator: c[j] = columns 8j..8j+7 in the
// mma.sync C-fragment layout of this warp's 16 rows) (+)= a (64 x 16 bf16 in
// registers, this warp's A fragment) * b (16 x 64 from shared memory)
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&c)[8][4], const uint32_t (&a)[4],
                                                uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(c[0][0]), "+f"(c[0][1]), "+f"(c[0][2]), "+f"(c[0][3]), "+f"(c[1][0]), "+f"(c[1][1]),
        "+f"(c[1][2]), "+f"(c[1][3]), "+f"(c[2][0]), "+f"(c[2][1]), "+f"(c[2][2]), "+f"(c[2][3]),
        "+f"(c[3][0]), "+f"(c[3][1]), "+f"(c[3][2]), "+f"(c[3][3]), "+f"(c[4][0]), "+f"(c[4][1]),
        "+f"(c[4][2]), "+f"(c[4][3]), "+f"(c[5][0]), "+f"(c[5][1]), "+f"(c[5][2]), "+f"(c[5][3]),
        "+f"(c[6][0]), "+f"(c[6][1]), "+f"(c[6][2]), "+f"(c[6][3]), "+f"(c[7][0]), "+f"(c[7][1]),
        "+f"(c[7][2]), "+f"(c[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate), "n"(kTransB)
      : "memory");
}

// the same with 32 columns
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n32k16(float (&c)[4][4], const uint32_t (&a)[4],
                                                uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(c[0][0]), "+f"(c[0][1]), "+f"(c[0][2]), "+f"(c[0][3]), "+f"(c[1][0]), "+f"(c[1][1]),
        "+f"(c[1][2]), "+f"(c[1][3]), "+f"(c[2][0]), "+f"(c[2][1]), "+f"(c[2][2]), "+f"(c[2][3]),
        "+f"(c[3][0]), "+f"(c[3][1]), "+f"(c[3][2]), "+f"(c[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate), "n"(kTransB)
      : "memory");
}

// the same with 8 columns (c[0..1] row g, c[2..3] row g + 8)
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n8k16(float (&c)[4], const uint32_t (&a)[4], uint64_t b,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, %10;\n}\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate), "n"(kTransB)
      : "memory");
}

// Shared-memory matrix descriptor of an unswizzled K-major tile of 8 x 8
// core matrices (8 rows of 16 bytes each, 128 bytes apart along both K and
// N): for a constant B such as all ones, where only its extent matters (the
// first 256 bytes for k16 x n8)
__device__ __forceinline__ uint64_t interleaved_desc(const void* tile) {
  constexpr uint64_t kOff = 128 >> 4;
  return static_cast<uint64_t>((smem_addr(tile) & 0x3ffff) >> 4) | (kOff << 16) | (kOff << 32);
}

// c (64 x 8J) (+)= a * b for 8J = 32 or 64 columns, by the accumulator's width
template <int kTransB, int J>
__device__ __forceinline__ void wgmma_m64k16(float (&c)[J][4], const uint32_t (&a)[4], uint64_t b,
                                             int accumulate) {
  if constexpr (J == 8) {
    wgmma_m64n64k16<kTransB>(c, a, b, accumulate);
  } else {
    static_assert(J == 4, "wgmma widths 32 and 64 only");
    wgmma_m64n32k16<kTransB>(c, a, b, accumulate);
  }
}

// ------------------------------------------------------------ int8 wgmma

__device__ __forceinline__ void fence_reg(int& x) { asm volatile("" : "+r"(x)::"memory"); }

// c (64 x 64 s32, laid out as the f32 accumulator above) (+)= a (64 x 32 s8
// in registers: this warp's m16n8k32 A fragment, register i holding 4 bytes)
// * b (32 x 64 s8 from shared memory). 8-bit operands are K-major only: there
// is no transpose bit.
__device__ __forceinline__ void wgmma_m64n64k32_s8(int (&c)[8][4], const uint32_t (&a)[4],
                                                   uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(c[0][0]), "+r"(c[0][1]), "+r"(c[0][2]), "+r"(c[0][3]), "+r"(c[1][0]), "+r"(c[1][1]),
        "+r"(c[1][2]), "+r"(c[1][3]), "+r"(c[2][0]), "+r"(c[2][1]), "+r"(c[2][2]), "+r"(c[2][3]),
        "+r"(c[3][0]), "+r"(c[3][1]), "+r"(c[3][2]), "+r"(c[3][3]), "+r"(c[4][0]), "+r"(c[4][1]),
        "+r"(c[4][2]), "+r"(c[4][3]), "+r"(c[5][0]), "+r"(c[5][1]), "+r"(c[5][2]), "+r"(c[5][3]),
        "+r"(c[6][0]), "+r"(c[6][1]), "+r"(c[6][2]), "+r"(c[6][3]), "+r"(c[7][0]), "+r"(c[7][1]),
        "+r"(c[7][2]), "+r"(c[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate)
      : "memory");
}

// the same with 32 columns
__device__ __forceinline__ void wgmma_m64n32k32_s8(int (&c)[4][4], const uint32_t (&a)[4],
                                                   uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(c[0][0]), "+r"(c[0][1]), "+r"(c[0][2]), "+r"(c[0][3]), "+r"(c[1][0]), "+r"(c[1][1]),
        "+r"(c[1][2]), "+r"(c[1][3]), "+r"(c[2][0]), "+r"(c[2][1]), "+r"(c[2][2]), "+r"(c[2][3]),
        "+r"(c[3][0]), "+r"(c[3][1]), "+r"(c[3][2]), "+r"(c[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate)
      : "memory");
}

// c (64 x 8J s32) (+)= a * b for 8J = 32 or 64 columns, by the accumulator's width
template <int J>
__device__ __forceinline__ void wgmma_m64k32_s8(int (&c)[J][4], const uint32_t (&a)[4], uint64_t b,
                                                int accumulate) {
  if constexpr (J == 8) {
    wgmma_m64n64k32_s8(c, a, b, accumulate);
  } else {
    static_assert(J == 4, "wgmma widths 32 and 64 only");
    wgmma_m64n32k32_s8(c, a, b, accumulate);
  }
}

}  // namespace flash

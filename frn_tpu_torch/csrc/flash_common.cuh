// Fragment helpers shared by the flash-attention kernels (forward and backward).
//
// The mma.sync products are m16n8k16 (bf16 in, f32 accumulate), and m16n8k8
// where a kernel contracts over d = 8. Head dims 8, 16, 32 and 64 are
// template parameters; a contraction over d runs in kSteps<D>() steps of 16,
// and for d = 8 the upper half of each 16-wide A fragment is zero in
// registers (no padded copy in memory).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int kTile = 64;  // rows of the other side per shared-memory tile

// 16-wide contraction steps over a head dim D
template <int D>
__host__ __device__ constexpr int kSteps() { return (D + 15) / 16; }

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// c (16x8 f32) += a (16x16 bf16, row-major) * b (16x8 bf16, column-major)
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c (16x8 f32) += a (16x8 bf16, row-major: a[0] row g, a[1] row g + 8, columns
// 2t, 2t + 1) * b (8x8 bf16, column-major: rows 2t, 2t + 1 of column g): a
// contraction over d = 8 without the zero upper half of m16n8k16
__device__ __forceinline__ void mma_1688(float c[4], const uint32_t a[2], uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p, bool valid) {
  return valid ? *reinterpret_cast<const uint32_t*>(p) : 0u;
}

// A fragments of rows r0 and r0 + 8 (global memory, row length D) over the
// whole head dim; rows past the end (ok = false) and columns past D read 0.
template <int D>
__device__ __forceinline__ void load_a_rows(uint32_t a[][4], const __nv_bfloat16* r0,
                                            const __nv_bfloat16* r1, bool ok0, bool ok1, int t) {
#pragma unroll
  for (int kk = 0; kk < kSteps<D>(); ++kk) {
    const int c = kk * 16 + 2 * t;
    const bool hi = kk * 16 + 8 < D;
    a[kk][0] = load_pair(r0 + c, ok0);
    a[kk][1] = load_pair(r1 + c, ok1);
    a[kk][2] = load_pair(r0 + c + 8, ok0 && hi);
    a[kk][3] = load_pair(r1 + c + 8, ok1 && hi);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Writes the f32 accumulator rows r0 and r0 + 8 of a (n, D) bf16 matrix.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float acc[][4], int r0, int r1,
                                           bool ok0, bool ok1, int t, float s0 = 1.f,
                                           float s1 = 1.f) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + 2 * t;
    if (ok0) {
      *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(r0) * D + c) =
          __floats2bfloat162_rn(acc[j][0] * s0, acc[j][1] * s0);
    }
    if (ok1) {
      *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(r1) * D + c) =
          __floats2bfloat162_rn(acc[j][2] * s1, acc[j][3] * s1);
    }
  }
}

}  // namespace flash

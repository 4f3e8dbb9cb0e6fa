// Flash-attention forward for the REFusion non-local cross-attention, Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel frn_tpu/ops/flash_attention.py::_flash_kernel
// (with _flash_q_group, launched by _flash_forward). It computes, per batch b,
//
//     O[b] = softmax(Q[b] K[b]^T) V[b]        (no 1/sqrt(d) scale)
//
// with Q = phi, K = theta, V = g, all (B, N, d) bf16 row-major, d in {32, 64}.
// Scores, the running row max and the running denominator are f32; p is rounded
// to bf16 before the PV product; the output accumulator is f32 and is divided by
// the denominator once, at the end. The key and query tails of any N are masked
// here, so no padded copy of Q, K or V is ever made.
//
// What bounds it on an H100: at the DSEC stage-1 shape (N = 19,200, d = 32)
// every score costs one exponential and 4d = 128 flops of the two products, so
// the special-function units (about 3.9e12 exp/s) cap it before the tensor cores
// (989 TFLOP/s bf16). Device memory is not the limit: Q, K, V and O are read or
// written once from device memory (K and V tiles are re-read by every query
// block, but from L2).
//
// Design (first, simple version): one block of 4 warps owns 64 query rows of one
// batch; each warp owns 16 rows and keeps its Q fragments, its scores, its row
// statistics and its output accumulator in registers. A loop over 64-key tiles
// takes the place of the TPU's sequential grid axis: the block stages the K tile
// and the transposed V tile in shared memory, each warp runs QK^T and PV as
// mma.sync m16n8k16 (bf16 in, f32 accumulate) and the online-softmax update in
// between. The score fragment layout of QK^T is the A-operand layout of PV, so p
// never leaves registers. Not yet done: cp.async/TMA double buffering of the
// tiles, wgmma, and exp2 with the log2(e) scale folded into Q.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kBlockQ = kWarps * 16;  // query rows per block
constexpr int kBlockK = 64;           // keys per shared-memory tile
constexpr int kPad = 8;               // bf16 row padding: conflict-free fragment reads

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

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* rowp, int col, bool valid) {
  return valid ? *reinterpret_cast<const uint32_t*>(rowp + col) : 0u;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int n) {
  static_assert(D % 16 == 0 && D <= 128, "head dim must be a multiple of 16");
  __shared__ __align__(16) __nv_bfloat16 k_tile[kBlockK][D + kPad];  // [key][d]
  __shared__ __align__(16) __nv_bfloat16 vt_tile[D][kBlockK + kPad];  // [d][key]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const size_t base = static_cast<size_t>(blockIdx.y) * n * D;
  const int row0 = blockIdx.x * kBlockQ + warp * 16 + g;  // rows row0 and row0 + 8
  const int row1 = row0 + 8;
  const bool ok0 = row0 < n, ok1 = row1 < n;
  const __nv_bfloat16* q0 = q + base + static_cast<size_t>(ok0 ? row0 : 0) * D;
  const __nv_bfloat16* q1 = q + base + static_cast<size_t>(ok1 ? row1 : 0) * D;

  // Q as A fragments, one per 16-wide slice of d; rows past n read as zeros
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = load_pair(q0, c, ok0);
    qa[kk][1] = load_pair(q1, c, ok1);
    qa[kk][2] = load_pair(q0, c + 8, ok0);
    qa[kk][3] = load_pair(q1, c + 8, ok1);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running row max (rows row0, row1)
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the denominators

  for (int kt = 0; kt < n; kt += kBlockK) {
    __syncthreads();  // the previous tile has been read by every warp
    constexpr int kChunks = D / 8;  // 16-byte chunks per row
    for (int i = threadIdx.x; i < kBlockK * kChunks; i += kWarps * 32) {
      const int r = i / kChunks;
      const int c = (i % kChunks) * 8;
      const int key = kt + r;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (key < n) {
        kv = *reinterpret_cast<const uint4*>(k + base + static_cast<size_t>(key) * D + c);
        vv = *reinterpret_cast<const uint4*>(v + base + static_cast<size_t>(key) * D + c);
      }
      *reinterpret_cast<uint4*>(&k_tile[r][c]) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) vt_tile[c + e][r] = ve[e];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows: kBlockK / 8 tiles of 16x8
    float s[kBlockK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t b[2];
        b[0] = *reinterpret_cast<const uint32_t*>(&k_tile[nt * 8 + g][kk * 16 + 2 * t]);
        b[1] = *reinterpret_cast<const uint32_t*>(&k_tile[nt * 8 + g][kk * 16 + 2 * t + 8]);
        mma_16816(s[nt], qa[kk], b);
      }
    }

    // mask the key tail, then the online-softmax update
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
      const int key = kt + nt * 8 + 2 * t;
      if (key >= n) { s[nt][0] = -INFINITY; s[nt][2] = -INFINITY; }
      if (key + 1 >= n) { s[nt][1] = -INFINITY; s[nt][3] = -INFINITY; }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    mx0 = quad_max(mx0);  // every tile holds a valid key, so mx is finite
    mx1 = quad_max(mx1);
    const float alpha0 = __expf(m0 - mx0);  // 0 on the first tile (m = -inf)
    const float alpha1 = __expf(m1 - mx1);
    m0 = mx0;
    m1 = mx1;

    // p = exp(s - m) in f32 for the denominator, rounded to bf16 for PV. The
    // 16x8 score tiles 2j and 2j+1 form the A fragment of the j-th 16-key slice.
    uint32_t pa[kBlockK / 16][4];
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
      const float p0 = __expf(s[nt][0] - mx0);
      const float p1 = __expf(s[nt][1] - mx0);
      const float p2 = __expf(s[nt][2] - mx1);
      const float p3 = __expf(s[nt][3] - mx1);
      rs0 += p0 + p1;
      rs1 += p2 + p3;
      pa[nt / 2][(nt % 2) * 2 + 0] = pack_bf16x2(p0, p1);
      pa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16x2(p2, p3);
    }
    l0 = l0 * alpha0 + rs0;
    l1 = l1 * alpha1 + rs1;

#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= alpha0;
      acc[j][1] *= alpha0;
      acc[j][2] *= alpha1;
      acc[j][3] *= alpha1;
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
        uint32_t b[2];
        b[0] = *reinterpret_cast<const uint32_t*>(&vt_tile[j * 8 + g][kk * 16 + 2 * t]);
        b[1] = *reinterpret_cast<const uint32_t*>(&vt_tile[j * 8 + g][kk * 16 + 2 * t + 8]);
        mma_16816(acc[j], pa[kk], b);
      }
    }
  }

  const float inv0 = 1.f / quad_sum(l0);
  const float inv1 = 1.f / quad_sum(l1);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + 2 * t;
    if (ok0) {
      *reinterpret_cast<__nv_bfloat162*>(o + base + static_cast<size_t>(row0) * D + c) =
          __floats2bfloat162_rn(acc[j][0] * inv0, acc[j][1] * inv0);
    }
    if (ok1) {
      *reinterpret_cast<__nv_bfloat162*>(o + base + static_cast<size_t>(row1) * D + c) =
          __floats2bfloat162_rn(acc[j][2] * inv1, acc[j][3] * inv1);
    }
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. Launches on `stream` and returns the
// cudaGetLastError() code of the launch (0 on success). Pointers must be
// 16-byte aligned and contiguous (B, N, d); the Python wrapper checks this.
extern "C" int frn_flash_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                  int batch, int n, int d, void* stream) {
  if (batch <= 0 || n <= 0 || batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kBlockQ - 1) / kBlockQ, batch);
  const dim3 block(kWarps * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  auto* ob = static_cast<__nv_bfloat16*>(o);
  if (d == 32) {
    flash_fwd_kernel<32><<<grid, block, 0, s>>>(qb, kb, vb, ob, n);
  } else if (d == 64) {
    flash_fwd_kernel<64><<<grid, block, 0, s>>>(qb, kb, vb, ob, n);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

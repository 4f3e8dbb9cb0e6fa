// Flash-attention backward for the REFusion non-local cross-attention, Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of frn_tpu/ops/flash_attention.py::
// _flash_backward: _bwd_dq_kernel (dQ) and _bwd_dkv_kernel (dK, dV). Given the
// forward's inputs Q, K, V (B, N, d) bf16, the upstream gradient dO (B, N, d)
// bf16, the forward's per-row logsumexp lse (B, N) f32 and D = rowsum(dO * O)
// (B, N) f32, computed outside (as _flash_backward does), per batch:
//
//     P  = exp(Q K^T - lse)            (no 1/sqrt(d) scale, as the forward)
//     dS = P * (dO V^T - D)
//     dQ = dS K,   dK = dS^T Q,   dV = P^T dO
//
// P is rounded to bf16 before the dV product and dS before the dQ and dK
// products (the JAX kernels' .astype); every sum is f32; the outputs are bf16.
// d is 8, 16, 32 or 64.
//
// What bounds them on an H100: per score, one exponential and 6d (dQ kernel)
// or 8d (dK/dV kernel) flops of matrix products. At d = 32 the dQ kernel is
// exp-bound (192 flops per exp; the tensor cores do 989e12 / 3.9e12 = 254) and
// the dK/dV kernel is product-bound by a hair (256); at d = 64 both are
// product-bound. Device memory is not the limit: every input is read once per
// block from L2 and the outputs are written once.
//
// Design (first, simple version, in the style of the forward): one block of 4
// warps owns 64 rows and loops over 64-row tiles of the other side staged in
// shared memory; each warp owns 16 rows, and its f32 accumulators stay in
// registers for the whole loop, so each block writes its rows once, with no
// atomics and no second pass.
//   dQ:   rows are queries. Q, dO, lse and D are in registers; per key tile the
//         block stages K [key][d], V [key][d] and K^T [d][key]. S = Q K^T and
//         dP = dO V^T are mma.sync m16n8k16 products; the C fragments of dS are
//         the A fragments of dQ += dS K.
//   dK/dV: rows are keys. K and V are in registers; per query tile the block
//         stages Q, dO (row-major and transposed) and the tile's lse and D. It
//         computes the transposed tiles directly: S^T = K Q^T, P^T = exp(S^T -
//         lse[col]), dP^T = V dO^T, dS^T = P^T * (dP^T - D[col]); then
//         dV += P^T dO and dK += dS^T Q.
// Ragged N: key columns past N are masked to P = 0 in the dQ kernel, and query
// columns past N to P = 0 and dS = 0 in the dK/dV kernel (their lse is never
// read). Not yet done: cp.async/TMA double buffering, wgmma, exp2.

#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int n) {
  static_assert(D % 8 == 0 && D <= 64, "head dim must be 8, 16, 32 or 64");
  constexpr int KD = kSteps<D>();
  __shared__ __align__(16) __nv_bfloat16 k_tile[kTile][D + kPad];   // [key][d]
  __shared__ __align__(16) __nv_bfloat16 v_tile[kTile][D + kPad];   // [key][d]
  __shared__ __align__(16) __nv_bfloat16 kt_tile[D][kTile + kPad];  // [d][key]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t base = static_cast<size_t>(blockIdx.y) * n * D;
  const size_t rbase = static_cast<size_t>(blockIdx.y) * n;
  const int row0 = blockIdx.x * kRows + warp * 16 + g;
  const int row1 = row0 + 8;
  const bool ok0 = row0 < n, ok1 = row1 < n;
  const size_t off0 = static_cast<size_t>(ok0 ? row0 : 0) * D;
  const size_t off1 = static_cast<size_t>(ok1 ? row1 : 0) * D;

  uint32_t qa[KD][4], da[KD][4];
  load_a_rows<D>(qa, q + base + off0, q + base + off1, ok0, ok1, t);
  load_a_rows<D>(da, dout + base + off0, dout + base + off1, ok0, ok1, t);
  const float lse0 = ok0 ? lse[rbase + row0] : 0.f, lse1 = ok1 ? lse[rbase + row1] : 0.f;
  const float dl0 = ok0 ? delta[rbase + row0] : 0.f, dl1 = ok1 ? delta[rbase + row1] : 0.f;

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int kt = 0; kt < n; kt += kTile) {
    __syncthreads();
    stage_tiles<D>(kt, n, k + base, k_tile, kt_tile, v + base, v_tile, nullptr);
    __syncthreads();

    // dS = exp(Q K^T - lse) * (dO V^T - D), one 16x8 tile of keys at a time
    uint32_t dsa[kTile / 16][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t b[2];
        b_from_rows<D>(b, k_tile[nt * 8 + g], kk, t);
        mma_16816(s, qa[kk], b);
        b_from_rows<D>(b, v_tile[nt * 8 + g], kk, t);
        mma_16816(dp, da[kk], b);
      }
      const int key = kt + nt * 8 + 2 * t;
      const bool in0 = key < n, in1 = key + 1 < n;
      const float p0 = in0 ? __expf(s[0] - lse0) : 0.f;
      const float p1 = in1 ? __expf(s[1] - lse0) : 0.f;
      const float p2 = in0 ? __expf(s[2] - lse1) : 0.f;
      const float p3 = in1 ? __expf(s[3] - lse1) : 0.f;
      to_a_frag(dsa, nt, p0 * (dp[0] - dl0), p1 * (dp[1] - dl0), p2 * (dp[2] - dl1),
                p3 * (dp[3] - dl1));
    }

    // dQ += dS K: B is K (16 keys x 8 of d), read from the transposed tile
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        uint32_t b[2];
        b_from_cols(b, kt_tile[j * 8 + g], kk, t);
        mma_16816(acc[j], dsa[kk], b);
      }
    }
  }
  store_rows<D>(dq + base, acc, row0, row1, ok0, ok1, t);
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int n) {
  static_assert(D % 8 == 0 && D <= 64, "head dim must be 8, 16, 32 or 64");
  constexpr int KD = kSteps<D>();
  __shared__ __align__(16) __nv_bfloat16 q_tile[kTile][D + kPad];    // [query][d]
  __shared__ __align__(16) __nv_bfloat16 do_tile[kTile][D + kPad];   // [query][d]
  __shared__ __align__(16) __nv_bfloat16 qt_tile[D][kTile + kPad];   // [d][query]
  __shared__ __align__(16) __nv_bfloat16 dot_tile[D][kTile + kPad];  // [d][query]
  __shared__ float lse_s[kTile], dl_s[kTile];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t base = static_cast<size_t>(blockIdx.y) * n * D;
  const size_t rbase = static_cast<size_t>(blockIdx.y) * n;
  const int row0 = blockIdx.x * kRows + warp * 16 + g;  // key rows row0, row0 + 8
  const int row1 = row0 + 8;
  const bool ok0 = row0 < n, ok1 = row1 < n;
  const size_t off0 = static_cast<size_t>(ok0 ? row0 : 0) * D;
  const size_t off1 = static_cast<size_t>(ok1 ? row1 : 0) * D;

  uint32_t ka[KD][4], va[KD][4];
  load_a_rows<D>(ka, k + base + off0, k + base + off1, ok0, ok1, t);
  load_a_rows<D>(va, v + base + off0, v + base + off1, ok0, ok1, t);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    dk_acc[j][0] = dk_acc[j][1] = dk_acc[j][2] = dk_acc[j][3] = 0.f;
    dv_acc[j][0] = dv_acc[j][1] = dv_acc[j][2] = dv_acc[j][3] = 0.f;
  }

  for (int qt = 0; qt < n; qt += kTile) {
    __syncthreads();
    stage_tile<D>(qt, n, q + base, q_tile, qt_tile);
    stage_tile<D>(qt, n, dout + base, do_tile, dot_tile);
    for (int i = threadIdx.x; i < kTile; i += kWarps * 32) {
      const bool in = qt + i < n;
      lse_s[i] = in ? lse[rbase + qt + i] : 0.f;
      dl_s[i] = in ? delta[rbase + qt + i] : 0.f;
    }
    __syncthreads();

    // P^T = exp(K Q^T - lse[col]) for this warp's 16 keys x the tile's queries;
    // kept in f32 for dS^T and as bf16 A fragments for dV += P^T dO
    float pt[kTile / 8][4];
    uint32_t pa[kTile / 16][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t b[2];
        b_from_rows<D>(b, q_tile[nt * 8 + g], kk, t);
        mma_16816(s, ka[kk], b);
      }
      const int c = nt * 8 + 2 * t;  // query column in the tile
      const bool in0 = qt + c < n, in1 = qt + c + 1 < n;
      pt[nt][0] = in0 ? __expf(s[0] - lse_s[c]) : 0.f;
      pt[nt][1] = in1 ? __expf(s[1] - lse_s[c + 1]) : 0.f;
      pt[nt][2] = in0 ? __expf(s[2] - lse_s[c]) : 0.f;
      pt[nt][3] = in1 ? __expf(s[3] - lse_s[c + 1]) : 0.f;
      to_a_frag(pa, nt, pt[nt][0], pt[nt][1], pt[nt][2], pt[nt][3]);
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        uint32_t b[2];
        b_from_cols(b, dot_tile[j * 8 + g], kk, t);
        mma_16816(dv_acc[j], pa[kk], b);
      }
    }

    // dS^T = P^T * (V dO^T - D[col]), zero in the masked query columns
    uint32_t dsa[kTile / 16][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      float dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t b[2];
        b_from_rows<D>(b, do_tile[nt * 8 + g], kk, t);
        mma_16816(dp, va[kk], b);
      }
      const int c = nt * 8 + 2 * t;
      const bool in0 = qt + c < n, in1 = qt + c + 1 < n;
      to_a_frag(dsa, nt, in0 ? pt[nt][0] * (dp[0] - dl_s[c]) : 0.f,
                in1 ? pt[nt][1] * (dp[1] - dl_s[c + 1]) : 0.f,
                in0 ? pt[nt][2] * (dp[2] - dl_s[c]) : 0.f,
                in1 ? pt[nt][3] * (dp[3] - dl_s[c + 1]) : 0.f);
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        uint32_t b[2];
        b_from_cols(b, qt_tile[j * 8 + g], kk, t);
        mma_16816(dk_acc[j], dsa[kk], b);
      }
    }
  }
  store_rows<D>(dk + base, dk_acc, row0, row1, ok0, ok1, t);
  store_rows<D>(dv + base, dv_acc, row0, row1, ok0, ok1, t);
}

int check_args(int batch, int n) {
  return (batch <= 0 || n <= 0 || batch > 65535) ? static_cast<int>(cudaErrorInvalidValue) : 0;
}

}  // namespace

// Plain C entry points, bound with ctypes. Each launches on `stream` and
// returns the cudaGetLastError() code of the launch (0 on success). Q, K, V,
// dO and the outputs are contiguous (B, N, d) bf16, lse and D contiguous
// (B, N) f32, all 16-byte aligned; the Python wrapper checks this.
extern "C" int frn_flash_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                                     const void* lse, const void* delta, void* dq, int batch, int n,
                                     int d, void* stream) {
  if (int rc = check_args(batch, n)) return rc;
  const dim3 grid((n + kRows - 1) / kRows, batch), block(kWarps * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  const auto* db = static_cast<const __nv_bfloat16*>(dout);
  const auto* lf = static_cast<const float*>(lse);
  const auto* df = static_cast<const float*>(delta);
  auto* out = static_cast<__nv_bfloat16*>(dq);
  switch (d) {
    case 8: flash_bwd_dq_kernel<8><<<grid, block, 0, s>>>(qb, kb, vb, db, lf, df, out, n); break;
    case 16: flash_bwd_dq_kernel<16><<<grid, block, 0, s>>>(qb, kb, vb, db, lf, df, out, n); break;
    case 32: flash_bwd_dq_kernel<32><<<grid, block, 0, s>>>(qb, kb, vb, db, lf, df, out, n); break;
    case 64: flash_bwd_dq_kernel<64><<<grid, block, 0, s>>>(qb, kb, vb, db, lf, df, out, n); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int frn_flash_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                                      const void* lse, const void* delta, void* dk, void* dv,
                                      int batch, int n, int d, void* stream) {
  if (int rc = check_args(batch, n)) return rc;
  const dim3 grid((n + kRows - 1) / kRows, batch), block(kWarps * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  const auto* db = static_cast<const __nv_bfloat16*>(dout);
  const auto* lf = static_cast<const float*>(lse);
  const auto* df = static_cast<const float*>(delta);
  auto* kout = static_cast<__nv_bfloat16*>(dk);
  auto* vout = static_cast<__nv_bfloat16*>(dv);
  switch (d) {
    case 8: flash_bwd_dkv_kernel<8><<<grid, block, 0, s>>>(qb, kb, vb, db, lf, df, kout, vout, n); break;
    case 16: flash_bwd_dkv_kernel<16><<<grid, block, 0, s>>>(qb, kb, vb, db, lf, df, kout, vout, n); break;
    case 32: flash_bwd_dkv_kernel<32><<<grid, block, 0, s>>>(qb, kb, vb, db, lf, df, kout, vout, n); break;
    case 64: flash_bwd_dkv_kernel<64><<<grid, block, 0, s>>>(qb, kb, vb, db, lf, df, kout, vout, n); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

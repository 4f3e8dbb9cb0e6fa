// Flash-attention forward for the REFusion non-local cross-attention, Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel frn_tpu/ops/flash_attention.py::_flash_kernel
// (with _flash_q_group, launched by _flash_forward). It computes, per batch b,
//
//     O[b] = softmax(Q[b] K[b]^T) V[b]        (no 1/sqrt(d) scale)
//
// with Q = phi, K = theta, V = g, all (B, N, d) bf16 row-major, d in
// {8, 16, 32, 64}, and on request (training) the per-row logsumexp
// lse = m + log(l) in f32, natural log, as _flash_forward(return_lse=True).
// Scores, the running row max and the running denominator are f32; p is rounded
// to bf16 before the PV product; the output accumulator is f32 and is divided by
// the denominator once, at the end.
//
// The kExpBf16 instance replaces the same Pallas kernel with exp_bf16=True
// (flash_nonlocal_attention_bf16exp, inference only, no lse): there
// p = bf16(__expf(bf16(s - m))), m the running row max, and the denominator
// sums those bf16 p, as the TPU kernel's ones lane does. It is a compile-time
// flag, so the default instance's code is unchanged. The key and query tails of any N are masked
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

#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

template <int D, bool kExpBf16>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse, int n) {
  static_assert(D % 8 == 0 && D <= 64, "head dim must be 8, 16, 32 or 64");
  constexpr int KD = kSteps<D>();
  __shared__ __align__(16) __nv_bfloat16 k_tile[kTile][D + kPad];  // [key][d]
  __shared__ __align__(16) __nv_bfloat16 vt_tile[D][kTile + kPad];  // [d][key]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const size_t base = static_cast<size_t>(blockIdx.y) * n * D;
  const int row0 = blockIdx.x * kRows + warp * 16 + g;  // rows row0 and row0 + 8
  const int row1 = row0 + 8;
  const bool ok0 = row0 < n, ok1 = row1 < n;

  // Q as A fragments, one per 16-wide slice of d; rows past n read as zeros
  uint32_t qa[KD][4];
  load_a_rows<D>(qa, q + base + static_cast<size_t>(ok0 ? row0 : 0) * D,
                 q + base + static_cast<size_t>(ok1 ? row1 : 0) * D, ok0, ok1, t);

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running row max (rows row0, row1)
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the denominators

  for (int kt = 0; kt < n; kt += kTile) {
    __syncthreads();  // the previous tile has been read by every warp
    stage_tiles<D>(kt, n, k + base, k_tile, nullptr, v + base, nullptr, vt_tile);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows: kTile / 8 tiles of 16x8
    float s[kTile / 8][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t b[2];
        b_from_rows<D>(b, k_tile[nt * 8 + g], kk, t);
        mma_16816(s[nt], qa[kk], b);
      }
    }

    // mask the key tail, then the online-softmax update
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
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

    // p = exp(s - m) in f32 for the denominator, rounded to bf16 for PV; with
    // kExpBf16, p = bf16(exp(bf16(s - m))) for both
    uint32_t pa[kTile / 16][4];
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      float p0, p1, p2, p3;
      if constexpr (kExpBf16) {
        p0 = round_bf16(__expf(round_bf16(s[nt][0] - mx0)));
        p1 = round_bf16(__expf(round_bf16(s[nt][1] - mx0)));
        p2 = round_bf16(__expf(round_bf16(s[nt][2] - mx1)));
        p3 = round_bf16(__expf(round_bf16(s[nt][3] - mx1)));
      } else {
        p0 = __expf(s[nt][0] - mx0);
        p1 = __expf(s[nt][1] - mx0);
        p2 = __expf(s[nt][2] - mx1);
        p3 = __expf(s[nt][3] - mx1);
      }
      rs0 += p0 + p1;
      rs1 += p2 + p3;
      to_a_frag(pa, nt, p0, p1, p2, p3);
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
      for (int kk = 0; kk < kTile / 16; ++kk) {
        uint32_t b[2];
        b_from_cols(b, vt_tile[j * 8 + g], kk, t);
        mma_16816(acc[j], pa[kk], b);
      }
    }
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  store_rows<D>(o + base, acc, row0, row1, ok0, ok1, t, 1.f / l0, 1.f / l1);
  if (lse != nullptr && t == 0) {
    float* out = lse + static_cast<size_t>(blockIdx.y) * n;
    if (ok0) out[row0] = m0 + logf(l0);
    if (ok1) out[row1] = m1 + logf(l1);
  }
}

template <int D, bool kExpBf16>
void launch(dim3 grid, cudaStream_t s, const __nv_bfloat16* q, const __nv_bfloat16* k,
            const __nv_bfloat16* v, __nv_bfloat16* o, float* lse, int n) {
  flash_fwd_kernel<D, kExpBf16><<<grid, kWarps * 32, 0, s>>>(q, k, v, o, lse, n);
}

template <bool kExpBf16>
int launch_d(int batch, int n, int d, void* stream, const void* q, const void* k, const void* v,
             void* o, void* lse) {
  if (batch <= 0 || n <= 0 || batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kRows - 1) / kRows, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  auto* ob = static_cast<__nv_bfloat16*>(o);
  auto* lf = static_cast<float*>(lse);
  switch (d) {
    case 8: launch<8, kExpBf16>(grid, s, qb, kb, vb, ob, lf, n); break;
    case 16: launch<16, kExpBf16>(grid, s, qb, kb, vb, ob, lf, n); break;
    case 32: launch<32, kExpBf16>(grid, s, qb, kb, vb, ob, lf, n); break;
    case 64: launch<64, kExpBf16>(grid, s, qb, kb, vb, ob, lf, n); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, bound with ctypes. Launches on `stream` and returns the
// cudaGetLastError() code of the launch (0 on success). Pointers must be
// 16-byte aligned and contiguous (B, N, d); `lse` is a (B, N) f32 output, or
// null when the caller needs no logsumexp (inference). The Python wrapper
// checks all of this.
extern "C" int frn_flash_fwd_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                                  int batch, int n, int d, void* stream) {
  return launch_d<false>(batch, n, d, stream, q, k, v, o, lse);
}

// The bf16-exp forward (inference only): the same arguments without lse.
extern "C" int frn_flash_fwd_bf16exp_bf16(const void* q, const void* k, const void* v, void* o,
                                          int batch, int n, int d, void* stream) {
  return launch_d<true>(batch, n, d, stream, q, k, v, o, nullptr);
}

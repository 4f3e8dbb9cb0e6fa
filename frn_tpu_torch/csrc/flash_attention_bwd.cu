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
// Design. Two kernels, each the counterpart of one Pallas kernel, so that a
// block writes its own rows once: no f32 scratch, no atomics, deterministic
// gradients. At d 32 and 64 (the path's head dims) both follow the forward's
// wgmma kernel (flash_attention.cu) and use its Hopper helpers
// (flash_sm90.cuh); a warpgroup owns 64 rows and loops over 64-row tiles of
// the other side, which thread 0 stages by TMA (3-D tensor maps, rows past N
// zero-filled) into a swizzled ring of kStages slots, kAhead tiles ahead,
// each slot completing on an mbarrier:
//  - flash_bwd_dq_wgmma: the rows are queries. Q and dO are A fragments in
//    registers, lse * log2(e) and D two f32 per row. The ring is the
//    forward's (a K tile, then a V tile per slot). Per tile: S = Q K^T and
//    dP = dO V^T are wgmma with K and V K-major; dS = P * (dP - D), with
//    P = ex2(s * log2(e) - lse * log2(e)), is formed in registers and packed
//    to bf16 A fragments; dQ += dS K is wgmma with the same K tile MN-major
//    (the transpose bit), as the forward's P V.
//  - flash_bwd_dkv_wgmma: the rows are keys. K and V are A fragments. A slot
//    holds a Q tile and a dO tile, by TMA, and beside them the tile's 64 lse
//    and 64 D, one f32 per thread by cp.async (a tensor map needs 16-byte
//    aligned starts, and the batches' rows start at b * N). Per tile:
//    S^T = K Q^T and dP^T = V dO^T (Q and dO K-major); P^T = ex2(S^T *
//    log2(e) - lse[col] * log2(e)), packed to bf16 A fragments for
//    dV += P^T dO (dO MN-major); dS^T = P^T * (dP^T - D[col]), packed for
//    dK += dS^T Q (Q MN-major).
// No tile is transposed in shared memory, and a warpgroup reads each operand
// tile from it once per product. In the dK/dV kernel each product is its own
// commit group, so that a warpgroup's exponentials of P^T run while its dP^T
// product does and dS^T while its dV product does (in the dQ kernel that
// measured slower, PERF.md); in both the last product of tile j runs on while
// the block passes the next tile's barrier. A slot is refilled two tiles after
// its last use, behind one __syncthreads per tile (the forward's discipline).
// The mask of the ragged last tile is a separate code path: key (dQ) or query
// (dK/dV) columns past N get P = 0 and so dS = 0. TMA's zero fill does not
// make it redundant: a zero key row gives s = 0 and p = exp(-lse), which is
// inf once lse < -88, and inf * 0 is NaN.
//
// At d 8 and 16 (off the path: tests and tiny configurations) the first,
// simple mma.sync kernels stay: one block of 4 warps owns 64 rows, each warp
// 16, with the tiles staged synchronously and the B operands of the products
// that contract over keys or queries read from tiles transposed element by
// element in padded shared memory.

#include <math.h>

#include "flash_sm90.cuh"

namespace {

using namespace flash;

// ------------------------------------------------------------ mma.sync kernels (d 8, 16)

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dq_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dq, int n) {
  static_assert(D == 8 || D == 16, "the mma.sync backward takes head dims 8 and 16");
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
flash_bwd_dkv_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int n) {
  static_assert(D == 8 || D == 16, "the mma.sync backward takes head dims 8 and 16");
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

// ------------------------------------------------------------ wgmma kernels (d 32, 64)

// shared memory of the dK/dV kernel: the ring, then per slot the tile's lse
// and D (kTile f32 each)
template <int D>
constexpr int dkv_smem_bytes() {
  return ring_bytes<D>() + kStages * 2 * kTile * 4;
}

// the offset of 16 tile rows in a tile descriptor (16-byte units): the
// contraction step of an MN-major B
template <int D>
constexpr uint64_t kRowStep = (16 * 2 * D) >> 4;

// The score tiles below are a warp's C fragments of 16 rows x 64 columns:
// x[nt][0..1] row g, x[nt][2..3] row g + 8, columns nt * 8 + 2t + {0, 1} of
// the tile. dS and P go to the bf16 A fragments of the next product in the
// same order: a[nt / 2][(nt % 2) * 2 + h] holds row g + 8h's pair of tile nt.

// dS = P * (dP - D) of one 64-key tile for this thread's query rows, with
// P = ex2(s * log2(e) - lb) (lb = lse * log2(e), dl = D of rows g and g + 8),
// as bf16 A fragments of dQ += dS K. P and dS of a score in one pass: two
// passes measured slower (PERF.md). With kMask, keys at or past n (key: the
// tile's first key + 2t) get P = 0: their zero-filled K rows give s = 0 and
// P = exp(-lse).
template <bool kMask>
__device__ __forceinline__ void ds_rows(const float (&s)[kTile / 8][4],
                                        const float (&dp)[kTile / 8][4], int key, int n,
                                        const float (&lb)[2], const float (&dl)[2],
                                        uint32_t (&dsa)[kTile / 16][4]) {
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float p0 = ex2(fmaf(s[nt][2 * h], kLog2e, -lb[h]));
      float p1 = ex2(fmaf(s[nt][2 * h + 1], kLog2e, -lb[h]));
      if constexpr (kMask) {
        if (key + nt * 8 >= n) p0 = 0.f;
        if (key + nt * 8 + 1 >= n) p1 = 0.f;
      }
      dsa[nt / 2][(nt % 2) * 2 + h] =
          pack_bf16x2(p0 * (dp[nt][2 * h] - dl[h]), p1 * (dp[nt][2 * h + 1] - dl[h]));
    }
  }
}

// st := P^T = ex2(s * log2(e) - lse * log2(e)) of one 64-query tile for this
// thread's key rows, with the tile's lse from shared memory (stats[0..kTile));
// pa := P^T in bf16, the A fragments of dV += P^T dO. With kMask, queries at
// or past n (q0: the tile's first query) get P = 0, whatever lse they read.
template <bool kMask>
__device__ __forceinline__ void p_cols(float (&st)[kTile / 8][4], const float* stats, int q0,
                                       int t, int n, uint32_t (&pa)[kTile / 16][4]) {
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt) {
    const int c = nt * 8 + 2 * t;
    const float2 l2 = *reinterpret_cast<const float2*>(stats + c);
    const float lb0 = l2.x * kLog2e, lb1 = l2.y * kLog2e;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float p0 = ex2(fmaf(st[nt][2 * h], kLog2e, -lb0));
      float p1 = ex2(fmaf(st[nt][2 * h + 1], kLog2e, -lb1));
      if constexpr (kMask) {
        if (q0 + c >= n) p0 = 0.f;
        if (q0 + c + 1 >= n) p1 = 0.f;
      }
      st[nt][2 * h] = p0;
      st[nt][2 * h + 1] = p1;
      pa[nt / 2][(nt % 2) * 2 + h] = pack_bf16x2(p0, p1);
    }
  }
}

// dS^T = P^T * (dP^T - D) of the same tile, D from stats[kTile..2 kTile), as
// bf16 A fragments of dK += dS^T Q. Queries past n have P = 0, dP^T = 0 (dO
// rows zero-filled) and D = 0 (zero-filled by stage_stats): dS = 0.
__device__ __forceinline__ void ds_cols(const float (&pt)[kTile / 8][4],
                                        const float (&dpt)[kTile / 8][4], const float* stats,
                                        int t, uint32_t (&dsa)[kTile / 16][4]) {
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt) {
    const float2 d2 = *reinterpret_cast<const float2*>(stats + kTile + nt * 8 + 2 * t);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      dsa[nt / 2][(nt % 2) * 2 + h] = pack_bf16x2(pt[nt][2 * h] * (dpt[nt][2 * h] - d2.x),
                                                  pt[nt][2 * h + 1] * (dpt[nt][2 * h + 1] - d2.y));
    }
  }
}

// keeps the compiler from moving reads or writes of a C fragment across the
// asynchronous products
template <int J>
__device__ __forceinline__ void fence_frag(float (&c)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) fence_reg(c[j][i]);
  }
}

// blocks per SM that __launch_bounds__ keeps registers for, by measurement
// on the H100 (PERF.md): three of dQ (138 and 155 registers at d 32 and 64),
// two of dK/dV (170 and 218; a third block at d 32, in 148, ran slower)
constexpr int kDqBlocks = 3;
constexpr int kDkvBlocks = 2;

// one warpgroup of 64 query rows; thread 0 stages K and V by TMA (kmap, vmap:
// encode_tile_map of K and V)
template <int D>
__global__ void __launch_bounds__(128, kDqBlocks)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int n) {
  static_assert(D == 32 || D == 64, "the wgmma backward takes head dims 32 and 64");
  constexpr int KD = D / 16;
  extern __shared__ uint8_t smem_raw[];
  __nv_bfloat16* ring = ring_base(smem_raw);
  __shared__ uint64_t full[kStages];  // ring slot s holds its next tile

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t base = static_cast<size_t>(blockIdx.y) * n * D;
  const size_t rbase = static_cast<size_t>(blockIdx.y) * n;
  const int row0 = blockIdx.x * 64 + warp * 16 + g, row1 = row0 + 8;  // warp w: rows 16 w..+15
  const bool ok0 = row0 < n, ok1 = row1 < n;
  const int tiles = (n + kTile - 1) / kTile;
  const bool ragged = n % kTile != 0;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    fence_mbar_init();
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      if (j < tiles) stage_tma<D>(&kmap, &vmap, j, ring, full);
    }
  }
  // Q and dO rows, lse * log2(e) and D; rows past n read as zeros (their dS
  // is finite and their dQ is never stored)
  const size_t off0 = static_cast<size_t>(ok0 ? row0 : 0) * D;
  const size_t off1 = static_cast<size_t>(ok1 ? row1 : 0) * D;
  uint32_t qa[KD][4], da[KD][4];
  load_a_rows<D>(qa, q + base + off0, q + base + off1, ok0, ok1, t);
  load_a_rows<D>(da, dout + base + off0, dout + base + off1, ok0, ok1, t);
  const float lb[2] = {ok0 ? lse[rbase + row0] * kLog2e : 0.f,
                       ok1 ? lse[rbase + row1] * kLog2e : 0.f};
  const float dl[2] = {ok0 ? delta[rbase + row0] : 0.f, ok1 ? delta[rbase + row1] : 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int j = 0; j < tiles; ++j) {
    __syncthreads();  // the barriers are set up; every warp has waited for dQ of tile j - 2
    if (threadIdx.x == 0 && j + kAhead < tiles) {
      stage_tma<D>(&kmap, &vmap, j + kAhead, ring, full);  // into tile j - 2's slot
    }
    mbar_wait(&full[j % kStages], (j / kStages) & 1);
    const __nv_bfloat16* kt = slot_tile<D>(ring, j % kStages);
    const uint64_t kdesc = tile_desc<D>(kt), vdesc = tile_desc<D>(kt + kTile * D);

    float s[kTile / 8][4], dp[kTile / 8][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      wgmma_m64n64k16<0>(s, qa[kk], kdesc + 2 * kk, kk);  // 32 bytes on along d
    }
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) wgmma_m64n64k16<0>(dp, da[kk], vdesc + 2 * kk, kk);
    wgmma_commit();
    wgmma_wait<0>();  // S and dP of tile j, and dQ of tile j - 1
    fence_frag(s);
    fence_frag(dp);
    fence_frag(acc);
    uint32_t dsa[kTile / 16][4];
    if (ragged && j == tiles - 1) {
      ds_rows<true>(s, dp, j * kTile + 2 * t, n, lb, dl, dsa);
    } else {
      ds_rows<false>(s, dp, j * kTile + 2 * t, n, lb, dl, dsa);
    }

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      wgmma_m64k16<1>(acc, dsa[kk], kdesc + kRowStep<D> * kk, 1);  // 16 keys on
    }
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_frag(acc);
  store_rows<D>(dq + base, acc, row0, row1, ok0, ok1, t);
}

// The block's 128 = 2 kTile threads start the copy of query tile `tile`'s lse
// (threads 0..63) and D (64..127) of this block's batch (lse, delta: its (n,)
// rows) into the tile's ring slot of `stats`, one f32 each by cp.async;
// queries past n are zero-filled. (A 2-D tensor map of (B, N) f32 needs
// N * 4 bytes to be a multiple of 16.)
__device__ __forceinline__ void stage_stats(const float* __restrict__ lse,
                                            const float* __restrict__ delta, int tile, int n,
                                            float* stats) {
  const int i = threadIdx.x;
  const int query = tile * kTile + i % kTile;
  const bool ok = query < n;
  const float* src = (i < kTile ? lse : delta) + (ok ? query : 0);
  cp_async_4(stats + (tile % kStages) * 2 * kTile + i, src, ok);
}

// one warpgroup of 64 key rows; thread 0 stages Q and dO by TMA (qmap, omap:
// encode_tile_map of Q and dO), the block's threads lse and D by cp.async
template <int D>
__global__ void __launch_bounds__(128, kDkvBlocks)
flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap omap, const float* __restrict__ lse,
                    const float* __restrict__ delta, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, int n) {
  static_assert(D == 32 || D == 64, "the wgmma backward takes head dims 32 and 64");
  constexpr int KD = D / 16;
  extern __shared__ uint8_t smem_raw[];
  __nv_bfloat16* ring = ring_base(smem_raw);
  float* stats = reinterpret_cast<float*>(ring + kStages * 2 * kTile * D);
  __shared__ uint64_t full[kStages];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t base = static_cast<size_t>(blockIdx.y) * n * D;
  const float* lse_b = lse + static_cast<size_t>(blockIdx.y) * n;
  const float* delta_b = delta + static_cast<size_t>(blockIdx.y) * n;
  const int row0 = blockIdx.x * 64 + warp * 16 + g, row1 = row0 + 8;  // key rows
  const bool ok0 = row0 < n, ok1 = row1 < n;
  const int tiles = (n + kTile - 1) / kTile;
  const bool ragged = n % kTile != 0;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    fence_mbar_init();
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      if (j < tiles) stage_tma<D>(&qmap, &omap, j, ring, full);
    }
  }
#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    if (j < tiles) stage_stats(lse_b, delta_b, j, n, stats);
    cp_async_commit();
  }
  // K and V rows; rows past n read as zeros (their dK and dV are never stored)
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

  for (int j = 0; j < tiles; ++j) {
    cp_async_wait<kAhead - 1>();  // this thread's lse or D of tile j has landed
    __syncthreads();  // everyone's has; every warp has waited for dK and dV of tile j - 2
    if (threadIdx.x == 0 && j + kAhead < tiles) {
      stage_tma<D>(&qmap, &omap, j + kAhead, ring, full);  // into tile j - 2's slot
    }
    if (j + kAhead < tiles) stage_stats(lse_b, delta_b, j + kAhead, n, stats);
    cp_async_commit();
    mbar_wait(&full[j % kStages], (j / kStages) & 1);
    const __nv_bfloat16* qt = slot_tile<D>(ring, j % kStages);
    const uint64_t qdesc = tile_desc<D>(qt), odesc = tile_desc<D>(qt + kTile * D);

    float st[kTile / 8][4], dpt[kTile / 8][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) wgmma_m64n64k16<0>(st, ka[kk], qdesc + 2 * kk, kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) wgmma_m64n64k16<0>(dpt, va[kk], odesc + 2 * kk, kk);
    wgmma_commit();
    wgmma_wait<1>();  // S^T of tile j, and dK, dV of tile j - 1; dP^T runs on
    fence_frag(st);
    fence_frag(dk_acc);
    fence_frag(dv_acc);
    uint32_t pa[kTile / 16][4];
    const float* stats_j = stats + (j % kStages) * 2 * kTile;
    if (ragged && j == tiles - 1) {
      p_cols<true>(st, stats_j, j * kTile, t, n, pa);
    } else {
      p_cols<false>(st, stats_j, j * kTile, t, n, pa);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      wgmma_m64k16<1>(dv_acc, pa[kk], odesc + kRowStep<D> * kk, 1);  // 16 queries on
    }
    wgmma_commit();
    wgmma_wait<1>();  // dP^T of tile j; dV runs on under dS^T
    fence_frag(dpt);
    uint32_t dsa[kTile / 16][4];
    ds_cols(st, dpt, stats_j, t, dsa);

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      wgmma_m64k16<1>(dk_acc, dsa[kk], qdesc + kRowStep<D> * kk, 1);
    }
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_frag(dk_acc);
  fence_frag(dv_acc);
  store_rows<D>(dk + base, dk_acc, row0, row1, ok0, ok1, t);
  store_rows<D>(dv + base, dv_acc, row0, row1, ok0, ok1, t);
}

// ------------------------------------------------------------ launch

struct Args {
  const __nv_bfloat16 *q, *k, *v, *dout;
  const float *lse, *delta;
  __nv_bfloat16 *dq, *dk, *dv;
  int batch, n;
  cudaStream_t stream;
};

template <int D>
int launch_dq_mma(const Args& a) {
  const dim3 grid((a.n + kRows - 1) / kRows, a.batch);
  flash_bwd_dq_mma<D><<<grid, kWarps * 32, 0, a.stream>>>(a.q, a.k, a.v, a.dout, a.lse, a.delta,
                                                          a.dq, a.n);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv_mma(const Args& a) {
  const dim3 grid((a.n + kRows - 1) / kRows, a.batch);
  flash_bwd_dkv_mma<D><<<grid, kWarps * 32, 0, a.stream>>>(a.q, a.k, a.v, a.dout, a.lse, a.delta,
                                                           a.dk, a.dv, a.n);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq_wgmma(const Args& a) {
  static int set_for_device = -1;
  int rc = allow_smem(flash_bwd_dq_wgmma<D>, ring_bytes<D>(), set_for_device);
  CUtensorMap kmap, vmap;
  if (rc == 0) rc = encode_tile_map<D>(&kmap, a.k, a.batch, a.n);
  if (rc == 0) rc = encode_tile_map<D>(&vmap, a.v, a.batch, a.n);
  if (rc != 0) return rc;
  const dim3 grid((a.n + 63) / 64, a.batch);
  flash_bwd_dq_wgmma<D><<<grid, 128, ring_bytes<D>(), a.stream>>>(
      kmap, vmap, a.q, a.dout, a.lse, a.delta, a.dq, a.n);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv_wgmma(const Args& a) {
  static int set_for_device = -1;
  int rc = allow_smem(flash_bwd_dkv_wgmma<D>, dkv_smem_bytes<D>(), set_for_device);
  CUtensorMap qmap, omap;
  if (rc == 0) rc = encode_tile_map<D>(&qmap, a.q, a.batch, a.n);
  if (rc == 0) rc = encode_tile_map<D>(&omap, a.dout, a.batch, a.n);
  if (rc != 0) return rc;
  const dim3 grid((a.n + 63) / 64, a.batch);
  flash_bwd_dkv_wgmma<D><<<grid, 128, dkv_smem_bytes<D>(), a.stream>>>(
      qmap, omap, a.lse, a.delta, a.k, a.v, a.dk, a.dv, a.n);
  return static_cast<int>(cudaGetLastError());
}

int check_args(int batch, int n) {
  return (batch <= 0 || n <= 0 || batch > 65535) ? static_cast<int>(cudaErrorInvalidValue) : 0;
}

Args make_args(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dq, void* dk, void* dv, int batch, int n, void* stream) {
  return {static_cast<const __nv_bfloat16*>(q),    static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v),    static_cast<const __nv_bfloat16*>(dout),
          static_cast<const float*>(lse),          static_cast<const float*>(delta),
          static_cast<__nv_bfloat16*>(dq),         static_cast<__nv_bfloat16*>(dk),
          static_cast<__nv_bfloat16*>(dv),         batch,
          n,                                       static_cast<cudaStream_t>(stream)};
}

}  // namespace

// Plain C entry points, bound with ctypes. Each launches on `stream` and
// returns the CUDA error code of the launch (0 on success). Q, K, V, dO and
// the outputs are contiguous (B, N, d) bf16, lse and D contiguous (B, N) f32,
// all 16-byte aligned; the Python wrapper checks this. By head dim: wgmma at
// d 32 and 64 (one warpgroup of 64 rows per block), mma.sync at d 8 and 16.
extern "C" int frn_flash_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                                     const void* lse, const void* delta, void* dq, int batch, int n,
                                     int d, void* stream) {
  if (int rc = check_args(batch, n)) return rc;
  const Args a = make_args(q, k, v, dout, lse, delta, dq, nullptr, nullptr, batch, n, stream);
  switch (d) {
    case 8: return launch_dq_mma<8>(a);
    case 16: return launch_dq_mma<16>(a);
    case 32: return launch_dq_wgmma<32>(a);
    case 64: return launch_dq_wgmma<64>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int frn_flash_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                                      const void* lse, const void* delta, void* dk, void* dv,
                                      int batch, int n, int d, void* stream) {
  if (int rc = check_args(batch, n)) return rc;
  const Args a = make_args(q, k, v, dout, lse, delta, nullptr, dk, dv, batch, n, stream);
  switch (d) {
    case 8: return launch_dkv_mma<8>(a);
    case 16: return launch_dkv_mma<16>(a);
    case 32: return launch_dkv_wgmma<32>(a);
    case 64: return launch_dkv_wgmma<64>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

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
// At d 8 and 16 (the depth-18 and -34 training path: N 19,200 at d 8, N
// 4,800 at d 16) the exponentials bound both kernels: 6d or 8d flops per exp
// is far below the tensor cores' 254. Both kernels follow the forward's
// mma.sync kernel (flash_attention.cu, flash_fwd_mma): all threads stage
// 64-row tiles of the other side by 16-byte cp.async into the forward's
// swizzled ring (kStages slots, kAhead tiles in flight, one __syncthreads per
// tile); B fragments come by ldmatrix from the row-major tiles for the
// score products and by ldmatrix.trans from the same tiles for the gradient
// products, so no tile is transposed in memory; products are m16n8k8 at d 8
// and m16n8k16 at d 16; dP's accumulator starts at -D, so that a score costs
// one FFMA and one ex2 for P and one FMUL for dS; only the ragged last tile
// takes the select that gives the other side's rows at or past N P = 0; each
// block writes its own rows once.
//  - flash_bwd_dq_ring: a block of dq_warps (4) warps owns dq_rows (64) query
//    rows, each warp dq_row_tiles (1) 16-row tile with Q and dO as A
//    fragments and lse * log2(e) and -D of its rows in registers, and walks
//    the key tiles of K and V. Per 16 keys: S = Q K^T and dP = dO V^T - D, P
//    = ex2(S log2(e) - lse log2(e)), dS = P dP packed once to a bf16 A
//    fragment, dQ += dS K.
//  - flash_bwd_dkv_ring: a block of dkv_warps (4) warps owns dkv_rows (128)
//    key rows, each warp dkv_key_tiles (2) 16-row tiles with K and V as A
//    fragments, so that each B fragment serves both, and walks the query
//    tiles of Q and dO. Beside the ring,
//    threads 0..127 carry each tile's lse and D a tile ahead in a register
//    and write them into one of two slots as the fragments read them: lse *
//    log2(e) in pairs, and -D as the C fragment that starts dP^T's
//    accumulator. Per 16 queries: S^T = K Q^T and dP^T = V dO^T - D; P^T =
//    ex2(S^T log2(e) - lse log2(e)) and dS^T = P^T dP^T, each packed once to
//    bf16 A fragments; dV += P^T dO and dK += dS^T Q.

#include <math.h>

#include "flash_sm90.cuh"

namespace {

using namespace flash;

// ------------------------------------------------------------ the ring dQ kernel (d 8, 16)

// Its block, by head dim: warps, each owning dq_row_tiles 16-row tiles of
// queries, and the blocks an SM that __launch_bounds__ keeps registers for.
// Chosen in turns on the H100 (PERF.md): 4 warps of one tile at 6 blocks an
// SM (80 registers) beat 5 and 7 blocks, 2 and 8 warps, and two tiles a warp
// (whose shared B fragments gained nothing here: 107-168 registers at 3-4
// blocks an SM).
template <int D>
__host__ __device__ constexpr int dq_warps() { return 4; }
template <int D>
__host__ __device__ constexpr int dq_row_tiles() { return 1; }
template <int D>
__host__ __device__ constexpr int dq_blocks_per_sm() { return 6; }
template <int D>
__host__ __device__ constexpr int dq_rows() { return dq_warps<D>() * 16 * dq_row_tiles<D>(); }

// One key tile (kTile keys from key0, K and V in the swizzled ring tiles kt
// and vt) for this warp's M 16-row query tiles (Q and dO as A fragments qa
// and da; lb = lse log2(e) and nd = -D of rows g and g + 8), 16 keys at a
// time: S = Q K^T and dP = dO V^T - D take their B fragments by ldmatrix from
// the row-major tiles (d 8: m16n8k8), dP's accumulator started at -D; P =
// ex2(S log2(e) - lb) and dS = P dP are packed once to a bf16 A fragment;
// dQ += dS K takes its B fragments by ldmatrix.trans from the same K tile.
// Each B fragment serves the M query tiles, and each query tile's dQ product
// follows its dS, so that one tile's dS is live at a time. With kMask (the
// ragged last tile) keys at or past n get P = 0 by a select, whatever their
// scores read.
template <int D, int M, bool kMask>
__device__ __forceinline__ void dq_tile(const uint32_t (&qa)[M][kSteps<D>()][4],
                                        const uint32_t (&da)[M][kSteps<D>()][4],
                                        const float (&lb)[M][2], const float (&nd)[M][2],
                                        const __nv_bfloat16* kt, const __nv_bfloat16* vt, int key0,
                                        int n, int lane, float (&acc)[M][D / 8][4]) {
  const int r8 = lane & 7, mat = lane >> 3;
  constexpr int kPair = D == 8 ? 2 : 1;  // steps that share one ldmatrix.x4.trans
#pragma unroll
  for (int k0 = 0; k0 < kTile / 16; k0 += kPair) {
    // B fragments of dQ += dS K, transposed: d 8, K rows +0, +8, +16, +24
    // (two steps' worth); d 16, K rows +0 chunk 0, rows +8 chunk 0, rows +0
    // chunk 1, rows +8 chunk 1
    uint32_t bt[4];
    ldmatrix_x4_trans(bt, kt + (D == 8 ? swz<D>(k0 * 16 + mat * 8 + r8, 0)
                                       : swz<D>(k0 * 16 + (mat & 1) * 8 + r8, mat >> 1)));
#pragma unroll
    for (int h = 0; h < kPair; ++h) {
      const int kk = k0 + h;  // keys key0 + 16 kk ..: score tiles 2 kk, 2 kk + 1
      // B fragments of S and dP (b). d 8: K rows +0, +8, then V rows +0, +8.
      // d 16: rows +0 chunk 0, rows +0 chunk 1, rows +8 chunk 0, rows +8 chunk
      // 1 of K (b[0..3]), then of V (b[4..7])
      uint32_t b[D == 8 ? 4 : 8];
      if constexpr (D == 8) {
        ldmatrix_x4(b, (mat < 2 ? kt : vt) + swz<D>(kk * 16 + (mat & 1) * 8 + r8, 0));
      } else {
        const int off = swz<D>(kk * 16 + (mat >> 1) * 8 + r8, mat & 1);
        ldmatrix_x4(b, kt + off);
        ldmatrix_x4(b + 4, vt + off);
      }
#pragma unroll
      for (int m = 0; m < M; ++m) {
        float s[2][4], dp[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
          dp[i][0] = dp[i][1] = nd[m][0];
          dp[i][2] = dp[i][3] = nd[m][1];
        }
        if constexpr (D == 8) {
          const uint32_t q8[2] = {qa[m][0][0], qa[m][0][1]}, o8[2] = {da[m][0][0], da[m][0][1]};
          mma_1688(s[0], q8, b[0]);
          mma_1688(s[1], q8, b[1]);
          mma_1688(dp[0], o8, b[2]);
          mma_1688(dp[1], o8, b[3]);
        } else {
          const uint32_t k0b[2] = {b[0], b[1]}, k1b[2] = {b[2], b[3]};
          const uint32_t v0b[2] = {b[4], b[5]}, v1b[2] = {b[6], b[7]};
          mma_16816(s[0], qa[m][0], k0b);
          mma_16816(s[1], qa[m][0], k1b);
          mma_16816(dp[0], da[m][0], v0b);
          mma_16816(dp[1], da[m][0], v1b);
        }
        uint32_t dsa[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {  // score tile 2 kk + i
          float p0 = ex2(fmaf(s[i][0], kLog2e, -lb[m][0]));
          float p1 = ex2(fmaf(s[i][1], kLog2e, -lb[m][0]));
          float p2 = ex2(fmaf(s[i][2], kLog2e, -lb[m][1]));
          float p3 = ex2(fmaf(s[i][3], kLog2e, -lb[m][1]));
          if constexpr (kMask) {
            const int key = key0 + kk * 16 + i * 8 + 2 * (lane & 3);
            if (key >= n) p0 = p2 = 0.f;
            if (key + 1 >= n) p1 = p3 = 0.f;
          }
          dsa[2 * i] = pack_bf16x2(p0 * dp[i][0], p1 * dp[i][1]);  // row g
          dsa[2 * i + 1] = pack_bf16x2(p2 * dp[i][2], p3 * dp[i][3]);  // row g + 8
        }
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const int c = D == 8 ? 2 * h : 2 * j;  // d 8: keys +0 / +16 of the pair's matrices
          const uint32_t bk[2] = {bt[c], bt[c + 1]};
          mma_16816(acc[m][j], dsa, bk);
        }
      }
    }
  }
}

// dq_warps warps of dq_row_tiles 16-row query tiles each; all threads stage
// the key tiles of K and V by 16-byte cp.async into the forward's swizzled
// ring (kStages slots, kAhead tiles ahead), one __syncthreads a tile.
template <int D>
__global__ void __launch_bounds__(dq_warps<D>() * 32, dq_blocks_per_sm<D>())
flash_bwd_dq_ring(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dq, int n) {
  static_assert(D == 8 || D == 16, "the ring dQ kernel takes head dims 8 and 16");
  constexpr int kThreads = dq_warps<D>() * 32, M = dq_row_tiles<D>(), KD = kSteps<D>();
  extern __shared__ uint8_t smem_raw[];
  __nv_bfloat16* ring = ring_base(smem_raw);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t base = static_cast<size_t>(blockIdx.y) * n * D;
  const size_t rbase = static_cast<size_t>(blockIdx.y) * n;
  const int row0 = blockIdx.x * dq_rows<D>() + warp * 16 * M;  // this warp's first query row
  const int tiles = (n + kTile - 1) / kTile;
  const bool ragged = n % kTile != 0;

#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    if (j < tiles) {
      __nv_bfloat16* slot = slot_tile<D>(ring, j);
      load_kv_async<D, kThreads>(k + base, v + base, j * kTile, n, slot, slot + kTile * D);
    }
    cp_async_commit();
  }
  // Q and dO rows, lse * log2(e) and -D; rows past n read as zeros (their dS
  // is 0 and their dQ is never stored)
  uint32_t qa[M][KD][4], da[M][KD][4];
  float lb[M][2], nd[M][2], acc[M][D / 8][4];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int r0 = row0 + m * 16 + g, r1 = r0 + 8;
    const bool ok0 = r0 < n, ok1 = r1 < n;
    const size_t off0 = static_cast<size_t>(ok0 ? r0 : 0) * D;
    const size_t off1 = static_cast<size_t>(ok1 ? r1 : 0) * D;
    load_a_rows<D>(qa[m], q + base + off0, q + base + off1, ok0, ok1, t);
    load_a_rows<D>(da[m], dout + base + off0, dout + base + off1, ok0, ok1, t);
    lb[m][0] = ok0 ? lse[rbase + r0] * kLog2e : 0.f;
    lb[m][1] = ok1 ? lse[rbase + r1] * kLog2e : 0.f;
    nd[m][0] = ok0 ? -delta[rbase + r0] : 0.f;
    nd[m][1] = ok1 ? -delta[rbase + r1] : 0.f;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.f;
  }

  for (int j = 0; j < tiles; ++j) {
    cp_async_wait<kAhead - 1>();  // this thread's copies of tile j have landed
    __syncthreads();              // everyone's have, and tile j - 1 is no longer read
    if (j + kAhead < tiles) {
      __nv_bfloat16* slot = slot_tile<D>(ring, (j + kAhead) % kStages);
      load_kv_async<D, kThreads>(k + base, v + base, (j + kAhead) * kTile, n, slot,
                                 slot + kTile * D);
    }
    cp_async_commit();
    const __nv_bfloat16* kt = slot_tile<D>(ring, j % kStages);
    if (ragged && j == tiles - 1) {
      dq_tile<D, M, true>(qa, da, lb, nd, kt, kt + kTile * D, j * kTile, n, lane, acc);
    } else {
      dq_tile<D, M, false>(qa, da, lb, nd, kt, kt + kTile * D, j * kTile, n, lane, acc);
    }
  }
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int r0 = row0 + m * 16 + g, r1 = r0 + 8;
    store_rows<D>(dq + base, acc[m], r0, r1, r0 < n, r1 < n, t);
  }
}

// ------------------------------------------------------------ the ring dK/dV kernel (d 8, 16)

// Its block, by head dim: warps, each owning dkv_key_tiles 16-row tiles of
// keys, and the blocks an SM that __launch_bounds__ keeps registers for.
// Chosen in turns on the H100 (PERF.md): two key tiles a warp share
// each B fragment and beat one by 18-20% at (8, 19,200, 8); 4 warps at 3
// blocks an SM fit them unspilled (157 and 158 registers), where 4 blocks
// spill and 4 key tiles a warp (209 registers, 2 blocks) run slower.
template <int D>
__host__ __device__ constexpr int dkv_warps() { return 4; }
template <int D>
__host__ __device__ constexpr int dkv_key_tiles() { return 2; }
template <int D>
__host__ __device__ constexpr int dkv_blocks_per_sm() { return 3; }
template <int D>
__host__ __device__ constexpr int dkv_rows() { return dkv_warps<D>() * 16 * dkv_key_tiles<D>(); }

// One query tile's statistics in shared memory, laid out as the fragments
// read them (c0 = 16 kk + 2t, c1 = c0 + 8; c = 8 nt + 2t):
//  - lb[kk][t] = {lb(c0), lb(c0 + 1), lb(c1), lb(c1 + 1)}, lb = lse log2(e):
//    the exponent's offsets of 16 queries' two score tiles;
//  - nd[nt][t] = {-D(c), -D(c + 1), -D(c), -D(c + 1)}: the C fragment (rows g
//    and g + 8) that starts dP^T of score tile nt at -D.
struct DkvStats {
  float4 lb[kTile / 16][4];
  float4 nd[kTile / 8][4];
};

// This thread's statistic of query tile `tile` of its batch (lse, delta: the
// batch's (n,) rows): threads 0..kTile-1 read lse, kTile..2 kTile-1 read D, of
// the tile's query threadIdx.x % kTile, by a plain load that is used a tile
// later (put_stat); queries past n and other threads give 0.
__device__ __forceinline__ float load_stat(const float* __restrict__ lse,
                                           const float* __restrict__ delta, int tile, int n) {
  const int i = threadIdx.x;
  const int query = tile * kTile + i % kTile;
  if (i >= 2 * kTile || query >= n) return 0.f;
  return i < kTile ? lse[query] : delta[query];
}

// Writes this thread's statistic x (load_stat) into st: lse as lse * log2(e)
// into its lb slot, D as -D into both of its nd slots.
__device__ __forceinline__ void put_stat(float x, DkvStats& st) {
  const int i = threadIdx.x;
  if (i < kTile) {  // query i: chunk i / 16, lane column t = (i % 8) / 2, half (i / 8) % 2
    reinterpret_cast<float*>(st.lb)[((i / 16) * 4 + (i % 8) / 2) * 4 + ((i / 8) % 2) * 2 + i % 2] =
        x * kLog2e;
  } else if (i < 2 * kTile) {  // query c: score tile c / 8, lane column t = (c % 8) / 2
    const int c = i - kTile;
    float* nd = reinterpret_cast<float*>(st.nd) + ((c / 8) * 4 + (c % 8) / 2) * 4 + c % 2;
    nd[0] = -x;
    nd[2] = -x;
  }
}

// One query tile (kTile queries from q0, Q and dO in the swizzled ring tiles
// qt and ot, statistics st) for this warp's M 16-row key tiles, 16 queries at
// a time: S^T = K Q^T and dP^T = V dO^T - D, their B fragments by ldmatrix
// from the row-major tiles (d 8: m16n8k8), dP^T's accumulator started at -D;
// P^T = ex2(S^T log2(e) - lb), dS^T = P^T dP^T, each packed once to bf16 A
// fragments; dV += P^T dO and dK += dS^T Q, their B fragments by
// ldmatrix.trans from the same tiles. Each B fragment serves the M key
// tiles, and each key tile's products follow its P^T and dS^T, so that one
// tile's A fragments are live at a time. With kMask (the ragged last tile)
// queries at or past n get P = 0 by a select, whatever their statistics
// read.
template <int D, int M, bool kMask>
__device__ __forceinline__ void dkv_tile(const uint32_t (&ka)[M][kSteps<D>()][4],
                                         const uint32_t (&va)[M][kSteps<D>()][4],
                                         const __nv_bfloat16* qt, const __nv_bfloat16* ot,
                                         const DkvStats& st, int q0, int n, int lane,
                                         float (&dk)[M][D / 8][4], float (&dv)[M][D / 8][4]) {
  const int r8 = lane & 7, mat = lane >> 3, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {  // queries q0 + 16 kk ..: score tiles 2 kk, 2 kk + 1
    // B fragments of S^T and dP^T (b) and of dK and dV (bt). d 8: Q rows +0,
    // +8 and dO rows +0, +8, plain and transposed. d 16: plain, rows +0 chunk
    // 0, rows +0 chunk 1, rows +8 chunk 0, rows +8 chunk 1 of Q (b[0..3]),
    // then of dO (b[4..7]); transposed, rows +0 chunk 0, rows +8 chunk 0,
    // rows +0 chunk 1, rows +8 chunk 1 of Q (bt[0..3]), then of dO (bt[4..7])
    uint32_t b[D == 8 ? 4 : 8], bt[D == 8 ? 4 : 8];
    if constexpr (D == 8) {
      const int off = swz<D>(kk * 16 + (mat & 1) * 8 + r8, 0);
      ldmatrix_x4(b, (mat < 2 ? qt : ot) + off);
      ldmatrix_x4_trans(bt, (mat < 2 ? qt : ot) + off);
    } else {
      const int off = swz<D>(kk * 16 + (mat >> 1) * 8 + r8, mat & 1);
      const int off_t = swz<D>(kk * 16 + (mat & 1) * 8 + r8, mat >> 1);
      ldmatrix_x4(b, qt + off);
      ldmatrix_x4(b + 4, ot + off);
      ldmatrix_x4_trans(bt, qt + off_t);
      ldmatrix_x4_trans(bt + 4, ot + off_t);
    }
    const float4 lb = st.lb[kk][t];
    const float4 nd[2] = {st.nd[2 * kk][t], st.nd[2 * kk + 1][t]};
#pragma unroll
    for (int m = 0; m < M; ++m) {
      float s[2][4], dp[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
        dp[i][0] = nd[i].x;
        dp[i][1] = nd[i].y;
        dp[i][2] = nd[i].z;
        dp[i][3] = nd[i].w;
      }
      if constexpr (D == 8) {
        const uint32_t k8[2] = {ka[m][0][0], ka[m][0][1]}, v8[2] = {va[m][0][0], va[m][0][1]};
        mma_1688(s[0], k8, b[0]);
        mma_1688(s[1], k8, b[1]);
        mma_1688(dp[0], v8, b[2]);
        mma_1688(dp[1], v8, b[3]);
      } else {
        const uint32_t q0b[2] = {b[0], b[1]}, q1b[2] = {b[2], b[3]};
        const uint32_t o0b[2] = {b[4], b[5]}, o1b[2] = {b[6], b[7]};
        mma_16816(s[0], ka[m][0], q0b);
        mma_16816(s[1], ka[m][0], q1b);
        mma_16816(dp[0], va[m][0], o0b);
        mma_16816(dp[1], va[m][0], o1b);
      }
      uint32_t pa[4], dsa[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // score tile 2 kk + i: its lb pair is lb.{x,y} or lb.{z,w}
        const float l0 = i == 0 ? lb.x : lb.z, l1 = i == 0 ? lb.y : lb.w;
        float p0 = ex2(fmaf(s[i][0], kLog2e, -l0)), p1 = ex2(fmaf(s[i][1], kLog2e, -l1));
        float p2 = ex2(fmaf(s[i][2], kLog2e, -l0)), p3 = ex2(fmaf(s[i][3], kLog2e, -l1));
        if constexpr (kMask) {
          const int c = q0 + kk * 16 + i * 8 + 2 * t;
          if (c >= n) p0 = p2 = 0.f;
          if (c + 1 >= n) p1 = p3 = 0.f;
        }
        pa[2 * i] = pack_bf16x2(p0, p1);  // row g
        pa[2 * i + 1] = pack_bf16x2(p2, p3);  // row g + 8
        dsa[2 * i] = pack_bf16x2(p0 * dp[i][0], p1 * dp[i][1]);
        dsa[2 * i + 1] = pack_bf16x2(p2 * dp[i][2], p3 * dp[i][3]);
      }
      // dK += dS^T Q and dV += P^T dO for this key tile at once, so that its
      // P^T and dS^T live only until here
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const uint32_t bk[2] = {bt[2 * j], bt[2 * j + 1]};
        const uint32_t bv[2] = {bt[(D == 8 ? 2 : 4) + 2 * j], bt[(D == 8 ? 2 : 4) + 2 * j + 1]};
        mma_16816(dk[m][j], dsa, bk);
        mma_16816(dv[m][j], pa, bv);
      }
    }
  }
}

// dkv_warps warps of dkv_key_tiles 16-row key tiles each; all threads stage
// the query tiles of Q and dO by 16-byte cp.async into the forward's
// swizzled ring (kStages slots, kAhead tiles ahead), threads 0..2 kTile-1
// each one statistic a tile, a tile ahead in a register (two slots).
template <int D>
__global__ void __launch_bounds__(dkv_warps<D>() * 32, dkv_blocks_per_sm<D>())
flash_bwd_dkv_ring(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int n) {
  static_assert(D == 8 || D == 16, "the ring dK/dV kernel takes head dims 8 and 16");
  constexpr int kThreads = dkv_warps<D>() * 32, M = dkv_key_tiles<D>(), KD = kSteps<D>();
  static_assert(kThreads >= 2 * kTile, "a thread for each statistic of a tile");
  extern __shared__ uint8_t smem_raw[];
  __nv_bfloat16* ring = ring_base(smem_raw);
  __shared__ DkvStats stats[2];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t base = static_cast<size_t>(blockIdx.y) * n * D;
  const float* lse_b = lse + static_cast<size_t>(blockIdx.y) * n;
  const float* delta_b = delta + static_cast<size_t>(blockIdx.y) * n;
  const int key0 = blockIdx.x * dkv_rows<D>() + warp * 16 * M;  // this warp's first key row
  const int tiles = (n + kTile - 1) / kTile;
  const bool ragged = n % kTile != 0;

#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    if (j < tiles) {
      __nv_bfloat16* slot = slot_tile<D>(ring, j);
      load_kv_async<D, kThreads>(q + base, dout + base, j * kTile, n, slot, slot + kTile * D);
    }
    cp_async_commit();
  }
  put_stat(load_stat(lse_b, delta_b, 0, n), stats[0]);
  float next = tiles > 1 ? load_stat(lse_b, delta_b, 1, n) : 0.f;  // tile 1's statistic
  // K and V rows; rows past n read as zeros (their dK and dV are never stored)
  uint32_t ka[M][KD][4], va[M][KD][4];
  float dk_acc[M][D / 8][4], dv_acc[M][D / 8][4];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int r0 = key0 + m * 16 + g, r1 = r0 + 8;
    const size_t off0 = static_cast<size_t>(r0 < n ? r0 : 0) * D;
    const size_t off1 = static_cast<size_t>(r1 < n ? r1 : 0) * D;
    load_a_rows<D>(ka[m], k + base + off0, k + base + off1, r0 < n, r1 < n, t);
    load_a_rows<D>(va[m], v + base + off0, v + base + off1, r0 < n, r1 < n, t);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) dk_acc[m][j][i] = dv_acc[m][j][i] = 0.f;
    }
  }

  for (int j = 0; j < tiles; ++j) {
    cp_async_wait<kAhead - 1>();  // this thread's copies of tile j have landed
    __syncthreads();  // everyone's have, tile j's statistics are written, and tile j - 1 is read
    if (j + kAhead < tiles) {
      __nv_bfloat16* slot = slot_tile<D>(ring, (j + kAhead) % kStages);
      load_kv_async<D, kThreads>(q + base, dout + base, (j + kAhead) * kTile, n, slot,
                                 slot + kTile * D);
    }
    cp_async_commit();
    if (j + 1 < tiles) {  // into the slot tile j - 1 used
      put_stat(next, stats[(j + 1) & 1]);
      if (j + 2 < tiles) next = load_stat(lse_b, delta_b, j + 2, n);
    }
    const __nv_bfloat16* qt = slot_tile<D>(ring, j % kStages);
    if (ragged && j == tiles - 1) {
      dkv_tile<D, M, true>(ka, va, qt, qt + kTile * D, stats[j & 1], j * kTile, n, lane, dk_acc,
                           dv_acc);
    } else {
      dkv_tile<D, M, false>(ka, va, qt, qt + kTile * D, stats[j & 1], j * kTile, n, lane, dk_acc,
                            dv_acc);
    }
  }
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int r0 = key0 + m * 16 + g, r1 = r0 + 8;
    store_rows<D>(dk + base, dk_acc[m], r0, r1, r0 < n, r1 < n, t);
    store_rows<D>(dv + base, dv_acc[m], r0, r1, r0 < n, r1 < n, t);
  }
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
int launch_dq_ring(const Args& a) {
  static int set_for_device = -1;
  const int rc = allow_smem(flash_bwd_dq_ring<D>, ring_bytes<D>(), set_for_device);
  if (rc != 0) return rc;
  const dim3 grid((a.n + dq_rows<D>() - 1) / dq_rows<D>(), a.batch);
  flash_bwd_dq_ring<D><<<grid, dq_warps<D>() * 32, ring_bytes<D>(), a.stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dq, a.n);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv_ring(const Args& a) {
  static int set_for_device = -1;
  const int rc = allow_smem(flash_bwd_dkv_ring<D>, ring_bytes<D>(), set_for_device);
  if (rc != 0) return rc;
  const dim3 grid((a.n + dkv_rows<D>() - 1) / dkv_rows<D>(), a.batch);
  flash_bwd_dkv_ring<D><<<grid, dkv_warps<D>() * 32, ring_bytes<D>(), a.stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dk, a.dv, a.n);
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
    case 8: return launch_dq_ring<8>(a);
    case 16: return launch_dq_ring<16>(a);
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
    case 8: return launch_dkv_ring<8>(a);
    case 16: return launch_dkv_ring<16>(a);
    case 32: return launch_dkv_wgmma<32>(a);
    case 64: return launch_dkv_wgmma<64>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

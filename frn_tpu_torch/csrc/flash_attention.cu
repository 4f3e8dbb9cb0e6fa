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
// Scores, the running row max m and the running denominator l are f32; p is
// rounded to bf16 before the PV product, and l sums those rounded p, as the
// TPU kernel's ones lane of V sums them; the output accumulator is f32 and is
// divided by l once, at the end.
//
// The bf16-exp instances (kModeExpBf16 of the wgmma kernel, kExpBf16 of the
// mma.sync one) replace the same Pallas kernel with exp_bf16=True
// (flash_nonlocal_attention_bf16exp, inference only, no lse): there
// p = bf16(exp(bf16(s - m))), m the running row max over 64-key tiles, and l
// sums those bf16 p, as the TPU kernel's ones lane does. The key and query
// tails of any N are masked here, so no padded copy of Q, K or V is ever made.
//
// The kNoExp instances (d 32 and 64, wgmma kernel only) replace the Pallas
// kernel tools/bench_flash.py::_kernel_noexp (flash_noexp), a measuring
// device: B1's data flow with the exponential taken out. There p = s * 1e-4
// in f32, with no rescale of the accumulator or of l when the running max
// moves; l sums the f32 p, P V takes bf16(p), m is still tracked, and
// O = acc / (l + 1) in bf16 (and, on request, the row's m + l in f32). Keys
// past N contribute nothing (the TPU tool's padded keys add -1e26 to l each,
// so its output depends on its own padding: the two agree where N is a
// multiple of its blocks). Its time beside B1's splits B1's into products and
// exponentials.
//
// What bounds it on an H100: every score costs one exponential and 4d flops of
// the two products. At the DSEC stage-1 shape (N = 19,200, d = 32) the
// special-function units' exponentials (about 3.9e12/s) bound it, at 3.7x the
// tensor cores' time for the products (989 TFLOP/s bf16). At stage 2
// (N = 4,800, d = 64) the products' term (0.0954 ms at B 16) is 1% above the
// exponentials' (0.0945 ms): both units are near their limits. Device memory
// is not the limit: Q, K, V and O cross it once; K and V tiles are re-read by
// every query block, from L2.
//
// Design. A block owns 64 or 128 query rows of one batch and loops over
// 64-key tiles, in place of the TPU's sequential grid axis; the row
// statistics and the output accumulator stay in registers. Two kernels:
//  - flash_fwd_wgmma (d 32 and 64, the path's shapes): one warpgroup of 64
//    rows per block at d 32, two at d 64 (launch_d). Q K^T is wgmma
//    m64n64k16 with Q in registers and the K tile K-major in shared memory;
//    P V is wgmma m64n{d}k16 with P (the Q K^T accumulator re-packed to
//    bf16) in registers and the V tile MN-major (the transpose bit), so V is
//    never transposed and a warpgroup reads each tile from shared memory
//    once. Thread 0 stages K and V by TMA (a 3-D tensor map per launch, box =
//    one tile, swizzled by the hardware into the layout wgmma reads, rows
//    past N zero-filled) into a ring of kStages slots, kAhead tiles ahead,
//    each slot completing on an mbarrier. The PV product of tile j runs on
//    while the block passes the next tile's barrier and issues its Q K^T.
//    The two warpgroups of a d 64 block run in step, one __syncthreads per
//    tile: taking turns to issue (FlashAttention-3's ping-pong, the slots
//    freed by mbarriers) measured slower on the H100 (PERF.md).
//  - flash_fwd_mma (d 8 and 16): 8 warps of 16 rows on mma.sync m16n8k16;
//    all threads stage the same swizzled ring by 16-byte cp.async, K
//    fragments come by ldmatrix.x4 and V fragments by ldmatrix.x4.trans.
// Both compute p = ex2(s * log2(e) - m * log2(e)), one FFMA and one ex2 per
// score: log2(e) multiplies the f32 scores, never Q in bf16. The key-tail mask
// is a separate code path, taken on the last, ragged tile only; the rescale of
// the accumulator is skipped when no row max of the warp moved (exact). The
// bf16-exp instances round s - m and p in pairs (cvt.rn.bf16x2.f32) and use
// the packed p as the PV A fragment. The denominator sums the bf16 p, as the
// TPU kernel does: in the wgmma kernel B1 and B1-lse multiply P by a ones tile
// (wgmma m64n8k16, B an all-ones shared-memory matrix) in the same commit
// group as P V, so the sums ride the tensor core (adding the two halves of
// each packed p in f32 instead, or a ones mma.sync, cost 5-6% there;
// PERF.md); B3, and B1 in the mma.sync kernel, sum the packed p against a
// ones mma.sync fragment. Either way each tile's sums start from zero and are
// added to l in f32 registers: the tensor core truncates what it adds, and l
// carried through its accumulator came out 4e-5 low (relative) at N 19,200.
// At bf16 p is rounded against the running
// max of the tiles seen so far, so the result depends on the 64-key tile, as
// B3's and B4's do (ops/flash_attention.py KERNEL_TILE). The rows of a ragged
// last query block (whole idle warps included) take part in every barrier and
// product and store neither O nor lse.

#include <math.h>

#include "flash_sm90.cuh"

namespace {

using namespace flash;

// the wgmma forward's modes: B1 (exp, p rounded to bf16 after it), B3 (the
// bf16-exp forward) and the exponential-free measuring kernel
constexpr int kModeExp = 0, kModeExpBf16 = 1, kModeNoExp = 2;
constexpr float kNoExpScale = 1e-4f;

// the K/V ring (flash_sm90.cuh): slot s holds a K tile and then a V tile
template <int D, int kThreads>
__device__ __forceinline__ void load_tile(const __nv_bfloat16* k, const __nv_bfloat16* v, int tile,
                                          int n, __nv_bfloat16* ring) {
  __nv_bfloat16* kt = slot_tile<D>(ring, tile % kStages);
  load_kv_async<D, kThreads>(k, v, tile * kTile, n, kt, kt + kTile * D);
}

// One 64-key tile of the online softmax for this thread's rows g and g + 8:
// s holds its warp's 16 x 64 scores as C fragments (s[nt][0..1] row g,
// s[nt][2..3] row g + 8, keys key + nt * 8 + {0, 1}, key = tile start + 2t).
// Updates m and l, returns the rescale factors of the accumulator's two rows
// in alpha and p (bf16) as the A fragments of the PV product in pa. With kSum
// the tensor core sums the tile's bf16 p against a ones B fragment, as the TPU
// kernel's ones lane sums them, and l (the whole row's sum) = l alpha + that;
// without it l is left to the caller (the wgmma kernel's B1 sums p on the
// tensor core beside P V).
template <bool kExpBf16, bool kMask, bool kSum>
__device__ __forceinline__ void softmax_tile(float (&s)[kTile / 8][4], int key, int n,
                                             float (&m)[2], float (&l)[2], float (&alpha)[2],
                                             uint32_t (&pa)[kTile / 16][4]) {
  if constexpr (kMask) {
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      if (key + nt * 8 >= n) s[nt][0] = s[nt][2] = -INFINITY;
      if (key + nt * 8 + 1 >= n) s[nt][1] = s[nt][3] = -INFINITY;
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt) {
    mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
  }
  float mb[2];  // m * log2(e)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = quad_max(mx[i]);  // every tile holds a valid key, so mx is finite
    alpha[i] = ex2((m[i] - mx[i]) * kLog2e);  // 0 on the first tile (m = -inf)
    m[i] = mx[i];
    mb[i] = mx[i] * kLog2e;
  }
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // h = 0: row g, h = 1: row g + 8
      uint32_t p;
      if constexpr (kExpBf16) {
        const uint32_t x = pack_bf16x2(s[nt][2 * h] - mx[h], s[nt][2 * h + 1] - mx[h]);
        p = pack_bf16x2(ex2(bf16_lo(x) * kLog2e), ex2(bf16_hi(x) * kLog2e));
      } else {
        const float p0 = ex2(fmaf(s[nt][2 * h], kLog2e, -mb[h]));
        const float p1 = ex2(fmaf(s[nt][2 * h + 1], kLog2e, -mb[h]));
        p = pack_bf16x2(p0, p1);
      }
      pa[nt / 2][(nt % 2) * 2 + h] = p;
    }
  }
  if constexpr (kSum) {  // c0 (row g) and c2 (row g + 8): the tile's sums
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    const uint32_t ones[2] = {0x3f803f80u, 0x3f803f80u};  // bf16 1.0 pairs
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) mma_16816(c, pa[kk], ones);
    l[0] = fmaf(l[0], alpha[0], c[0]);
    l[1] = fmaf(l[1], alpha[1], c[2]);
  }
}

template <bool kExpBf16, bool kSum>
__device__ __forceinline__ void softmax_any(bool last_ragged, float (&s)[kTile / 8][4], int key,
                                            int n, float (&m)[2], float (&l)[2], float (&alpha)[2],
                                            uint32_t (&pa)[kTile / 16][4]) {
  if (last_ragged) {
    softmax_tile<kExpBf16, true, kSum>(s, key, n, m, l, alpha, pa);
  } else {
    softmax_tile<kExpBf16, false, kSum>(s, key, n, m, l, alpha, pa);
  }
}

// The kNoExp tile: the running max over valid keys, p = s * 1e-4 (0 past N)
// as the PV product's bf16 A fragments in pa, and this thread's f32 p added
// to its partial row sums l (the quad's partial sums are added at the end).
template <bool kMask>
__device__ __forceinline__ void noexp_tile(float (&s)[kTile / 8][4], int key, int n, float (&m)[2],
                                           float (&l)[2], uint32_t (&pa)[kTile / 16][4]) {
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool valid = !kMask || key + nt * 8 + (i & 1) < n;
      const float x = s[nt][i];
      m[i >> 1] = fmaxf(m[i >> 1], valid ? x : -INFINITY);
      s[nt][i] = valid ? x * kNoExpScale : 0.f;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += s[nt][2 * h] + s[nt][2 * h + 1];
      pa[nt / 2][(nt % 2) * 2 + h] = pack_bf16x2(s[nt][2 * h], s[nt][2 * h + 1]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) m[i] = quad_max(m[i]);
}

// acc rows times alpha; skipped when no row max of the warp moved (alpha = 1,
// exact), as on most tiles once the running max has settled
template <int J>
__device__ __forceinline__ void rescale(float (&acc)[J][4], const float (&alpha)[2]) {
  if (!__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) return;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    acc[j][0] *= alpha[0];
    acc[j][1] *= alpha[0];
    acc[j][2] *= alpha[1];
    acc[j][3] *= alpha[1];
  }
}

// O = acc / l for this thread's rows, and lse = m + log(l) when asked; l the
// whole rows' sums
template <int D>
__device__ __forceinline__ void write_rows(__nv_bfloat16* o, float* lse, const float acc[][4],
                                           const float (&m)[2], const float (&l)[2], int row0,
                                           int n, int t) {
  const float l0 = l[0], l1 = l[1];
  const int row1 = row0 + 8;
  const bool ok0 = row0 < n, ok1 = row1 < n;
  store_rows<D>(o, acc, row0, row1, ok0, ok1, t, 1.f / l0, 1.f / l1);
  if (lse != nullptr && t == 0) {
    if (ok0) lse[row0] = m[0] + logf(l0);
    if (ok1) lse[row1] = m[1] + logf(l1);
  }
}

// ------------------------------------------------------------ mma.sync variant

// S (16 x 64) = Q K^T for this warp's rows, K fragments by ldmatrix.x4
template <int D>
__device__ __forceinline__ void qk_mma(float (&s)[kTile / 8][4], const uint32_t qa[][4],
                                       const __nv_bfloat16* kt, int lane) {
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
  const int r8 = lane & 7, mat = lane >> 3;  // this lane's row address: row r8 of matrix mat
  if constexpr (D == 16) {  // matrices: key tiles nt, nt + 1 x chunks 0, 1
#pragma unroll
    for (int nt = 0; nt < kTile / 8; nt += 2) {
      uint32_t r[4];
      ldmatrix_x4(r, kt + swz<D>((nt + (mat >> 1)) * 8 + r8, mat & 1));
      const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
      mma_16816(s[nt], qa[0], b0);
      mma_16816(s[nt + 1], qa[0], b1);
    }
  } else {  // D == 8, matrices: key tiles nt..nt + 3; the upper k half is 0
#pragma unroll
    for (int nt = 0; nt < kTile / 8; nt += 4) {
      uint32_t r[4];
      ldmatrix_x4(r, kt + swz<D>((nt + mat) * 8 + r8, 0));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t b[2] = {r[i], 0u};
        mma_16816(s[nt + i], qa[0], b);
      }
    }
  }
}

// 8 warps of 16 query rows each; every warp reads the whole K and V tile
template <int D, bool kExpBf16>
__global__ void __launch_bounds__(256, 2)
flash_fwd_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
              float* __restrict__ lse, int n) {
  static_assert(D == 8 || D == 16, "the mma.sync forward takes head dims 8 and 16");
  constexpr int kThreads = 256;
  extern __shared__ uint8_t smem_raw[];
  __nv_bfloat16* ring = ring_base(smem_raw);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t base = static_cast<size_t>(blockIdx.y) * n * D;
  const int row0 = blockIdx.x * 128 + warp * 16 + g;  // rows row0 and row0 + 8
  const int tiles = (n + kTile - 1) / kTile;
  const bool ragged = n % kTile != 0;

#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    if (j < tiles) load_tile<D, kThreads>(k + base, v + base, j, n, ring);
    cp_async_commit();
  }
  uint32_t qa[kSteps<D>()][4];  // rows past n read as zeros
  load_a_rows<D>(qa, q + base + static_cast<size_t>(row0 < n ? row0 : 0) * D,
                 q + base + static_cast<size_t>(row0 + 8 < n ? row0 + 8 : 0) * D, row0 < n,
                 row0 + 8 < n, t);
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int j = 0; j < tiles; ++j) {
    cp_async_wait<kAhead - 1>();  // this thread's copies of tile j have landed
    __syncthreads();              // everyone's have, and tile j - 1 is no longer read
    if (j + kAhead < tiles) load_tile<D, kThreads>(k + base, v + base, j + kAhead, n, ring);
    cp_async_commit();
    const __nv_bfloat16* kt = slot_tile<D>(ring, j % kStages);

    float s[kTile / 8][4];
    qk_mma<D>(s, qa, kt, lane);
    float alpha[2];
    uint32_t pa[kTile / 16][4];
    softmax_any<kExpBf16, true>(ragged && j == tiles - 1, s, j * kTile + 2 * t, n, m, l, alpha,
                                pa);
    rescale(acc, alpha);
    pv_mma<D>(acc, pa, kt + kTile * D, lane);
  }
  float* lse_b = lse == nullptr ? nullptr : lse + static_cast<size_t>(blockIdx.y) * n;
  write_rows<D>(o + base, lse_b, acc, m, l, row0, n, t);
}

// ------------------------------------------------------------ wgmma variant

// kGroups warpgroups of 64 query rows each; both products are wgmma, and
// thread 0 stages K and V by TMA (kmap, vmap: encode_tile_map of K and V).
// kMode: kModeExp (B1, B1-lse), kModeExpBf16 (B3) or kModeNoExp (lse then
// holds the row's m + l)
template <int D, int kMode, int kGroups>
__global__ void __launch_bounds__(kGroups * 128, 4 / kGroups)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
                const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ o,
                float* __restrict__ lse, int n) {
  static_assert(D == 32 || D == 64, "the wgmma forward takes head dims 32 and 64");
  constexpr int KD = D / 16;
  extern __shared__ uint8_t smem_raw[];
  __nv_bfloat16* ring = ring_base(smem_raw);
  __shared__ uint64_t full[kStages];  // ring slot s holds its next tile
  // B of the denominator's product: bf16 ones (only the first 256 bytes are read)
  __shared__ __align__(128) uint32_t ones[64];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t base = static_cast<size_t>(blockIdx.y) * n * D;
  // warp w owns the block's rows 16 w .. 16 w + 15: rows 16 (w % 4).. of warpgroup w / 4
  const int row0 = blockIdx.x * (64 * kGroups) + warp * 16 + g;
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
  if constexpr (kMode == kModeExp) {
    if (threadIdx.x < 64) ones[threadIdx.x] = 0x3f803f80u;  // bf16 1.0 pairs
    fence_proxy_async();  // the first __syncthreads of the loop hands them to wgmma
  }
  const uint64_t ones_desc = interleaved_desc(ones);
  uint32_t qa[KD][4];
  load_a_rows<D>(qa, q + base + static_cast<size_t>(row0 < n ? row0 : 0) * D,
                 q + base + static_cast<size_t>(row0 + 8 < n ? row0 + 8 : 0) * D, row0 < n,
                 row0 + 8 < n, t);
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  // in kModeExp, a tile's row sums of the bf16 p: P times a ones B (n8) on
  // the tensor core beside P V, from zero each tile; columns equal
  float lsum[1][4] = {{0.f, 0.f, 0.f, 0.f}};

  for (int j = 0; j < tiles; ++j) {
    __syncthreads();  // the barriers are set up; every warpgroup has waited for PV of tile j - 2
    if (threadIdx.x == 0 && j + kAhead < tiles) {
      stage_tma<D>(&kmap, &vmap, j + kAhead, ring, full);  // into tile j - 2's slot
    }
    mbar_wait(&full[j % kStages], (j / kStages) & 1);
    const __nv_bfloat16* kt = slot_tile<D>(ring, j % kStages);

    float s[kTile / 8][4];
    const uint64_t kdesc = tile_desc<D>(kt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      wgmma_m64n64k16<0>(s, qa[kk], kdesc + 2 * kk, kk);  // 32 bytes on along d
    }
    wgmma_commit();
    wgmma_wait<0>();  // S of tile j, and PV of tile j - 1
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) fence_reg(s[nt][i]);
    }
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd) {
#pragma unroll
      for (int i = 0; i < 4; ++i) fence_reg(acc[jd][i]);
    }
    if constexpr (kMode == kModeExp) {  // l += tile j - 1's sums (zero at j = 0), then zero them
#pragma unroll
      for (int i = 0; i < 4; ++i) fence_reg(lsum[0][i]);
      l[0] += lsum[0][0];
      l[1] += lsum[0][2];
      lsum[0][0] = lsum[0][1] = lsum[0][2] = lsum[0][3] = 0.f;
    }
    uint32_t pa[kTile / 16][4];
    if constexpr (kMode == kModeNoExp) {
      if (ragged && j == tiles - 1) {
        noexp_tile<true>(s, j * kTile + 2 * t, n, m, l, pa);
      } else {
        noexp_tile<false>(s, j * kTile + 2 * t, n, m, l, pa);
      }
    } else {
      constexpr bool kBf16 = kMode == kModeExpBf16;
      float alpha[2];
      softmax_any<kBf16, kBf16>(ragged && j == tiles - 1, s, j * kTile + 2 * t, n, m, l, alpha,
                                pa);
      rescale(acc, alpha);
      if constexpr (kMode == kModeExp) {
        l[0] *= alpha[0];
        l[1] *= alpha[1];
      }
    }

    const uint64_t vdesc = tile_desc<D>(kt + kTile * D);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      wgmma_m64k16<1>(acc, pa[kk], vdesc + ((16 * 2 * D) >> 4) * kk, 1);  // 16 keys on
      if constexpr (kMode == kModeExp) wgmma_m64n8k16<0>(lsum[0], pa[kk], ones_desc, 1);
    }
    wgmma_commit();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int jd = 0; jd < D / 8; ++jd) {
#pragma unroll
    for (int i = 0; i < 4; ++i) fence_reg(acc[jd][i]);
  }
  if constexpr (kMode == kModeExp) {
#pragma unroll
    for (int i = 0; i < 4; ++i) fence_reg(lsum[0][i]);
    l[0] += lsum[0][0];
    l[1] += lsum[0][2];
  }
  float* lse_b = lse == nullptr ? nullptr : lse + static_cast<size_t>(blockIdx.y) * n;
  if constexpr (kMode == kModeNoExp) {  // O = acc / (l + 1), and m + l on request
    const float l0 = quad_sum(l[0]), l1 = quad_sum(l[1]);
    const int row1 = row0 + 8;
    store_rows<D>(o + base, acc, row0, row1, row0 < n, row1 < n, t, 1.f / (l0 + 1.f),
                  1.f / (l1 + 1.f));
    if (lse_b != nullptr && t == 0) {
      if (row0 < n) lse_b[row0] = m[0] + l0;
      if (row1 < n) lse_b[row1] = m[1] + l1;
    }
  } else {
    write_rows<D>(o + base, lse_b, acc, m, l, row0, n, t);
  }
}

// ------------------------------------------------------------ launch

struct Args {
  const __nv_bfloat16 *q, *k, *v;
  __nv_bfloat16* o;
  float* lse;
  int batch, n;
  cudaStream_t stream;
};

template <int D, bool kExpBf16>
int launch_mma(const Args& a) {
  static int set_for_device = -1;
  const int rc = allow_smem(flash_fwd_mma<D, kExpBf16>, ring_bytes<D>(), set_for_device);
  if (rc != 0) return rc;
  const dim3 grid((a.n + 127) / 128, a.batch);
  flash_fwd_mma<D, kExpBf16>
      <<<grid, 256, ring_bytes<D>(), a.stream>>>(a.q, a.k, a.v, a.o, a.lse, a.n);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int kMode, int kGroups>
int launch_wgmma(const Args& a) {
  static int set_for_device = -1;
  int rc = allow_smem(flash_fwd_wgmma<D, kMode, kGroups>, ring_bytes<D>(), set_for_device);
  CUtensorMap kmap, vmap;
  if (rc == 0) rc = encode_tile_map<D>(&kmap, a.k, a.batch, a.n);
  if (rc == 0) rc = encode_tile_map<D>(&vmap, a.v, a.batch, a.n);
  if (rc != 0) return rc;
  const dim3 grid((a.n + 64 * kGroups - 1) / (64 * kGroups), a.batch);
  flash_fwd_wgmma<D, kMode, kGroups>
      <<<grid, kGroups * 128, ring_bytes<D>(), a.stream>>>(kmap, vmap, a.q, a.o, a.lse, a.n);
  return static_cast<int>(cudaGetLastError());
}

// By measurement on the H100 (PERF.md): at d 32 one warpgroup of 64 rows per
// block (five warpgroups fit on an SM, four in 128-row blocks: registers); at
// d 64 two (the ring's 66 KB of shared memory fits only three 64-row blocks on
// an SM, two 128-row ones four warpgroups). mma.sync at d 8 and 16 (not in
// kModeNoExp, which the wgmma kernel alone has).
template <int kMode>
int launch_d(int d, const Args& a) {
  if (a.batch <= 0 || a.n <= 0 || a.batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (kMode != kModeNoExp) {
    if (d == 8) return launch_mma<8, kMode == kModeExpBf16>(a);
    if (d == 16) return launch_mma<16, kMode == kModeExpBf16>(a);
  }
  switch (d) {
    case 32: return launch_wgmma<32, kMode, 1>(a);
    case 64: return launch_wgmma<64, kMode, 2>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

Args make_args(const void* q, const void* k, const void* v, void* o, void* lse, int batch, int n,
               void* stream) {
  return {static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
          static_cast<float*>(lse), batch, n, static_cast<cudaStream_t>(stream)};
}

}  // namespace

// Plain C entry point, bound with ctypes. Launches on `stream` and returns the
// CUDA error code of the launch (0 on success). Pointers must be 16-byte
// aligned and contiguous (B, N, d); `lse` is a (B, N) f32 output, or null when
// the caller needs no logsumexp (inference). The Python wrapper checks all of
// this.
extern "C" int frn_flash_fwd_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                                  int batch, int n, int d, void* stream) {
  return launch_d<kModeExp>(d, make_args(q, k, v, o, lse, batch, n, stream));
}

// The bf16-exp forward (inference only): the same arguments without lse.
extern "C" int frn_flash_fwd_bf16exp_bf16(const void* q, const void* k, const void* v, void* o,
                                          int batch, int n, int d, void* stream) {
  return launch_d<kModeExpBf16>(d, make_args(q, k, v, o, nullptr, batch, n, stream));
}

// The exponential-free forward (a measuring kernel, d 32 and 64 only): the
// same arguments as frn_flash_fwd_bf16, with `ml` an optional (B, N) f32
// output of each row's m + l.
extern "C" int frn_flash_fwd_noexp_bf16(const void* q, const void* k, const void* v, void* o,
                                        void* ml, int batch, int n, int d, void* stream) {
  return launch_d<kModeNoExp>(d, make_args(q, k, v, o, ml, batch, n, stream));
}

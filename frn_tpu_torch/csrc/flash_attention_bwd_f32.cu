// Flash-attention backward at f32 for the REFusion non-local cross-attention,
// Hopper (sm_90a): the f32 instances of the Pallas TPU kernels
// frn_tpu/ops/flash_attention.py::_bwd_dq_kernel (B2a) and ::_bwd_dkv_kernel
// (B2b), launched by _flash_backward on f32 inputs, as an f32 detector's
// training runs them. Per batch b, with P = exp(Q K^T - lse) (lse the
// forward's per-row logsumexp, natural log) and D = rowsum(dO * O) (a plain
// torch op before the launches, as in the JAX package):
//
//     dS = P * (dO V^T - D),  dQ = dS K         (frn_flash_bwd_dq_f32)
//     dV = P^T dO,            dK = dS^T Q       (frn_flash_bwd_dkv_f32)
//
// with Q = phi, K = theta, V = g and dO all (B, N, d) f32 row-major, d in
// {8, 16, 32, 64}, and lse, D (B, N) f32. At f32 every cast in the TPU
// kernels' bodies (ds.astype(k.dtype), a.astype(do.dtype)) is the identity:
// P and dS stay f32, and every product and sum is an f32 FMA on the CUDA
// cores, never the tensor cores (TF32 or 3xTF32 would compute another
// function). P = 2^(fma(s, log2 e, -(lse log2 e))), the f32 forward's
// formulation: the exponent is one difference, never exp(s) exp(-lse), which
// overflows where lse < -88.
//
// d 32 and 64: two register-blocked tiles in the manner of an SGEMM on CUDA
// cores, the f32 forward's design (flash_attention_f32.cu). A block of 128
// threads owns a run of rows of one batch, staged once into shared memory,
// and walks the other side in tiles through a two-slot ring filled by 16-byte
// cp.async, the next tile in flight while one is computed. Thread (row group
// rg, lane group g), g = lane % 8 and four row groups to a warp, owns the
// block's rows rg + 16 i and the tile's rows g + 8 j of two products, A B^T
// of a staged row and a tile row each: for each 4 columns of d it reads the
// float4s of its rows on both sides and does 4 FMAs on each pair, so a
// float read from shared memory feeds 4 or 8 FMAs. The products'
// result goes to a shared buffer with the block's rows as its rows; the same
// thread, owning those rows and the float4 columns 4 (g + 8 u) of an
// accumulator, adds X B over the tile's rows in order (accumulate). The
// accumulators stay in registers for the whole launch. A row of the buffer
// is written and read only by the 8 lanes of its row group, so warp barriers
// order it; the block meets once a tile, for the ring. Strided tile rows put
// the 8 lanes of a row group on neighbouring staged rows, and every staged
// row is padded by 16 bytes (the buffer's by 32, so that a warp's scalar
// stores spread over the banks too). 3 blocks an SM (12 warps;
// __launch_bounds__ caps the registers, a static assert the shared memory).
//
// - dQ, flash_bwd_dq_f32_tiled: a block owns BQ query rows (dq_tiled_rows:
//   64 at d 32, 48 at d 64), their Q and dO staged, each thread the -lse
//   log2 e and D of its rows in registers; K and V come through the ring in
//   tiles of BK keys (dq_tiled_keys: 64 at d 32, 32 at d 64). A thread holds
//   4 rows x 8 keys of S = Q K^T and dP = dO V^T at d 32 (3 x 4 at d 64),
//   both in one pass over d, puts dS = P * (dP - D) into the buffer and adds
//   dQ += dS K.
// - dK/dV, flash_bwd_dkv_f32_tiled: a block owns BK key rows (tiled_key_rows:
//   64 at d 32, 48 at d 64), their K and V staged; Q and dO, with their lse
//   and D, come through the ring in tiles of BQ queries (tiled_queries: 64 at
//   d 32, 32 at d 64). A thread holds 4 key rows x 8 queries of S^T = K Q^T
//   at d 32 (3 x 4 at d 64): P^T goes to the buffer and dV += P^T dO; then
//   dS^T = P^T * (dP^T - D), its own P^T read back (so that P and dP^T are
//   never live at once: that spilled), into the same buffer (a second one
//   would cost a block an SM at d 32), and dK += dS^T Q.
//
// 48-row blocks at d 64 give stage 2's launches (B 2, N 4,800) 200 blocks
// over the 132 SMs, where 64 gave 150. The limits of the first designs that
// this removes: a row per thread held 3d (dQ) or 4d (dK/dV) floats (two
// threads a row at d 64, 216-251 registers, 8 warps an SM), and every thread
// of a warp read the same tile row, so each float read fed one FMA. What
// holds the tiles near half their bound on an H100 is not settled: not the
// shared memory's bandwidth (lane pairs that split the queries of the dK and
// dV products cut its reads by 14% and the time by 2% at d 32), not the
// block barriers (warp barriers in their place changed nothing at d 32, -3%
// at d 64), not too few registers for larger thread tiles (an 8 x 8 dK/dV
// tile at 2 blocks an SM was 40% slower at d 32). The designs keep the tile
// shapes and unroll factors that were fastest in turns.
//
// d 8 and 16 (the depth-18/34 f32 train CLI):
//
// - dK/dV, flash_bwd_dkv_f32_small: register-blocked key rows, built for
//   small d on the f32 forward's flash_fwd_f32_small map. A block of 128
//   threads owns BK key rows of one batch (dkv_small_rows: 64 at d 8, 32 at
//   d 16); thread (rg, qg), qg = lane % 8, owns key rows rg + 16 i (TM =
//   BK / 16 of them: 4 at d 8, 2 at d 16) and queries qg + 8 j of each
//   64-query tile. Its k and v rows and its dK and dV accumulators (4 TM d
//   floats, 128 at both) stay in registers for the whole launch. Q and dO
//   tiles, 16-byte padded rows (the 8 distinct query rows a warp reads at
//   once fall on distinct banks), and their lse and D come through a
//   two-slot cp.async ring, the next tile in flight, one __syncthreads a
//   tile. Per query, streamed float4 by float4: s = k q (each float4 of q
//   feeds TM * 4 FMAs), P = 2^(fma(s, log2 e, -lse log2 e)), dV += P dO and
//   dP = v dO in one pass over dO (TM * 8 FMAs a float4), dS = P (dP - D),
//   dK += dS q. P, dP and dS never leave the registers: no shared buffer and
//   no warp barrier in the loop. Each lane ends with partial dK and dV over
//   its own queries; the row group's 8 lanes sum them by __shfl_xor_sync
//   (both are linear in the queries) and split the row's float4 stores.
//   168 registers at both head dims, 3 blocks an SM (12 warps). The first
//   design, a key row per thread in 128-row blocks, gave stage 2 (B 2,
//   N 4,800) 76 blocks for 132 SMs, and fed each shared read to 4 FMAs
//   (every lane of a warp read the same query row); stage 2 now has 300
//   blocks, stage 1 (B 2, N 19,200) 600. Per query a thread issues 4 TM d
//   = 128 FFMA and about 25 other instructions (PERF.md has the SASS).
// - dQ, flash_bwd_dq_f32_small: the dK/dV kernel's map, mirrored. What
//   bounds it: 6 B N^2 d flops at 67 TFLOP/s (B 2, N 19,200, d 8: 0.528 ms),
//   all f32 FMAs, so the design feeds the FMA pipes. A block of 128 threads
//   owns BQ query rows of one batch (dq_small_rows: 64 at d 8, 32 at d 16);
//   thread (rg, kg), kg = lane % 8, owns query rows rg + 16 i (TM = BQ / 16:
//   4 at d 8, 2 at d 16) and keys kg + 8 j of each 64-key tile. Its q and dO
//   rows and its dQ accumulator (3 TM d floats, 96 at both) and its TM
//   values of -lse log2 e and D stay in registers for the whole launch: lse
//   and D are per query row, so nothing of them is staged. K and V tiles,
//   16-byte padded rows (the 8 distinct key rows a warp reads at once fall on
//   distinct banks: at d 8 lane kg starts on bank 12 kg mod 32), come
//   through a two-slot cp.async ring, the next tile in flight, one
//   __syncthreads a tile. Per key, float4 by float4: s = q k and dP = dO v in
//   one pass (each float4 of k or v feeds TM * 4 FMAs), P = 2^(fma(s, log2
//   e, -lse log2 e)), dS = P (dP - D), dQ += dS k. Each lane ends with a
//   partial dQ over its own keys; the row group's 8 lanes sum it by
//   __shfl_xor_sync (dQ is linear in the keys) and split the row's float4
//   stores. The first design, a query row per thread in 128-row blocks, fed
//   each 16-byte shared read to 4 FMAs (every lane of a warp read the same
//   key row) in serial dot4 chains, and gave stage 2 (B 2, N 4,800) 76 blocks
//   for 132 SMs; stage 2 now has 300 blocks, stage 1 (B 2, N 19,200) 600.
//   149 registers at d 8, 163 at d 16, 3 blocks an SM (12 warps). Per key a
//   thread issues 3 TM d = 96 FFMA, TM more for the exponent and 14-16
//   other instructions (86-88% FFMA; PERF.md has the SASS and the trials).
//
// The ragged tail: tile rows past N are zero-filled in the ring. In the dQ
// kernels a key past N would give s = 0 and P = exp(-lse), inf where
// lse < -88, so its dS is set to 0 by a select, never a multiply (no inf
// reaches the accumulator, and inf * 0 is NaN; the d 8/16 kernel selects
// only on the last, ragged tile), and a query row past N reads no lse or D
// (zeros); in the dK/dV kernels a query row past N has no lse or
// D of its own (both zero-filled, never read from past N), and its P is set
// to 0 there by a select, so it adds nothing to dK or dV. Rows past N store
// nothing.
//
// What bounds it on an H100: 6d (dQ) and 8d (dK/dV) flops per (query, key)
// pair at the CUDA cores' f32 rate (67 TFLOP/s on the H100 SXM data sheet);
// their bytes (each input read once, each output written once) are far below.

#include <math.h>

#include "flash_sm90.cuh"

namespace {

using namespace flash;

// ------------------------------------------------------------ d 8 and 16

constexpr int kThreadsBwd = 128;  // threads per block
constexpr int kTileBwd = 64;      // keys (dQ) or queries (dK/dV) per shared tile
static_assert(kThreadsBwd == 2 * kTileBwd, "one thread copies each lse and each D of a tile");

__device__ __forceinline__ void axpy4(float a, float4 x, float* y) {
  y[0] = fmaf(a, x.x, y[0]);
  y[1] = fmaf(a, x.y, y[1]);
  y[2] = fmaf(a, x.z, y[2]);
  y[3] = fmaf(a, x.w, y[3]);
}

// starts the copy of rows [r0, r0 + kTileBwd) of one batch's lse and D into
// lt and dt (one 4-byte cp.async a thread); rows past n are zero-filled
__device__ __forceinline__ void load_stats(const float* __restrict__ lse,
                                           const float* __restrict__ delta, int r0, int n,
                                           float* lt, float* dt) {
  const int i = threadIdx.x % kTileBwd;
  const bool valid = r0 + i < n;
  const int off = valid ? r0 + i : 0;
  if (threadIdx.x < kTileBwd)
    cp_async_4(lt + i, lse + off, valid);
  else
    cp_async_4(dt + i, delta + off, valid);
}

// ---- dK/dV, register-blocked key rows

// G: the lanes of a row group, which split a tile's queries (both dK/dV kernels)
constexpr int kQueryGroups = 8;

// key rows a block owns (BK): a thread owns BK / 16 of them (TM), and their
// k, v, dK and dV rows take 4 TM d floats of its registers, 128 at both head
// dims (at d 16, TM 4 would take 256 before any temporaries)
template <int D>
__host__ __device__ constexpr int dkv_small_rows() {
  return D == 8 ? 64 : 32;
}

// blocks an SM (__launch_bounds__ caps the registers at 65,536 / (128 x this),
// 168): on the H100, with the query loop rolled, 4 (128 registers, 400-472
// bytes spilled) took 3.7-4.3x the time of 3 and 2 took 18-42% more (PERF.md)
constexpr int kDkvBlocksPerSM = 3;

template <int D>
struct DkvSmall {
  static constexpr int kBK = dkv_small_rows<D>();
  static constexpr int kG = kQueryGroups;
  static constexpr int kR = kThreadsBwd / kG;     // row groups
  static constexpr int kTM = kBK / kR;            // key rows per thread
  static constexpr int kBQ = kTileBwd;            // queries per tile
  static constexpr int kTN = kBQ / kG;            // a thread's queries of a tile
  static constexpr int kS = D + 4;                // padded row stride, in floats
  static constexpr int kT = kBQ * kS;             // floats of a Q (or a dO) tile
  static constexpr int kSlot = 2 * kT + 2 * kBQ;  // a Q and a dO tile, their lse and D
  static constexpr int kBytes = 4 * 2 * kSlot;    // two slots
  static_assert(kTM * kR == kBK && kTN * kG == kBQ && D % 4 == 0,
                "whole tiles, float4 columns");
  static_assert(kDkvBlocksPerSM * (kBytes + 1024) <= 228 * 1024,
                "the blocks an SM fit in shared memory");
};

// one query tile for this thread's key rows: for each of its queries
// qg + G j in order, S^T = K q (each float4 of q feeds TM * 4 FMAs), P^T =
// 2^(fma(s, log2 e, -lse log2 e)), dV += P^T dO and dP^T = V dO in one pass
// over dO (each float4 feeds TM * 8 FMAs), dS^T = P^T (dP^T - D), dK += dS^T
// q; P, dP and dS never leave the registers. The loop over the queries is
// unrolled whole: on the H100 it took 6% less time than a rolled loop at
// stage 1 and 12% less at stage 2, and taking 2 or 4 queries a step, or
// holding q in registers from the S^T step to the dK step, moved it by no
// more than 0.6% (PERF.md). kMask (the last, ragged tile): P of a query at
// or past `valid` is 0, by a select (it may be inf there)
template <int D, bool kMask>
__device__ __forceinline__ void dkv_small_tile(const float4 (&kr)[DkvSmall<D>::kTM][D / 4],
                                               const float4 (&vr)[DkvSmall<D>::kTM][D / 4],
                                               const float* __restrict__ slot, int valid, int qg,
                                               float (&dk)[DkvSmall<D>::kTM][D],
                                               float (&dv)[DkvSmall<D>::kTM][D]) {
  using T = DkvSmall<D>;
  constexpr int TM = T::kTM, G = T::kG, C = D / 4;
  const float* lt = slot + 2 * T::kT;
  const float* dt = lt + T::kBQ;
#pragma unroll
  for (int j = 0; j < T::kTN; ++j) {
    const int col = qg + G * j;
    const float* qrow = slot + col * T::kS;
    const float* orow = qrow + T::kT;
    float p[TM], dp[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) p[i] = dp[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float4 qf = *reinterpret_cast<const float4*>(qrow + 4 * c);
#pragma unroll
      for (int i = 0; i < TM; ++i) fma4(p[i], kr[i][c], qf);
    }
    const float nlb = -(lt[col] * kLog2e);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float e = ex2(fmaf(p[i], kLog2e, nlb));
      p[i] = kMask && col >= valid ? 0.f : e;
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float4 of = *reinterpret_cast<const float4*>(orow + 4 * c);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        axpy4(p[i], of, dv[i] + 4 * c);
        fma4(dp[i], vr[i][c], of);
      }
    }
    const float dl = dt[col];
#pragma unroll
    for (int i = 0; i < TM; ++i) p[i] *= dp[i] - dl;  // dS^T
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float4 qf = *reinterpret_cast<const float4*>(qrow + 4 * c);
#pragma unroll
      for (int i = 0; i < TM; ++i) axpy4(p[i], qf, dk[i] + 4 * c);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsBwd, kDkvBlocksPerSM)
    flash_bwd_dkv_f32_small(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            float* __restrict__ dk, float* __restrict__ dv, int n) {
  using T = DkvSmall<D>;
  constexpr int TM = T::kTM, G = T::kG, R = T::kR, BQ = T::kBQ, C = D / 4;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);  // two slots
  const size_t base = static_cast<size_t>(blockIdx.y) * n * D;
  const size_t rbase = static_cast<size_t>(blockIdx.y) * n;
  q += base;
  dout += base;
  lse += rbase;
  delta += rbase;
  const int key0 = blockIdx.x * T::kBK;
  const int qg = threadIdx.x % G;  // queries qg + G j of every tile
  const int rg = threadIdx.x / G;  // key rows key0 + rg + R i

  auto stage = [&](int t) {  // query tile t into its slot; rows past n zero-filled
    float* slot = ring + (t % 2) * T::kSlot;
    stage_rows_f32<D, BQ, T::kS, kThreadsBwd>(q, t * BQ, n, slot);
    stage_rows_f32<D, BQ, T::kS, kThreadsBwd>(dout, t * BQ, n, slot + T::kT);
    load_stats(lse, delta, t * BQ, n, slot + 2 * T::kT, slot + 2 * T::kT + BQ);
    cp_async_commit();
  };
  stage(0);

  // the thread's k and v rows stay in registers (rows past n: zeros, never stored)
  float4 kr[TM][C], vr[TM][C];
  float dka[TM][D], dva[TM][D];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = key0 + rg + R * i;
    const bool live = row < n;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const size_t off = base + static_cast<size_t>(live ? row : 0) * D + 4 * c;
      kr[i][c] = live ? *reinterpret_cast<const float4*>(k + off) : make_float4(0.f, 0.f, 0.f, 0.f);
      vr[i][c] = live ? *reinterpret_cast<const float4*>(v + off) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int c = 0; c < D; ++c) dka[i][c] = dva[i][c] = 0.f;
  }
  const int tiles = (n + BQ - 1) / BQ;
  const bool ragged = n % BQ != 0;
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // tile t is in; every thread is done with tile t - 1 and its slot
    if (t + 1 < tiles) stage(t + 1);
    const float* slot = ring + (t % 2) * T::kSlot;
    if (ragged && t == tiles - 1)
      dkv_small_tile<D, true>(kr, vr, slot, n - t * BQ, qg, dka, dva);
    else
      dkv_small_tile<D, false>(kr, vr, slot, BQ, qg, dka, dva);
  }
  // each lane's partial dK and dV over its own queries, summed over the row
  // group's G lanes (both are linear in the queries); the xor butterfly
  // leaves the same sums in all G lanes
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int off = 1; off < G; off *= 2) {
#pragma unroll
      for (int c = 0; c < D; ++c) {
        dka[i][c] += __shfl_xor_sync(0xffffffffu, dka[i][c], off);
        dva[i][c] += __shfl_xor_sync(0xffffffffu, dva[i][c], off);
      }
    }
  }
  // the TM rows' 2 C float4s of dK and dV, split over the G lanes: float4 u of
  // row i (dK's first, then dV's) by lane (i 2 C + u) % G; rows past n store
  // nothing
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = key0 + rg + R * i;
    if (row >= n) continue;
#pragma unroll
    for (int u = 0; u < 2 * C; ++u) {
      if ((i * 2 * C + u) % G != qg) continue;
      const float* a = (u < C ? dka[i] : dva[i]) + 4 * (u % C);
      *reinterpret_cast<float4*>((u < C ? dk : dv) + base + static_cast<size_t>(row) * D +
                                 4 * (u % C)) = make_float4(a[0], a[1], a[2], a[3]);
    }
  }
}

// ---- dQ, register-blocked query rows

// G: the lanes of a row group, which split a tile's keys (both dQ kernels)
constexpr int kKeyGroups = 8;

// query rows a block owns (BQ): a thread owns BQ / 16 of them (TM), and their
// q and dO rows and dQ accumulator take 3 TM d floats of its registers, 96 at
// both head dims (149 and 163 registers in all). On the H100 in turns, 80 rows
// at d 8 (TM 5, 168 registers) took 6% less time at stage 1 (B 2, N 19,200:
// 480 blocks) and 15% more at DDD17 (B 4, N 5,655: 284 blocks, under one
// wave); 48 took 7-8% more, 128 (2 blocks an SM) 42% more; 16 at d 16 (TM 1,
// 600 blocks) 37-40% more: each float4 of k then feeds 4 FMAs (PERF.md)
template <int D>
__host__ __device__ constexpr int dq_small_rows() {
  return D == 8 ? 64 : 32;
}

// blocks an SM (__launch_bounds__ caps the registers at 65,536 / (128 x this),
// 168): on the H100, 4 (128 registers, 16 bytes spilled at both head dims)
// took 10-16% more time (PERF.md)
constexpr int kDqSmallBlocksPerSM = 3;

template <int D>
struct DqSmall {
  static constexpr int kBQ = dq_small_rows<D>();
  static constexpr int kG = kKeyGroups;
  static constexpr int kR = kThreadsBwd / kG;   // row groups
  static constexpr int kTM = kBQ / kR;          // query rows per thread
  static constexpr int kBK = kTileBwd;          // keys per tile
  static constexpr int kTN = kBK / kG;          // a thread's keys of a tile
  static constexpr int kS = D + 4;              // padded row stride, in floats
  static constexpr int kT = kBK * kS;           // floats of a K (or a V) tile
  static constexpr int kSlot = 2 * kT;          // a K and a V tile
  static constexpr int kBytes = 4 * 2 * kSlot;  // two slots
  static_assert(kTM * kR == kBQ && kTN * kG == kBK && D % 4 == 0,
                "whole tiles, float4 columns");
  static_assert(kDqSmallBlocksPerSM * (kBytes + 1024) <= 228 * 1024,
                "the blocks an SM fit in shared memory");
};

// one key tile for this thread's query rows: for each of its keys kg + G j in
// order, S = Q k and dP = dO v in one pass over d (each float4 of k or v
// feeds TM * 4 FMAs), P = 2^(fma(s, log2 e, -lse log2 e)), dS = P (dP - D),
// dQ += dS k; P, dP and dS never leave the registers. The loop over the keys
// is unrolled whole: on the H100 a rolled loop took 26% more time a
// micro-step, 2 keys a step 3% more, 128-key tiles 2% more; k held from the
// first pass to the last is the code the compiler makes of its second read
// (PERF.md). kMask (the last, ragged tile): dS of a key at or past `valid` is
// 0, by a select (P may be inf there, and inf * 0 is NaN)
template <int D, bool kMask>
__device__ __forceinline__ void dq_small_tile(const float4 (&qr)[DqSmall<D>::kTM][D / 4],
                                              const float4 (&dor)[DqSmall<D>::kTM][D / 4],
                                              const float (&nlb)[DqSmall<D>::kTM],
                                              const float (&dl)[DqSmall<D>::kTM],
                                              const float* __restrict__ slot, int valid, int kg,
                                              float (&dq)[DqSmall<D>::kTM][D]) {
  using T = DqSmall<D>;
  constexpr int TM = T::kTM, G = T::kG, C = D / 4;
#pragma unroll
  for (int j = 0; j < T::kTN; ++j) {
    const int col = kg + G * j;
    const float* krow = slot + col * T::kS;
    const float* vrow = krow + T::kT;
    float s[TM], dp[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float4 kf = *reinterpret_cast<const float4*>(krow + 4 * c);
      const float4 vf = *reinterpret_cast<const float4*>(vrow + 4 * c);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        fma4(s[i], qr[i][c], kf);
        fma4(dp[i], dor[i][c], vf);
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float ds = ex2(fmaf(s[i], kLog2e, nlb[i])) * (dp[i] - dl[i]);
      s[i] = kMask && col >= valid ? 0.f : ds;
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float4 kf = *reinterpret_cast<const float4*>(krow + 4 * c);
#pragma unroll
      for (int i = 0; i < TM; ++i) axpy4(s[i], kf, dq[i] + 4 * c);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsBwd, kDqSmallBlocksPerSM)
    flash_bwd_dq_f32_small(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           float* __restrict__ dq, int n) {
  using T = DqSmall<D>;
  constexpr int TM = T::kTM, G = T::kG, R = T::kR, BK = T::kBK, C = D / 4;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);  // two slots
  const size_t base = static_cast<size_t>(blockIdx.y) * n * D;
  const size_t rbase = static_cast<size_t>(blockIdx.y) * n;
  k += base;
  v += base;
  const int row0 = blockIdx.x * T::kBQ;
  const int kg = threadIdx.x % G;  // keys kg + G j of every tile
  const int rg = threadIdx.x / G;  // query rows row0 + rg + R i

  auto stage = [&](int t) {  // key tile t into its slot; rows past n zero-filled
    float* slot = ring + (t % 2) * T::kSlot;
    stage_rows_f32<D, BK, T::kS, kThreadsBwd>(k, t * BK, n, slot);
    stage_rows_f32<D, BK, T::kS, kThreadsBwd>(v, t * BK, n, slot + T::kT);
    cp_async_commit();
  };
  stage(0);

  // the thread's q and dO rows, -lse log2 e and D stay in registers (rows
  // past n: zeros, no lse or D read, never stored)
  float4 qr[TM][C], dor[TM][C];
  float nlb[TM], dl[TM], acc[TM][D];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + rg + R * i;
    const bool live = row < n;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const size_t off = base + static_cast<size_t>(live ? row : 0) * D + 4 * c;
      qr[i][c] = live ? *reinterpret_cast<const float4*>(q + off) : make_float4(0.f, 0.f, 0.f, 0.f);
      dor[i][c] =
          live ? *reinterpret_cast<const float4*>(dout + off) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    nlb[i] = live ? -(lse[rbase + row] * kLog2e) : 0.f;
    dl[i] = live ? delta[rbase + row] : 0.f;
#pragma unroll
    for (int c = 0; c < D; ++c) acc[i][c] = 0.f;
  }
  const int tiles = (n + BK - 1) / BK;
  const bool ragged = n % BK != 0;
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // tile t is in; every thread is done with tile t - 1 and its slot
    if (t + 1 < tiles) stage(t + 1);
    const float* slot = ring + (t % 2) * T::kSlot;
    if (ragged && t == tiles - 1)
      dq_small_tile<D, true>(qr, dor, nlb, dl, slot, n - t * BK, kg, acc);
    else
      dq_small_tile<D, false>(qr, dor, nlb, dl, slot, BK, kg, acc);
  }
  // each lane's partial dQ over its own keys, summed over the row group's G
  // lanes (dQ is linear in the keys); the xor butterfly leaves the same sums
  // in all G lanes
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int off = 1; off < G; off *= 2) {
#pragma unroll
      for (int c = 0; c < D; ++c) acc[i][c] += __shfl_xor_sync(0xffffffffu, acc[i][c], off);
    }
  }
  // the TM rows' C float4s, split over the G lanes: float4 u of row i by lane
  // (i C + u) % G; rows past n store nothing
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + rg + R * i;
    if (row >= n) continue;
#pragma unroll
    for (int u = 0; u < C; ++u) {
      if ((i * C + u) % G != kg) continue;
      const float* a = acc[i] + 4 * u;
      *reinterpret_cast<float4*>(dq + base + static_cast<size_t>(row) * D + 4 * u) =
          make_float4(a[0], a[1], a[2], a[3]);
    }
  }
}

// ------------------------------------------------------------ d 32 and 64: the tiles

constexpr int kTiledThreads = 128;

// Each tile's shapes, as T in the shared helpers below: kD, the lane groups
// kG and the row groups kR, a thread's rows of the block kTM, the rows of a
// ring tile and a thread's of them (kTile, kTN), a thread's accumulator
// columns kCW, the padded strides of the staged rows kS and of the buffer
// kPS, and the unroll factor of the loop over a tile's rows kTileUnroll.

// ---- dK and dV (B2b)

// key rows a block owns (BK): at d 64, 48 (3 a thread) gives stage 2's
// launch (B 2, N 4,800) 200 blocks over the 132 SMs, where 64 gave 150
template <int D>
__host__ __device__ constexpr int tiled_key_rows() {
  return D == 32 ? 64 : 48;
}

// query rows per tile (BQ): at d 32 a thread takes 8 queries of a 64-query
// tile; at d 64, whose accumulators are twice as wide, 4 of a 32-query tile
template <int D>
__host__ __device__ constexpr int tiled_queries() {
  return D == 32 ? 64 : 32;
}

constexpr int kTiledBlocksPerSM = 3;

// unroll factors of the loops over d (products) and over the tile's queries
// (accumulators): whole loops were 5% slower at d 32 and 10% at d 64
constexpr int kTiledDUnroll = 4;

template <int D>
__host__ __device__ constexpr int tiled_query_unroll() {
  return D == 32 ? 8 : 2;
}

template <int D>
struct DkvTiled {
  static constexpr int kD = D;
  static constexpr int kG = kQueryGroups;
  static constexpr int kBK = tiled_key_rows<D>();
  static constexpr int kBQ = tiled_queries<D>();
  static constexpr int kTile = kBQ;
  static constexpr int kR = kTiledThreads / kG;            // row groups
  static constexpr int kTM = kBK / kR;                     // key rows per thread
  static constexpr int kTN = kBQ / kG;                     // query columns per thread
  static constexpr int kCW = D / kG;                       // accumulator columns per thread
  static constexpr int kS = D + 4;                         // padded row strides, in floats
  static constexpr int kPS = kBQ + 8;                      // P^T's: 32 bytes, so its stores spread too
  static constexpr int kTileUnroll = tiled_query_unroll<D>();
  static constexpr int kKV = kBK * kS;                     // floats of the staged K (and V)
  static constexpr int kT = kBQ * kS;                      // of a Q (and a dO) tile
  static constexpr int kSlot = 2 * kT + 2 * kBQ;           // a Q and a dO tile, their lse and D
  static constexpr int kP = kBK * kPS;                     // P^T, then dS^T
  static constexpr int kBytes = 4 * (2 * kKV + 2 * kSlot + kP);
  static_assert(kTM * kR == kBK && kTN * kG == kBQ && kCW % 4 == 0,
                "whole tiles, float4 columns");
  static_assert(2 * kBQ <= kTiledThreads, "one thread copies each lse and each D of a tile");
  static_assert(kTiledBlocksPerSM * (kBytes + 1024) <= 228 * 1024,
                "the blocks an SM fit in shared memory");
};

// ---- dQ (B2a)

// query rows a block owns (BQ): at d 64, 48 (3 a thread) gives stage 2's
// launch (B 2, N 4,800) 200 blocks over the 132 SMs, where 64 gave 150
template <int D>
__host__ __device__ constexpr int dq_tiled_rows() {
  return D == 32 ? 64 : 48;
}

// keys per tile (BK): at d 32 a thread takes 8 keys of a 64-key tile; at d
// 64, whose accumulator is twice as wide, 4 of a 32-key tile
template <int D>
__host__ __device__ constexpr int dq_tiled_keys() {
  return D == 32 ? 64 : 32;
}

constexpr int kDqBlocksPerSM = 3;

// unroll factors of the loops over d (products) and over the tile's keys
// (the accumulator)
constexpr int kDqDUnroll = 4;

template <int D>
__host__ __device__ constexpr int dq_key_unroll() {
  return D == 32 ? 8 : 2;
}

template <int D>
struct DqTiled {
  static constexpr int kD = D;
  static constexpr int kG = kKeyGroups;
  static constexpr int kBQ = dq_tiled_rows<D>();
  static constexpr int kBK = dq_tiled_keys<D>();
  static constexpr int kTile = kBK;
  static constexpr int kR = kTiledThreads / kG;  // row groups
  static constexpr int kTM = kBQ / kR;           // query rows per thread
  static constexpr int kTN = kBK / kG;           // key columns per thread
  static constexpr int kCW = D / kG;             // accumulator columns per thread
  static constexpr int kS = D + 4;               // padded row strides, in floats
  static constexpr int kPS = kBK + 8;            // dS's: 32 bytes, so its stores spread too
  static constexpr int kTileUnroll = dq_key_unroll<D>();
  static constexpr int kQ = kBQ * kS;            // floats of the staged Q (and dO)
  static constexpr int kT = kBK * kS;            // of a K (and a V) tile
  static constexpr int kSlot = 2 * kT;           // a K and a V tile
  static constexpr int kP = kBQ * kPS;           // dS
  static constexpr int kBytes = 4 * (2 * kQ + 2 * kSlot + kP);
  static_assert(kTM * kR == kBQ && kTN * kG == kBK && kCW % 4 == 0,
                "whole tiles, float4 columns");
  static_assert(kDqBlocksPerSM * (kBytes + 1024) <= 228 * 1024,
                "the blocks an SM fit in shared memory");
};

// ---- shared by both tiles

// acc += X B over the tile's rows in order (X in the shared buffer ps, rows
// of stride kPS; B the tile's rows, of stride kS), for this thread's rows and its
// columns 4 (g + G u) .. + 3
template <class T>
__device__ __forceinline__ void accumulate(const float* __restrict__ ps,
                                           const float* __restrict__ b, int rg, int g,
                                           float (&acc)[T::kTM][T::kCW]) {
  constexpr int TM = T::kTM, CW = T::kCW, G = T::kG, R = T::kR;
  // per 4 tile rows: their B columns held, each row's float4 of X read in turn
#pragma unroll (T::kTileUnroll)
  for (int kk = 0; kk < T::kTile; kk += 4) {
    float4 bb[4][CW / 4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int cu = 0; cu < CW / 4; ++cu)
        bb[u][cu] = *reinterpret_cast<const float4*>(b + (kk + u) * T::kS + 4 * (g + G * cu));
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float4 xf = *reinterpret_cast<const float4*>(ps + (rg + R * i) * T::kPS + kk);
#pragma unroll
      for (int cu = 0; cu < CW / 4; ++cu) {  // tile rows in order
        float* a = acc[i] + 4 * cu;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float x = u == 0 ? xf.x : u == 1 ? xf.y : u == 2 ? xf.z : xf.w;
          a[0] = fmaf(x, bb[u][cu].x, a[0]);
          a[1] = fmaf(x, bb[u][cu].y, a[1]);
          a[2] = fmaf(x, bb[u][cu].z, a[2]);
          a[3] = fmaf(x, bb[u][cu].w, a[3]);
        }
      }
    }
  }
}

// this thread's part of the accumulator into rows row0 + rg + R i of a
// (n, D) output; rows past n store nothing
template <class T>
__device__ __forceinline__ void store_acc(float* __restrict__ out, int row0, int n, int rg, int g,
                                          const float (&acc)[T::kTM][T::kCW]) {
#pragma unroll
  for (int i = 0; i < T::kTM; ++i) {
    const int row = row0 + rg + T::kR * i;
    if (row >= n) continue;
#pragma unroll
    for (int cu = 0; cu < T::kCW / 4; ++cu) {
      const float* a = acc[i] + 4 * cu;
      *reinterpret_cast<float4*>(out + static_cast<size_t>(row) * T::kD + 4 * (g + T::kG * cu)) =
          make_float4(a[0], a[1], a[2], a[3]);
    }
  }
}

// ---- the dQ tile

// dS = P * (dP - D) of this thread's part of the tile into the shared
// [BQ][kPS] buffer ds: S = Q K^T and dP = dO V^T in one pass over d (for
// each 4 columns, the float4s of its q and dO rows held, each key's k and v
// float4 read in turn: 3-4% faster at stage 2 than two passes), P =
// 2^(fma(s, log2 e, -lse log2 e)); dS of a key at or past n is 0 (on the
// last, ragged tile; a select, as P may be inf there; one instance for
// every tile keeps the loop's code small)
template <int D>
__device__ __forceinline__ void tile_dq_ds(const float* __restrict__ qs,
                                           const float* __restrict__ dos,
                                           const float* __restrict__ slot, int key0, int n,
                                           int rg, int kg, const float (&nlb)[DqTiled<D>::kTM],
                                           const float (&dl)[DqTiled<D>::kTM],
                                           float* __restrict__ ds) {
  using T = DqTiled<D>;
  constexpr int TM = T::kTM, TN = T::kTN, G = T::kG, R = T::kR;
  float s[TM][TN], dp[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) s[i][j] = dp[i][j] = 0.f;
  }
#pragma unroll (kDqDUnroll)
  for (int c = 0; c < D; c += 4) {
    float4 qf[TM], of[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      qf[i] = *reinterpret_cast<const float4*>(qs + (rg + R * i) * T::kS + c);
      of[i] = *reinterpret_cast<const float4*>(dos + (rg + R * i) * T::kS + c);
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const float* kv = slot + (kg + G * j) * T::kS + c;
      const float4 kf = *reinterpret_cast<const float4*>(kv);
      const float4 vf = *reinterpret_cast<const float4*>(kv + T::kT);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        fma4(s[i][j], qf[i], kf);
        fma4(dp[i][j], of[i], vf);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int col = kg + G * j;
    const bool dead = key0 + col >= n;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float x = ex2(fmaf(s[i][j], kLog2e, nlb[i])) * (dp[i][j] - dl[i]);
      ds[(rg + R * i) * T::kPS + col] = dead ? 0.f : x;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kTiledThreads, kDqBlocksPerSM)
    flash_bwd_dq_f32_tiled(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           float* __restrict__ dq, int n) {
  using T = DqTiled<D>;
  constexpr int TM = T::kTM, CW = T::kCW, G = T::kG, R = T::kR, BK = T::kBK;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* dos = qs + T::kQ;
  float* ring = dos + T::kQ;  // two slots
  float* ds = ring + 2 * T::kSlot;
  const size_t base = static_cast<size_t>(blockIdx.y) * n * D;
  const size_t rbase = static_cast<size_t>(blockIdx.y) * n;
  k += base;
  v += base;
  const int row0 = blockIdx.x * T::kBQ;
  const int kg = threadIdx.x % G;  // key columns kg + G j; accumulator columns 4 (kg + G u) ..
  const int rg = threadIdx.x / G;  // query rows row0 + rg + R i

  stage_rows_f32<D, T::kBQ, T::kS, kTiledThreads>(q + base, row0, n, qs);
  stage_rows_f32<D, T::kBQ, T::kS, kTiledThreads>(dout + base, row0, n, dos);
  stage_rows_f32<D, BK, T::kS, kTiledThreads>(k, 0, n, ring);
  stage_rows_f32<D, BK, T::kS, kTiledThreads>(v, 0, n, ring + T::kT);
  cp_async_commit();

  float nlb[TM], dl[TM], acc[TM][CW];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + rg + R * i;
    const bool live = row < n;  // a row past n reads no lse or D
    nlb[i] = live ? -(lse[rbase + row] * kLog2e) : 0.f;
    dl[i] = live ? delta[rbase + row] : 0.f;
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[i][c] = 0.f;
  }
  const int tiles = (n + BK - 1) / BK;
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // tile t is in; every thread is done with tile t - 1 and its slot
    if (t + 1 < tiles) {
      float* next = ring + ((t + 1) % 2) * T::kSlot;
      stage_rows_f32<D, BK, T::kS, kTiledThreads>(k, (t + 1) * BK, n, next);
      stage_rows_f32<D, BK, T::kS, kTiledThreads>(v, (t + 1) * BK, n, next + T::kT);
      cp_async_commit();
    }
    const float* slot = ring + (t % 2) * T::kSlot;
    // the rows rg + R i of dS are written and read by the 8 lanes of one row
    // group, in one warp: a warp barrier orders them (the next tile's writes
    // come after the block barrier above)
    tile_dq_ds<D>(qs, dos, slot, t * BK, n, rg, kg, nlb, dl, ds);
    __syncwarp();  // dS is in
    accumulate<T>(ds, slot, rg, kg, acc);
  }
  store_acc<T>(dq + base, row0, n, rg, kg, acc);
}

// ---- the dK/dV tile

// Starts the copy of query tile t (Q and dO rows, their lse and D) into its
// slot of the ring (the caller commits); rows past n are zero-filled.
template <int D>
__device__ __forceinline__ void stage_query_tile(const float* __restrict__ q,
                                                 const float* __restrict__ dout,
                                                 const float* __restrict__ lse,
                                                 const float* __restrict__ delta, int t, int n,
                                                 float* slot) {
  using T = DkvTiled<D>;
  const int r0 = t * T::kBQ;
  stage_rows_f32<D, T::kBQ, T::kS, kTiledThreads>(q, r0, n, slot);
  stage_rows_f32<D, T::kBQ, T::kS, kTiledThreads>(dout, r0, n, slot + T::kT);
  if (threadIdx.x < 2 * T::kBQ) {
    const int i = threadIdx.x % T::kBQ;
    const bool valid = r0 + i < n;
    const bool is_lse = threadIdx.x < T::kBQ;
    cp_async_4(slot + 2 * T::kT + threadIdx.x, (is_lse ? lse : delta) + (valid ? r0 + i : 0),
               valid);
  }
}

// out = A B^T for this thread's key rows rg + R i of A (the staged K or V) and
// query rows qg + G j of B (the tile's Q or dO), both of row stride kS
template <int D>
__device__ __forceinline__ void tile_products(const float* __restrict__ a,
                                              const float* __restrict__ b, int rg, int qg,
                                              float (&out)[DkvTiled<D>::kTM][DkvTiled<D>::kTN]) {
  using T = DkvTiled<D>;
  constexpr int TM = T::kTM, TN = T::kTN, G = kQueryGroups, R = T::kR;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) out[i][j] = 0.f;
  }
  // for each 4 columns of d: the float4s of the smaller side held, the
  // other side's read one at a time (fewer registers live)
#pragma unroll (kTiledDUnroll)
  for (int c = 0; c < D; c += 4) {
    if constexpr (TM <= TN) {
      float4 af[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        af[i] = *reinterpret_cast<const float4*>(a + (rg + R * i) * T::kS + c);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float4 bf = *reinterpret_cast<const float4*>(b + (qg + G * j) * T::kS + c);
#pragma unroll
        for (int i = 0; i < TM; ++i) fma4(out[i][j], af[i], bf);
      }
    } else {
      float4 bf[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j)
        bf[j] = *reinterpret_cast<const float4*>(b + (qg + G * j) * T::kS + c);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 af = *reinterpret_cast<const float4*>(a + (rg + R * i) * T::kS + c);
#pragma unroll
        for (int j = 0; j < TN; ++j) fma4(out[i][j], af, bf[j]);
      }
    }
  }
}

// P^T of this thread's part of the tile, into the shared [BK][kPS] buffer ps:
// S^T = K Q^T and P^T = 2^(fma(s, log2 e, -lse log2 e)); P of a query at or
// past n is 0 (on the last, ragged tile; one instance for every tile keeps
// the loop's code small)
template <int D>
__device__ __forceinline__ void tile_p(const float* __restrict__ ks,
                                       const float* __restrict__ slot, int query0, int n, int rg,
                                       int qg, float* __restrict__ ps) {
  using T = DkvTiled<D>;
  constexpr int TM = T::kTM, TN = T::kTN, G = kQueryGroups, R = T::kR;
  const float* lt = slot + 2 * T::kT;
  float s[TM][TN];
  tile_products<D>(ks, slot, rg, qg, s);
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int col = qg + G * j;
    const float nlb = -(lt[col] * kLog2e);
    const bool dead = query0 + col >= n;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float e = ex2(fmaf(s[i][j], kLog2e, nlb));
      ps[(rg + R * i) * T::kPS + col] = dead ? 0.f : e;  // a select: e may be inf past n
    }
  }
}

// dS^T = P^T * (dP^T - D) of this thread's part of the tile (into ds), with
// dP^T = V dO^T and its own P^T read back from ps: P and dP^T are never
// live in registers at once
template <int D>
__device__ __forceinline__ void tile_ds(const float* __restrict__ vs,
                                        const float* __restrict__ slot,
                                        const float* __restrict__ ps, int rg, int qg,
                                        float (&ds)[DkvTiled<D>::kTM][DkvTiled<D>::kTN]) {
  using T = DkvTiled<D>;
  constexpr int TM = T::kTM, TN = T::kTN, G = kQueryGroups, R = T::kR;
  const float* dt = slot + 2 * T::kT + T::kBQ;
  tile_products<D>(vs, slot + T::kT, rg, qg, ds);
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int col = qg + G * j;
    const float dl = dt[col];
#pragma unroll
    for (int i = 0; i < TM; ++i) ds[i][j] = ps[(rg + R * i) * T::kPS + col] * (ds[i][j] - dl);
  }
}

// this thread's part of dS^T into ps
template <int D>
__device__ __forceinline__ void store_pt(float* __restrict__ ps, int rg, int qg,
                                         const float (&x)[DkvTiled<D>::kTM][DkvTiled<D>::kTN]) {
  using T = DkvTiled<D>;
#pragma unroll
  for (int i = 0; i < T::kTM; ++i) {
    float* row = ps + (rg + T::kR * i) * T::kPS + qg;
#pragma unroll
    for (int j = 0; j < T::kTN; ++j) row[kQueryGroups * j] = x[i][j];
  }
}

template <int D>
__global__ void __launch_bounds__(kTiledThreads, kTiledBlocksPerSM)
    flash_bwd_dkv_f32_tiled(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            float* __restrict__ dk, float* __restrict__ dv, int n) {
  using T = DkvTiled<D>;
  constexpr int TM = T::kTM, TN = T::kTN, CW = T::kCW, G = kQueryGroups;
  constexpr int BQ = T::kBQ;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = ks + T::kKV;
  float* ring = vs + T::kKV;  // two slots
  float* ps = ring + 2 * T::kSlot;
  const size_t base = static_cast<size_t>(blockIdx.y) * n * D;
  const size_t rbase = static_cast<size_t>(blockIdx.y) * n;
  q += base;
  dout += base;
  lse += rbase;
  delta += rbase;
  const int key0 = blockIdx.x * T::kBK;
  const int qg = threadIdx.x % G;  // query columns qg + G j; accumulator columns 4 (qg + G u) ..
  const int rg = threadIdx.x / G;  // key rows key0 + rg + R i

  stage_rows_f32<D, T::kBK, T::kS, kTiledThreads>(k + base, key0, n, ks);
  stage_rows_f32<D, T::kBK, T::kS, kTiledThreads>(v + base, key0, n, vs);
  stage_query_tile<D>(q, dout, lse, delta, 0, n, ring);
  cp_async_commit();

  float dka[TM][CW], dva[TM][CW];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int c = 0; c < CW; ++c) dka[i][c] = dva[i][c] = 0.f;
  }
  const int tiles = (n + BQ - 1) / BQ;
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // tile t is in; every thread is done with tile t - 1 and its slot
    if (t + 1 < tiles) {
      stage_query_tile<D>(q, dout, lse, delta, t + 1, n, ring + ((t + 1) % 2) * T::kSlot);
      cp_async_commit();
    }
    const float* slot = ring + (t % 2) * T::kSlot;
    // the rows rg + R i of P^T and dS^T are written and read by the 8 lanes
    // of one row group, in one warp: a warp barrier orders them
    tile_p<D>(ks, slot, t * BQ, n, rg, qg, ps);
    __syncwarp();  // P^T is in
    accumulate<T>(ps, slot + T::kT, rg, qg, dva);
    float ds[TM][TN];
    tile_ds<D>(vs, slot, ps, rg, qg, ds);
    __syncwarp();  // the warp is done with P^T
    store_pt<D>(ps, rg, qg, ds);
    __syncwarp();  // dS^T is in
    accumulate<T>(ps, slot, rg, qg, dka);
  }
  store_acc<T>(dk + base, key0, n, rg, qg, dka);
  store_acc<T>(dv + base, key0, n, rg, qg, dva);
}

// ------------------------------------------------------------ launches

template <int D>
int launch_dq_small(const float* q, const float* k, const float* v, const float* dout,
                    const float* lse, const float* delta, float* dq, int batch, int n,
                    cudaStream_t stream) {
  using T = DqSmall<D>;
  static int set_for_device = -1;
  const int rc = allow_smem(flash_bwd_dq_f32_small<D>, T::kBytes, set_for_device);
  if (rc != 0) return rc;
  const dim3 grid((n + T::kBQ - 1) / T::kBQ, batch);
  flash_bwd_dq_f32_small<D><<<grid, kThreadsBwd, T::kBytes, stream>>>(q, k, v, dout, lse, delta,
                                                                      dq, n);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq_tiled(const float* q, const float* k, const float* v, const float* dout,
                    const float* lse, const float* delta, float* dq, int batch, int n,
                    cudaStream_t stream) {
  using T = DqTiled<D>;
  static int set_for_device = -1;
  const int rc = allow_smem(flash_bwd_dq_f32_tiled<D>, T::kBytes, set_for_device);
  if (rc != 0) return rc;
  const dim3 grid((n + T::kBQ - 1) / T::kBQ, batch);
  flash_bwd_dq_f32_tiled<D><<<grid, kTiledThreads, T::kBytes, stream>>>(q, k, v, dout, lse, delta,
                                                                        dq, n);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv_small(const float* q, const float* k, const float* v, const float* dout,
                     const float* lse, const float* delta, float* dk, float* dv, int batch, int n,
                     cudaStream_t stream) {
  using T = DkvSmall<D>;
  static int set_for_device = -1;
  const int rc = allow_smem(flash_bwd_dkv_f32_small<D>, T::kBytes, set_for_device);
  if (rc != 0) return rc;
  const dim3 grid((n + T::kBK - 1) / T::kBK, batch);
  flash_bwd_dkv_f32_small<D><<<grid, kThreadsBwd, T::kBytes, stream>>>(q, k, v, dout, lse, delta,
                                                                       dk, dv, n);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv_tiled(const float* q, const float* k, const float* v, const float* dout,
                     const float* lse, const float* delta, float* dk, float* dv, int batch, int n,
                     cudaStream_t stream) {
  using T = DkvTiled<D>;
  static int set_for_device = -1;
  const int rc = allow_smem(flash_bwd_dkv_f32_tiled<D>, T::kBytes, set_for_device);
  if (rc != 0) return rc;
  const dim3 grid((n + T::kBK - 1) / T::kBK, batch);
  flash_bwd_dkv_f32_tiled<D><<<grid, kTiledThreads, T::kBytes, stream>>>(q, k, v, dout, lse, delta,
                                                                         dk, dv, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound with ctypes. Each launches on `stream` and
// returns the CUDA error code of the launch (0 on success). q, k, v, dout and
// the outputs: contiguous (B, N, d) f32, 16-byte aligned; lse, delta:
// contiguous (B, N) f32 (the Python wrapper checks this).
extern "C" int frn_flash_bwd_dq_f32(const void* q, const void* k, const void* v, const void* dout,
                                    const void* lse, const void* delta, void* dq, int batch, int n,
                                    int d, void* stream) {
  if (batch <= 0 || n <= 0 || batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* of = static_cast<const float*>(dout);
  const auto* lf = static_cast<const float*>(lse);
  const auto* df = static_cast<const float*>(delta);
  auto* out = static_cast<float*>(dq);
  auto* s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 8: return launch_dq_small<8>(qf, kf, vf, of, lf, df, out, batch, n, s);
    case 16: return launch_dq_small<16>(qf, kf, vf, of, lf, df, out, batch, n, s);
    case 32: return launch_dq_tiled<32>(qf, kf, vf, of, lf, df, out, batch, n, s);
    case 64: return launch_dq_tiled<64>(qf, kf, vf, of, lf, df, out, batch, n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int frn_flash_bwd_dkv_f32(const void* q, const void* k, const void* v, const void* dout,
                                     const void* lse, const void* delta, void* dk, void* dv,
                                     int batch, int n, int d, void* stream) {
  if (batch <= 0 || n <= 0 || batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* of = static_cast<const float*>(dout);
  const auto* lf = static_cast<const float*>(lse);
  const auto* df = static_cast<const float*>(delta);
  auto* dkf = static_cast<float*>(dk);
  auto* dvf = static_cast<float*>(dv);
  auto* s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 8: return launch_dkv_small<8>(qf, kf, vf, of, lf, df, dkf, dvf, batch, n, s);
    case 16: return launch_dkv_small<16>(qf, kf, vf, of, lf, df, dkf, dvf, batch, n, s);
    case 32: return launch_dkv_tiled<32>(qf, kf, vf, of, lf, df, dkf, dvf, batch, n, s);
    case 64: return launch_dkv_tiled<64>(qf, kf, vf, of, lf, df, dkf, dvf, batch, n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

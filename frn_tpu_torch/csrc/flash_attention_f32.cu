// Flash-attention forward at f32 for the REFusion non-local cross-attention,
// Hopper (sm_90a): the f32 instance of the Pallas TPU kernel
// frn_tpu/ops/flash_attention.py::_flash_kernel (launched by _flash_forward on
// f32 inputs, as an f32 detector's evaluation and training do). Per batch b,
//
//     O[b] = softmax(Q[b] K[b]^T) V[b]        (no 1/sqrt(d) scale)
//
// with Q = phi, K = theta, V = g, all (B, N, d) f32 row-major, d in
// {8, 16, 32, 64}, and on request (training: _flash_forward(return_lse=True))
// the per-row logsumexp lse = m + log(l), natural log, (B, N) f32; inference
// passes a null lse and stores none. Scores, the running
// row max m, the denominator l and the output accumulator are f32, and p stays
// f32: the PV product takes the unrounded p and l sums it, as the TPU kernel
// does when V is f32 (its ones lane of V sums the same p the PV product
// takes). Over each tile of keys: m' = max(m, max_j s_j),
// alpha = 2^((m - m') log2 e), p_j = 2^(fma(s_j, log2 e, -m' log2 e)) (the
// bf16 forward's formulation: one FFMA and one ex2 per score),
// l = l alpha + sum_j p_j, acc = acc alpha + sum_j p_j V_j (keys in order);
// at the end O = acc / l (an IEEE division). The products are f32 FMAs on the
// CUDA cores, never the tensor cores (TF32 or 3xTF32 would compute another
// function); the order of the sums changes only the rounding.
//
// What bounds it on an H100: 4d flops per (query, key) pair, 4 B N^2 d in
// all, at the CUDA cores' f32 rate (67 TFLOP/s on the H100 SXM data sheet);
// its bytes (Q, K, V, O once) are far below that.
//
// d 32 and 64: flash_fwd_f32_tiled, a register-blocked tile in the manner of
// an SGEMM on CUDA cores. A block of 128 threads owns 64 query rows of one
// batch and walks K and V in tiles of BN keys (64 at d 32, 32 at d 64),
// staged by 16-byte cp.async into a two-slot ring, the next tile in flight
// while a tile is computed; Q's rows are staged once. Thread (row group rg,
// key group kg), kg = lane % 8 and four row groups to a warp, owns rows
// rg + 16 i (i < 4) and keys kg + 8 j (j < BN / 8) of the tile's scores: for
// each 4 columns of d it reads the float4s of its 4 q rows and its BN / 8 k
// rows and does 4 * BN / 8 * 4 FMAs, so each value read from shared memory
// feeds 4 or 8 FMAs. Strided keys put the 8 lanes of a row group on
// neighbouring K rows, and every staged row is padded by 16 bytes, so a
// warp's reads spread over the banks. The row group's 8 lanes take the tile's
// row max by __shfl_xor_sync; each keeps a partial l over its own keys,
// rescaled by the same alpha and summed across the 8 once at the end (l is
// linear). p goes to shared memory (padded rows), and the same thread owns
// rows rg + 16 i and the float4 columns 4 (kg + 8 u) of the accumulator for
// O += P V: each float4 of p feeds 4 d/8 FMAs. The limits of the first
// design, one row per thread: every value read from shared memory fed 1 FMA;
// 254 registers left 8 warps an SM; its 128-row blocks left stage 2's grid
// (76 blocks at batch 2) under the 132 SMs. Here a thread holds 168 (d 32) or
// 164 (d 64) registers and 3 blocks of 61 or 60 KB share an SM (12 warps:
// larger thread tiles at 12 warps beat 4 x 4 tiles at 16 warps on the H100),
// and 64-row blocks give every launch of the paths more blocks than the
// card has SMs.
//
// d 8 and 16 (the depth-18 and -34 detectors: stage widths 64 and 128, head
// dim C / 8): flash_fwd_f32_small, register-blocked on the same thread map
// (128 threads, 64 query rows, thread (rg, kg) owns rows rg + 16 i, i < 4, and
// keys kg + 8 j of each tile), built for small d. At d 8 a row's accumulator
// is two float4s, too narrow to split its columns over 8 lanes as the tiled
// kernel does, and a round trip of p through shared memory would cost as many
// shared reads as V's. So p stays in registers: each thread accumulates O
// over its own keys for all d columns (4 x d accumulators, rescaled by the
// row group's shared alpha), and the 8 lanes' partial O and l are summed once
// at the end by __shfl_xor_sync (O and l are linear in the keys). The
// thread's 4 q rows stay in registers for the whole walk, so each float4 of K
// or V read from shared memory feeds 16 FMAs. Tiles of 64 keys (8 a thread)
// are staged by cp.async into a two-slot ring of padded rows (16 bytes: the 8
// distinct rows a warp reads at once fall on distinct banks); 4 blocks an SM
// at d 8 (128 registers), 2 at d 16 (254). The first design, one
// query row per thread in 128-row blocks, fed 1 FMA per value read and left
// the train CLI's stage 2 (B 2, N 4,800) 76 blocks; 64-row blocks give it
// 150. What is left besides the 4d FMAs per score (about 4 more FP32
// operations: the exp's argument, the max, l, the rescale, and one ex2 on
// the special-function unit) keeps it under about 80% of the flops bound; on
// the H100 it reached 48% at d 8 and 41% at d 16 (PERF.md).
//
// Both: keys past N are zero-filled in the ring and their scores masked to
// -inf on the last, ragged tile only; rows past N compute and store nothing
// (no O, no lse).

#include <math.h>

#include "flash_sm90.cuh"

namespace {

using namespace flash;

// ------------------------------------------------------------ d 32 and 64

constexpr int kTiledRows = 64;     // BM: query rows a block owns
constexpr int kTiledThreads = 128;
constexpr int kKeyGroups = 8;      // G: the lanes that share a row group
constexpr int kTiledBlocksPerSM = 3;

// keys per tile (BN): at d 32 a thread takes 8 keys of a 64-key tile; at d 64,
// whose accumulator is twice as wide, 4 keys of a 32-key tile
template <int D>
__host__ __device__ constexpr int tiled_keys() {
  return D == 32 ? 64 : 32;
}

template <int D>
struct Tiled {
  static constexpr int kBN = tiled_keys<D>();
  static constexpr int kR = kTiledThreads / kKeyGroups;  // row groups
  static constexpr int kTM = kTiledRows / kR;            // rows per thread
  static constexpr int kTN = kBN / kKeyGroups;           // keys per thread
  static constexpr int kCW = D / kKeyGroups;             // accumulator columns per thread
  static constexpr int kQS = D + 4;                      // padded row strides, in floats
  static constexpr int kPS = kBN + 4;
  static constexpr int kQ = kTiledRows * kQS;            // floats of each staged tile
  static constexpr int kK = kBN * kQS;
  static constexpr int kV = kBN * D;
  static constexpr int kP = kTiledRows * kPS;
  static constexpr int kBytes = 4 * (kQ + 2 * kK + 2 * kV + kP);
  static_assert(kTM * kR == kTiledRows && kTN * kKeyGroups == kBN && kCW % 4 == 0,
                "whole tiles, float4 columns");
  static_assert(kTiledBlocksPerSM * (kBytes + 1024) <= 228 * 1024, "3 blocks an SM");
};

// S = Q K^T for this thread's rows and keys of the tile, the online softmax
// step of its rows (m, the partial l, acc rescaled by alpha), and p into ps
template <int D, bool kMask>
__device__ __forceinline__ void scores_to_p(const float* __restrict__ qs,
                                            const float* __restrict__ kt, float* __restrict__ ps,
                                            int key0, int n, int rg, int kg,
                                            float (&m)[Tiled<D>::kTM], float (&l)[Tiled<D>::kTM],
                                            float (&acc)[Tiled<D>::kTM][Tiled<D>::kCW]) {
  using T = Tiled<D>;
  constexpr int TM = T::kTM, TN = T::kTN, G = kKeyGroups, R = T::kR;
  float s[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
  }
  // for each 4 columns of d: the float4s of the smaller side held, the
  // other side's read one at a time (fewer registers live)
#pragma unroll
  for (int c = 0; c < D; c += 4) {
    if constexpr (TN <= TM) {
      float4 kf[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j)
        kf[j] = *reinterpret_cast<const float4*>(kt + (kg + G * j) * T::kQS + c);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 qf = *reinterpret_cast<const float4*>(qs + (rg + R * i) * T::kQS + c);
#pragma unroll
        for (int j = 0; j < TN; ++j) fma4(s[i][j], qf, kf[j]);
      }
    } else {
      float4 qf[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        qf[i] = *reinterpret_cast<const float4*>(qs + (rg + R * i) * T::kQS + c);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float4 kf = *reinterpret_cast<const float4*>(kt + (kg + G * j) * T::kQS + c);
#pragma unroll
        for (int i = 0; i < TM; ++i) fma4(s[i][j], qf[i], kf);
      }
    }
  }
  if constexpr (kMask) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      if (key0 + kg + G * j >= n) {
#pragma unroll
        for (int i = 0; i < TM; ++i) s[i][j] = -INFINITY;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float mx = m[i];
#pragma unroll
    for (int j = 0; j < TN; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
    for (int off = 1; off < G; off *= 2)  // the row group's G lanes
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    // finite: the tile's first key is valid
    const float alpha = ex2((m[i] - mx) * kLog2e);  // 0 on the first tile (m = -inf)
    const float mb = mx * kLog2e;
    m[i] = mx;
    float ts = 0.f;
    float* prow = ps + (rg + R * i) * T::kPS + kg;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const float p = ex2(fmaf(s[i][j], kLog2e, -mb));  // 0 for a masked key
      ts += p;
      prow[G * j] = p;
    }
    l[i] = l[i] * alpha + ts;
#pragma unroll
    for (int c = 0; c < T::kCW; ++c) acc[i][c] *= alpha;
  }
}

// acc += P V over the tile's keys in order, for this thread's rows and its
// columns 4 (kg + G u) .. + 3
template <int D>
__device__ __forceinline__ void accumulate_pv(const float* __restrict__ ps,
                                              const float* __restrict__ vt, int rg, int kg,
                                              float (&acc)[Tiled<D>::kTM][Tiled<D>::kCW]) {
  using T = Tiled<D>;
  constexpr int TM = T::kTM, CW = T::kCW, G = kKeyGroups, R = T::kR;
  // per 4 keys: their V columns held, each row's float4 of p read in turn
#pragma unroll
  for (int kk = 0; kk < T::kBN; kk += 4) {
    float4 vv[4][CW / 4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int cu = 0; cu < CW / 4; ++cu)
        vv[u][cu] = *reinterpret_cast<const float4*>(vt + (kk + u) * D + 4 * (kg + G * cu));
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float4 pf = *reinterpret_cast<const float4*>(ps + (rg + R * i) * T::kPS + kk);
#pragma unroll
      for (int cu = 0; cu < CW / 4; ++cu) {  // keys in order
        float* a = acc[i] + 4 * cu;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float p = u == 0 ? pf.x : u == 1 ? pf.y : u == 2 ? pf.z : pf.w;
          a[0] = fmaf(p, vv[u][cu].x, a[0]);
          a[1] = fmaf(p, vv[u][cu].y, a[1]);
          a[2] = fmaf(p, vv[u][cu].z, a[2]);
          a[3] = fmaf(p, vv[u][cu].w, a[3]);
        }
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kTiledThreads, kTiledBlocksPerSM)
    flash_fwd_f32_tiled(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o,
                        float* __restrict__ lse, int n) {
  using T = Tiled<D>;
  constexpr int TM = T::kTM, CW = T::kCW, G = kKeyGroups, R = T::kR, BN = T::kBN;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ks = qs + T::kQ;      // two slots
  float* vs = ks + 2 * T::kK;  // two slots
  float* ps = vs + 2 * T::kV;
  const size_t base = static_cast<size_t>(blockIdx.y) * n * D;
  q += base;
  k += base;
  v += base;
  o += base;
  const int row0 = blockIdx.x * kTiledRows;
  const int kg = threadIdx.x % G;  // keys kg + G j; columns 4 (kg + G u) ..
  const int rg = threadIdx.x / G;  // rows row0 + rg + R i

  stage_rows_f32<D, kTiledRows, T::kQS, kTiledThreads>(q, row0, n, qs);
  stage_rows_f32<D, BN, T::kQS, kTiledThreads>(k, 0, n, ks);
  stage_rows_f32<D, BN, D, kTiledThreads>(v, 0, n, vs);
  cp_async_commit();

  float m[TM], l[TM], acc[TM][CW];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[i][c] = 0.f;
  }
  const int tiles = (n + BN - 1) / BN;
  const bool ragged = n % BN != 0;
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // tile t is in; every thread is done with tile t - 1 and its slot
    if (t + 1 < tiles) {
      const int slot = (t + 1) % 2;
      stage_rows_f32<D, BN, T::kQS, kTiledThreads>(k, (t + 1) * BN, n, ks + slot * T::kK);
      stage_rows_f32<D, BN, D, kTiledThreads>(v, (t + 1) * BN, n, vs + slot * T::kV);
      cp_async_commit();
    }
    const float* kt = ks + (t % 2) * T::kK;
    if (ragged && t == tiles - 1)
      scores_to_p<D, true>(qs, kt, ps, t * BN, n, rg, kg, m, l, acc);
    else
      scores_to_p<D, false>(qs, kt, ps, t * BN, n, rg, kg, m, l, acc);
    __syncthreads();  // p is in
    accumulate_pv<D>(ps, vs + (t % 2) * T::kV, rg, kg, acc);
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int off = 1; off < G; off *= 2) l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    const int row = row0 + rg + R * i;
    if (row >= n) continue;
#pragma unroll
    for (int cu = 0; cu < CW / 4; ++cu) {
      const float* a = acc[i] + 4 * cu;
      *reinterpret_cast<float4*>(o + static_cast<size_t>(row) * D + 4 * (kg + G * cu)) =
          make_float4(a[0] / l[i], a[1] / l[i], a[2] / l[i], a[3] / l[i]);
    }
    if (lse != nullptr && kg == 0)
      lse[static_cast<size_t>(blockIdx.y) * n + row] = m[i] + logf(l[i]);
  }
}

template <int D>
int launch_tiled(const float* q, const float* k, const float* v, float* o, float* lse, int batch,
                 int n, cudaStream_t stream) {
  static int set_for_device = -1;
  const int rc = allow_smem(flash_fwd_f32_tiled<D>, Tiled<D>::kBytes, set_for_device);
  if (rc != 0) return rc;
  const dim3 grid((n + kTiledRows - 1) / kTiledRows, batch);
  flash_fwd_f32_tiled<D><<<grid, kTiledThreads, Tiled<D>::kBytes, stream>>>(q, k, v, o, lse, n);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ d 8 and 16

constexpr int kSmallRows = 64;  // BM: query rows a block owns
constexpr int kSmallThreads = 128;

// keys per tile (BN): a thread takes 8 keys of a 64-key tile. By
// measurement on the H100 (PERF.md): at d 8, 128-key tiles spilled at
// 3 blocks an SM and ran 10% slower at 2; at d 16, 32-key tiles ran 17%
// slower and 128-key ones 3%
template <int D>
__host__ __device__ constexpr int small_keys() {
  return D == 8 ? 64 : 64;
}

// blocks an SM: 4 at d 8 (16 warps, 128 registers a thread: 8% faster than
// 3); 2 at d 16, whose 64 q and 64 accumulator registers a thread spill at 3
template <int D>
__host__ __device__ constexpr int small_blocks_per_sm() {
  return D == 8 ? 4 : 2;
}

template <int D>
struct Small {
  static constexpr int kBN = small_keys<D>();
  static constexpr int kR = kSmallThreads / kKeyGroups;  // row groups
  static constexpr int kTM = kSmallRows / kR;            // rows per thread
  static constexpr int kTN = kBN / kKeyGroups;           // keys per thread
  static constexpr int kS = D + 4;                       // padded row stride, in floats
  static constexpr int kTile = kBN * kS;                 // floats of a staged K or V tile
  static constexpr int kBytes = 4 * 2 * 2 * kTile;       // two slots of K and V
  static_assert(kTM * kR == kSmallRows && kTN * kKeyGroups == kBN && D % 4 == 0,
                "whole tiles, float4 columns");
  static_assert(small_blocks_per_sm<D>() * (kBytes + 1024) <= 228 * 1024, "blocks an SM");
};

// one tile for this thread's rows and keys: S = Q K^T, the online softmax
// step of its rows (m, the partial l and acc rescaled by alpha), then acc +=
// P V over its own keys in order; p never leaves the registers
template <int D, bool kMask>
__device__ __forceinline__ void small_tile(const float4 (&qr)[Small<D>::kTM][D / 4],
                                           const float* __restrict__ kt,
                                           const float* __restrict__ vt, int key0, int n, int kg,
                                           float (&m)[Small<D>::kTM], float (&l)[Small<D>::kTM],
                                           float (&acc)[Small<D>::kTM][D]) {
  using T = Small<D>;
  constexpr int TM = T::kTM, TN = T::kTN, G = kKeyGroups;
  float s[TM][TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const float* krow = kt + (kg + G * j) * T::kS;
#pragma unroll
    for (int i = 0; i < TM; ++i) s[i][j] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 4; ++c) {  // each float4 of K feeds TM * 4 FMAs
      const float4 kf = *reinterpret_cast<const float4*>(krow + 4 * c);
#pragma unroll
      for (int i = 0; i < TM; ++i) fma4(s[i][j], qr[i][c], kf);
    }
  }
  if constexpr (kMask) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      if (key0 + kg + G * j >= n) {
#pragma unroll
        for (int i = 0; i < TM; ++i) s[i][j] = -INFINITY;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float mx = m[i];
#pragma unroll
    for (int j = 0; j < TN; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
    for (int off = 1; off < G; off *= 2)  // the row group's G lanes
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    // finite: the tile's first key is valid
    const float alpha = ex2((m[i] - mx) * kLog2e);  // 0 on the first tile (m = -inf)
    const float mb = mx * kLog2e;
    m[i] = mx;
    float ts = 0.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      s[i][j] = ex2(fmaf(s[i][j], kLog2e, -mb));  // 0 for a masked key
      ts += s[i][j];
    }
    l[i] = l[i] * alpha + ts;
#pragma unroll
    for (int c = 0; c < D; ++c) acc[i][c] *= alpha;
  }
#pragma unroll
  for (int j = 0; j < TN; ++j) {  // keys in order
    const float* vrow = vt + (kg + G * j) * T::kS;
#pragma unroll
    for (int c = 0; c < D / 4; ++c) {  // each float4 of V feeds TM * 4 FMAs
      const float4 vf = *reinterpret_cast<const float4*>(vrow + 4 * c);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        float* a = acc[i] + 4 * c;
        a[0] = fmaf(s[i][j], vf.x, a[0]);
        a[1] = fmaf(s[i][j], vf.y, a[1]);
        a[2] = fmaf(s[i][j], vf.z, a[2]);
        a[3] = fmaf(s[i][j], vf.w, a[3]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kSmallThreads, small_blocks_per_sm<D>())
    flash_fwd_f32_small(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o,
                        float* __restrict__ lse, int n) {
  using T = Small<D>;
  constexpr int TM = T::kTM, G = kKeyGroups, R = T::kR, BN = T::kBN;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);  // two slots
  float* vs = ks + 2 * T::kTile;                   // two slots
  const size_t base = static_cast<size_t>(blockIdx.y) * n * D;
  q += base;
  k += base;
  v += base;
  o += base;
  const int row0 = blockIdx.x * kSmallRows;
  const int kg = threadIdx.x % G;  // keys kg + G j of every tile
  const int rg = threadIdx.x / G;  // rows row0 + rg + R i

  stage_rows_f32<D, BN, T::kS, kSmallThreads>(k, 0, n, ks);
  stage_rows_f32<D, BN, T::kS, kSmallThreads>(v, 0, n, vs);
  cp_async_commit();

  // the thread's q rows stay in registers (rows past n: zeros, never stored)
  float4 qr[TM][D / 4];
  float m[TM], l[TM], acc[TM][D];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + rg + R * i;
#pragma unroll
    for (int c = 0; c < D / 4; ++c)
      qr[i][c] = row < n ? *reinterpret_cast<const float4*>(q + static_cast<size_t>(row) * D + 4 * c)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < D; ++c) acc[i][c] = 0.f;
  }
  const int tiles = (n + BN - 1) / BN;
  const bool ragged = n % BN != 0;
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // tile t is in; every thread is done with tile t - 1 and its slot
    if (t + 1 < tiles) {
      const int slot = (t + 1) % 2;
      stage_rows_f32<D, BN, T::kS, kSmallThreads>(k, (t + 1) * BN, n, ks + slot * T::kTile);
      stage_rows_f32<D, BN, T::kS, kSmallThreads>(v, (t + 1) * BN, n, vs + slot * T::kTile);
      cp_async_commit();
    }
    const float* kt = ks + (t % 2) * T::kTile;
    const float* vt = vs + (t % 2) * T::kTile;
    if (ragged && t == tiles - 1)
      small_tile<D, true>(qr, kt, vt, t * BN, n, kg, m, l, acc);
    else
      small_tile<D, false>(qr, kt, vt, t * BN, n, kg, m, l, acc);
  }
  // the G lanes' partial l and acc over their own keys, summed once (both are
  // linear in the keys, and every lane scaled by the same alphas); the xor
  // butterfly leaves the same sums in all G lanes
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int off = 1; off < G; off *= 2) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
#pragma unroll
      for (int c = 0; c < D; ++c) acc[i][c] += __shfl_xor_sync(0xffffffffu, acc[i][c], off);
    }
    const int row = row0 + rg + R * i;
    if (row >= n) continue;
#pragma unroll
    for (int c = 0; c < D / 4; ++c) {  // lane c stores the row's float4 c
      if (kg == c) {
        const float* a = acc[i] + 4 * c;
        *reinterpret_cast<float4*>(o + static_cast<size_t>(row) * D + 4 * c) =
            make_float4(a[0] / l[i], a[1] / l[i], a[2] / l[i], a[3] / l[i]);
      }
    }
    if (lse != nullptr && kg == G - 1)
      lse[static_cast<size_t>(blockIdx.y) * n + row] = m[i] + logf(l[i]);
  }
}

template <int D>
int launch_small(const float* q, const float* k, const float* v, float* o, float* lse, int batch,
                 int n, cudaStream_t stream) {
  static int set_for_device = -1;
  const int rc = allow_smem(flash_fwd_f32_small<D>, Small<D>::kBytes, set_for_device);
  if (rc != 0) return rc;
  const dim3 grid((n + kSmallRows - 1) / kSmallRows, batch);
  flash_fwd_f32_small<D><<<grid, kSmallThreads, Small<D>::kBytes, stream>>>(q, k, v, o, lse, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, bound with ctypes. Launches on `stream` and returns the
// CUDA error code of the launch (0 on success). q, k, v, o: contiguous
// (B, N, d) f32, 16-byte aligned (the Python wrapper checks this); lse: null,
// or contiguous (B, N) f32.
extern "C" int frn_flash_fwd_f32(const void* q, const void* k, const void* v, void* o, void* lse,
                                 int batch, int n, int d, void* stream) {
  if (batch <= 0 || n <= 0 || batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(o);
  auto* lf = static_cast<float*>(lse);
  auto* s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 8: return launch_small<8>(qf, kf, vf, of, lf, batch, n, s);
    case 16: return launch_small<16>(qf, kf, vf, of, lf, batch, n, s);
    case 32: return launch_tiled<32>(qf, kf, vf, of, lf, batch, n, s);
    case 64: return launch_tiled<64>(qf, kf, vf, of, lf, batch, n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

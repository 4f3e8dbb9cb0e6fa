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
// takes). Over each tile of keys (64, or 32 at d 64): m' = max(m, max_j s_j),
// alpha = 2^((m - m') log2 e), p_j = 2^(fma(s_j, log2 e, -m' log2 e)) (the
// bf16 forward's formulation: one FFMA and one ex2 per score),
// l = l alpha + sum_j p_j (the tile's sum from zero, in key order),
// acc = acc alpha + sum_j p_j V_j; at the end O = acc / l (an IEEE division).
//
// Design: the products run as f32 FMAs on the CUDA cores, never on the
// tensor cores (TF32 or 3xTF32 would compute another function). A block owns
// 128 query rows of one batch, one per thread: the thread keeps its q row, its
// accumulator and the scores of the current tile in registers (at d 64 a tile
// of 64 keys spilled past the 255 registers a thread has, so the tile there is
// 32 keys; at f32 the tile changes only the rounding).
// K and V tiles are staged by 16-byte cp.async into a two-slot ring in
// shared memory, the next tile in flight while a tile is computed; every
// thread of a warp reads the same key's float4 at once (a broadcast). Keys
// past N are zero-filled in the ring and their scores masked to -inf on the
// last, ragged tile only; rows past N compute and store nothing (no O, no
// lse).
//
// What bounds it on an H100: 4d flops per (query, key) pair at the CUDA
// cores' f32 rate (67 TFLOP/s on the H100 SXM data sheet); every float4 read
// of K or V from shared memory feeds 4 FMAs of each thread.

#include <math.h>

#include "flash_sm90.cuh"

namespace {

using namespace flash;

constexpr int kRowsF32 = 128;  // query rows (threads) per block

// keys per tile: what the registers allow beside a q row and an accumulator
template <int D>
__host__ __device__ constexpr int keys_per_tile() {
  return D == 64 ? 32 : 64;
}

template <int D>
constexpr int f32_ring_bytes() {
  return 2 * 2 * keys_per_tile<D>() * D * 4;  // two slots of a K and a V tile
}

// one tile of the online softmax for this thread's row
template <int D, bool kMask>
__device__ __forceinline__ void tile_step(const float (&q)[D], const float* __restrict__ kt,
                                          const float* __restrict__ vt, int key0, int n, float& m,
                                          float& l, float (&acc)[D]) {
  constexpr int kTileF32 = keys_per_tile<D>();
  float s[kTileF32];
#pragma unroll
  for (int j = 0; j < kTileF32; ++j) s[j] = 0.f;
#pragma unroll
  for (int c = 0; c < D; c += 4) {
#pragma unroll
    for (int j = 0; j < kTileF32; ++j) {
      const float4 kv = *reinterpret_cast<const float4*>(kt + j * D + c);
      s[j] = fmaf(q[c], kv.x, s[j]);
      s[j] = fmaf(q[c + 1], kv.y, s[j]);
      s[j] = fmaf(q[c + 2], kv.z, s[j]);
      s[j] = fmaf(q[c + 3], kv.w, s[j]);
    }
  }
  if constexpr (kMask) {
#pragma unroll
    for (int j = 0; j < kTileF32; ++j)
      if (key0 + j >= n) s[j] = -INFINITY;
  }
  float mx = m;
#pragma unroll
  for (int j = 0; j < kTileF32; ++j) mx = fmaxf(mx, s[j]);  // finite: a tile holds a valid key
  const float alpha = ex2((m - mx) * kLog2e);  // 0 on the first tile (m = -inf)
  const float mb = mx * kLog2e;
  m = mx;
  float ts = 0.f;
#pragma unroll
  for (int j = 0; j < kTileF32; ++j) {
    s[j] = ex2(fmaf(s[j], kLog2e, -mb));  // 0 for a masked key
    ts += s[j];
  }
  l = l * alpha + ts;
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] *= alpha;
#pragma unroll
  for (int j = 0; j < kTileF32; ++j) {
#pragma unroll
    for (int c = 0; c < D; c += 4) {
      const float4 vv = *reinterpret_cast<const float4*>(vt + j * D + c);
      acc[c] = fmaf(s[j], vv.x, acc[c]);
      acc[c + 1] = fmaf(s[j], vv.y, acc[c + 1]);
      acc[c + 2] = fmaf(s[j], vv.z, acc[c + 2]);
      acc[c + 3] = fmaf(s[j], vv.w, acc[c + 3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kRowsF32)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                  int n) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);
  const size_t base = static_cast<size_t>(blockIdx.y) * n * D;
  q += base;
  k += base;
  v += base;
  o += base;
  const int row = blockIdx.x * kRowsF32 + threadIdx.x;
  const bool live = row < n;

  float qr[D], acc[D];
#pragma unroll
  for (int c = 0; c < D; c += 4) {
    const float4 x = live ? *reinterpret_cast<const float4*>(q + static_cast<size_t>(row) * D + c)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    qr[c] = x.x;
    qr[c + 1] = x.y;
    qr[c + 2] = x.z;
    qr[c + 3] = x.w;
  }
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] = 0.f;
  float m = -INFINITY, l = 0.f;

  constexpr int kTileF32 = keys_per_tile<D>();
  const int tiles = (n + kTileF32 - 1) / kTileF32;
  const bool ragged = n % kTileF32 != 0;
  load_rows_f32<D, kTileF32, kRowsF32>(k, v, 0, n, ring, ring + kTileF32 * D);
  cp_async_commit();
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {
      float* next = ring + ((t + 1) % 2) * 2 * kTileF32 * D;
      load_rows_f32<D, kTileF32, kRowsF32>(k, v, (t + 1) * kTileF32, n, next, next + kTileF32 * D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* kt = ring + (t % 2) * 2 * kTileF32 * D;
    if (ragged && t == tiles - 1)
      tile_step<D, true>(qr, kt, kt + kTileF32 * D, t * kTileF32, n, m, l, acc);
    else
      tile_step<D, false>(qr, kt, kt + kTileF32 * D, t * kTileF32, n, m, l, acc);
    __syncthreads();  // the slot is refilled by the next iteration's copy
  }
  if (live) {
#pragma unroll
    for (int c = 0; c < D; c += 4)
      *reinterpret_cast<float4*>(o + static_cast<size_t>(row) * D + c) =
          make_float4(acc[c] / l, acc[c + 1] / l, acc[c + 2] / l, acc[c + 3] / l);
    if (lse != nullptr) lse[static_cast<size_t>(blockIdx.y) * n + row] = m + logf(l);
  }
}

template <int D>
int launch_f32(const float* q, const float* k, const float* v, float* o, float* lse, int batch,
               int n, cudaStream_t stream) {
  static int set_for_device = -1;
  const int rc = allow_smem(flash_fwd_f32<D>, f32_ring_bytes<D>(), set_for_device);
  if (rc != 0) return rc;
  const dim3 grid((n + kRowsF32 - 1) / kRowsF32, batch);
  flash_fwd_f32<D><<<grid, kRowsF32, f32_ring_bytes<D>(), stream>>>(q, k, v, o, lse, n);
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
    case 8: return launch_f32<8>(qf, kf, vf, of, lf, batch, n, s);
    case 16: return launch_f32<16>(qf, kf, vf, of, lf, batch, n, s);
    case 32: return launch_f32<32>(qf, kf, vf, of, lf, batch, n, s);
    case 64: return launch_f32<64>(qf, kf, vf, of, lf, batch, n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

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
// Design: a block of 128 threads owns a run of rows of one batch, query rows
// (dQ) or key rows (dK/dV). A row's own vectors stay in registers for the
// whole launch: q, dO and the dQ accumulator (3d floats), or k, v and the dK
// and dV accumulators (4d floats, 256 at d 64: over the 255 registers a
// thread has). So at d 64 two neighbouring threads share a row, each holding
// every other float4 of it, and add their partial dot products with one
// shuffle; at d 8-32 a thread holds a whole row. The other side (K and V
// tiles for dQ; Q and dO tiles, with their lse and D, for dK/dV) is staged by
// cp.async into a two-slot ring in shared memory, 64 rows a tile, the next
// tile in flight while one is computed; every thread of a warp reads the same
// tile row (a broadcast; the two threads of a pair read neighbouring 16
// bytes). Each step takes a group of tile rows at once, whose values the
// compiler keeps in registers from their first pass over them to their last
// (K's in the dQ kernel, Q's in the dK/dV kernel): 4 rows in the dQ kernel
// (8 independent FMA chains a thread); in the dK/dV kernel 4 rows where a
// thread holds 16 columns or fewer, and 2 where it holds 32 (4 row vectors
// and 2 Q rows of 32 floats each stay under the 255 registers a thread
// has; 4 Q rows spilled), each score summed in two halves (4 chains).
//
// The ragged tail: tile rows past N are zero-filled in the ring. In the dQ
// kernel a key past N would give s = 0 and P = exp(-lse), inf where lse < -88,
// so its dS is set to 0 on the last, ragged tile (a select: no inf reaches
// the accumulator); in the dK/dV kernel a query row past N has no lse or D of
// its own (both zero-filled, never read from past N), and its P is set to 0
// there, so it adds nothing to dK or dV. Rows past N store nothing.
//
// What bounds it on an H100: 6d (dQ) and 8d (dK/dV) flops per (query, key)
// pair at the CUDA cores' f32 rate (67 TFLOP/s on the H100 SXM data sheet);
// every float4 read from shared memory feeds 4 FMAs of a thread.

#include <math.h>

#include "flash_sm90.cuh"

namespace {

using namespace flash;

constexpr int kThreadsBwd = 128;  // threads per block
constexpr int kTileBwd = 64;      // keys (dQ) or queries (dK/dV) per shared tile
constexpr int kGroup = 4;         // tile rows a thread of the dQ kernel takes at once
static_assert(kThreadsBwd == 2 * kTileBwd, "one thread copies each lse and each D of a tile");

// threads that share a row: two at d 64 (each holding half its columns)
template <int D>
__host__ __device__ constexpr int split() {
  return D == 64 ? 2 : 1;
}

template <int D>
__host__ __device__ constexpr int cols() {
  return D / split<D>();  // a row's columns held by one thread
}

template <int D>
__host__ __device__ constexpr int rows_per_block() {
  return kThreadsBwd / split<D>();
}

// tile rows a thread of the dK/dV kernel takes at once (see the head comment)
template <int D>
__host__ __device__ constexpr int dkv_group() {
  return cols<D>() >= 32 ? 2 : 4;
}

// column of the thread's i-th float4 of a row: the threads of a pair take
// every other float4, so that they read neighbouring 16 bytes of a tile row
template <int D>
__device__ __forceinline__ int col(int i, int h) {
  return 4 * (split<D>() * i + h);
}

// the row's sum of the threads' partial sums (the same value in both threads)
template <int D>
__device__ __forceinline__ float row_sum(float x) {
  if constexpr (split<D>() == 2) x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x;
}

// the thread's columns of row `row` of a (n, D) f32 matrix; zeros past n
template <int D>
__device__ __forceinline__ void load_row(const float* __restrict__ a, int row, bool live, int h,
                                         float (&r)[cols<D>()]) {
#pragma unroll
  for (int i = 0; i < cols<D>() / 4; ++i) {
    const float4 x = live ? *reinterpret_cast<const float4*>(a + static_cast<size_t>(row) * D + col<D>(i, h))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    r[4 * i] = x.x;
    r[4 * i + 1] = x.y;
    r[4 * i + 2] = x.z;
    r[4 * i + 3] = x.w;
  }
}

template <int D>
__device__ __forceinline__ void store_row(float* __restrict__ a, int row, int h,
                                          const float (&r)[cols<D>()]) {
#pragma unroll
  for (int i = 0; i < cols<D>() / 4; ++i)
    *reinterpret_cast<float4*>(a + static_cast<size_t>(row) * D + col<D>(i, h)) =
        make_float4(r[4 * i], r[4 * i + 1], r[4 * i + 2], r[4 * i + 3]);
}

// the thread's float4 i of row t of a shared [kTileBwd][D] tile
template <int D>
__device__ __forceinline__ float4 tile_chunk(const float* __restrict__ tile, int t, int i, int h) {
  return *reinterpret_cast<const float4*>(tile + t * D + col<D>(i, h));
}

__device__ __forceinline__ float dot4(const float* a, float4 b, float acc) {
  acc = fmaf(a[0], b.x, acc);
  acc = fmaf(a[1], b.y, acc);
  acc = fmaf(a[2], b.z, acc);
  return fmaf(a[3], b.w, acc);
}

__device__ __forceinline__ void axpy4(float a, float4 x, float* y) {
  y[0] = fmaf(a, x.x, y[0]);
  y[1] = fmaf(a, x.y, y[1]);
  y[2] = fmaf(a, x.z, y[2]);
  y[3] = fmaf(a, x.w, y[3]);
}

// ------------------------------------------------------------ dQ (B2a)

// one tile of keys for the thread's query row: dQ += sum_j dS_j K_j; keys at
// or past `valid` (kMask: the last, ragged tile) add nothing
template <int D, bool kMask>
__device__ __forceinline__ void dq_tile(const float (&qr)[cols<D>()], const float (&dor)[cols<D>()],
                                        const float* __restrict__ kt, const float* __restrict__ vt,
                                        float nlb, float dl, int valid, int h,
                                        float (&acc)[cols<D>()]) {
  constexpr int C = cols<D>();
#pragma unroll 1
  for (int j0 = 0; j0 < kTileBwd; j0 += kGroup) {
    float s[kGroup], dp[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) s[g] = dp[g] = 0.f;
#pragma unroll
    for (int i = 0; i < C / 4; ++i) {
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        s[g] = dot4(qr + 4 * i, tile_chunk<D>(kt, j0 + g, i, h), s[g]);
        dp[g] = dot4(dor + 4 * i, tile_chunk<D>(vt, j0 + g, i, h), dp[g]);
      }
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const float p = ex2(fmaf(row_sum<D>(s[g]), kLog2e, nlb));
      const float ds = p * (row_sum<D>(dp[g]) - dl);
      s[g] = kMask && j0 + g >= valid ? 0.f : ds;
    }
#pragma unroll
    for (int i = 0; i < C / 4; ++i) {
#pragma unroll
      for (int g = 0; g < kGroup; ++g) axpy4(s[g], tile_chunk<D>(kt, j0 + g, i, h), acc + 4 * i);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsBwd)
    flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dq, int n) {
  constexpr int C = cols<D>();
  extern __shared__ __align__(16) uint8_t smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);
  const size_t base = static_cast<size_t>(blockIdx.y) * n * D;
  const size_t rbase = static_cast<size_t>(blockIdx.y) * n;
  k += base;
  v += base;
  const int row = blockIdx.x * rows_per_block<D>() + threadIdx.x / split<D>();
  const int h = threadIdx.x % split<D>();
  const bool live = row < n;

  float qr[C], dor[C], acc[C];
  load_row<D>(q + base, row, live, h, qr);
  load_row<D>(dout + base, row, live, h, dor);
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
  const float nlb = live ? -(lse[rbase + row] * kLog2e) : 0.f;
  const float dl = live ? delta[rbase + row] : 0.f;

  constexpr int kSlot = 2 * kTileBwd * D;  // a K and a V tile
  const int tiles = (n + kTileBwd - 1) / kTileBwd;
  load_rows_f32<D, kTileBwd, kThreadsBwd>(k, v, 0, n, ring, ring + kTileBwd * D);
  cp_async_commit();
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {
      float* next = ring + ((t + 1) % 2) * kSlot;
      load_rows_f32<D, kTileBwd, kThreadsBwd>(k, v, (t + 1) * kTileBwd, n, next, next + kTileBwd * D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* kt = ring + (t % 2) * kSlot;
    const int valid = n - t * kTileBwd;
    if (valid < kTileBwd)
      dq_tile<D, true>(qr, dor, kt, kt + kTileBwd * D, nlb, dl, valid, h, acc);
    else
      dq_tile<D, false>(qr, dor, kt, kt + kTileBwd * D, nlb, dl, valid, h, acc);
    __syncthreads();  // the slot is refilled by the next iteration's copy
  }
  if (live) store_row<D>(dq + base, row, h, acc);
}

// ------------------------------------------------------------ dK and dV (B2b)

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

// one tile of queries for the thread's key row: dV += sum_i P_i dO_i and
// dK += sum_i dS_i Q_i; query rows at or past `valid` (kMask) add nothing
template <int D, bool kMask>
__device__ __forceinline__ void dkv_tile(const float (&kr)[cols<D>()], const float (&vr)[cols<D>()],
                                         const float* __restrict__ qt, const float* __restrict__ dot,
                                         const float* __restrict__ lt, const float* __restrict__ dt,
                                         int valid, int h, float (&dk)[cols<D>()],
                                         float (&dv)[cols<D>()]) {
  constexpr int C = cols<D>();
  constexpr int G = dkv_group<D>();
#pragma unroll 1
  for (int i0 = 0; i0 < kTileBwd; i0 += G) {
    float s[G][2], dp[G], p[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g][0] = s[g][1] = dp[g] = 0.f;
#pragma unroll
    for (int i = 0; i < C / 4; ++i) {
#pragma unroll
      for (int g = 0; g < G; ++g)
        s[g][i % 2] = dot4(kr + 4 * i, tile_chunk<D>(qt, i0 + g, i, h), s[g][i % 2]);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      p[g] = ex2(fmaf(row_sum<D>(s[g][0] + s[g][1]), kLog2e, -(lt[i0 + g] * kLog2e)));
      if (kMask && i0 + g >= valid) p[g] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < C / 4; ++i) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 o = tile_chunk<D>(dot, i0 + g, i, h);
        axpy4(p[g], o, dv + 4 * i);
        dp[g] = dot4(vr + 4 * i, o, dp[g]);
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) p[g] *= row_sum<D>(dp[g]) - dt[i0 + g];  // dS
#pragma unroll
    for (int i = 0; i < C / 4; ++i) {
#pragma unroll
      for (int g = 0; g < G; ++g) axpy4(p[g], tile_chunk<D>(qt, i0 + g, i, h), dk + 4 * i);
    }
  }
}

template <int D>
__host__ __device__ constexpr int dkv_slot_floats() {
  return 2 * kTileBwd * D + 2 * kTileBwd;  // a Q and a dO tile, their lse and D
}

template <int D>
__global__ void __launch_bounds__(kThreadsBwd)
    flash_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, int n) {
  constexpr int C = cols<D>();
  extern __shared__ __align__(16) uint8_t smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);
  const size_t base = static_cast<size_t>(blockIdx.y) * n * D;
  const size_t rbase = static_cast<size_t>(blockIdx.y) * n;
  q += base;
  dout += base;
  lse += rbase;
  delta += rbase;
  const int row = blockIdx.x * rows_per_block<D>() + threadIdx.x / split<D>();
  const int h = threadIdx.x % split<D>();
  const bool live = row < n;

  float kr[C], vr[C], dka[C], dva[C];
  load_row<D>(k + base, row, live, h, kr);
  load_row<D>(v + base, row, live, h, vr);
#pragma unroll
  for (int c = 0; c < C; ++c) dka[c] = dva[c] = 0.f;

  constexpr int kSlot = dkv_slot_floats<D>();
  const int tiles = (n + kTileBwd - 1) / kTileBwd;
  auto load_slot = [&](int t) {
    float* slot = ring + (t % 2) * kSlot;
    load_rows_f32<D, kTileBwd, kThreadsBwd>(q, dout, t * kTileBwd, n, slot, slot + kTileBwd * D);
    load_stats(lse, delta, t * kTileBwd, n, slot + 2 * kTileBwd * D,
               slot + 2 * kTileBwd * D + kTileBwd);
    cp_async_commit();
  };
  load_slot(0);
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {
      load_slot(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* qt = ring + (t % 2) * kSlot;
    const float* lt = qt + 2 * kTileBwd * D;
    const int valid = n - t * kTileBwd;
    if (valid < kTileBwd)
      dkv_tile<D, true>(kr, vr, qt, qt + kTileBwd * D, lt, lt + kTileBwd, valid, h, dka, dva);
    else
      dkv_tile<D, false>(kr, vr, qt, qt + kTileBwd * D, lt, lt + kTileBwd, valid, h, dka, dva);
    __syncthreads();  // the slot is refilled by the next iteration's copy
  }
  if (live) {
    store_row<D>(dk + base, row, h, dka);
    store_row<D>(dv + base, row, h, dva);
  }
}

// ------------------------------------------------------------ launches

template <int D>
int launch_dq(const float* q, const float* k, const float* v, const float* dout, const float* lse,
              const float* delta, float* dq, int batch, int n, cudaStream_t stream) {
  static int set_for_device = -1;
  constexpr int bytes = 2 * 2 * kTileBwd * D * 4;
  const int rc = allow_smem(flash_bwd_dq_f32<D>, bytes, set_for_device);
  if (rc != 0) return rc;
  const dim3 grid((n + rows_per_block<D>() - 1) / rows_per_block<D>(), batch);
  flash_bwd_dq_f32<D><<<grid, kThreadsBwd, bytes, stream>>>(q, k, v, dout, lse, delta, dq, n);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const float* q, const float* k, const float* v, const float* dout, const float* lse,
               const float* delta, float* dk, float* dv, int batch, int n, cudaStream_t stream) {
  static int set_for_device = -1;
  constexpr int bytes = 2 * dkv_slot_floats<D>() * 4;
  const int rc = allow_smem(flash_bwd_dkv_f32<D>, bytes, set_for_device);
  if (rc != 0) return rc;
  const dim3 grid((n + rows_per_block<D>() - 1) / rows_per_block<D>(), batch);
  flash_bwd_dkv_f32<D><<<grid, kThreadsBwd, bytes, stream>>>(q, k, v, dout, lse, delta, dk, dv, n);
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
    case 8: return launch_dq<8>(qf, kf, vf, of, lf, df, out, batch, n, s);
    case 16: return launch_dq<16>(qf, kf, vf, of, lf, df, out, batch, n, s);
    case 32: return launch_dq<32>(qf, kf, vf, of, lf, df, out, batch, n, s);
    case 64: return launch_dq<64>(qf, kf, vf, of, lf, df, out, batch, n, s);
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
    case 8: return launch_dkv<8>(qf, kf, vf, of, lf, df, dkf, dvf, batch, n, s);
    case 16: return launch_dkv<16>(qf, kf, vf, of, lf, df, dkf, dvf, batch, n, s);
    case 32: return launch_dkv<32>(qf, kf, vf, of, lf, df, dkf, dvf, batch, n, s);
    case 64: return launch_dkv<64>(qf, kf, vf, of, lf, df, dkf, dvf, batch, n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Int8 flash-attention forward for the REFusion cross-attention, and its
// quantization pre-pass, Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel frn_tpu/ops/flash_attention.py::_flash_int8_kernel
// (launched by _flash_forward_int8, reached through flash_nonlocal_attention_int8
// when ModelConfig.attention_quant is set; inference only) and the wrapper's
// pre-pass `quantize` there. Per batch slice b, with s = max|x| over (N, d) (at
// least 1e-30) and xi = round(x * (127 / s)), ties to even, for Q, K and, in
// 'int8' mode, V, and the score scale c[b] = sq * sk / 127^2:
//
//     S = int32(Qi Ki^T) * c                          (f32, online softmax in f32)
//     'int8_qk': O = sum(bf16(p) V) / sum(bf16(p))     (V bf16, PV on bf16 MMA)
//     'int8':    p_q = round(127 p) (int8, p <= 1 against the running max),
//                O = bf16(bf16(sum(p_q Vi) / (127 sum(p_q))) * sv)   (PV on int8 MMA)
//
// Both denominators sum the weights the PV product used, as the TPU kernel's
// ones lane does. The running max moves in 64-key tiles (KERNEL_TILE in the
// Python wrapper), and mode 'int8''s function depends on that step.
//
// What bounds it on an H100: as the bf16 forward, the B*N^2 exponentials on
// the special-function units (about 3.9e12 exp/s); int8 MMA (1,979 TOPS dense)
// only halves the product term, which was already the smaller. Device memory
// is not the limit. What else each score costs is dispatch slots beside its
// MUFU.EX2: a conversion of the int32 score, the row max, the exponent's FFMA
// and, in mode 'int8', the rounding of 127 p and its byte.
//
// Pre-pass (two launches, frn_flash_int8_prepass): (a) int8_absmax_partial,
// kPartials blocks per batch slice and tensor, each a partial max|x| over its
// share of the slice (bf16 pairs compared as unsigned bits: |x| is x without
// its sign bit); (b) int8_quantize, one block per 64 rows of a slice, which
// reduces its slice's partials, writes qi and ki (IEEE 127 / s, a separate f32
// multiply, round half to even: bitwise the torch and JAX pre-passes), c and
// sv from block 0, and in mode 'int8' the quantized V transposed through
// shared memory straight into the kernel's (B, d, N_pad) layout: keys in the
// PV fragment order within each 32 (below), zero-padded to a whole tile.
//
// The kernel at d 32 and 64 (flash_int8_wgmma), B1's redesign
// (flash_attention.cu) with int8 operands: a block of one warpgroup owns 64
// query rows and loops over 64-key tiles; thread 0 stages the K and V tiles
// by TMA (per-launch 3-D tensor maps, rows past N zero-filled) into a ring of
// kStages slots, kAhead tiles ahead, completing on mbarriers. Each tile's
// two products are waited for before the tile ends: left in flight across
// the next tile's Q K^T, as in the bf16 forward, the P V product made ptxas
// serialize every wgmma of the kernel (C7515), which measured slower.
//  - Q K^T: wgmma m64n64k32 s8, Qi in registers (the m16n8k32 A fragment per
//    warp), the [64][d] int8 K tile K-major (d 32: 32-byte swizzle, d 64:
//    64-byte), s32 scores.
//  - The row max is taken on the int32 scores (c > 0, so c * max(s) =
//    max(c * s) bitwise) and converted once per row; each score converts
//    exactly on the integer and FMA pipes (|s| <= 64 * 127^2 < 2^22:
//    float(s) = bits(s + 0x4B400000) - 1.5 * 2^23), and p = ex2(s * c log2e -
//    m log2e), one FFMA. Keys past N are masked on the last ragged tile only.
//  - 'int8_qk': P V is B1's bf16 wgmma, V MN-major through the transpose bit;
//    the bf16 p are summed by the tensor core against a ones fragment.
//  - 'int8': 127 p comes out of the exponential itself (log2(127) added to
//    the exponent: no multiply), and round(127 p) is fadd_rn(127 p, 1.5 *
//    2^23), whose low byte is p_q; __byte_perm packs four, and the row sums
//    add the bit patterns. (p itself is ex2.approx's, never bitwise the plain
//    version's exp, so neither way of forming 127 p rounds its ties alike.)
//    P V is wgmma m64n{d}k32 s8 with p_q in registers and the pre-pass's
//    [d][64] V^T tile K-major (64-byte swizzle). The wgmma s8 A fragment is
//    m16n8k32's, which holds keys 4t..4t+3 and 16+4t..16+4t+3 of 32 where the
//    Q K^T accumulator holds keys 2t, 2t+1 of each 8: PV contracts over keys,
//    so P stays in the accumulator's order and V^T is written in it (slot s of
//    each 32 holds key 16(s/16) + 2(s%16/4) + s%2 + 8(s%4/2)). The int32 PV
//    sums and the p_q row sums accumulate across tiles and are added into the
//    f32 accumulator only when a row max of the block moves (times alpha) or
//    after kFlushTiles tiles (int32 range), not converted on every tile. The
//    flush is decided for the whole warpgroup (__syncthreads_or): ptxas turns
//    the zeroed sums into the next product's scale-d operand, which must be
//    the same for its four warps.
// d 8 and 16 (off the path; 8- and 16-byte int8 rows break TMA's 16-byte
// stride rule) keep the first mma.sync m16n8k32 kernel, flash_int8_mma, with
// all threads staging each tile synchronously; it reads the same pre-pass
// outputs.

#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "flash_sm90.cuh"

namespace {

using namespace flash;

constexpr int kPartials = 32;             // pre-pass: partial maxima per slice and tensor
constexpr int kMagic = 0x4B400000;        // the bits of 1.5 * 2^23
constexpr float kMagicF = 12582912.f;     // 1.5 * 2^23
constexpr int kFlushTiles = 1024;         // 1024 * 64 * 127^2 < 2^31
constexpr float kLog2_127 = 6.988684686772166f;
constexpr int kPad8 = 16;                 // mma.sync kernel: int8 row padding in bytes

__device__ __forceinline__ uint32_t warp_max_u32(uint32_t x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ int quad_max_i(int x) {
  x = max(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return max(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// the low bytes of a, b, c, d as bytes 0..3
__device__ __forceinline__ uint32_t pack_low_bytes(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// float(x), exact for |x| < 2^22, on the integer and FMA pipes
__device__ __forceinline__ float small_int_to_float(int x) {
  return __int_as_float(x + kMagic) - kMagicF;
}

__device__ __forceinline__ uint32_t load_u32(const int8_t* p, bool valid) {
  return valid ? *reinterpret_cast<const uint32_t*>(p) : 0u;
}

// ------------------------------------------------------------ the pre-pass

// (a) partial max|x| of batch slice blockIdx.y of q, k or v (blockIdx.z),
// written as f32 bits (non-negative floats order as their bits; a NaN is
// above infinity) to partial[z][b][blockIdx.x]
__global__ void __launch_bounds__(256)
int8_absmax_partial(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, uint32_t* __restrict__ partial, int n,
                    int d) {
  const int b = blockIdx.y, z = blockIdx.z;
  const __nv_bfloat16* x = z == 0 ? q : z == 1 ? k : v;
  const size_t chunks = static_cast<size_t>(n) * d / 8;  // 16 bytes each
  const uint4* src = reinterpret_cast<const uint4*>(x + static_cast<size_t>(b) * n * d);
  uint32_t m = 0;  // two |bf16| maxima as unsigned 16-bit halves
  for (size_t i = static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x; i < chunks;
       i += kPartials * 256) {
    const uint4 w = src[i];
    m = __vmaxu2(m, w.x & 0x7fff7fffu);
    m = __vmaxu2(m, w.y & 0x7fff7fffu);
    m = __vmaxu2(m, w.z & 0x7fff7fffu);
    m = __vmaxu2(m, w.w & 0x7fff7fffu);
  }
  m = warp_max_u32(max(m & 0xffffu, m >> 16) << 16);
  __shared__ uint32_t warp_m[8];
  if ((threadIdx.x & 31) == 0) warp_m[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < 8; ++w) m = max(m, warp_m[w]);
    partial[(static_cast<size_t>(z) * gridDim.y + b) * kPartials + blockIdx.x] = m;
  }
}

// called by one whole warp: max(max|x| of slice b of tensor z, 1e-30), as
// torch's clamp_min (a NaN stays NaN)
__device__ __forceinline__ float slice_scale(const uint32_t* __restrict__ partial, int z,
                                             int batch, int b) {
  static_assert(kPartials == 32, "one partial per lane");
  const uint32_t m = warp_max_u32(partial[(static_cast<size_t>(z) * batch + b) * kPartials +
                                          (threadIdx.x & 31)]);
  const float a = __uint_as_float(m);
  return a < 1e-30f ? 1e-30f : a;
}

// 8 bf16 -> 8 int8: round(x * inv), ties to even (inv = 127 / s)
__device__ __forceinline__ uint2 quantize8(uint4 x, float inv) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
  uint32_t r[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    r[2 * i] = static_cast<uint32_t>(__float2int_rn(__fmul_rn(bf16_lo(w[i]), inv)));
    r[2 * i + 1] = static_cast<uint32_t>(__float2int_rn(__fmul_rn(bf16_hi(w[i]), inv)));
  }
  return make_uint2(pack_low_bytes(r[0], r[1], r[2], r[3]), pack_low_bytes(r[4], r[5], r[6], r[7]));
}

// (b) rows [64 x, 64 x + 64) of batch slice y: qi, ki and (kFull) the V^T
// tile; block (0, y) also writes c and sv. 8 D threads: thread i quantizes
// 16-byte chunk i % (D / 8) of row i / (D / 8) of each tensor, then writes
// 8 bytes of the V^T tile, row i / 8.
template <int D, bool kFull>
__global__ void __launch_bounds__(8 * D)
int8_quantize(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, const uint32_t* __restrict__ partial,
              int8_t* __restrict__ qi, int8_t* __restrict__ ki, int8_t* __restrict__ vt,
              float* __restrict__ scale, float* __restrict__ v_scale, int n, int n_pad) {
  constexpr int C = D / 8;
  __shared__ float s[3];
  __shared__ __align__(16) int8_t vs[kFull ? D : 1][kTile + 8];  // [d][slot]
  const int b = blockIdx.y;
  if (threadIdx.x < 32) {
#pragma unroll
    for (int z = 0; z < (kFull ? 3 : 2); ++z) {
      const float sz = slice_scale(partial, z, gridDim.y, b);
      if (threadIdx.x == 0) s[z] = sz;
    }
  }
  __syncthreads();
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    scale[b] = __fmul_rn(__fmul_rn(s[0], s[1]), static_cast<float>(1.0 / (127.0 * 127.0)));
    if (kFull) v_scale[b] = s[2];
  }
  const int r = threadIdx.x / C, c = threadIdx.x % C;
  const int row = blockIdx.x * kTile + r;
  const size_t off = (static_cast<size_t>(b) * n + row) * D + c * 8;
  if (row < n) {
    *reinterpret_cast<uint2*>(qi + off) =
        quantize8(*reinterpret_cast<const uint4*>(q + off), 127.f / s[0]);
    *reinterpret_cast<uint2*>(ki + off) =
        quantize8(*reinterpret_cast<const uint4*>(k + off), 127.f / s[1]);
  }
  if constexpr (kFull) {
    uint2 x = make_uint2(0, 0);  // keys past n are zero
    if (row < n) x = quantize8(*reinterpret_cast<const uint4*>(v + off), 127.f / s[2]);
    // the slot of key r: the inverse of the PV key order within its 32
    const int slot = 32 * (r >> 5) + 16 * ((r >> 4) & 1) + 4 * ((r >> 1) & 3) +
                     2 * ((r >> 3) & 1) + (r & 1);
    const uint8_t* bytes = reinterpret_cast<const uint8_t*>(&x);
#pragma unroll
    for (int e = 0; e < 8; ++e) vs[c * 8 + e][slot] = static_cast<int8_t>(bytes[e]);
    __syncthreads();
    const int dim = threadIdx.x / 8, part = threadIdx.x % 8;
    *reinterpret_cast<uint2*>(vt + (static_cast<size_t>(b) * D + dim) * n_pad +
                              blockIdx.x * kTile + part * 8) =
        *reinterpret_cast<const uint2*>(&vs[dim][part * 8]);
  }
}

// ------------------------------------------------------------ mma.sync kernel (d 8, 16)

// c (16x8 s32) += a (16x32 s8, row-major) * b (32x8 s8, column-major)
__device__ __forceinline__ void mma_16832_s8(int c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_s8x4(int a, int b, int c, int d) {
  return (static_cast<uint32_t>(a) & 0xffu) | ((static_cast<uint32_t>(b) & 0xffu) << 8) |
         ((static_cast<uint32_t>(c) & 0xffu) << 16) | (static_cast<uint32_t>(d) << 24);
}

// Stage rows [r0, r0 + kTile) of a (n, D) int8 matrix into a shared tile;
// rows past n are 0. 16-byte chunks (8-byte for D = 8).
template <int D>
__device__ __forceinline__ void stage_rows_s8(int r0, int n, const int8_t* __restrict__ a,
                                              int8_t (*rows)[D + kPad8]) {
  if constexpr (D >= 16) {
    constexpr int kChunks = D / 16;
    for (int i = threadIdx.x; i < kTile * kChunks; i += kWarps * 32) {
      const int r = i / kChunks;
      const int c = (i % kChunks) * 16;
      uint4 x = make_uint4(0, 0, 0, 0);
      if (r0 + r < n) x = *reinterpret_cast<const uint4*>(a + static_cast<size_t>(r0 + r) * D + c);
      *reinterpret_cast<uint4*>(&rows[r][c]) = x;
    }
  } else {
    for (int r = threadIdx.x; r < kTile; r += kWarps * 32) {
      uint2 x = make_uint2(0, 0);
      if (r0 + r < n) x = *reinterpret_cast<const uint2*>(a + static_cast<size_t>(r0 + r) * D);
      *reinterpret_cast<uint2*>(&rows[r][0]) = x;
    }
  }
}

template <int D, bool kFull>
__global__ void __launch_bounds__(kWarps * 32)
flash_int8_mma(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
               const void* __restrict__ v, const float* __restrict__ scale,
               const float* __restrict__ v_scale, __nv_bfloat16* __restrict__ o, int n,
               int n_pad) {
  static_assert(D == 8 || D == 16, "the mma.sync int8 kernel takes head dims 8 and 16");
  using VT = std::conditional_t<kFull, int8_t, __nv_bfloat16>;
  constexpr int kVPad = kFull ? kPad8 : kPad;
  __shared__ __align__(16) int8_t k_tile[kTile][D + kPad8];  // [key][d]
  __shared__ __align__(16) VT vt_tile[D][kTile + kVPad];     // [d][key]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int batch = blockIdx.y;
  const size_t base = static_cast<size_t>(batch) * n * D;
  const int row0 = blockIdx.x * kRows + warp * 16 + g;  // rows row0 and row0 + 8
  const int row1 = row0 + 8;
  const bool ok0 = row0 < n, ok1 = row1 < n;
  const float c = scale[batch];

  // Q as one m16n8k32 A fragment; rows past n and columns past D read as zeros
  uint32_t qa[4];
  {
    const int8_t* q0 = q + base + static_cast<size_t>(ok0 ? row0 : 0) * D;
    const int8_t* q1 = q + base + static_cast<size_t>(ok1 ? row1 : 0) * D;
    const int lo = 4 * t, hi = lo + 16;
    qa[0] = load_u32(q0 + lo, ok0 && lo < D);
    qa[1] = load_u32(q1 + lo, ok1 && lo < D);
    qa[2] = load_u32(q0 + hi, ok0 && hi < D);
    qa[3] = load_u32(q1 + hi, ok1 && hi < D);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running row max (rows row0, row1)
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the denominators

  for (int kt = 0; kt < n; kt += kTile) {
    __syncthreads();  // the previous tile has been read by every warp
    stage_rows_s8<D>(kt, n, k + base, k_tile);
    if constexpr (kFull) {
      // int8 V^T, (B, D, n_pad), already in the PV key order and zero-padded
      const int8_t* vt = static_cast<const int8_t*>(v) + static_cast<size_t>(batch) * D * n_pad;
      for (int i = threadIdx.x; i < D * (kTile / 16); i += kWarps * 32) {
        const int d = i / (kTile / 16);
        const int col = (i % (kTile / 16)) * 16;
        *reinterpret_cast<uint4*>(&vt_tile[d][col]) =
            *reinterpret_cast<const uint4*>(vt + static_cast<size_t>(d) * n_pad + kt + col);
      }
    } else {
      stage_tile<D>(kt, n, static_cast<const __nv_bfloat16*>(v) + base, nullptr, vt_tile);
    }
    __syncthreads();

    // S = (Qi Ki^T) * c for this warp's 16 rows: kTile / 8 tiles of 16x8
    float s[kTile / 8][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      int si[4] = {0, 0, 0, 0};
      const int8_t* krow = k_tile[nt * 8 + g];
      const int lo = 4 * t, hi = lo + 16;
      const uint32_t b[2] = {load_u32(krow + lo, lo < D), load_u32(krow + hi, hi < D)};
      mma_16832_s8(si, qa, b);
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = static_cast<float>(si[e]) * c;
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
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= alpha0;
      acc[j][1] *= alpha0;
      acc[j][2] *= alpha1;
      acc[j][3] *= alpha1;
    }

    if constexpr (kFull) {
      // p_q = round(127 p) in [0, 127], kept in the C order: A fragment kk of
      // the 32 keys of tiles 4kk..4kk+3 (see the key order above)
      uint32_t pa[kTile / 32][4];
      int rs0 = 0, rs1 = 0;
#pragma unroll
      for (int kk = 0; kk < kTile / 32; ++kk) {
        int pq[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int nt = 4 * kk + u;
          pq[u][0] = __float2int_rn(__expf(s[nt][0] - mx0) * 127.f);
          pq[u][1] = __float2int_rn(__expf(s[nt][1] - mx0) * 127.f);
          pq[u][2] = __float2int_rn(__expf(s[nt][2] - mx1) * 127.f);
          pq[u][3] = __float2int_rn(__expf(s[nt][3] - mx1) * 127.f);
          rs0 += pq[u][0] + pq[u][1];
          rs1 += pq[u][2] + pq[u][3];
        }
        pa[kk][0] = pack_s8x4(pq[0][0], pq[0][1], pq[1][0], pq[1][1]);
        pa[kk][1] = pack_s8x4(pq[0][2], pq[0][3], pq[1][2], pq[1][3]);
        pa[kk][2] = pack_s8x4(pq[2][0], pq[2][1], pq[3][0], pq[3][1]);
        pa[kk][3] = pack_s8x4(pq[2][2], pq[2][3], pq[3][2], pq[3][3]);
      }
      l0 = l0 * alpha0 + static_cast<float>(127 * rs0);
      l1 = l1 * alpha1 + static_cast<float>(127 * rs1);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        int pv[4] = {0, 0, 0, 0};
        const int8_t* vrow = vt_tile[j * 8 + g];
#pragma unroll
        for (int kk = 0; kk < kTile / 32; ++kk) {
          const uint32_t b[2] = {*reinterpret_cast<const uint32_t*>(vrow + kk * 32 + 4 * t),
                                 *reinterpret_cast<const uint32_t*>(vrow + kk * 32 + 16 + 4 * t)};
          mma_16832_s8(pv, pa[kk], b);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += static_cast<float>(pv[e]);
      }
    } else {
      // p rounded to bf16 feeds both the PV product and the denominator
      uint32_t pa[kTile / 16][4];
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt) {
        const float p0 = round_bf16(__expf(s[nt][0] - mx0));
        const float p1 = round_bf16(__expf(s[nt][1] - mx0));
        const float p2 = round_bf16(__expf(s[nt][2] - mx1));
        const float p3 = round_bf16(__expf(s[nt][3] - mx1));
        rs0 += p0 + p1;
        rs1 += p2 + p3;
        to_a_frag(pa, nt, p0, p1, p2, p3);
      }
      l0 = l0 * alpha0 + rs0;
      l1 = l1 * alpha1 + rs1;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk) {
          uint32_t b[2];
          b_from_cols(b, vt_tile[j * 8 + g], kk, t);
          mma_16816(acc[j], pa[kk], b);
        }
      }
    }
  }

  // O = bf16(acc / l); in 'int8' mode then bf16(O * sv), as the JAX wrapper
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float sv = kFull ? v_scale[batch] : 1.f;
  __nv_bfloat16* out = o + base;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + 2 * t;
    __nv_bfloat162 y0 = __floats2bfloat162_rn(acc[j][0] / l0, acc[j][1] / l0);
    __nv_bfloat162 y1 = __floats2bfloat162_rn(acc[j][2] / l1, acc[j][3] / l1);
    if constexpr (kFull) {
      y0 = __floats2bfloat162_rn(__low2float(y0) * sv, __high2float(y0) * sv);
      y1 = __floats2bfloat162_rn(__low2float(y1) * sv, __high2float(y1) * sv);
    }
    if (ok0) *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(row0) * D + col) = y0;
    if (ok1) *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(row1) * D + col) = y1;
  }
}

// ------------------------------------------------------------ wgmma kernel (d 32, 64)

// bytes of a ring slot: the [kTile][D] int8 K tile, then the V tile, [kTile][D]
// bf16 in 'int8_qk' mode or the [D][kTile] int8 V^T tile in 'int8'
template <int D, bool kFull>
__host__ __device__ constexpr int slot_bytes() {
  return kTile * D + (kFull ? 1 : 2) * kTile * D;
}

template <int D, bool kFull>
constexpr int int8_ring_bytes() {
  return kStages * slot_bytes<D, kFull>() + 1024;
}

// One thread stages tile `tile` (K, then V or V^T) into its ring slot by TMA
template <int D, bool kFull>
__device__ __forceinline__ void stage_kv(const CUtensorMap* kmap, const CUtensorMap* vmap, int tile,
                                         uint8_t* ring, uint64_t* ready) {
  uint8_t* slot = ring + (tile % kStages) * slot_bytes<D, kFull>();
  uint64_t* bar = ready + tile % kStages;
  mbar_expect_tx(bar, slot_bytes<D, kFull>());
  tma_load_3d(slot, kmap, 0, tile * kTile, blockIdx.y, bar);
  if constexpr (kFull) {
    tma_load_3d(slot + kTile * D, vmap, tile * kTile, 0, blockIdx.y, bar);  // keys along rows
  } else {
    tma_load_3d(slot + kTile * D, vmap, 0, tile * kTile, blockIdx.y, bar);
  }
}

// The row max of this thread's rows g and g + 8 over a tile of int32 scores
// (s[nt][0..1] row g, s[nt][2..3] row g + 8, keys key + nt * 8 + {0, 1});
// with kMask, keys past n become INT_MIN. Updates m (f32, c times the int
// max), returns alpha = exp(m_old - m) and mb = m * log2(e).
template <bool kMask>
__device__ __forceinline__ void tile_max(int (&s)[kTile / 8][4], int key, int n, float c,
                                         float (&m)[2], float (&alpha)[2], float (&mb)[2]) {
  int mi[2] = {INT_MIN, INT_MIN};
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt) {
    if constexpr (kMask) {
      if (key + nt * 8 >= n) s[nt][0] = s[nt][2] = INT_MIN;
      if (key + nt * 8 + 1 >= n) s[nt][1] = s[nt][3] = INT_MIN;
    }
    mi[0] = max(mi[0], max(s[nt][0], s[nt][1]));
    mi[1] = max(mi[1], max(s[nt][2], s[nt][3]));
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    // every tile holds a valid key; c > 0, so c * max(s) is the max of c * s
    const float mx = fmaxf(m[i], c * static_cast<float>(quad_max_i(mi[i])));
    alpha[i] = ex2((m[i] - mx) * kLog2e);  // 0 on the first tile (m = -inf)
    m[i] = mx;
    mb[i] = mx * kLog2e;
  }
}

// p = exp(c s - m) as ex2(s * c log2(e) - m log2(e)); 0 for a masked key
template <bool kMask>
__device__ __forceinline__ float score_exp(int s, float cl2, float mb) {
  const float x = fmaf(small_int_to_float(s), cl2, -mb);
  return ex2(kMask && s == INT_MIN ? -INFINITY : x);
}

// 'int8_qk': the bf16 p as the A fragments of the bf16 PV product, and l
// (whole rows) = l * alpha + the sum of those p, on the tensor core
template <bool kMask>
__device__ __forceinline__ void softmax_qk(int (&s)[kTile / 8][4], int key, int n, float c,
                                           float (&m)[2], float (&l)[2], float (&alpha)[2],
                                           uint32_t (&pa)[kTile / 16][4]) {
  float mb[2];
  tile_max<kMask>(s, key, n, c, m, alpha, mb);
  const float cl2 = c * kLog2e;
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // h = 0: row g, h = 1: row g + 8
      pa[nt / 2][(nt % 2) * 2 + h] = pack_bf16x2(score_exp<kMask>(s[nt][2 * h], cl2, mb[h]),
                                                 score_exp<kMask>(s[nt][2 * h + 1], cl2, mb[h]));
    }
  }
  float sums[4] = {l[0] * alpha[0], 0.f, l[1] * alpha[1], 0.f};  // c0: row g, c2: row g + 8
  const uint32_t ones[2] = {0x3f803f80u, 0x3f803f80u};           // bf16 1.0 pairs
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) mma_16816(sums, pa[kk], ones);
  l[0] = sums[0];
  l[1] = sums[2];
}

// 'int8': p_q = round(127 p) packed as the s8 A fragments of the PV product
// (fragment kk: the keys of score tiles 4kk..4kk+3 in the accumulator's
// order), and this thread's share of each row's sum of p_q in rs. 127 p is
// ex2 of the exponent plus log2(127), one FFMA and one MUFU.EX2 as for p.
template <bool kMask>
__device__ __forceinline__ void softmax_full(int (&s)[kTile / 8][4], int key, int n, float c,
                                             float (&m)[2], float (&alpha)[2],
                                             uint32_t (&pa)[kTile / 32][4], uint32_t (&rs)[2]) {
  float mb[2];
  tile_max<kMask>(s, key, n, c, m, alpha, mb);
  const float cl2 = c * kLog2e;
  const float mq[2] = {mb[0] - kLog2_127, mb[1] - kLog2_127};
  uint32_t bits[kTile / 8][4];  // 1.5 * 2^23 + p_q, as f32 bits
  rs[0] = rs[1] = 0u;
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p127 = score_exp<kMask>(s[nt][e], cl2, mq[e / 2]);  // at most 127.5
      bits[nt][e] = __float_as_uint(__fadd_rn(p127, kMagicF));
      rs[e / 2] += bits[nt][e];  // modulo 2^32
    }
  }
  rs[0] -= static_cast<uint32_t>(kTile / 4) * static_cast<uint32_t>(kMagic);
  rs[1] -= static_cast<uint32_t>(kTile / 4) * static_cast<uint32_t>(kMagic);
#pragma unroll
  for (int kk = 0; kk < kTile / 32; ++kk) {
    const int nt = 4 * kk;
    pa[kk][0] = pack_low_bytes(bits[nt][0], bits[nt][1], bits[nt + 1][0], bits[nt + 1][1]);
    pa[kk][1] = pack_low_bytes(bits[nt][2], bits[nt][3], bits[nt + 1][2], bits[nt + 1][3]);
    pa[kk][2] = pack_low_bytes(bits[nt + 2][0], bits[nt + 2][1], bits[nt + 3][0], bits[nt + 3][1]);
    pa[kk][3] = pack_low_bytes(bits[nt + 2][2], bits[nt + 2][3], bits[nt + 3][2], bits[nt + 3][3]);
  }
}

// acc rows times alpha; skipped when no row max of the warp moved (exact)
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

// 'int8': acc (f32) = (acc + acc_i) * alpha, l = (l + 127 l_i) * alpha, and
// the int32 sums restart at 0
template <int J>
__device__ __forceinline__ void flush(float (&acc)[J][4], int (&acc_i)[J][4], float (&l)[2],
                                      uint32_t (&l_i)[2], const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[j][e] = (acc[j][e] + static_cast<float>(acc_i[j][e])) * alpha[e / 2];
      acc_i[j][e] = 0;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = (l[i] + 127.f * static_cast<float>(l_i[i])) * alpha[i];
    l_i[i] = 0u;
  }
}

template <int J>
__device__ __forceinline__ void fence_acc(float (&acc)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) fence_reg(acc[j][i]);
  }
}

template <int J>
__device__ __forceinline__ void fence_acc(int (&acc)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) fence_reg(acc[j][i]);
  }
}

// One warpgroup of 64 query rows per block; kmap: the int8 K map, vmap: the
// bf16 V map ('int8_qk') or the int8 V^T map ('int8')
template <int D, bool kFull, int kMinBlocks>
__global__ void __launch_bounds__(128, kMinBlocks)
flash_int8_wgmma(const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
                 const int8_t* __restrict__ q, const float* __restrict__ scale,
                 const float* __restrict__ v_scale, __nv_bfloat16* __restrict__ o, int n) {
  static_assert(D == 32 || D == 64, "the wgmma int8 forward takes head dims 32 and 64");
  constexpr int KD = D / 32;  // s8 steps of Q K^T
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(ring_base(smem_raw));
  __shared__ uint64_t ready[kStages];  // ring slot s holds its next tile

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t base = static_cast<size_t>(blockIdx.y) * n * D;
  const int row0 = blockIdx.x * 64 + warp * 16 + g;  // rows row0 and row0 + 8
  const int row1 = row0 + 8;
  const bool ok0 = row0 < n, ok1 = row1 < n;
  const int tiles = (n + kTile - 1) / kTile;
  const bool ragged = n % kTile != 0;
  const float c = scale[blockIdx.y];

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) mbar_init(&ready[s], 1);
    fence_mbar_init();
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      if (j < tiles) stage_kv<D, kFull>(&kmap, &vmap, j, ring, ready);
    }
  }
  uint32_t qa[KD][4];  // rows past n read as zeros
  {
    const int8_t* q0 = q + base + static_cast<size_t>(ok0 ? row0 : 0) * D;
    const int8_t* q1 = q + base + static_cast<size_t>(ok1 ? row1 : 0) * D;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const int lo = kk * 32 + 4 * t, hi = lo + 16;
      qa[kk][0] = load_u32(q0 + lo, ok0);
      qa[kk][1] = load_u32(q1 + lo, ok1);
      qa[kk][2] = load_u32(q0 + hi, ok0);
      qa[kk][3] = load_u32(q1 + hi, ok1);
    }
  }
  float acc[D / 8][4];
  int acc_i[D / 8][4];  // 'int8': the PV sums since the last flush
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[j][e] = 0.f;
      acc_i[j][e] = 0;
    }
  }
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  uint32_t l_i[2] = {0u, 0u};  // 'int8': this thread's p_q sums since the last flush

  for (int j = 0; j < tiles; ++j) {
    __syncthreads();  // the barriers are set up; every warpgroup has waited for PV of tile j - 1
    if (threadIdx.x == 0 && j + kAhead < tiles) {
      stage_kv<D, kFull>(&kmap, &vmap, j + kAhead, ring, ready);  // into tile j - 2's slot
    }
    mbar_wait(&ready[j % kStages], (j / kStages) & 1);
    const uint8_t* kt = ring + (j % kStages) * slot_bytes<D, kFull>();

    int s[kTile / 8][4];
    const uint64_t kdesc = swizzled_desc<D>(kt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      wgmma_m64n64k32_s8(s, qa[kk], kdesc + 2 * kk, kk);  // 32 bytes on along d
    }
    wgmma_commit();
    wgmma_wait<0>();  // S of tile j
    fence_acc(s);
    fence_acc(acc);
    if constexpr (kFull) fence_acc(acc_i);

    const int key = j * kTile + 2 * t;
    const bool mask = ragged && j == tiles - 1;
    float alpha[2];
    if constexpr (kFull) {
      uint32_t pa[kTile / 32][4], rs[2];
      if (mask) {
        softmax_full<true>(s, key, n, c, m, alpha, pa, rs);
      } else {
        softmax_full<false>(s, key, n, c, m, alpha, pa, rs);
      }
      // the whole warpgroup (the block) flushes or none of it: the zeroed
      // int32 sums may become the products' scale-d operand, one for all
      // four warps
      if (__syncthreads_or(alpha[0] != 1.f || alpha[1] != 1.f ||
                           j % kFlushTiles == kFlushTiles - 1)) {
        flush(acc, acc_i, l, l_i, alpha);
      }
      l_i[0] += rs[0];
      l_i[1] += rs[1];
      const uint64_t vdesc = swizzled_desc<kTile>(kt + kTile * D);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTile / 32; ++kk) {
        wgmma_m64k32_s8<D / 8>(acc_i, pa[kk], vdesc + 2 * kk, 1);  // 32 keys on
      }
      wgmma_commit();
      wgmma_wait<0>();  // see the design note: in flight across Q K^T, ptxas serializes
    } else {
      uint32_t pa[kTile / 16][4];
      if (mask) {
        softmax_qk<true>(s, key, n, c, m, l, alpha, pa);
      } else {
        softmax_qk<false>(s, key, n, c, m, l, alpha, pa);
      }
      rescale(acc, alpha);
      const uint64_t vdesc =
          tile_desc<D>(reinterpret_cast<const __nv_bfloat16*>(kt + kTile * D));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        wgmma_m64k16<1>(acc, pa[kk], vdesc + ((16 * 2 * D) >> 4) * kk, 1);  // 16 keys on
      }
      wgmma_commit();
      wgmma_wait<0>();
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);
  float l0 = l[0], l1 = l[1];
  if constexpr (kFull) {
    fence_acc(acc_i);
    const float one[2] = {1.f, 1.f};
    flush(acc, acc_i, l, l_i, one);
    l0 = quad_sum(l[0]);
    l1 = quad_sum(l[1]);
  }

  // O = bf16(acc / l); in 'int8' mode then bf16(O * sv), as the JAX wrapper
  const float sv = kFull ? v_scale[blockIdx.y] : 1.f;
  __nv_bfloat16* out = o + base;
#pragma unroll
  for (int jd = 0; jd < D / 8; ++jd) {
    const int col = jd * 8 + 2 * t;
    __nv_bfloat162 y0 = __floats2bfloat162_rn(acc[jd][0] / l0, acc[jd][1] / l0);
    __nv_bfloat162 y1 = __floats2bfloat162_rn(acc[jd][2] / l1, acc[jd][3] / l1);
    if constexpr (kFull) {
      y0 = __floats2bfloat162_rn(__low2float(y0) * sv, __high2float(y0) * sv);
      y1 = __floats2bfloat162_rn(__low2float(y1) * sv, __high2float(y1) * sv);
    }
    if (ok0) *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(row0) * D + col) = y0;
    if (ok1) *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(row1) * D + col) = y1;
  }
}

// ------------------------------------------------------------ launch

struct Args {
  const int8_t *q, *k;
  const void* v;
  const float *scale, *v_scale;
  __nv_bfloat16* o;
  int batch, n, n_pad;
  cudaStream_t stream;
};

template <int D, bool kFull>
int launch_mma(const Args& a) {
  const dim3 grid((a.n + kRows - 1) / kRows, a.batch);
  flash_int8_mma<D, kFull>
      <<<grid, kWarps * 32, 0, a.stream>>>(a.q, a.k, a.v, a.scale, a.v_scale, a.o, a.n, a.n_pad);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kFull, int kMinBlocks>
int launch_wgmma(const Args& a) {
  static int set_for_device = -1;
  constexpr int kSmem = int8_ring_bytes<D, kFull>();
  int rc = allow_smem(flash_int8_wgmma<D, kFull, kMinBlocks>, kSmem, set_for_device);
  CUtensorMap kmap, vmap;
  if (rc == 0) {
    rc = encode_map<D>(&kmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a.k, a.batch, a.n, D, kTile);
  }
  if (rc == 0) {
    rc = kFull ? encode_map<kTile>(&vmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a.v, a.batch, D,
                                   a.n_pad, D)
               : encode_tile_map<D>(&vmap, a.v, a.batch, a.n);
  }
  if (rc != 0) return rc;
  const dim3 grid((a.n + 63) / 64, a.batch);
  flash_int8_wgmma<D, kFull, kMinBlocks><<<grid, 128, kSmem, a.stream>>>(
      kmap, vmap, a.q, a.scale, a.v_scale, a.o, a.n);
  return static_cast<int>(cudaGetLastError());
}

// One warpgroup of 64 rows per block, four blocks per SM at d 32 and three at
// d 64, by measurement on the H100 (PERF.md: two warpgroups per block at d 64,
// as the bf16 forward, ran 4-5% slower)
template <bool kFull>
int launch_d(int d, const Args& a) {
  switch (d) {
    case 8: return launch_mma<8, kFull>(a);
    case 16: return launch_mma<16, kFull>(a);
    case 32: return launch_wgmma<32, kFull, 4>(a);
    case 64: return launch_wgmma<64, kFull, 3>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int D, bool kFull>
void launch_quantize(dim3 grid, cudaStream_t s, const void* q, const void* k, const void* v,
                     const uint32_t* partial, void* qi, void* ki, void* vt, void* scale,
                     void* v_scale, int n, int n_pad) {
  int8_quantize<D, kFull><<<grid, 8 * D, 0, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), partial, static_cast<int8_t*>(qi),
      static_cast<int8_t*>(ki), static_cast<int8_t*>(vt), static_cast<float*>(scale),
      static_cast<float*>(v_scale), n, n_pad);
}

template <int D>
void launch_quantize_mode(bool full, dim3 grid, cudaStream_t s, const void* q, const void* k,
                          const void* v, const uint32_t* partial, void* qi, void* ki, void* vt,
                          void* scale, void* v_scale, int n, int n_pad) {
  if (full) {
    launch_quantize<D, true>(grid, s, q, k, v, partial, qi, ki, vt, scale, v_scale, n, n_pad);
  } else {
    launch_quantize<D, false>(grid, s, q, k, v, partial, qi, ki, vt, scale, v_scale, n, n_pad);
  }
}

}  // namespace

// Plain C entry points, bound with ctypes. Each launches on `stream` and
// returns the cudaGetLastError() code of its launches (0 on success).
// Pointers are 16-byte aligned and contiguous, checked by the Python wrapper.
//
// The pre-pass: q, k, v bf16 (B, N, d); partial: u32 scratch (2 or 3, B, 32);
// qi, ki: int8 (B, N, d); scale: f32 (B,) sq * sk / 127^2. With full ('int8'
// mode) also vt: int8 (B, d, n_pad) in the kernel's key order, n_pad the
// multiple of 64 at or above N, and v_scale: f32 (B,) sv; else both null.
extern "C" int frn_flash_int8_prepass(const void* q, const void* k, const void* v, void* partial,
                                      void* qi, void* ki, void* vt, void* scale, void* v_scale,
                                      int batch, int n, int n_pad, int d, int full, void* stream) {
  if (batch <= 0 || n <= 0 || batch > 65535 || n_pad < n || n_pad % kTile != 0 ||
      (full && (vt == nullptr || v_scale == nullptr)) || (d != 8 && d != 16 && d != 32 && d != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* part = static_cast<uint32_t*>(partial);
  int8_absmax_partial<<<dim3(kPartials, batch, full ? 3 : 2), 256, 0, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), part, n, d);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const dim3 grid(n_pad / kTile, batch);
  switch (d) {
    case 8: launch_quantize_mode<8>(full, grid, s, q, k, v, part, qi, ki, vt, scale, v_scale, n, n_pad); break;
    case 16: launch_quantize_mode<16>(full, grid, s, q, k, v, part, qi, ki, vt, scale, v_scale, n, n_pad); break;
    case 32: launch_quantize_mode<32>(full, grid, s, q, k, v, part, qi, ki, vt, scale, v_scale, n, n_pad); break;
    default: launch_quantize_mode<64>(full, grid, s, q, k, v, part, qi, ki, vt, scale, v_scale, n, n_pad); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// The kernel: q, k int8 (B, N, d) row-major; v bf16 (B, N, d) when full == 0
// ('int8_qk'), else int8 (B, d, n_pad) in the kernel's key order (n_pad a
// multiple of 64); scale: f32 (B,) sq * sk / 127^2; v_scale: f32 (B,) sv when
// full, else null; o: bf16 (B, N, d).
extern "C" int frn_flash_int8(const void* q, const void* k, const void* v, const void* scale,
                              const void* v_scale, void* o, int batch, int n, int n_pad, int d,
                              int full, void* stream) {
  if (batch <= 0 || n <= 0 || batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (full && (n_pad < n || n_pad % kTile != 0 || v_scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const int8_t*>(q), static_cast<const int8_t*>(k), v,
               static_cast<const float*>(scale), static_cast<const float*>(v_scale),
               static_cast<__nv_bfloat16*>(o), batch, n, n_pad, static_cast<cudaStream_t>(stream)};
  return full ? launch_d<true>(d, a) : launch_d<false>(d, a);
}

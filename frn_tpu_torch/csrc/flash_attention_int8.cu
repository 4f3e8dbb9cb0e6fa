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
// and, in mode 'int8', the rounding of 127 p and its byte. No score takes a
// second special-function instruction (I2F, F2I): both kernels convert by
// the magic add and round by an FADD.
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
// The kernel at d 8 and 16 (flash_int8_ring; the depth-18 and -34 paths; 8-
// and 16-byte int8 rows break TMA's 16-byte stride rule, not cp.async's)
// follows the bf16 forward's mma.sync kernel (flash_attention.cu,
// flash_fwd_mma) and reuses the score helpers above: a block of ring_warps (4)
// warps owns ring_rows (64) query rows, each warp ring_row_tiles (1) 16-row
// tiles with Qi as m16n8k16 A fragments in registers, 4 blocks an SM; all
// threads stage the 64-key tiles
// by cp.async into a ring of kStages slots, kAhead tiles ahead, one
// __syncthreads a tile: K a key a copy (8 bytes at d 8, into rows padded to
// 16), V bf16 into pv_mma's swizzled tile, or the pre-pass's V^T slice, keys
// past N zero-filled.
//  - Q K^T: mma.sync m16n8k16 s8 (at d 16 exact, at d 8 the upper half of
//    Q's fragment zero), K's B fragments by ldmatrix, each serving the warp's
//    tiles. The accumulator starts at kMagic, so a score comes out as the
//    bits of the float 1.5 * 2^23 + s: the helpers' row max on the int32
//    scores, then float(s) one FADD, the exponent one FFMA, p one MUFU.EX2.
//  - 'int8_qk': the helpers' bf16 pack and tensor-core row sums; P V is
//    m16n8k16 bf16 with V fragments by ldmatrix.trans (pv_mma).
//  - 'int8': p_q by the helpers' FADD rounding and byte packing, in the PV
//    key order; P V is m16n8k32 s8 with V^T fragments by ldmatrix, and the
//    row sums of p_q are P times a ones fragment on the tensor core. Both
//    int32 sums are flushed into f32 as in the wgmma kernel, decided per
//    warp: mma.sync takes each thread's own accumulator.
//  - Only the last, ragged tile masks keys past N (by a select, INT_MIN).

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

// ------------------------------------------------------------ the ring slots (both kernels)

// bytes of a K row in a ring slot: d 8 rows are padded to 16, so that one
// ldmatrix reads 8 keys as an 8x8 b16 matrix (the ring kernel)
template <int D>
__host__ __device__ constexpr int k_row_bytes() {
  return D < 16 ? 16 : D;
}

// bytes of a ring slot: the [kTile][k_row_bytes] int8 K tile, then the V
// tile, [kTile][D] bf16 in 'int8_qk' mode or the [D][kTile] int8 V^T tile in
// 'int8'
template <int D, bool kFull>
__host__ __device__ constexpr int slot_bytes() {
  return kTile * k_row_bytes<D>() + (kFull ? 1 : 2) * kTile * D;
}

template <int D, bool kFull>
constexpr int int8_ring_bytes() {
  return kStages * slot_bytes<D, kFull>() + 1024;
}

// One thread stages tile `tile` (K, then V or V^T) into its ring slot by TMA
// (the wgmma kernel)
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

// ------------------------------------------------------------ a score tile's softmax (both kernels)

// The helpers below take a warp's 16 x 64 int32 scores as C fragments
// (s[nt][0..1] row g, s[nt][2..3] row g + 8, keys key + nt * 8 + {0, 1}).
// With kBiased (the ring kernel) each holds s + kMagic, the bits of the float
// 1.5 * 2^23 + s (exact: |s| < 2^22), its product's accumulator having
// started at kMagic: the conversion to float is one FADD, no IADD.

// float(s) of a score as the helpers hold it (exact)
template <bool kBiased>
__device__ __forceinline__ float score_float(int s) {
  return kBiased ? __int_as_float(s) - kMagicF : small_int_to_float(s);
}

// The row max of this thread's rows g and g + 8 over a tile of int32 scores;
// with kMask, keys past n become INT_MIN (below every score, biased or not).
// Updates m (f32, c times the int max), returns alpha = exp(m_old - m) and
// mb = m * log2(e).
template <bool kMask, bool kBiased>
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
    const int top = quad_max_i(mi[i]);
    const float mx = fmaxf(m[i], c * (kBiased ? score_float<true>(top) : static_cast<float>(top)));
    alpha[i] = ex2((m[i] - mx) * kLog2e);  // 0 on the first tile (m = -inf)
    m[i] = mx;
    mb[i] = mx * kLog2e;
  }
}

// p = exp(c s - m) as ex2(s * c log2(e) - m log2(e)); 0 for a masked key
template <bool kMask, bool kBiased>
__device__ __forceinline__ float score_exp(int s, float cl2, float mb) {
  const float x = fmaf(score_float<kBiased>(s), cl2, -mb);
  return ex2(kMask && s == INT_MIN ? -INFINITY : x);
}

// 'int8_qk': the bf16 p as the A fragments of the bf16 PV product, and l
// (whole rows) = l * alpha + the sum of those p, on the tensor core
template <bool kMask, bool kBiased>
__device__ __forceinline__ void softmax_qk(int (&s)[kTile / 8][4], int key, int n, float c,
                                           float (&m)[2], float (&l)[2], float (&alpha)[2],
                                           uint32_t (&pa)[kTile / 16][4]) {
  float mb[2];
  tile_max<kMask, kBiased>(s, key, n, c, m, alpha, mb);
  const float cl2 = c * kLog2e;
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // h = 0: row g, h = 1: row g + 8
      pa[nt / 2][(nt % 2) * 2 + h] =
          pack_bf16x2(score_exp<kMask, kBiased>(s[nt][2 * h], cl2, mb[h]),
                      score_exp<kMask, kBiased>(s[nt][2 * h + 1], cl2, mb[h]));
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
// With kBiased rs is left alone: the ring kernel sums p_q on the tensor core.
template <bool kMask, bool kBiased>
__device__ __forceinline__ void softmax_full(int (&s)[kTile / 8][4], int key, int n, float c,
                                             float (&m)[2], float (&alpha)[2],
                                             uint32_t (&pa)[kTile / 32][4], uint32_t (&rs)[2]) {
  float mb[2];
  tile_max<kMask, kBiased>(s, key, n, c, m, alpha, mb);
  const float cl2 = c * kLog2e;
  const float mq[2] = {mb[0] - kLog2_127, mb[1] - kLog2_127};
  uint32_t bits[kTile / 8][4];  // 1.5 * 2^23 + p_q, as f32 bits
  if constexpr (!kBiased) rs[0] = rs[1] = 0u;
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p127 = score_exp<kMask, kBiased>(s[nt][e], cl2, mq[e / 2]);  // at most 127.5
      bits[nt][e] = __float_as_uint(__fadd_rn(p127, kMagicF));
      if constexpr (!kBiased) rs[e / 2] += bits[nt][e];  // modulo 2^32
    }
  }
  if constexpr (!kBiased) {
    rs[0] -= static_cast<uint32_t>(kTile / 4) * static_cast<uint32_t>(kMagic);
    rs[1] -= static_cast<uint32_t>(kTile / 4) * static_cast<uint32_t>(kMagic);
  }
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

// O = bf16(acc / l) for this thread's rows r0 and r0 + 8 of a (n, D) output
// (l0, l1 their whole sums); in 'int8' mode then bf16(O * sv), as the JAX
// wrapper
template <int D, bool kFull>
__device__ __forceinline__ void store_out(__nv_bfloat16* out, const float (&acc)[D / 8][4],
                                          float l0, float l1, float sv, int r0, int n, int t) {
#pragma unroll
  for (int jd = 0; jd < D / 8; ++jd) {
    const int col = jd * 8 + 2 * t;
    __nv_bfloat162 y0 = __floats2bfloat162_rn(acc[jd][0] / l0, acc[jd][1] / l0);
    __nv_bfloat162 y1 = __floats2bfloat162_rn(acc[jd][2] / l1, acc[jd][3] / l1);
    if constexpr (kFull) {
      y0 = __floats2bfloat162_rn(__low2float(y0) * sv, __high2float(y0) * sv);
      y1 = __floats2bfloat162_rn(__low2float(y1) * sv, __high2float(y1) * sv);
    }
    if (r0 < n) *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(r0) * D + col) = y0;
    if (r0 + 8 < n) {
      *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(r0 + 8) * D + col) = y1;
    }
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

// ------------------------------------------------------------ wgmma kernel (d 32, 64)

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
        softmax_full<true, false>(s, key, n, c, m, alpha, pa, rs);
      } else {
        softmax_full<false, false>(s, key, n, c, m, alpha, pa, rs);
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
        softmax_qk<true, false>(s, key, n, c, m, l, alpha, pa);
      } else {
        softmax_qk<false, false>(s, key, n, c, m, l, alpha, pa);
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

  store_out<D, kFull>(o + base, acc, l0, l1, kFull ? v_scale[blockIdx.y] : 1.f, row0, n, t);
}

// ------------------------------------------------------------ ring kernel (d 8, 16)

// Its block, by head dim: warps, 16-row query tiles a warp, and the blocks an
// SM that __launch_bounds__ keeps registers for. Chosen in turns on the H100
// (PERF.md): blocks of 4 warps at 4 an SM (72-85 registers) beat 8 warps at
// 2 by 9% (int8_qk) and 4% (int8) a depth-18 batch; 5 blocks an SM ran level,
// 2 warps at 8 3-6% slower, two query tiles a warp (3 or 4 blocks an SM)
// 1-2% slower in int8_qk and up to 3% faster in int8 (one block shape serves
// both modes). m16n8k32 for Q K^T (its upper half zero) ran 6% slower.
template <int D>
__host__ __device__ constexpr int ring_warps() { return 4; }
template <int D>
__host__ __device__ constexpr int ring_row_tiles() { return 1; }
template <int D>
__host__ __device__ constexpr int ring_blocks_per_sm() { return 4; }
template <int D>
__host__ __device__ constexpr int ring_rows() { return ring_warps<D>() * 16 * ring_row_tiles<D>(); }

// c = a b + kMagic, s8 m16n8k16: a (16 x 16 s8, row-major: a[0] row g, a[1]
// row g + 8, bytes 4t..4t+3), b (16 x 8 s8, column-major: bytes 4t..4t+3 of
// column g); the accumulator starts at kMagic, so each score comes out
// biased as the softmax helpers' kBiased wants it
__device__ __forceinline__ void mma_16816_s8_biased(int (&c)[4], const uint32_t (&a)[2],
                                                    uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %8, %9, %10};\n"
      : "=r"(c[0]), "=r"(c[1]), "=r"(c[2]), "=r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b), "r"(kMagic), "r"(kMagic), "r"(kMagic), "r"(kMagic));
}

// c (16x8 s32) += a (16x32 s8, row-major: a[0], a[1] rows g, g + 8 at bytes
// 4t..4t+3, a[2], a[3] at 16 + 4t..) * b (32x8 s8, column-major: b[0] bytes
// 4t..4t+3 of column g, b[1] bytes 16 + 4t..)
__device__ __forceinline__ void mma_16832_s8(int (&c)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Starts the copy of tile `tile` of this block's batch into its ring slot,
// kThreads threads sharing the copies (the caller commits): K (int8 (n, D))
// as kTile rows of k_row_bytes, a key a copy (8 bytes at d 8, where a batch's
// K starts only 8-byte aligned for odd n); then V, bf16 (n, D) in the
// swizzled [kTile][D] tile of pv_mma ('int8_qk'), or the pre-pass's zero-padded
// int8 V^T slice ('int8': v the batch's (D, n_pad), rows of kTile bytes whose
// 16-byte chunks are swizzled as a bf16 [D][32] tile's). Keys past n are
// zero-filled; nothing past a tensor is read.
template <int D, bool kFull, int kThreads>
__device__ __forceinline__ void load_ring_tile(const int8_t* __restrict__ k, const void* v,
                                               int tile, int n, int n_pad, uint8_t* slot) {
  constexpr int kCopies = kTile + (kFull ? D * kTile / 16 : kTile * D / 8);
  const int key0 = tile * kTile;
  uint8_t* vt = slot + kTile * k_row_bytes<D>();
#pragma unroll
  for (int it = 0; it < (kCopies + kThreads - 1) / kThreads; ++it) {
    const int i = it * kThreads + threadIdx.x;
    if (kCopies % kThreads != 0 && i >= kCopies) break;
    if (i < kTile) {
      const bool ok = key0 + i < n;
      const int8_t* src = k + static_cast<size_t>(ok ? key0 + i : 0) * D;
      if constexpr (D == 8) {
        cp_async_8(slot + i * k_row_bytes<D>(), src, ok);
      } else {
        cp_async_16(slot + i * k_row_bytes<D>(), src, ok);
      }
    } else if constexpr (kFull) {
      const int r = (i - kTile) / 4, ch = (i - kTile) % 4;  // row d, chunk of 16 keys
      cp_async_16(vt + 2 * swz<32>(r, ch),
                  static_cast<const int8_t*>(v) + static_cast<size_t>(r) * n_pad + key0 + ch * 16,
                  true);
    } else {
      const int r = (i - kTile) / (D / 8), ch = (i - kTile) % (D / 8);
      const bool ok = key0 + r < n;
      cp_async_16(reinterpret_cast<__nv_bfloat16*>(vt) + swz<D>(r, ch),
                  static_cast<const __nv_bfloat16*>(v) + static_cast<size_t>(ok ? key0 + r : 0) * D +
                      ch * 8,
                  ok);
    }
  }
}

// 'int8': acc_i += p_q V and l_i += the row sums of p_q for a warp's 16 rows,
// s8 m16n8k32 over the tile's two 32-key steps. V's B fragments come by
// ldmatrix from the swizzled V^T tile vt (matrix i: the 16-byte chunk i,
// slots 16i..16i+15, of d rows 8 jd..8 jd + 7), in the key order that pa
// holds; the row sums multiply pa by a ones B fragment, from zero each tile
// (a ones column: every c of a row is its sum).
template <int D>
__device__ __forceinline__ void pv_int8(int (&acc_i)[D / 8][4], uint32_t (&l_i)[2],
                                        const uint32_t (&pa)[kTile / 32][4], const uint8_t* vt,
                                        int lane) {
  const int r8 = lane & 7, mat = lane >> 3;
#pragma unroll
  for (int jd = 0; jd < D / 8; ++jd) {
    uint32_t b[4];
    ldmatrix_x4(b, vt + 2 * swz<32>(jd * 8 + r8, mat));
    const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
    mma_16832_s8(acc_i[jd], pa[0], b0);
    mma_16832_s8(acc_i[jd], pa[1], b1);
  }
  int sums[4] = {0, 0, 0, 0};
  const uint32_t ones[2] = {0x01010101u, 0x01010101u};
#pragma unroll
  for (int kk = 0; kk < kTile / 32; ++kk) mma_16832_s8(sums, pa[kk], ones);
  l_i[0] += static_cast<uint32_t>(sums[0]);
  l_i[1] += static_cast<uint32_t>(sums[2]);
}

// One 64-key tile (its ring slot `slot`, its first key j * kTile) for this
// warp's M 16-row query tiles: K's B fragments by ldmatrix (matrix i: the
// rows of 8 keys; at d 8 the upper 8 bytes of a row meet the zero upper half
// of qa), each serving the M tiles; then each tile's softmax and PV product
// in turn. Per score: the product, one IMNMX, FADD, FFMA and MUFU.EX2, and
// a bf16 pack ('int8_qk') or the rounding FADD and a byte pack ('int8').
template <int D, bool kFull, int M, bool kMask>
__device__ __forceinline__ void ring_tile(const uint8_t* slot, const uint32_t (&qa)[M][2], int j,
                                          int n, float c, float (&m)[M][2], float (&l)[M][2],
                                          float (&acc)[M][D / 8][4], int (&acc_i)[M][D / 8][4],
                                          uint32_t (&l_i)[M][2], int lane) {
  const int r8 = lane & 7, mat = lane >> 3, t = lane & 3;
  uint32_t kb[kTile / 8];
#pragma unroll
  for (int h = 0; h < kTile / 32; ++h) {
    ldmatrix_x4(&kb[4 * h], slot + ((4 * h + mat) * 8 + r8) * k_row_bytes<D>());
  }
  int s[M][kTile / 8][4];
#pragma unroll
  for (int mt = 0; mt < M; ++mt) {
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) mma_16816_s8_biased(s[mt][nt], qa[mt], kb[nt]);
  }
  const uint8_t* vt = slot + kTile * k_row_bytes<D>();
  const int key = j * kTile + 2 * t;
#pragma unroll
  for (int mt = 0; mt < M; ++mt) {
    float alpha[2];
    if constexpr (kFull) {
      uint32_t pa[kTile / 32][4], unused[2];
      softmax_full<kMask, true>(s[mt], key, n, c, m[mt], alpha, pa, unused);
      // each thread owns its rows' sums: a warp flushes on its own
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f) ||
          j % kFlushTiles == kFlushTiles - 1) {
        flush(acc[mt], acc_i[mt], l[mt], l_i[mt], alpha);
      }
      pv_int8<D>(acc_i[mt], l_i[mt], pa, vt, lane);
    } else {
      uint32_t pa[kTile / 16][4];
      softmax_qk<kMask, true>(s[mt], key, n, c, m[mt], l[mt], alpha, pa);
      rescale(acc[mt], alpha);
      pv_mma<D>(acc[mt], pa, reinterpret_cast<const __nv_bfloat16*>(vt), lane);
    }
  }
}

// ring_warps warps of ring_row_tiles 16-row query tiles each; all threads
// stage the 64-key tiles by cp.async into a ring of kStages slots, kAhead
// tiles ahead, one __syncthreads a tile. v: bf16 (B, n, D) ('int8_qk') or the
// pre-pass's int8 V^T (B, D, n_pad) ('int8').
template <int D, bool kFull>
__global__ void __launch_bounds__(ring_warps<D>() * 32, ring_blocks_per_sm<D>())
flash_int8_ring(const int8_t* __restrict__ q, const int8_t* __restrict__ k, const void* v,
                const float* __restrict__ scale, const float* __restrict__ v_scale,
                __nv_bfloat16* __restrict__ o, int n, int n_pad) {
  static_assert(D == 8 || D == 16, "the ring int8 forward takes head dims 8 and 16");
  constexpr int kThreads = ring_warps<D>() * 32, M = ring_row_tiles<D>();
  constexpr int kSlot = slot_bytes<D, kFull>();
  __shared__ __align__(128) uint8_t ring[kStages * kSlot];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int batch = blockIdx.y;
  const size_t base = static_cast<size_t>(batch) * n * D;
  const int8_t* kb = k + base;
  const void* vb = kFull ? static_cast<const void*>(static_cast<const int8_t*>(v) +
                                                    static_cast<size_t>(batch) * D * n_pad)
                         : static_cast<const void*>(static_cast<const __nv_bfloat16*>(v) + base);
  const int row0 = blockIdx.x * ring_rows<D>() + warp * 16 * M + g;  // tile m: + 16 m, + 8
  const int tiles = (n + kTile - 1) / kTile;
  const bool ragged = n % kTile != 0;
  const float c = scale[batch];

  if constexpr (D < 16) {  // the K rows' pad (never copied into), zeroed once
    for (int i = threadIdx.x; i < kStages * kTile; i += kThreads) {
      *reinterpret_cast<uint2*>(ring + (i / kTile) * kSlot + (i % kTile) * 16 + 8) =
          make_uint2(0, 0);
    }
  }
#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    if (j < tiles) load_ring_tile<D, kFull, kThreads>(kb, vb, j, n, n_pad, ring + j * kSlot);
    cp_async_commit();
  }
  uint32_t qa[M][2];  // rows past n and bytes past D read as zeros
  float acc[M][D / 8][4], m[M][2], l[M][2];
  int acc_i[M][D / 8][4];  // 'int8': the PV sums since the last flush
  uint32_t l_i[M][2];      // 'int8': the p_q row sums since the last flush
#pragma unroll
  for (int mt = 0; mt < M; ++mt) {
    const int r0 = row0 + 16 * mt, r1 = r0 + 8;
    qa[mt][0] = load_u32(q + base + static_cast<size_t>(r0 < n ? r0 : 0) * D + 4 * t,
                         r0 < n && 4 * t < D);
    qa[mt][1] = load_u32(q + base + static_cast<size_t>(r1 < n ? r1 : 0) * D + 4 * t,
                         r1 < n && 4 * t < D);
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[mt][jd][e] = 0.f;
        acc_i[mt][jd][e] = 0;
      }
    }
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
    l_i[mt][0] = l_i[mt][1] = 0u;
  }

  for (int j = 0; j < tiles; ++j) {
    cp_async_wait<kAhead - 1>();  // this thread's copies of tile j have landed
    __syncthreads();              // everyone's have, and tile j - 1 is no longer read
    if (j + kAhead < tiles) {
      load_ring_tile<D, kFull, kThreads>(kb, vb, j + kAhead, n, n_pad,
                                         ring + ((j + kAhead) % kStages) * kSlot);
    }
    cp_async_commit();
    const uint8_t* slot = ring + (j % kStages) * kSlot;
    if (ragged && j == tiles - 1) {
      ring_tile<D, kFull, M, true>(slot, qa, j, n, c, m, l, acc, acc_i, l_i, lane);
    } else {
      ring_tile<D, kFull, M, false>(slot, qa, j, n, c, m, l, acc, acc_i, l_i, lane);
    }
  }

  const float sv = kFull ? v_scale[batch] : 1.f;
#pragma unroll
  for (int mt = 0; mt < M; ++mt) {
    if constexpr (kFull) {
      const float one[2] = {1.f, 1.f};
      flush(acc[mt], acc_i[mt], l[mt], l_i[mt], one);
    }
    // l holds whole rows (the tensor core's sums)
    store_out<D, kFull>(o + base, acc[mt], l[mt][0], l[mt][1], sv, row0 + 16 * mt, n, t);
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
int launch_ring(const Args& a) {
  const dim3 grid((a.n + ring_rows<D>() - 1) / ring_rows<D>(), a.batch);
  flash_int8_ring<D, kFull><<<grid, ring_warps<D>() * 32, 0, a.stream>>>(
      a.q, a.k, a.v, a.scale, a.v_scale, a.o, a.n, a.n_pad);
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
    case 8: return launch_ring<8, kFull>(a);
    case 16: return launch_ring<16, kFull>(a);
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

// Int8 flash-attention forward for the REFusion cross-attention, Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel frn_tpu/ops/flash_attention.py::_flash_int8_kernel
// (launched by _flash_forward_int8, reached through flash_nonlocal_attention_int8
// when ModelConfig.attention_quant is set; inference only). Per batch b, with the
// dynamic per-slice quantization done before the launch (ops/flash_attention.py,
// quantize_int8: Qi = round(127 Q / max|Q|), the same for K and, in 'int8' mode,
// V) and the score scale c[b] = sq * sk / 127^2:
//
//     S = int32(Qi Ki^T) * c                          (f32, online softmax in f32)
//     'int8_qk': O = sum(bf16(p) V) / sum(bf16(p))     (V bf16, PV on bf16 MMA)
//     'int8':    p_q = round(127 p) (int8, p <= 1 against the running max),
//                O = bf16(bf16(sum(p_q Vi) / (127 sum(p_q))) * sv)   (PV on int8 MMA)
//
// Both denominators sum the weights the PV product used, as the TPU kernel's
// ones lane does. Key columns past N are masked to -inf in registers (DDD17's
// 5,655 tokens are ragged); the query tail is masked on load and store.
//
// What bounds it on an H100: as the bf16 kernel, the B*N^2 exponentials on the
// special-function units (about 3.9e12 exp/s); int8 MMA (1,979 TOPS dense) only
// halves the product term, which was already the smaller. Device memory is not
// the limit. The quantization pre-passes in torch add bytes outside the kernel.
//
// Design (first, simple version, B1's shape): one block of 4 warps owns 64 query
// rows of one batch, each warp 16 rows with its int8 Q fragments, scores, row
// statistics and f32 output accumulator in registers, and loops over 64-key
// tiles staged in shared memory. QK^T is mma.sync m16n8k32 s8.s8.s32: Q and K
// row-major are already its A and .col B operands. Two layout traps of int8 MMA:
//  - the QK^T C fragment holds keys 2t, 2t+1 of each 8-key tile, where the
//    m16n8k32 A operand wants slots 4t..4t+3 and 16+4t..16+4t+3. PV contracts
//    over keys, so the order of the keys is free: P stays in registers in the C
//    order, and V's rows are read in the same order (slot s of each 32-key group
//    holds key 16(s/16) + 2(s%16/4) + s%2 + 8(s%4/2));
//  - there is no 8-bit ldmatrix.trans for V as the B operand: the wrapper writes
//    the int8 V transposed, (B, d, N_pad), in that key order and zero-padded to a
//    whole tile, so each fragment register is one 32-bit shared-memory load.
// In 'int8_qk' mode V stays bf16 and is staged transposed as in the bf16 kernel.
// Not yet done: cp.async/TMA pipelining, wgmma, exp2, a fused quantization pass.

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kPad8 = 16;  // int8 row padding in bytes: fragment loads hit distinct banks

// c (16x8 s32) += a (16x32 s8, row-major) * b (32x8 s8, column-major)
__device__ __forceinline__ void mma_16832_s8(int c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 32-wide int8 contraction steps over a head dim D
template <int D>
__host__ __device__ constexpr int kSteps8() { return (D + 31) / 32; }

__device__ __forceinline__ uint32_t load_u32(const int8_t* p, bool valid) {
  return valid ? *reinterpret_cast<const uint32_t*>(p) : 0u;
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
flash_int8_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
                  const void* __restrict__ v, const float* __restrict__ scale,
                  const float* __restrict__ v_scale, __nv_bfloat16* __restrict__ o, int n,
                  int n_pad) {
  static_assert(D % 8 == 0 && D <= 64, "head dim must be 8, 16, 32 or 64");
  constexpr int KD = kSteps8<D>();
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

  // Q as m16n8k32 A fragments, one per 32-wide slice of d; rows past n and
  // columns past D read as zeros
  uint32_t qa[KD][4];
  {
    const int8_t* q0 = q + base + static_cast<size_t>(ok0 ? row0 : 0) * D;
    const int8_t* q1 = q + base + static_cast<size_t>(ok1 ? row1 : 0) * D;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const int lo = kk * 32 + 4 * t, hi = lo + 16;
      qa[kk][0] = load_u32(q0 + lo, ok0 && lo < D);
      qa[kk][1] = load_u32(q1 + lo, ok1 && lo < D);
      qa[kk][2] = load_u32(q0 + hi, ok0 && hi < D);
      qa[kk][3] = load_u32(q1 + hi, ok1 && hi < D);
    }
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
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const int lo = kk * 32 + 4 * t, hi = lo + 16;
        const uint32_t b[2] = {load_u32(krow + lo, lo < D), load_u32(krow + hi, hi < D)};
        mma_16832_s8(si, qa[kk], b);
      }
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

template <int D, bool kFull>
void launch(dim3 grid, cudaStream_t s, const int8_t* q, const int8_t* k, const void* v,
            const float* scale, const float* v_scale, __nv_bfloat16* o, int n, int n_pad) {
  flash_int8_kernel<D, kFull><<<grid, kWarps * 32, 0, s>>>(q, k, v, scale, v_scale, o, n, n_pad);
}

template <bool kFull>
int launch_d(dim3 grid, cudaStream_t s, int d, const int8_t* q, const int8_t* k, const void* v,
             const float* scale, const float* v_scale, __nv_bfloat16* o, int n, int n_pad) {
  switch (d) {
    case 8: launch<8, kFull>(grid, s, q, k, v, scale, v_scale, o, n, n_pad); break;
    case 16: launch<16, kFull>(grid, s, q, k, v, scale, v_scale, o, n, n_pad); break;
    case 32: launch<32, kFull>(grid, s, q, k, v, scale, v_scale, o, n, n_pad); break;
    case 64: launch<64, kFull>(grid, s, q, k, v, scale, v_scale, o, n, n_pad); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, bound with ctypes. Launches on `stream` and returns the
// cudaGetLastError() code of the launch (0 on success). q, k: int8 (B, N, d)
// row-major; v: bf16 (B, N, d) when full == 0 ('int8_qk'), else int8
// (B, d, n_pad) in the kernel's key order (n_pad a multiple of 64); scale:
// f32 (B,) sq * sk / 127^2; v_scale: f32 (B,) sv when full, else null; o: bf16
// (B, N, d). Pointers 16-byte aligned, checked by the Python wrapper.
extern "C" int frn_flash_int8(const void* q, const void* k, const void* v, const void* scale,
                              const void* v_scale, void* o, int batch, int n, int n_pad, int d,
                              int full, void* stream) {
  if (batch <= 0 || n <= 0 || batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (full && (n_pad < n || n_pad % kTile != 0 || v_scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kRows - 1) / kRows, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qi = static_cast<const int8_t*>(q);
  const auto* ki = static_cast<const int8_t*>(k);
  const auto* sc = static_cast<const float*>(scale);
  const auto* vs = static_cast<const float*>(v_scale);
  auto* ob = static_cast<__nv_bfloat16*>(o);
  return full ? launch_d<true>(grid, s, d, qi, ki, v, sc, vs, ob, n, n_pad)
              : launch_d<false>(grid, s, d, qi, ki, v, sc, vs, ob, n, n_pad);
}

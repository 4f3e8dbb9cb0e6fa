// ResNet stem for the detector's backbones: conv 7x7, stride 2, padding 3, to
// 64 channels, with the frozen batch norm and the ReLU fused, Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel frn_tpu/ops/stem.py::_stem_kernel (launched by
// stem_conv_bn_relu, selected by ModelConfig.stem_kernel; inference only):
//
//     out = bf16(relu(conv7x7_s2_p3(x, w) * scale + bias))
//
// x bf16 NHWC (B, H, W, C), C in {3, 5} (RGB, event voxels), even H and W;
// scale, bias f32 (64,) (the folded frozen BN); out bf16 NHWC
// (B, H/2, W/2, 64), which is the channels_last NCHW tensor the max pool takes
// next. Products are summed in f32 and rounded once, at the end. w is bf16 in
// torch's conv layout (64, C, 7, 7); each block packs it into the kernel's K
// order in shared memory (modelled in torch by tests/test_torch_optin_kernels.py).
//
// What bounds it on an H100: by the card's peaks, the bytes. At DSEC batch 16
// the output alone is 157 MB (0.047 ms at 3.35 TB/s) against 29.5 MB (RGB) or
// 49 MB (event) of input; the 2.8e10 (RGB) and 4.5e10 (event) flops of the
// padded K take 0.03-0.05 ms on the bf16 tensor cores. In this design each
// k16 step of a 64-pixel tile moves 4 KB through shared memory (A's 4-byte
// loads and wgmma's read of B), about what the SM's shared memory delivers in
// the 32 cycles the tensor core takes for the step (PERF.md).
//
// Design: an implicit GEMM on the tensor cores. M is output pixels, N the 64
// filters, K the 7 x 8C slots of the TPU kernel's pack_stem_weights: for each
// row tap kh, a run of 8C slots whose slot i holds tap o = i - 1 = kw * C + c
// (slot 0 and slots past 7C carry zero weight), then zero rows up to KP (176
// at C 3, 288 at C 5; 11 and 18 k16 steps). For output column ow the run is
// one contiguous span of the zero-padded input row, starting at element
// 2 ow C - 1. Each shared-memory row holds the padded row one element to the
// right, so that span starts at the even element 2 ow C: every A pair
// (k, k + 1) of a product is one aligned 4-byte shared-memory load, no im2col
// buffer is built, and the image's own elements land on 4-byte words that
// match x's (3C + 1 is even), so rows are copied by 4-byte cp.async at any W
// (a DDD17 row, 2,076 or 3,460 bytes, is not 16-byte aligned). The run of
// k16 step s, half h (8 slots) lies in one row tap, kh = (2s + h) / C, so a
// thread's addresses are a compile-time offset plus its pixel's and 2t.
// (Runs cut to 7C + 1 slots, 10 and 16 k16 steps, measured no faster:
// PERF.md.)
//
// One warpgroup per block, as many blocks as fit on the card at once (2 per
// SM at DSEC; registers and shared memory bound them), each walking a strip of
// output rows. A block packs the weights once (swizzled, 128-byte rows:
// wgmma's B, MN-major), keeps a ring of 9 padded input rows (the 7 under
// an output row and the 2 the next one adds, fetched by cp.async while this
// one is computed; zero rows above and below the image, zero pads on both
// sides), and for every 64-pixel tile of an output row runs KP / 16 wgmma
// m64n64k16 with A in registers. A tile's products run while the tile before
// it in the row goes out (scale, bias, ReLU and the one rounding in
// registers, then each warp's 16 pixels, 2 KB contiguous in NHWC, through a
// swizzled shared-memory tile as 16-byte streaming stores). Pixels past W/2
// (a ragged last tile) read the last pixel's inputs and are not stored.

#include "flash_sm90.cuh"

namespace {

using namespace flash;

constexpr int kF = 64;           // filters
constexpr int kThreads = 128;    // one warpgroup
constexpr int kTileM = 64;       // output pixels per product
constexpr int kRing = 9;         // input rows held: 7 taps + the next output row's 2
constexpr int kMaxSmem = 232448; // a block's shared memory on an H100

// K: 7 runs of 8C slots, one per row tap, then zero rows up to whole k16 steps
template <int C>
__host__ __device__ constexpr int weight_rows() {
  return (56 * C + 15) / 16 * 16;  // 176, 288
}

// ring row stride in elements: the padded row ((W + 6) C), shifted one element
// right, rounded up to 16 bytes
inline int ring_stride(int wd, int c) { return ((wd + 6) * c + 1 + 7) / 8 * 8; }

template <int C>
size_t smem_bytes(int rs) {
  return 1024 + static_cast<size_t>(weight_rows<C>()) * kF * 2 +
         static_cast<size_t>(kRing) * rs * 2 + 4 * 16 * kF * 2 + 2 * kF * 4;
}

template <int C>
__global__ void __launch_bounds__(kThreads)
stem_wgmma(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
           const float* __restrict__ scale, const float* __restrict__ bias,
           __nv_bfloat16* __restrict__ out, int h, int wd, int rs, int rows_total, int oh_n,
           int ow_n) {
  constexpr int KP = weight_rows<C>();
  constexpr int KS = KP / 16;
  extern __shared__ uint8_t smem_raw[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));  // [KP][64], swizzled
  __nv_bfloat16* ring = ws + KP * kF;                               // [kRing][rs]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  __nv_bfloat16* stg = ring + kRing * rs + warp * 16 * kF;  // this warp's [16][64] output tile
  float* sc = reinterpret_cast<float*>(ring + kRing * rs + 4 * 16 * kF);
  float* bi = sc + kF;

  // this block's output rows [first, last) of the B * H/2 rows
  const long long share = rows_total;
  const int first = static_cast<int>(share * blockIdx.x / gridDim.x);
  const int last = static_cast<int>(share * (blockIdx.x + 1) / gridDim.x);

  // padded row pr (input row pr - 3) of image b into ring slot pr % kRing:
  // the row's words from word (3C + 1) / 2 on, zeros outside the image
  const int row_words = wd * C / 2, lead = (3 * C + 1) / 2;
  auto stage_row = [&](int b, int pr) {
    const int r = pr - 3;
    const bool ok = r >= 0 && r < h;
    const uint32_t* src = reinterpret_cast<const uint32_t*>(x) +
                          static_cast<size_t>(b * h + (ok ? r : 0)) * row_words;
    uint32_t* dst = reinterpret_cast<uint32_t*>(ring + (pr % kRing) * rs) + lead;
    for (int i = threadIdx.x; i < row_words; i += kThreads) cp_async_4(dst + i, src + i, ok);
  };
  // the ring rows' pads, zero for good (cp.async writes only the words between)
  const int pad = rs / 2 - row_words;
  for (int i = threadIdx.x; i < kRing * pad; i += kThreads) {
    const int slot = i / pad, k = i - slot * pad;
    reinterpret_cast<uint32_t*>(ring + slot * rs)[k < lead ? k : row_words + k] = 0u;
  }
  // the first output row's input rows, in flight while the weights are packed
  int ready = first;  // the output row whose new input rows are in flight
  for (int kh = 0; kh < 7; ++kh) stage_row(first / oh_n, 2 * (first % oh_n) + kh);
  cp_async_commit();

  // the weights once per block, packed into the K order: w[f][c][kh][kw] at
  // row 8C kh + 1 + kw C + c; zeros at each run's slot 0 and slots past 7C
  // and past 56C; 16-byte chunk q of row r at chunk q ^ (r % 8)
  auto w_at = [&](int r, int f) { return ws + r * kF + (((f >> 3) ^ (r & 7)) << 3) + (f & 7); };
  for (int i = threadIdx.x; i < (KP - 49 * C) * kF; i += kThreads) {
    const int z = i / kF, m = z % C;
    const int r = z < 7 * C ? z / C * 8 * C + (m == 0 ? 0 : 7 * C + m) : 49 * C + z;
    *w_at(r, i % kF) = __float2bfloat16_rn(0.f);
  }
  for (int q = threadIdx.x; q < kF * 49 * C / 8; q += kThreads) {  // w in its own order
    const uint4 v = reinterpret_cast<const uint4*>(w)[q];
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int f = (8 * q + k) / (49 * C), tap = 8 * q + k - f * 49 * C;  // (c 7 + kh) 7 + kw
      const int c = tap / 49, kh = tap / 7 % 7, kw = tap % 7;
      *w_at(kh * 8 * C + 1 + kw * C + c, f) = e[k];
    }
  }
  if (threadIdx.x < kF) {
    sc[threadIdx.x] = scale[threadIdx.x];
    bi[threadIdx.x] = bias[threadIdx.x];
  }
  fence_proxy_async();  // the weights, for wgmma

  const uint64_t wdesc = swizzled_desc<128>(ws);
  for (int row = first; row < last; ++row) {
    const int b = row / oh_n, oh = row - b * oh_n;
    if (ready != row) {
#pragma unroll 1
      for (int kh = 0; kh < 7; ++kh) stage_row(b, 2 * oh + kh);
      cp_async_commit();
    }
    if (row + 1 < last && oh + 1 < oh_n) {
      stage_row(b, 2 * oh + 7);
      stage_row(b, 2 * oh + 8);
      ready = row + 1;
    }
    cp_async_commit();
    cp_async_wait<1>();  // every group but the next row's prefetch has landed
    __syncthreads();

    int rowbase[7];  // element offset of the ring row of tap kh, plus this lane's 2t
#pragma unroll
    for (int kh = 0; kh < 7; ++kh) rowbase[kh] = ((2 * oh + kh) % kRing) * rs + 2 * t;

    // A of the tile at pixel px0 into registers, then its KP / 16 products
    // into acc (A stays in registers until they complete)
    float acc[8][4];
    auto start = [&](int px0) {
      // this lane's A rows: pixels px0 + 16 warp + g and + 8, the last
      // pixel's inputs past the row's end (computed, not stored)
      const int e0 = 2 * C * min(px0 + warp * 16 + g, ow_n - 1);
      const int e1 = 2 * C * min(px0 + warp * 16 + g + 8, ow_n - 1);
      uint32_t a[KS][4];
#pragma unroll
      for (int s = 0; s < KS; ++s) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int j = 2 * s + hh;  // slots 8j..8j+7: tap kh = j / C, run offset 8 (j % C)
          if (j / C < 7) {
            const __nv_bfloat16* r = ring + rowbase[j / C] + 8 * (j % C);
            a[s][2 * hh] = *reinterpret_cast<const uint32_t*>(r + e0);
            a[s][2 * hh + 1] = *reinterpret_cast<const uint32_t*>(r + e1);
          } else {  // the K padding past 56C: zero weights, zero data
            a[s][2 * hh] = a[s][2 * hh + 1] = 0u;
          }
        }
      }
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        wgmma_m64n64k16<1>(acc, a[s], wdesc + 128 * s, s);  // 16 weight rows on
      }
      wgmma_commit();
    };

    start(0);
    for (int px0 = 0; px0 < ow_n; px0 += kTileM) {
      wgmma_wait<0>();
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
#pragma unroll
        for (int i = 0; i < 4; ++i) fence_reg(acc[jn][i]);
      }
      // epilogue in registers: rows g and g + 8, filters 8 jn + 2t, +1
      uint32_t y[8][2];
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
        const float2 s2 = *reinterpret_cast<const float2*>(sc + 8 * jn + 2 * t);
        const float2 b2 = *reinterpret_cast<const float2*>(bi + 8 * jn + 2 * t);
        y[jn][0] = pack_bf16x2(fmaxf(acc[jn][0] * s2.x + b2.x, 0.f),
                               fmaxf(acc[jn][1] * s2.y + b2.y, 0.f));
        y[jn][1] = pack_bf16x2(fmaxf(acc[jn][2] * s2.x + b2.x, 0.f),
                               fmaxf(acc[jn][3] * s2.y + b2.y, 0.f));
      }
      // the next tile's products run while this one goes out
      if (px0 + kTileM < ow_n) start(px0 + kTileM);
      // chunk jn of row r at chunk jn ^ (r % 8)
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
        const int col = ((jn ^ g) * 8) + 2 * t;
        *reinterpret_cast<uint32_t*>(stg + g * kF + col) = y[jn][0];
        *reinterpret_cast<uint32_t*>(stg + (g + 8) * kF + col) = y[jn][1];
      }
      __syncwarp();
      // the warp's 16 pixels are 2 KB contiguous in NHWC: 4 16-byte stores a
      // lane, streamed past L2 (nothing reads them back soon)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int id = q * 32 + lane, r = id >> 3, c = id & 7;
        const int p = px0 + warp * 16 + r;
        const uint4 v = *reinterpret_cast<const uint4*>(stg + r * kF + ((c ^ (r & 7)) * 8));
        if (p < ow_n) {
          __stcs(reinterpret_cast<uint4*>(out + (static_cast<size_t>(row) * ow_n + p) * kF + c * 8),
                 v);
        }
      }
      __syncwarp();
    }
    __syncthreads();  // every warp is done with this row's ring slots
  }
}

template <int C>
int launch(int batch, int h, int wd, const void* x, const void* w, const void* scale,
           const void* bias, void* out, cudaStream_t s) {
  const int rs = ring_stride(wd, C);
  const size_t bytes = smem_bytes<C>(rs);
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  static int set_for_device = -1;
  int rc = allow_smem(stem_wgmma<C>, kMaxSmem, set_for_device);
  if (rc != 0) return rc;
  // blocks that fit on the card at once, asked once per device and row width
  // (the queries take longer than the launch)
  static int fit_device = -1, fit = 0;
  static size_t fit_bytes = 0;
  int dev = 0;
  rc = static_cast<int>(cudaGetDevice(&dev));
  if (rc == 0 && (dev != fit_device || bytes != fit_bytes)) {
    int sms = 0, per_sm = 0;
    rc = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
    if (rc == 0) {
      rc = static_cast<int>(
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stem_wgmma<C>, kThreads, bytes));
    }
    if (rc == 0 && per_sm < 1) rc = static_cast<int>(cudaErrorInvalidConfiguration);
    if (rc == 0) {
      fit_device = dev;
      fit_bytes = bytes;
      fit = per_sm * sms;
    }
  }
  if (rc != 0) return rc;
  const int oh_n = h / 2, ow_n = wd / 2;
  const int rows_total = batch * oh_n;
  const int grid = fit < rows_total ? fit : rows_total;
  stem_wgmma<C><<<grid, kThreads, bytes, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), h, wd, rs, rows_total, oh_n, ow_n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, bound with ctypes. Launches on `stream` and returns the
// CUDA error code (0 on success). x: bf16 (B, H, W, C) contiguous, C in {3, 5},
// H and W even; w: bf16 (64, C, 7, 7) contiguous, torch's conv layout;
// scale, bias: f32 (64,); out: bf16 (B, H/2, W/2, 64). Pointers 16-byte
// aligned, checked by the Python wrapper.
extern "C" int frn_stem_conv_bn_relu(const void* x, const void* w, const void* scale,
                                     const void* bias, void* out, int batch, int h, int wd,
                                     int c, void* stream) {
  if (batch <= 0 || h <= 0 || wd <= 0 || h % 2 || wd % 2 ||
      static_cast<long long>(batch) * (h / 2) > (1LL << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 3: return launch<3>(batch, h, wd, x, w, scale, bias, out, s);
    case 5: return launch<5>(batch, h, wd, x, w, scale, bias, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

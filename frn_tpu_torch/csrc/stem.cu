// ResNet stem for the detector's backbones: conv 7x7, stride 2, padding 3, to
// 64 channels, with the frozen batch norm and the ReLU fused, Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel frn_tpu/ops/stem.py::_stem_kernel (launched by
// stem_conv_bn_relu, selected by ModelConfig.stem_kernel; inference only):
//
//     out = bf16(relu(conv7x7_s2_p3(x, w) * scale + bias))
//
// x bf16 NHWC (B, H, W, C), C in {3, 5} (RGB, event voxels), even H and W;
// w bf16 (7, 7, C, 64); scale, bias f32 (64,) (the folded frozen BN); out bf16
// NHWC (B, H/2, W/2, 64), which is the channels_last NCHW tensor the max pool
// takes next. Products are summed in f32 and rounded once, at the end.
//
// What bounds it on an H100: by the reckoning of the card's peaks, the bytes
// (at DSEC batch 16 the output alone is 157 MB, 0.047 ms at 3.35 TB/s); its
// 2.3e10 (RGB) and 3.9e10 (event) flops would take less on the bf16 tensor
// cores. This first version runs the flops as f32 FMAs on the CUDA cores
// (67 TFLOP/s), so they, not the bytes, set its time.
//
// Design (first, simple version): the TPU kernel's phase-plane deinterleave and
// packed weight slots are a lane-layout device and are not carried over. One
// block of 8 warps computes 320 output columns of one output row of one image:
// it stages the 49 * C * 64 weights and the 7 input rows under that output row
// (645 columns, zero outside the image) in shared memory as f32, then each
// thread accumulates 8 filters x 10 output columns in registers over the
// 49 * C taps (two 16-byte weight loads, shared across the warp, and 10 input
// loads per 80 FMAs). The affine and ReLU are applied in registers and each
// thread writes 16-byte runs of 8 filters. Not yet done: tensor cores (an
// implicit GEMM with K = 49C on mma/wgmma), TMA, several rows per block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kF = 64;                // filters
constexpr int kThreads = 256;         // 8 warps
constexpr int kFiltersPerThread = 8;  // lane % 8 picks 8 filters
constexpr int kColGroups = 4;         // lane / 8 picks a column phase
constexpr int kColsPerThread = 10;
constexpr int kWarpCols = kColGroups * kColsPerThread;      // 40
constexpr int kBlockCols = (kThreads / 32) * kWarpCols;     // 320 output columns
constexpr int kSpan = 2 * (kBlockCols - 1) + 7;             // 645 input columns

template <int C>
constexpr size_t smem_bytes() {
  return sizeof(float) * (49 * C * kF + 7 * kSpan * C);
}

template <int C>
__global__ void __launch_bounds__(kThreads)
stem_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
            const float* __restrict__ scale, const float* __restrict__ bias,
            __nv_bfloat16* __restrict__ out, int h, int wd, int oh_n, int ow_n) {
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;                // [kh][kw][c][f]
  float* xs = smem + 49 * C * kF;  // [kh][column][c], column j = input column 2 * ow0 - 3 + j
  const int b = blockIdx.z, oh = blockIdx.y, ow0 = blockIdx.x * kBlockCols;

  for (int i = threadIdx.x; i < 49 * C * kF; i += kThreads) ws[i] = __bfloat162float(w[i]);
  const int col0 = 2 * ow0 - 3;
  for (int i = threadIdx.x; i < 7 * kSpan * C; i += kThreads) {
    const int kh = i / (kSpan * C);
    const int rem = i - kh * kSpan * C;
    const int col = col0 + rem / C;
    const int r = 2 * oh - 3 + kh;
    float val = 0.f;
    if (r >= 0 && r < h && col >= 0 && col < wd)
      val = __bfloat162float(x[(static_cast<size_t>(b * h + r) * wd + col) * C + rem % C]);
    xs[i] = val;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int f0 = (lane % 8) * kFiltersPerThread;
  // this thread's output columns: lc = warp * 40 + lane / 8 + 4 * i, i < 10
  const int lc0 = warp * kWarpCols + lane / 8;

  float acc[kColsPerThread][kFiltersPerThread];
#pragma unroll
  for (int i = 0; i < kColsPerThread; ++i)
#pragma unroll
    for (int f = 0; f < kFiltersPerThread; ++f) acc[i][f] = 0.f;

  for (int kh = 0; kh < 7; ++kh) {
#pragma unroll
    for (int kw = 0; kw < 7; ++kw) {
      // input column of output column lc at tap kw: 2 * lc + kw
      const float* xrow = xs + (kh * kSpan + 2 * lc0 + kw) * C;
      const float* wrow = ws + ((kh * 7 + kw) * C) * kF + f0;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float4 wa = *reinterpret_cast<const float4*>(wrow + c * kF);
        const float4 wb = *reinterpret_cast<const float4*>(wrow + c * kF + 4);
        const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int i = 0; i < kColsPerThread; ++i) {
          const float xv = xrow[(8 * i) * C + c];  // column 2 * (lc0 + 4i) + kw
#pragma unroll
          for (int f = 0; f < kFiltersPerThread; ++f) acc[i][f] = fmaf(xv, wv[f], acc[i][f]);
        }
      }
    }
  }

  float sc[kFiltersPerThread], bi[kFiltersPerThread];
#pragma unroll
  for (int f = 0; f < kFiltersPerThread; ++f) {
    sc[f] = scale[f0 + f];
    bi[f] = bias[f0 + f];
  }
#pragma unroll
  for (int i = 0; i < kColsPerThread; ++i) {
    const int ow = ow0 + lc0 + 4 * i;
    if (ow >= ow_n) continue;
    uint4 packed;
    __nv_bfloat162* y = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
    for (int f = 0; f < kFiltersPerThread; f += 2) {
      y[f / 2] = __floats2bfloat162_rn(fmaxf(acc[i][f] * sc[f] + bi[f], 0.f),
                                       fmaxf(acc[i][f + 1] * sc[f + 1] + bi[f + 1], 0.f));
    }
    *reinterpret_cast<uint4*>(out + (static_cast<size_t>(b * oh_n + oh) * ow_n + ow) * kF + f0) =
        packed;
  }
}

template <int C>
int launch(int batch, int h, int wd, const void* x, const void* w, const void* scale,
           const void* bias, void* out, cudaStream_t s) {
  constexpr size_t bytes = smem_bytes<C>();
  // above 48 KB only as dynamic shared memory, after raising the kernel's limit
  const cudaError_t err =
      cudaFuncSetAttribute(stem_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int oh_n = h / 2, ow_n = wd / 2;
  const dim3 grid((ow_n + kBlockCols - 1) / kBlockCols, oh_n, batch);
  stem_kernel<C><<<grid, kThreads, bytes, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), h, wd, oh_n, ow_n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, bound with ctypes. Launches on `stream` and returns the
// CUDA error code (0 on success). x: bf16 (B, H, W, C) contiguous, C in {3, 5},
// H and W even; w: bf16 (7, 7, C, 64) contiguous; scale, bias: f32 (64,); out:
// bf16 (B, H/2, W/2, 64). Pointers 16-byte aligned, checked by the Python wrapper.
extern "C" int frn_stem_conv_bn_relu(const void* x, const void* w, const void* scale,
                                     const void* bias, void* out, int batch, int h, int wd,
                                     int c, void* stream) {
  if (batch <= 0 || batch > 65535 || h <= 0 || wd <= 0 || h % 2 || wd % 2 || h / 2 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 3: return launch<3>(batch, h, wd, x, w, scale, bias, out, s);
    case 5: return launch<5>(batch, h, wd, x, w, scale, bias, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// uint8 RGB -> luma -> bilinear 1/up degradation, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// srcgan_tpu/ops/pallas/preprocess_kernel.py:44 (fused_gray_degrade), the
// input path of the cascade trainer's uint8 steps with fused_input=True:
//
//     rgb  = u8 / 255                                   (N, H, W, 3), never stored
//     gray = 0.2125 R + 0.7154 G + 0.0721 B             (N, H, W)     fp32 out
//     low  = mh . gray . mw                             (N, H/up, W/up) fp32 out
//
// mh (H/up, H) and mw (W, W/up) are torch's bilinear (align_corners=False)
// sampling matrices.  Every row of such a matrix has at most two non-zeros,
// at adjacent inputs, so the wrapper (ops/kernels/preprocess_kernel.py)
// hands the kernel per-output-row and per-output-column tap tables
// (lo, hi, w_lo, w_hi) taken from the port's matrices, and the two matrix
// products become two 2-tap stencils, rows first and then columns, as the
// TPU kernel's dots sum them.
//
// What bounds it: at the training shape (8 x 256 x 256 x 3 uint8, up=2) the
// kernel reads 1.57 MB and writes 2.10 MB of gray and 0.52 MB of low, about
// 1.3 us of HBM time at 3.35 TB/s; the launch costs more than the traffic.
// The design therefore does one pass in one launch: the NHWC bytes are read
// as they lie (no transpose to channel planes, which the TPU needed only for
// its (8, 128) tiling), the fp32 RGB tensor never exists, and each block owns
// a strip of output rows of one image.  A block writes gray for the input
// rows of its strip, then for each output row combines its two tap rows into
// one shared-memory row (recomputing their luma from the bytes, which L1/L2
// hold, instead of waiting on other blocks) and reduces that row into low.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 48 * 1024;   // one fp32 row of the widest image

__device__ __forceinline__ float luma_at(const uint8_t* __restrict__ px) {
  const float r = float(px[0]) / 255.0f;
  const float g = float(px[1]) / 255.0f;
  const float b = float(px[2]) / 255.0f;
  return r * 0.2125f + g * 0.7154f + b * 0.0721f;
}

// grid (ceil(h2 / rows), n).  row_taps / col_taps: int (out, 2) = (lo, hi);
// row_w / col_w: float (out, 2) = (w_lo, w_hi); hi == lo with w_hi == 0 where
// the matrix row has one non-zero.
__global__ void __launch_bounds__(kThreads)
gray_degrade_kernel(const uint8_t* __restrict__ rgb, const int* __restrict__ row_taps,
                    const float* __restrict__ row_w, const int* __restrict__ col_taps,
                    const float* __restrict__ col_w, float* __restrict__ gray,
                    float* __restrict__ low, int h, int w, int h2, int w2, int rows) {
  extern __shared__ float tmp[];   // one vertically combined row, w floats
  const int n = blockIdx.y;
  const int o0 = blockIdx.x * rows;
  const int o1 = min(o0 + rows, h2);
  const uint8_t* img = rgb + size_t(n) * h * w * 3;

  // 1. gray for the input rows of this strip: [o0*h/h2, o1*h/h2), the last
  //    strip down to row h, so the strips partition the image.
  const int hb = int(static_cast<long long>(o0) * h / h2);
  const int he = o1 == h2 ? h : int(static_cast<long long>(o1) * h / h2);
  float* g_img = gray + size_t(n) * h * w + size_t(hb) * w;
  const uint8_t* src = img + size_t(hb) * w * 3;
  const int count = (he - hb) * w;
  for (int i = threadIdx.x; i < count; i += kThreads) g_img[i] = luma_at(src + 3 * size_t(i));

  // 2. low, one output row at a time: rows first, then columns
  float* l_img = low + size_t(n) * h2 * w2;
  for (int o = o0; o < o1; ++o) {
    const uint8_t* r_lo = img + size_t(row_taps[2 * o]) * w * 3;
    const uint8_t* r_hi = img + size_t(row_taps[2 * o + 1]) * w * 3;
    const float w_lo = row_w[2 * o], w_hi = row_w[2 * o + 1];
    for (int x = threadIdx.x; x < w; x += kThreads)
      tmp[x] = fmaf(w_hi, luma_at(r_hi + 3 * x), w_lo * luma_at(r_lo + 3 * x));
    __syncthreads();
    for (int x = threadIdx.x; x < w2; x += kThreads)
      l_img[size_t(o) * w2 + x] = fmaf(col_w[2 * x + 1], tmp[col_taps[2 * x + 1]],
                                       col_w[2 * x] * tmp[col_taps[2 * x]]);
    __syncthreads();                // tmp is rewritten for the next row
  }
}

}  // namespace

extern "C" {

// rgb (n, h, w, 3) uint8 NHWC contiguous; row_taps/row_w (h2, 2); col_taps/
// col_w (w2, 2); gray (n, h, w) and low (n, h2, w2) fp32.  rows: output rows
// per block.  Launches on `stream` and returns cudaGetLastError().
int gray_degrade_launch(const void* rgb, const void* row_taps, const void* row_w,
                        const void* col_taps, const void* col_w, void* gray, void* low,
                        int n, int h, int w, int h2, int w2, int rows, void* stream) {
  if (n <= 0 || n > 65535 || h2 <= 0 || w2 <= 0 || h < h2 || w < w2 || rows <= 0)
    return cudaErrorInvalidValue;
  const size_t smem = size_t(w) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const dim3 grid((h2 + rows - 1) / rows, n);
  gray_degrade_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(rgb), static_cast<const int*>(row_taps),
      static_cast<const float*>(row_w), static_cast<const int*>(col_taps),
      static_cast<const float*>(col_w), static_cast<float*>(gray), static_cast<float*>(low),
      h, w, h2, w2, rows);
  return cudaGetLastError();
}

const char* gray_degrade_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

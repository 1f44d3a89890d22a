// SSIM plane sums for Hopper (sm_90a): separable Gaussian filters, the SSIM and
// contrast-structure maps and their sums, in one pass over the two images.
//
// Replaces the Pallas TPU kernel srcgan_tpu/ops/pallas/ssim_kernel.py:76
// (ssim_pallas, body _ssim_plane_kernel :37), the SSIM column of the eval
// protocol.  For every (image, channel) plane, with the WS taps g of the
// sigma-1.5 window and filt = valid rows-then-columns filter:
//
//     mu1 = filt(x), mu2 = filt(y)
//     s1 = filt(x*x) - mu1^2,  s2 = filt(y*y) - mu2^2,  s12 = filt(x*y) - mu1*mu2
//     c1 = (0.01 L)^2, c2 = (0.03 L)^2,  v1 = 2 s12 + c2,  v2 = s1 + s2 + c2
//     ssim_sum = sum ((2 mu1 mu2 + c1) v1) / ((mu1^2 + mu2^2 + c1) v2)
//     cs_sum   = sum v1 / v2
//
// over the (H-WS+1) x (W-WS+1) valid region; L is the plane's dynamic range,
// read from device memory.  The wrapper (ops/kernels/ssim_kernel.py) detects
// L and finishes the means.
//
// What bounds it: at the eval shape (8 x 256 x 256 x 3 fp32, twice) the two
// inputs are 12.6 MB, 3.8 us of HBM time at 3.35 TB/s, and the arithmetic is
// about 0.4 GFLOP, 6 us at the fp32 rate: the launch costs as much as either.
// The design is therefore one launch that reads each input once and keeps
// every filtered map on the chip.  The TPU kernel holds a whole plane in VMEM
// per grid step; a 512^2 plane does not fit a block's shared memory, so a
// block owns one 32 x 32 tile of outputs of one plane: it stages the
// (32+WS-1)^2 halo of x and y in shared memory (NHWC is read as it lies; the
// TPU's transpose to planes would be a second pass over HBM), runs the row
// pass of the five maps into shared memory and the column pass in registers,
// sums its SSIM and cs terms (warp shuffles, then one warp over the warps'
// sums) and writes ONE partial per block.  The wrapper adds the partials of a
// plane with torch.sum: no float atomics, so the result does not change from
// run to run.  Taps are applied in the TPU kernel's order, 0..WS-1, rows
// first; the map arithmetic uses the round-to-nearest intrinsics so that no
// subtraction of near-equal numbers is contracted into an fma the plain
// version does not have.
//
// Ragged tiles: a thread outside the valid region adds 0 to both sums (its
// terms would otherwise be c2/c2 = 1 each).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTile = 32;         // outputs per block, each way
constexpr int kThreads = 256;     // 8 warps; a warp owns 4 output rows
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTaps = 11;

struct Taps {
  float g[kMaxTaps];
};

template <int WS>
__global__ void __launch_bounds__(kThreads)
ssim_kernel(const float* __restrict__ x, const float* __restrict__ y,
            const float* __restrict__ dyn, Taps taps, float* __restrict__ ssim_part,
            float* __restrict__ cs_part, int h, int w, int c) {
  constexpr int kHalo = kTile + WS - 1;
  __shared__ float sx[kHalo][kHalo + 1];
  __shared__ float sy[kHalo][kHalo + 1];
  __shared__ float row[5][kHalo][kTile];   // x, y, x*x, y*y, x*y after the row pass
  __shared__ float red[2][kWarps];

  const int tid = threadIdx.x;
  const int plane = blockIdx.z;
  const int n = plane / c, ch = plane % c;
  const int w0 = blockIdx.x * kTile, h0 = blockIdx.y * kTile;
  const int vh = h - (WS - 1), vw = w - (WS - 1);

  // 1. the halo of x and y; zeros beyond the image (only masked outputs read them)
  for (int i = tid; i < kHalo * kHalo; i += kThreads) {
    const int r = i / kHalo, q = i % kHalo;
    const int gr = h0 + r, gc = w0 + q;
    float a = 0.0f, b = 0.0f;
    if (gr < h && gc < w) {
      const size_t at = ((size_t(n) * h + gr) * w + gc) * c + ch;
      a = x[at];
      b = y[at];
    }
    sx[r][q] = a;
    sy[r][q] = b;
  }
  __syncthreads();

  // 2. row pass (along W) of the five maps, taps 0..WS-1 in order
  for (int i = tid; i < kHalo * kTile; i += kThreads) {
    const int r = i / kTile, q = i % kTile;
    float xv = sx[r][q], yv = sy[r][q];
    float ax = xv * taps.g[0], ay = yv * taps.g[0];
    float axx = __fmul_rn(xv, xv) * taps.g[0], ayy = __fmul_rn(yv, yv) * taps.g[0];
    float axy = __fmul_rn(xv, yv) * taps.g[0];
#pragma unroll
    for (int k = 1; k < WS; ++k) {
      xv = sx[r][q + k];
      yv = sy[r][q + k];
      const float g = taps.g[k];
      ax = fmaf(xv, g, ax);
      ay = fmaf(yv, g, ay);
      axx = fmaf(__fmul_rn(xv, xv), g, axx);
      ayy = fmaf(__fmul_rn(yv, yv), g, ayy);
      axy = fmaf(__fmul_rn(xv, yv), g, axy);
    }
    row[0][r][q] = ax;
    row[1][r][q] = ay;
    row[2][r][q] = axx;
    row[3][r][q] = ayy;
    row[4][r][q] = axy;
  }
  __syncthreads();

  // 3. column pass (along H) in registers, then the maps and this thread's sums
  const float dyn_l = dyn[plane];
  const float k1 = 0.01f * dyn_l, k2 = 0.03f * dyn_l;
  const float c1 = __fmul_rn(k1, k1), c2 = __fmul_rn(k2, k2);
  const int q = tid % kTile;
  float ssim_sum = 0.0f, cs_sum = 0.0f;
#pragma unroll
  for (int j = 0; j < kTile / kWarps; ++j) {
    const int o = (tid / kTile) * (kTile / kWarps) + j;
    float f[5];
#pragma unroll
    for (int m = 0; m < 5; ++m) {
      float acc = row[m][o][q] * taps.g[0];
#pragma unroll
      for (int k = 1; k < WS; ++k) acc = fmaf(row[m][o + k][q], taps.g[k], acc);
      f[m] = acc;
    }
    const float mu1_sq = __fmul_rn(f[0], f[0]);
    const float mu2_sq = __fmul_rn(f[1], f[1]);
    const float mu1_mu2 = __fmul_rn(f[0], f[1]);
    const float s1 = __fsub_rn(f[2], mu1_sq);
    const float s2 = __fsub_rn(f[3], mu2_sq);
    const float s12 = __fsub_rn(f[4], mu1_mu2);
    const float v1 = __fadd_rn(__fmul_rn(2.0f, s12), c2);
    const float v2 = __fadd_rn(__fadd_rn(s1, s2), c2);
    const float num = __fmul_rn(__fadd_rn(__fmul_rn(2.0f, mu1_mu2), c1), v1);
    const float den = __fmul_rn(__fadd_rn(__fadd_rn(mu1_sq, mu2_sq), c1), v2);
    if (h0 + o < vh && w0 + q < vw) {
      ssim_sum += __fdiv_rn(num, den);
      cs_sum += __fdiv_rn(v1, v2);
    }
  }

  // 4. one partial per block: shuffles within a warp, then warp 0 over the warps
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    ssim_sum += __shfl_down_sync(0xffffffffu, ssim_sum, d);
    cs_sum += __shfl_down_sync(0xffffffffu, cs_sum, d);
  }
  if (tid % 32 == 0) {
    red[0][tid / 32] = ssim_sum;
    red[1][tid / 32] = cs_sum;
  }
  __syncthreads();
  if (tid == 0) {
    float a = 0.0f, b = 0.0f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      a += red[0][i];
      b += red[1][i];
    }
    const size_t tiles = size_t(gridDim.x) * gridDim.y;
    const size_t at = size_t(plane) * tiles + size_t(blockIdx.y) * gridDim.x + blockIdx.x;
    ssim_part[at] = a;
    cs_part[at] = b;
  }
}

template <int WS>
int launch(const float* x, const float* y, const float* dyn, const Taps& taps,
           float* ssim_part, float* cs_part, int planes, int h, int w, int c,
           cudaStream_t stream) {
  const int vh = h - (WS - 1), vw = w - (WS - 1);
  if (vh < 1 || vw < 1) return cudaErrorInvalidValue;
  const dim3 grid((vw + kTile - 1) / kTile, (vh + kTile - 1) / kTile, planes);
  if (grid.y > 65535u) return cudaErrorInvalidValue;
  ssim_kernel<WS><<<grid, kThreads, 0, stream>>>(x, y, dyn, taps, ssim_part, cs_part, h, w, c);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y (n, h, w, c) fp32 NHWC contiguous; dyn (n*c,) fp32, the range L of each
// plane; taps_host: ws floats in HOST memory; ssim_part, cs_part
// (n*c, tiles_y * tiles_x) fp32 with tiles = ceil((size - ws + 1) / 32).
// ws is one of 3, 5, 7, 9, 11.  Launches on `stream`; returns cudaGetLastError().
int ssim_launch(const void* x, const void* y, const void* dyn, const float* taps_host,
                void* ssim_part, void* cs_part, int n, int h, int w, int c, int ws,
                void* stream) {
  if (n <= 0 || c <= 0 || h <= 0 || w <= 0) return cudaErrorInvalidValue;
  const long long planes = static_cast<long long>(n) * c;
  if (planes > 65535) return cudaErrorInvalidValue;
  if (ws < 1 || ws > kMaxTaps) return cudaErrorInvalidValue;
  Taps taps;
  for (int k = 0; k < kMaxTaps; ++k) taps.g[k] = k < ws ? taps_host[k] : 0.0f;
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  const float* df = static_cast<const float*>(dyn);
  float* sp = static_cast<float*>(ssim_part);
  float* cp = static_cast<float*>(cs_part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int p = static_cast<int>(planes);
  switch (ws) {
    case 3: return launch<3>(xf, yf, df, taps, sp, cp, p, h, w, c, s);
    case 5: return launch<5>(xf, yf, df, taps, sp, cp, p, h, w, c, s);
    case 7: return launch<7>(xf, yf, df, taps, sp, cp, p, h, w, c, s);
    case 9: return launch<9>(xf, yf, df, taps, sp, cp, p, h, w, c, s);
    case 11: return launch<11>(xf, yf, df, taps, sp, cp, p, h, w, c, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* ssim_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

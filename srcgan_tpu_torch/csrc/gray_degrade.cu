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
// TPU kernel's dots sum them: fmaf(w_hi, hi, w_lo * lo) each.
//
// What bounds it: at the training shape (8 x 256 x 256 x 3 uint8, up=2) the
// kernel reads 1.57 MB and writes 2.10 MB of gray and 0.52 MB of low, 1.25 us
// at 3.35 TB/s: bytes, and at that size the time a wave of blocks takes to
// start and drain.  The design is one pass in one launch, one wave:
//
// - block o of image n owns output row o of low and the input rows
//   [o*H/H2, (o+1)*H/H2) (the last block down to row H), so the blocks
//   partition the image and the grid (H2, N) is 1,024 blocks of 128 threads
//   at the training shape, all resident at once on 132 SMs;
// - the block's rows are one contiguous run of pixels in NHWC, in gray too:
//   a thread converts 4 pixels at a time, three aligned 32-bit loads of 12
//   bytes and one float4 store of gray (a scalar head and tail where the run
//   does not start or end on 4 pixels, or where the pointers are not
//   aligned), each pixel's luma computed once, divided by 255.0f as the plain
//   version does (a reciprocal would round differently);
// - the same values go to shared memory, and low is formed from them after
//   one barrier.  For every integer ratio (H = up * H2) both tap rows of
//   output row o lie in its own up rows: up*o + up/2 - 1 and up*o + up/2 for
//   even up, up*o + (up-1)/2 alone for odd up.  Where the ratio is ragged a
//   tap row may lie outside the block's rows; its luma is then recomputed
//   from the bytes (L2 holds them), the same function of the same bytes.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, PERF.md):
// 4.3 us on the device against the first design's 6.93 and the bound's 1.25;
// one wave's start and drain is most of it.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr size_t kMaxSmem = 232448;   // an H100 block's dynamic shared memory

// u8 / 255 per channel, then the weighted sum in the plain version's order
__device__ __forceinline__ float luma(uint32_t r, uint32_t g, uint32_t b) {
  const float rf = float(r) / 255.0f, gf = float(g) / 255.0f, bf = float(b) / 255.0f;
  return __fadd_rn(__fadd_rn(__fmul_rn(rf, 0.2125f), __fmul_rn(gf, 0.7154f)),
                   __fmul_rn(bf, 0.0721f));
}

__device__ __forceinline__ float luma_at(const uint8_t* __restrict__ px) {
  return luma(px[0], px[1], px[2]);
}

// grid (h2, n): block o owns output row o.  row_taps / col_taps: int (out, 2)
// = (lo, hi); row_w / col_w: float (out, 2) = (w_lo, w_hi); hi == lo with
// w_hi == 0 where the matrix row has one non-zero.  kVec: rgb 4-byte and gray
// 16-byte aligned.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
gray_degrade_kernel(const uint8_t* __restrict__ rgb, const int* __restrict__ row_taps,
                    const float* __restrict__ row_w, const int* __restrict__ col_taps,
                    const float* __restrict__ col_w, float* __restrict__ gray,
                    float* __restrict__ low, int h, int w, int h2, int w2) {
  extern __shared__ float4 rows_smem4[];   // the block's gray, from pixel a0 on
  float* rows_smem = reinterpret_cast<float*>(rows_smem4);
  const int o = blockIdx.x, n = blockIdx.y;
  const int hb = int(static_cast<long long>(o) * h / h2);
  const int he = o + 1 == h2 ? h : int(static_cast<long long>(o + 1) * h / h2);
  const size_t p0 = (size_t(n) * h + hb) * w, p1 = (size_t(n) * h + he) * w;
  const size_t a0 = p0 & ~size_t(3);
  const int tid = threadIdx.x;

  // the row taps of output row o, and the column taps of output column x
  const int lo = __ldg(row_taps + 2 * o), hi = __ldg(row_taps + 2 * o + 1);
  const float rw_lo = __ldg(row_w + 2 * o), rw_hi = __ldg(row_w + 2 * o + 1);
  struct Col {
    int lo, hi;
    float w_lo, w_hi;
  };
  auto col = [&](int x) {
    return Col{__ldg(col_taps + 2 * x), __ldg(col_taps + 2 * x + 1), __ldg(col_w + 2 * x),
               __ldg(col_w + 2 * x + 1)};
  };
  // a thread's first column taps are loaded now, so that their latency
  // hides behind step 1
  const Col first = col(tid < w2 ? tid : 0);

  // 1. gray for the block's rows: a vector body on whole 4-pixel groups, a
  //    scalar head and tail
  size_t v0 = p1, v1 = p1;
  if (kVec) {
    const size_t up0 = (p0 + 3) & ~size_t(3), dn1 = p1 & ~size_t(3);
    v0 = up0 < p1 ? up0 : p1;
    v1 = dn1 > v0 ? dn1 : v0;
    for (size_t p = v0 + 4 * size_t(tid); p < v1; p += 4 * kThreads) {
      const uint32_t* src = reinterpret_cast<const uint32_t*>(rgb + 3 * p);
      const uint32_t a = __ldg(src), b = __ldg(src + 1), c = __ldg(src + 2);
      float4 v;   // bytes: r0 g0 b0 r1 | g1 b1 r2 g2 | b2 r3 g3 b3
      v.x = luma(a & 255u, (a >> 8) & 255u, (a >> 16) & 255u);
      v.y = luma(a >> 24, b & 255u, (b >> 8) & 255u);
      v.z = luma((b >> 16) & 255u, b >> 24, c & 255u);
      v.w = luma((c >> 8) & 255u, (c >> 16) & 255u, c >> 24);
      *reinterpret_cast<float4*>(gray + p) = v;
      rows_smem4[(p - a0) / 4] = v;
    }
  }
  for (size_t p = p0 + tid; p < v0; p += kThreads) {
    const float v = luma_at(rgb + 3 * p);
    gray[p] = v;
    rows_smem[p - a0] = v;
  }
  for (size_t p = v1 + tid; p < p1; p += kThreads) {
    const float v = luma_at(rgb + 3 * p);
    gray[p] = v;
    rows_smem[p - a0] = v;
  }
  __syncthreads();

  // 2. low row o: rows first, then columns, from the block's gray where the
  //    tap row is one of its rows
  auto g = [&](int row, int x) {
    const size_t at = (size_t(n) * h + row) * w + x;
    return row >= hb && row < he ? rows_smem[at - a0] : luma_at(rgb + 3 * at);
  };
  float* l_row = low + (size_t(n) * h2 + o) * w2;
  for (int x = tid; x < w2; x += kThreads) {
    const Col t = x == tid ? first : col(x);
    const float t_lo = fmaf(rw_hi, g(hi, t.lo), rw_lo * g(lo, t.lo));
    const float t_hi = fmaf(rw_hi, g(hi, t.hi), rw_lo * g(lo, t.hi));
    l_row[x] = fmaf(t.w_hi, t_hi, t.w_lo * t_lo);
  }
}

}  // namespace

extern "C" {

// Bytes of shared memory a block takes at this shape: the most input rows a
// block owns (ceil(h / h2)) of w floats, and 3 of alignment.
long long gray_degrade_smem_bytes(int h, int w, int h2) {
  if (h <= 0 || w <= 0 || h2 <= 0) return 0;
  return (static_cast<long long>((h + h2 - 1) / h2) * w + 4) * 4;
}

// rgb (n, h, w, 3) uint8 NHWC contiguous; row_taps/row_w (h2, 2); col_taps/
// col_w (w2, 2); gray (n, h, w) and low (n, h2, w2) fp32.  One launch on
// `stream`; returns cudaGetLastError().
int gray_degrade_launch(const void* rgb, const void* row_taps, const void* row_w,
                        const void* col_taps, const void* col_w, void* gray, void* low,
                        int n, int h, int w, int h2, int w2, void* stream) {
  if (n <= 0 || n > 65535 || h2 <= 0 || w2 <= 0 || h < h2 || w < w2)
    return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(gray_degrade_smem_bytes(h, w, h2));
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {   // above 48 KB only after this, on the current device
    const void* fns[2] = {reinterpret_cast<const void*>(gray_degrade_kernel<true>),
                          reinterpret_cast<const void*>(gray_degrade_kernel<false>)};
    for (const void* fn : fns) {
      const cudaError_t err = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kMaxSmem));
      if (err != cudaSuccess) return err;
    }
  }
  const bool vec = (reinterpret_cast<uintptr_t>(rgb) & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(gray) & 15) == 0;
  const dim3 grid(h2, n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* src = static_cast<const uint8_t*>(rgb);
  const int* rt = static_cast<const int*>(row_taps);
  const float* rw = static_cast<const float*>(row_w);
  const int* ct = static_cast<const int*>(col_taps);
  const float* cw = static_cast<const float*>(col_w);
  float* g = static_cast<float*>(gray);
  float* l = static_cast<float*>(low);
  if (vec)
    gray_degrade_kernel<true><<<grid, kThreads, smem, s>>>(src, rt, rw, ct, cw, g, l, h, w, h2, w2);
  else
    gray_degrade_kernel<false><<<grid, kThreads, smem, s>>>(src, rt, rw, ct, cw, g, l, h, w, h2, w2);
  return cudaGetLastError();
}

const char* gray_degrade_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

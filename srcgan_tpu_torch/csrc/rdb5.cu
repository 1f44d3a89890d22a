// One ResidualDenseBlock_5 per launch, in bf16 or int8, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel srcgan_tpu/ops/pallas/rdb5_kernel.py::_kernel,
// which both rdb5_bf16_fused and rdb5_int8_fused run.  The block is five 3x3
// convolutions over the dense concat [x, x1..x4] (64 + 4*32 channels), each
// followed by LeakyReLU, and out = conv5 * lemda + x:
//
//   bf16: bf16 operands, fp32 sums over taps and sources, + bias, LeakyReLU,
//         the stage output rounded to bf16; out rounded to bf16.
//   int8: int8 operands (x and every x_k quantized as round(v * rq), the
//         weights quantized by the wrapper), int32 sums over taps and sources,
//         ONE fp32 dequant per stage (pre * sw + bias), LeakyReLU, requantize;
//         out = x5 * lemda + x in fp32.
//
// What bounds it: 479,232 FLOP per pixel against 256 B (bf16) or 512 B (int8
// form, fp32 in and out) moved, far above the card's ridge, so the tensor
// cores bound it.  The TPU kernel holds a whole padded image in its 100 MB of
// VMEM; a block here has 227 KB.  A block owns a 16x16 tile of outputs of one
// image and keeps everything the tile needs in shared memory: x with a
// 5-pixel halo (26x26x64) and x1..x4 on shrinking regions (24^2, 22^2, 20^2,
// 18^2 x 32), 200,704 B in bf16 and 100,352 B in int8.  The halo is
// recomputed by neighbouring tiles (1.34x the operations).  The work goes by
// stage, not by source as on the TPU: stage i sums its sources 0..i out of
// shared memory into 32- or 64-wide accumulators in registers, which is the
// same function (the int32 sums are exact in any order, and the bf16 form
// never rounds a partial sum).  There is no im2col: the nine taps are nine
// shifted reads of the source tile.  x1..x4 are written as ZERO outside the
// image, as the convolutions' zero padding has them (not as
// lrelu(bias)), on all four edges and on a ragged last tile.
//
// The products are mma.sync (m16n8k16 bf16 -> f32, m16n8k32 s8 -> s32): a
// warp takes up to five 16-pixel slabs of the stage's region at once and
// reuses each weight fragment on all of them.  A fragments are single 32-bit
// reads of shared memory, whose words are XOR-swizzled per pixel so that the
// 8 pixels x 4 words a fragment register reads fall in 32 different banks
// (padding would not fit).  The weights (479 KB in bf16) do not fit beside
// the tiles: the wrapper stores them in fragment order and every warp streams
// them from L2 with 16-byte loads.  wgmma, TMA and staging the weights in
// shared memory are left for later work.
//
// Every fp32 step of the int8 form uses _rn intrinsics, so nvcc contracts no
// multiply-add that the plain version (separate torch ops) lacks: one ulp can
// flip a requantization round.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kTile = 16;     // outputs per block, each way
constexpr int kHalo = 5;      // context a chain of five 3x3 convolutions needs
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kNF = 64;       // channels of x and of the output
constexpr int kGC = 32;       // channels of x1..x4

// Source j (0 = x, k = x_k) lives on a side(j) x side(j) region around the
// tile; stage i (0..4) writes source i+1, and stage 4 the 16x16 output.
__host__ __device__ constexpr int side(int j) { return kTile + 2 * (kHalo - j); }
__host__ __device__ constexpr int chans(int j) { return j == 0 ? kNF : kGC; }
__host__ __device__ constexpr int width(int i) { return i == 4 ? kNF : kGC; }

// Operand elements per 32-bit word: 2 bf16 or 4 int8.  In words the two
// forms then look alike: a k-step of one mma spans 8 words of a pixel.
template <bool Q> __host__ __device__ constexpr int elems() { return Q ? 4 : 2; }
template <bool Q> __host__ __device__ constexpr int wpp(int j) { return chans(j) / elems<Q>(); }

// Word offset of source j's tile in shared memory; buf_off(5) is the total.
template <bool Q> __host__ __device__ constexpr int buf_off(int j) {
  int o = 0;
  for (int k = 0; k < j; ++k) o += side(k) * side(k) * wpp<Q>(k);
  return o;
}

// Word offset of (stage i, source j) in the fragment-ordered weights; the
// wrapper (ops/kernels/rdb5_kernel.py::_fragments) writes them in this order.
template <bool Q> __host__ __device__ constexpr int frag_off(int i, int j) {
  int o = 0;
  for (int a = 0; a < 5; ++a)
    for (int b = 0; b <= a; ++b) {
      if (a == i && b == j) return o;
      o += 9 * chans(b) * width(a) / elems<Q>();
    }
  return o;
}

// Word index of word w of pixel p in a tile of WPP words per pixel.  The 4-word
// group index is XORed with pixel bits so that 8 consecutive pixels x 4
// consecutive words cover all 32 banks.
template <int WPP> __device__ __forceinline__ int swz(int p, int w) {
  constexpr int kPixPer128B = 32 / WPP;
  constexpr int kGroups = WPP / 4;
  return p * WPP + (w ^ (((p / kPixPer128B) % kGroups) << 2));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int quantize(float v, float r) {
  const float q = rintf(__fmul_rn(v, r));            // round half to even
  return int(fminf(fmaxf(q, -127.f), 127.f));
}

__device__ __forceinline__ float leaky(float v, float alpha) {
  return v >= 0.f ? v : __fmul_rn(alpha, v);
}

// Source J's contribution to stage I for this warp's MT slabs of 16 pixels.
// (py, px)[i][h]: the pixel of row g + 8h of slab i, in the stage's region.
template <bool Q, int I, int J, int MT, int NT, typename Acc>
__device__ __forceinline__ void accumulate(const uint32_t* smem,
                                           const uint32_t* __restrict__ frag,
                                           const int (&py)[MT][2], const int (&px)[MT][2],
                                           const bool (&on)[MT], Acc (&acc)[MT][NT][4],
                                           int lane) {
  constexpr int P = side(J);             // row pitch of the source tile, pixels
  constexpr int WPP = wpp<Q>(J);
  constexpr int KSTEPS = WPP / 8;
  constexpr int OFF = I - J;             // the stage's region inside the source's
  constexpr int VEC = NT * 2 / 4;        // uint4 loads of one lane's B registers
  constexpr int SRC = buf_off<Q>(J), WEIGHTS = frag_off<Q>(I, J);
  const uint32_t* src = smem + SRC;
  const uint4* wf = reinterpret_cast<const uint4*>(frag + WEIGHTS) + lane * VEC;
  const int t = lane & 3;
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap - dy * 3;
    int p[MT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) p[i][h] = (py[i][h] + OFF + dy) * P + px[i][h] + OFF + dx;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      uint32_t b[NT * 2];
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const uint4 q = __ldg(wf + size_t(tap * KSTEPS + ks) * 32 * VEC + v);
        b[4 * v] = q.x; b[4 * v + 1] = q.y; b[4 * v + 2] = q.z; b[4 * v + 3] = q.w;
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (!on[i]) continue;            // the same for every lane of the warp
        uint32_t a[4];
        a[0] = src[swz<WPP>(p[i][0], ks * 8 + t)];
        a[1] = src[swz<WPP>(p[i][1], ks * 8 + t)];
        a[2] = src[swz<WPP>(p[i][0], ks * 8 + 4 + t)];
        a[3] = src[swz<WPP>(p[i][1], ks * 8 + 4 + t)];
#pragma unroll
        for (int j = 0; j < NT; ++j) mma(acc[i][j], a, b[2 * j], b[2 * j + 1]);
      }
    }
  }
}

// Stage I of the block for one tile: sum sources 0..I, then the epilogue.
// I < 4 writes source I+1 into shared memory; I == 4 writes the output.
template <bool Q, int I>
__device__ __forceinline__ void stage(uint32_t* smem, const uint32_t* __restrict__ frag,
                                      const float* __restrict__ sw,
                                      const float* __restrict__ rq,
                                      const float* __restrict__ bias, const void* xg, void* outg,
                                      int img, int ty0, int tx0, int H, int W, float alpha,
                                      float lemda) {
  using Acc = typename std::conditional<Q, int, float>::type;
  constexpr int R = side(I + 1);         // the stage's region: R x R pixels
  constexpr int M = R * R;
  constexpr int SLABS = (M + 15) / 16;
  constexpr int MT = (SLABS + kWarps - 1) / kWarps;
  constexpr int NT = width(I) / 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  int m[MT][2], py[MT][2], px[MT][2];
  bool on[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int slab = warp + i * kWarps;
    on[i] = slab < SLABS;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[i][h] = slab * 16 + g + 8 * h;
      const int mc = m[i][h] < M ? m[i][h] : M - 1;   // rows past the region read a valid pixel
      py[i][h] = mc / R;
      px[i][h] = mc - py[i][h] * R;
    }
  }
  Acc acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  accumulate<Q, I, 0, MT, NT>(smem, frag, py, px, on, acc, lane);
  if constexpr (I >= 1) accumulate<Q, I, 1, MT, NT>(smem, frag, py, px, on, acc, lane);
  if constexpr (I >= 2) accumulate<Q, I, 2, MT, NT>(smem, frag, py, px, on, acc, lane);
  if constexpr (I >= 3) accumulate<Q, I, 3, MT, NT>(smem, frag, py, px, on, acc, lane);
  if constexpr (I >= 4) accumulate<Q, I, 4, MT, NT>(smem, frag, py, px, on, acc, lane);

  constexpr int kOut = kHalo - 1 - I;    // halo of the stage's region around the tile
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    if (!on[i]) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (m[i][h] >= M) continue;
      const int gy = ty0 - kOut + py[i][h], gx = tx0 - kOut + px[i][h];
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = j * 8 + 2 * t;     // this lane's two channels: c, c + 1
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float b = __ldg(bias + I * kNF + c + e);
          if constexpr (Q)
            v[e] = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * h + e]),
                                       __ldg(sw + I * kNF + c + e)), b);
          else
            v[e] = __fadd_rn(acc[i][j][2 * h + e], b);
        }
        if constexpr (I < 4) {
          // x_{I+1}: zero outside the image, as the next convolution's padding
          v[0] = inside ? leaky(v[0], alpha) : 0.f;
          v[1] = inside ? leaky(v[1], alpha) : 0.f;
          constexpr int WD = wpp<Q>(I + 1), DST = buf_off<Q>(I + 1);
          uint32_t* dst = smem + DST;
          if constexpr (Q) {
            const int q0 = quantize(v[0], __ldg(rq + (I + 1) * kNF + c));
            const int q1 = quantize(v[1], __ldg(rq + (I + 1) * kNF + c + 1));
            uint16_t* half = reinterpret_cast<uint16_t*>(dst + swz<WD>(m[i][h], c / 4));
            half[t & 1] = uint16_t((q0 & 0xff) | ((q1 & 0xff) << 8));
          } else {
            const __nv_bfloat162 pair = __floats2bfloat162_rn(v[0], v[1]);
            dst[swz<WD>(m[i][h], c / 2)] = *reinterpret_cast<const uint32_t*>(&pair);
          }
        } else {
          if (!inside) continue;         // a ragged last tile
          const size_t at = ((size_t(img) * H + gy) * W + gx) * kNF + c;
          if constexpr (Q) {
            const float2 x = *reinterpret_cast<const float2*>(static_cast<const float*>(xg) + at);
            float2 o;
            o.x = __fadd_rn(__fmul_rn(v[0], lemda), x.x);
            o.y = __fadd_rn(__fmul_rn(v[1], lemda), x.y);
            *reinterpret_cast<float2*>(static_cast<float*>(outg) + at) = o;
          } else {
            const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                static_cast<const __nv_bfloat16*>(xg) + at));
            *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(outg) + at) =
                __floats2bfloat162_rn(__fadd_rn(__fmul_rn(v[0], lemda), x.x),
                                      __fadd_rn(__fmul_rn(v[1], lemda), x.y));
          }
        }
      }
    }
  }
}

template <bool Q>
__global__ void __launch_bounds__(kThreads, 1)
rdb5_kernel(const void* __restrict__ xg, const uint32_t* __restrict__ frag,
            const float* __restrict__ sw, const float* __restrict__ rq,
            const float* __restrict__ bias, void* __restrict__ outg, int H, int W, float alpha,
            float lemda) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int img = blockIdx.z, ty0 = blockIdx.y * kTile, tx0 = blockIdx.x * kTile;

  // x with its halo into shared memory, zero outside the image
  constexpr int P0 = side(0), WPP0 = wpp<Q>(0);
  constexpr int VECS = WPP0 / (Q ? 1 : 4);   // loads per pixel: 16 float4 or 8 uint4
  for (int idx = threadIdx.x; idx < P0 * P0 * VECS; idx += kThreads) {
    const int p = idx / VECS, v = idx - p * VECS;
    const int y = p / P0, x = p - y * P0;
    const int gy = ty0 - kHalo + y, gx = tx0 - kHalo + x;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const size_t pix = (size_t(img) * H + (inside ? gy : 0)) * W + (inside ? gx : 0);
    if constexpr (Q) {
      // four fp32 channels -> four int8 in one word
      float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
      if (inside) f = __ldg(reinterpret_cast<const float4*>(xg) + pix * (kNF / 4) + v);
      const float4 r = __ldg(reinterpret_cast<const float4*>(rq) + v);
      smem[swz<WPP0>(p, v)] = uint32_t(quantize(f.x, r.x) & 0xff) |
                              (uint32_t(quantize(f.y, r.y) & 0xff) << 8) |
                              (uint32_t(quantize(f.z, r.z) & 0xff) << 16) |
                              (uint32_t(quantize(f.w, r.w) & 0xff) << 24);
    } else {
      uint4 q = make_uint4(0u, 0u, 0u, 0u);
      if (inside) q = __ldg(reinterpret_cast<const uint4*>(xg) + pix * (kNF / 8) + v);
      *reinterpret_cast<uint4*>(smem + swz<WPP0>(p, v * 4)) = q;
    }
  }
  __syncthreads();
  stage<Q, 0>(smem, frag, sw, rq, bias, xg, outg, img, ty0, tx0, H, W, alpha, lemda);
  __syncthreads();
  stage<Q, 1>(smem, frag, sw, rq, bias, xg, outg, img, ty0, tx0, H, W, alpha, lemda);
  __syncthreads();
  stage<Q, 2>(smem, frag, sw, rq, bias, xg, outg, img, ty0, tx0, H, W, alpha, lemda);
  __syncthreads();
  stage<Q, 3>(smem, frag, sw, rq, bias, xg, outg, img, ty0, tx0, H, W, alpha, lemda);
  __syncthreads();
  stage<Q, 4>(smem, frag, sw, rq, bias, xg, outg, img, ty0, tx0, H, W, alpha, lemda);
}

static_assert(sizeof(uint32_t) * buf_off<false>(5) <= 232448,
              "the bf16 tiles exceed a Hopper block's shared memory");

template <bool Q>
int launch(const void* x, const void* frag, const float* sw, const float* rq, const float* bias,
           void* out, int n, int h, int w, float alpha, float lemda, cudaStream_t stream) {
  constexpr size_t smem = sizeof(uint32_t) * buf_off<Q>(5);
  cudaError_t err = cudaFuncSetAttribute(rdb5_kernel<Q>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(w / kTile, (h + kTile - 1) / kTile, n);
  rdb5_kernel<Q><<<grid, kThreads, smem, stream>>>(x, static_cast<const uint32_t*>(frag), sw, rq,
                                                   bias, out, h, w, alpha, lemda);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One RDB5 on x (n, h, w, 64), contiguous NHWC, into out of the same shape
// and type.  quant == 0: x and out bf16, frag the bf16 weights in fragment
// order (119,808 words), bias (5, 64) fp32; sw and rq are not read.
// quant != 0: x and out fp32, frag the int8 weights (59,904 words), sw, rq and
// bias (5, 64) fp32.  Every pointer 16-byte aligned; w % 16 == 0; n and
// ceil(h / 16) at most 65,535.  Launches on `stream`, returns cudaGetLastError().
int rdb5_launch(const void* x, const void* frag, const void* sw, const void* rq,
                const void* bias, void* out, int n, int h, int w, float alpha, float lemda,
                int quant, void* stream) {
  if (n <= 0 || n > 65535 || h <= 0 || (h + kTile - 1) / kTile > 65535 || w <= 0 ||
      w % kTile != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fsw = static_cast<const float*>(sw);
  const float* frq = static_cast<const float*>(rq);
  const float* fb = static_cast<const float*>(bias);
  return quant ? launch<true>(x, frag, fsw, frq, fb, out, n, h, w, alpha, lemda, s)
               : launch<false>(x, frag, fsw, frq, fb, out, n, h, w, alpha, lemda, s);
}

const char* rdb5_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// GroupNorm's forward on bf16 NHWC (channels_last) activations, for Hopper
// (sm_90a), with an optional residual add and ReLU in its epilogue:
//
//     y = relu?(gamma * (x - mean_g) * rstd_g + beta + residual?)     -> bf16
//
// with mean_g and rstd_g = 1 / sqrt(var_g + eps) per (sample, group), over
// the group's channels and every pixel, in fp32 (biased variance, as
// torch.nn.GroupNorm and srcgan_tpu/ops/norm.py:11 group_norm take it).
//
// Replaces no TPU kernel: the JAX package leaves GroupNorm to XLA, which
// fuses the fp32 statistics, the affine map and the casts.  Eager PyTorch
// does not: its path cast the bf16 channels_last activation to fp32, read it
// as contiguous NCHW, normalised in fp32, cast back, then ran the ReLU and the
// residual add as passes of their own, ~30-36 bytes an element.  This kernel
// is the colorizer's (ResDeconv's) 32 GroupNorm(32) calls a bf16 forward.
//
// What bounds it: bytes.  x is read twice (statistics, then apply), the
// residual once where there is one, y written once: 6 bytes an element, 8
// with a residual: at (8,256,256,64), 67.1 MB a tensor, 201 MB moved (268 MB
// with a residual), 60 us (80 us) at 3.35 TB/s; the colorizer's 32 norms at
// batch 8 of 512^2 move 3.8 GB, 1.13 ms.  The function itself needs 2 bytes
// an element less (x read once: 4, 6 with a residual), the least time the
// kernel is measured against.  The design is two launches, each a stream of
// 16-byte accesses:
//
// 1. statistics.  Grid (chunks, n): block (c, n) owns a run of pixels of
//    sample n.  A thread keeps 8 channels of one pixel column (one 16-byte
//    load a pixel, neighbouring threads on neighbouring addresses), sums of
//    (x - k) and (x - k)^2 about k, its first value, in fp32, four loads in
//    flight.  Its channels' (count, mean, M2) are merged into its groups by
//    Chan's rule, then the block's into one per group by a tree in shared
//    memory, in a fixed order, and written to a small fp32 scratch.  No
//    atomics: the result is the same from run to run.
// 2. apply.  Grid (chunks, n) again, taken in reverse order, so that the
//    first blocks re-read what the statistics pass read last (in L2).  A
//    block merges its sample's partials in a fixed order (each thread a
//    strided run of one group's chunks, coalesced, then one thread a group
//    over those runs), forms a = gamma * rstd and b = beta - mean * a per
//    channel in shared memory, and streams its pixels: 16-byte loads of x
//    (and the residual), fmaf(x, a, b) (+ residual) (ReLU) in fp32, one
//    rounding to bf16, 16-byte stores.
//
// The chunks follow a sample's H * W * C alone (group_norm_chunks): at
// least kMinElems elements a block, at most kMaxChunks a sample (the
// partials every apply block merges; 8 samples of 64 chunks fill the card's
// 132 SMs with 4 blocks each), in whole rows of a block's pixel grid.  Not
// the batch: a sample's sums are taken in the same order whatever the batch
// it comes in, so its answer is the same bits in every batch.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md), with residual and
// ReLU, a graph of 10 calls: 112 us a call at (8,256,256,64) against the
// 6-byte least time's 60 (the design's 8 bytes: 80), 55 at (8,128,128,128)
// against 30 (40), 29 at (8,64,64,256) against 15 (20), 15 at (8,32,32,512)
// against 7.5 (10).  No faster: 33, 98 or 128
// chunks a sample in place of 64, 8192 or 32768 elements a block, a
// programmatic dependent launch of the apply pass; merging the partials a
// warp a group (the first design) cost the apply pass up to 10 us.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;                  // channels a thread loads at once: 16 bytes
constexpr long long kMinElems = 16384;   // the least elements a block takes
constexpr int kMaxChunks = 64;           // partials a sample

struct Moments {
  float n, mean, m2;
};

// Chan's rule: the (count, mean, M2) of the union of a and b
__device__ __forceinline__ Moments merge(Moments a, Moments b) {
  if (b.n == 0.f) return a;
  if (a.n == 0.f) return b;
  const float n = a.n + b.n;
  const float wb = b.n / n;
  const float d = b.mean - a.mean;
  return {n, fmaf(d, wb, a.mean), a.m2 + b.m2 + d * d * a.n * wb};
}

__device__ __forceinline__ void unpack(const uint4& v, float (&f)[kVec]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack(const float (&f)[kVec]) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}

// The pixels of a block: a multiple of the pixels a pass of the block's
// threads covers (kThreads / (c / kVec)).
struct Plan {
  int chunks, pixels;
};

inline Plan plan(int hw, int c) {
  const int rows = kThreads / (c / kVec);
  long long chunks = (static_cast<long long>(hw) * c + kMinElems - 1) / kMinElems;
  if (chunks > kMaxChunks) chunks = kMaxChunks;
  int pixels = static_cast<int>((hw + chunks - 1) / chunks);
  pixels = (pixels + rows - 1) / rows * rows;
  return {(hw + pixels - 1) / pixels, pixels};
}

// kGv: the groups within one thread's 8 channels (8 / channels a group), or
// 1 where a group spans whole vectors.  part: (n, chunks, groups) Moments.
template <int kGv>
__global__ void __launch_bounds__(kThreads)
gn_stats_kernel(const uint4* __restrict__ x, Moments* __restrict__ part, int hw, int c,
                int groups, int pixels) {
  __shared__ Moments items[kThreads * kGv];
  const int v = c / kVec, rows = kThreads / v;
  const int cpg = c / groups;                       // channels a group
  const int vpg = cpg > kVec ? cpg / kVec : 1;      // vectors a group
  const int per_group = rows * vpg;                 // items a group
  const int chunk = blockIdx.x, n = blockIdx.y, tid = threadIdx.x;
  const int cv = tid % v, r = tid / v;
  const int p0 = chunk * pixels;
  const int p1 = min(hw, p0 + pixels);

  if (r < rows) {
    float k[kVec], s[kVec], q[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) k[j] = s[j] = q[j] = 0.f;
    const uint4* base = x + static_cast<size_t>(n) * hw * v + cv;
    int p = p0 + r, cnt = 0;
    if (p < p1) unpack(__ldg(base + static_cast<size_t>(p) * v), k);
    auto add = [&](const uint4& u) {
      float f[kVec];
      unpack(u, f);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float d = f[j] - k[j];
        s[j] += d;
        q[j] = fmaf(d, d, q[j]);
      }
    };
    for (; p + 3 * rows < p1; p += 4 * rows, cnt += 4) {
      const uint4 a0 = __ldg(base + static_cast<size_t>(p) * v);
      const uint4 a1 = __ldg(base + static_cast<size_t>(p + rows) * v);
      const uint4 a2 = __ldg(base + static_cast<size_t>(p + 2 * rows) * v);
      const uint4 a3 = __ldg(base + static_cast<size_t>(p + 3 * rows) * v);
      add(a0);
      add(a1);
      add(a2);
      add(a3);
    }
    for (; p < p1; p += rows, ++cnt) add(__ldg(base + static_cast<size_t>(p) * v));

    // the thread's channels, merged into its groups in channel order
    const float fc = static_cast<float>(cnt);
    constexpr int kPer = kVec / kGv;                // channels of a vector in one slot
#pragma unroll
    for (int gl = 0; gl < kGv; ++gl) {
      Moments m{0.f, 0.f, 0.f};
      if (cnt > 0) {
#pragma unroll
        for (int j = gl * kPer; j < (gl + 1) * kPer; ++j) {
          const float mean = s[j] / fc;
          m = merge(m, {fc, k[j] + mean, fmaxf(q[j] - s[j] * mean, 0.f)});
        }
      }
      // group g's items: the rows, and within a row the group's vectors
      const int g = cpg > kVec ? cv / vpg : cv * kGv + gl;
      const int idx = cpg > kVec ? r * vpg + cv % vpg : r;
      items[g * per_group + idx] = m;
    }
  }

  // the block's items of each group, halved in a fixed order
  for (int len = per_group; len > 1;) {
    const int half = (len + 1) / 2, pairs = len - half;
    __syncthreads();
    for (int i = tid; i < groups * pairs; i += kThreads) {
      const int g = i / pairs, j = i % pairs;
      Moments* at = items + g * per_group;
      at[j] = merge(at[j], at[j + half]);
    }
    len = half;
  }
  __syncthreads();
  for (int g = tid; g < groups; g += kThreads)
    part[(static_cast<size_t>(n) * gridDim.x + chunk) * groups + g] = items[g * per_group];
}

template <bool kResidual, bool kRelu>
__global__ void __launch_bounds__(kThreads)
gn_apply_kernel(const uint4* __restrict__ x, const uint4* __restrict__ res,
                const __nv_bfloat16* __restrict__ gamma, const __nv_bfloat16* __restrict__ beta,
                const Moments* __restrict__ part, uint4* __restrict__ y, int hw, int c,
                int groups, int pixels, float eps) {
  extern __shared__ float4 smem4[];
  float* a_s = reinterpret_cast<float*>(smem4);     // c scales
  float* b_s = a_s + c;                             // c shifts
  float* st = b_s + c;                              // (mean, rstd) a group
  __shared__ Moments red[kThreads];
  const int chunks = gridDim.x, tid = threadIdx.x;
  // reversed: the first blocks apply what the statistics pass read last
  const int lin = chunks * gridDim.y - 1 - (blockIdx.y * chunks + blockIdx.x);
  const int chunk = lin % chunks, n = lin / chunks;
  const int v = c / kVec;
  const int p0 = chunk * pixels;
  const int count = (min(hw, p0 + pixels) - p0) * v;
  const size_t e0 = (static_cast<size_t>(n) * hw + p0) * v;

  // the block's first vectors of x and the residual are loaded first, so
  // that their latency hides behind the merge of the statistics
  uint4 xv[4], rv[4];
  auto load4 = [&](int i) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      xv[u] = __ldg(x + e0 + i + u * kThreads);
      if (kResidual) rv[u] = __ldg(res + e0 + i + u * kThreads);
    }
  };
  bool loaded = tid + 3 * kThreads < count;
  if (loaded) load4(tid);

  // 1. the sample's statistics: thread t merges the partials of group
  //    t % gs (gs groups a pass) of every (kThreads / gs)-th chunk from
  //    chunk t / gs on, then one thread a group merges those in order
  const Moments* ps = part + static_cast<size_t>(n) * chunks * groups;
  const int gs = groups < kThreads ? groups : kThreads;
  const int lanes = kThreads / gs;
  for (int g0 = 0; g0 < groups; g0 += gs) {
    const int g = g0 + tid % gs, j0 = tid / gs;
    Moments m{0.f, 0.f, 0.f};
    if (j0 < lanes && g < groups) {
#pragma unroll 4
      for (int j = j0; j < chunks; j += lanes) m = merge(m, ps[static_cast<size_t>(j) * groups + g]);
    }
    red[tid] = m;
    __syncthreads();
    if (tid < gs && g0 + tid < groups) {
      Moments t = red[tid];
      for (int l = 1; l < lanes; ++l) t = merge(t, red[l * gs + tid]);
      st[2 * (g0 + tid)] = t.mean;
      st[2 * (g0 + tid) + 1] = rsqrtf(fmaxf(t.m2 / t.n, 0.f) + eps);
    }
    __syncthreads();
  }
  const int cpg = c / groups;
  for (int ch = tid; ch < c; ch += kThreads) {
    const int g = ch / cpg;
    const float a = __bfloat162float(gamma[ch]) * st[2 * g + 1];
    a_s[ch] = a;
    b_s[ch] = fmaf(-st[2 * g], a, __bfloat162float(beta[ch]));
  }
  __syncthreads();

  // 2. the block's pixels, 8 channels a vector, four vectors in flight
  const int step = kThreads % v;
  auto apply = [&](const uint4& xin, const uint4& rin, int cv) {
    float f[kVec], a[kVec], b[kVec];
    unpack(xin, f);
    const float4* a4 = reinterpret_cast<const float4*>(a_s + cv * kVec);
    const float4* b4 = reinterpret_cast<const float4*>(b_s + cv * kVec);
    *reinterpret_cast<float4*>(a) = a4[0];
    *reinterpret_cast<float4*>(a + 4) = a4[1];
    *reinterpret_cast<float4*>(b) = b4[0];
    *reinterpret_cast<float4*>(b + 4) = b4[1];
    float rf[kVec];
    if (kResidual) unpack(rin, rf);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      f[j] = fmaf(f[j], a[j], b[j]);
      if (kResidual) f[j] += rf[j];
      if (kRelu) f[j] = f[j] < 0.f ? 0.f : f[j];   // NaN stays NaN, as torch's relu
    }
    return pack(f);
  };
  int i = tid, cv = tid % v;
  for (; i + 3 * kThreads < count; i += 4 * kThreads) {
    if (!loaded) load4(i);
    loaded = false;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      y[e0 + i + u * kThreads] = apply(xv[u], rv[u], cv);
      cv += step;
      if (cv >= v) cv -= v;
    }
  }
  for (; i < count; i += kThreads) {
    const uint4 r1 = kResidual ? __ldg(res + e0 + i) : uint4{};
    y[e0 + i] = apply(__ldg(x + e0 + i), r1, cv);
    cv += step;
    if (cv >= v) cv -= v;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <int kGv>
void launch_stats(const Plan& pl, int n, cudaStream_t s, const uint4* x, Moments* part, int hw,
                  int c, int groups) {
  gn_stats_kernel<kGv><<<dim3(pl.chunks, n), kThreads, 0, s>>>(x, part, hw, c, groups,
                                                               pl.pixels);
}

}  // namespace

extern "C" {

// The partials' chunks a sample at this shape; 0 where the kernel does not
// take it.  The scratch holds n * chunks * groups * 3 floats.
int group_norm_chunks(int n, int hw, int c, int groups) {
  if (n <= 0 || n > 65535 || hw <= 0 || c <= 0 || c % kVec || c / kVec > kThreads ||
      groups <= 0 || c % groups)
    return 0;
  const int cpg = c / groups;
  if (cpg <= kVec ? kVec % cpg : cpg % kVec) return 0;
  return plan(hw, c).chunks;
}

// x, residual (or null), y: (n, h, w, c) bf16 NHWC contiguous, 16-byte
// aligned; gamma, beta: (c,) bf16; scratch: group_norm_chunks(...) * n *
// groups * 3 floats.  Two launches on `stream`; returns cudaGetLastError().
int group_norm_launch(const void* x, const void* residual, const void* gamma, const void* beta,
                      void* y, void* scratch, long long scratch_floats, int n, int hw, int c,
                      int groups, float eps, int relu, void* stream) {
  const int chunks = group_norm_chunks(n, hw, c, groups);
  if (chunks == 0 || !aligned16(x) || !aligned16(y) || (residual && !aligned16(residual)) ||
      !gamma || !beta || scratch_floats < 3LL * n * chunks * groups)
    return cudaErrorInvalidValue;
  const Plan pl = plan(hw, c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint4* xv = static_cast<const uint4*>(x);
  Moments* part = static_cast<Moments*>(scratch);
  const int cpg = c / groups;
  switch (cpg >= kVec ? 1 : kVec / cpg) {
    case 1: launch_stats<1>(pl, n, s, xv, part, hw, c, groups); break;
    case 2: launch_stats<2>(pl, n, s, xv, part, hw, c, groups); break;
    case 4: launch_stats<4>(pl, n, s, xv, part, hw, c, groups); break;
    default: launch_stats<8>(pl, n, s, xv, part, hw, c, groups); break;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const uint4* rv = static_cast<const uint4*>(residual);
  uint4* yv = static_cast<uint4*>(y);
  auto kernel = residual ? (relu ? gn_apply_kernel<true, true> : gn_apply_kernel<true, false>)
                         : (relu ? gn_apply_kernel<false, true> : gn_apply_kernel<false, false>);
  const size_t smem = (2 * static_cast<size_t>(c) + 2 * groups) * sizeof(float);
  kernel<<<dim3(pl.chunks, n), kThreads, smem, s>>>(
      xv, rv, static_cast<const __nv_bfloat16*>(gamma), static_cast<const __nv_bfloat16*>(beta),
      part, yv, hw, c, groups, pl.pixels, eps);
  return cudaGetLastError();
}

const char* group_norm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// SSIM with the protocol's automatic dynamic range, for Hopper (sm_90a): the
// range, the separable Gaussian filters, the SSIM and contrast-structure maps
// and the finished means, in two launches and no other device work.
//
// Replaces the Pallas TPU kernel srcgan_tpu/ops/pallas/ssim_kernel.py:76
// (ssim_pallas, body _ssim_plane_kernel :37), the SSIM column of the eval
// protocol.  For every (image, channel) plane, with the WS taps g of the
// sigma-1.5 window and filt = valid rows-then-columns filter:
//
//     mu1 = filt(x), mu2 = filt(y)
//     s1 = filt(x*x) - mu1^2,  s2 = filt(y*y) - mu2^2,  s12 = filt(x*y) - mu1*mu2
//     c1 = (0.01 L)^2, c2 = (0.03 L)^2,  v1 = 2 s12 + c2,  v2 = s1 + s2 + c2
//     ssim = mean ((2 mu1 mu2 + c1) v1) / ((mu1^2 + mu2^2 + c1) v2)
//     cs   = mean v1 / v2
//
// over the (H-WS+1) x (W-WS+1) valid region, with L = max_val - min_val from
// x (y_pred): max_val 255 where max(x) > 128 else 1, min_val -1 where
// min(x) < -0.5 else 0, over the batch or per sample.
//
// What bounds it: at the eval shape (8 x 256 x 256 x 3 fp32, twice) the
// inputs are 12.6 MB, 3.8 us at 3.35 TB/s; the separable form is about 0.35
// GFLOP, 5.2 us at the fp32 rate.  About 250 instructions an output (the row
// pass 110 a row, the column pass 55, the maps and two IEEE divides) issue
// beside the staging of the rows, the range and the finish, which nothing
// overlaps.
//
// 1. range_kernel reduces x's min and max per sample (four float4 loads in
//    flight a thread) into one (min, max) a block.  Folding the range into
//    the main pass would cost it three more map evaluations (six divides) an
//    output, one for each other candidate L; this launch reads x once (6.3
//    MB) and leaves it in L2 for the main pass.
// 2. ssim_kernel: a block owns a strip of `sw` output columns of ALL C
//    channels of one image and `rows` output rows; thread t is (column q,
//    channel ch) = (t / C, t % C).  It first reduces the range pass's
//    partials of its sample (or of the batch) to L.  The strip's input rows,
//    each one contiguous NHWC run of (sw + WS - 1) * C floats, pass through a
//    ring of kSlots chunks of WS rows in shared memory (static where C and
//    the strip are constants, so that every read of the row pass takes an
//    immediate offset: a fifth faster at C = 3, below; cp.async, 16 bytes
//    where the rows are aligned, zero-filled beyond the image; every thread
//    copies a share),
//    one chunk ahead, so that a barrier falls once every WS rows.  For each
//    input row a thread forms the five row-pass sums of its (q, ch) from
//    shared memory (2 * WS reads at t + k * C: consecutive lanes
//    read consecutive words, free of bank conflicts for any C) and keeps the
//    last WS of each map in registers (5 x WS floats; the row loop is
//    unrolled by WS so every ring index is static).  Once WS rows are in,
//    each new row yields one output: the column pass in registers, the maps,
//    this thread's two sums.  Shared-memory reads an output: 2 WS (rows + WS
//    - 1) / rows, 29 at rows = 32, against about 94 of the first design (a
//    32 x 32 tile of one plane with the row pass through shared memory).
// 3. The finish: each block writes one (ssim, cs) partial, summed over its
//    threads in a fixed order (warp shuffles, then the warps in order).  The
//    last block of a sample to finish (the sample's atomic ticket; 64 blocks
//    contend for each at the eval shape, not 512 for one) sums the sample's
//    partials in double in a fixed order and writes its mean; the last of
//    those (the batch's ticket) sums the samples and writes the batch's
//    means and cs.  Each resets its ticket.  No float atomics: the result is
//    bit-equal from call to call.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W at the eval shape, per-sample
// range (python -m srcgan_tpu_torch.probes ssim, PERF.md): the range pass 2.8
// us, the main pass 24.1 us (the dynamic ring 30.2; 3 chunks 24.8; 16 or 64
// rows a block 28.3, 30.0); with the maps and divides left out 21.3, the
// column pass too 17.4, the row pass too 9.5.  The bound is 5.15 us.
//
// Taps are applied in the TPU kernel's order, 0..WS-1, rows first, and the
// map arithmetic uses the round-to-nearest intrinsics so that no subtraction
// of near-equal numbers is contracted into an fma the plain version does not
// have: every output term is the first design's bit for bit.  A thread whose
// column lies beyond the valid region adds nothing (its terms would be
// c2/c2 = 1 each); the rows a block emits are valid by construction.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

// For measuring only (python -m srcgan_tpu_torch.probes ssim).
// SSIM_STATIC_RING=0 takes the dynamic ring for every C; SSIM_SLOTS is the
// ring's count of chunks.  SSIM_LEAVE_OUT leaves work out of the main pass,
// so the result is wrong and only the time means something: 1 the maps and
// divides (the column pass's five sums are added instead), 2 the column pass
// too (the row pass's sums), 3 the row pass too (one read of each row).
#ifndef SSIM_STATIC_RING
#define SSIM_STATIC_RING 1
#endif
#ifndef SSIM_SLOTS
#define SSIM_SLOTS 2
#endif
#ifndef SSIM_LEAVE_OUT
#define SSIM_LEAVE_OUT 0
#endif

namespace {

constexpr int kMaxTaps = 11;
constexpr int kMaxThreads = 256;      // sw * C: a strip's (column, channel) pairs
constexpr int kSlots = SSIM_SLOTS;    // chunks of WS input rows in the ring
constexpr int kLeaveOut = SSIM_LEAVE_OUT;
constexpr size_t kMaxSmem = 232448;   // an H100 block's dynamic shared memory
constexpr int kStrip = 32;            // a strip's columns where C is a constant (1 or 3)
constexpr int kRangeThreads = 256;
constexpr int kRangeUnroll = 4;       // float4 loads in flight a thread
constexpr int kRangeBlocks = 528;     // four per SM of an H100, over all samples

struct Taps {
  float g[kMaxTaps];
};

// The workspace (one buffer, zeroed once by the caller, reused across calls):
// the main pass's tickets (the batch's, one a sample), L per sample (written
// for checks), the range pass's per-block min and max, the main pass's
// per-block partials and the finish's per-sample sums in double.
struct Layout {
  size_t dyn, tick, rmin, rmax, part, sums, bytes;
};

__host__ __device__ inline size_t align8(size_t b) { return (b + 7) & ~size_t(7); }

__host__ __device__ inline Layout layout(int n, int range_blocks, int blocks) {
  Layout l;
  l.dyn = 16;                                          // the batch's ticket: uint32 at 0
  l.tick = l.dyn + size_t(n) * 4;                      // a ticket a sample
  l.rmin = l.tick + size_t(n) * 4;
  l.rmax = l.rmin + size_t(n) * range_blocks * 4;
  l.part = l.rmax + size_t(n) * range_blocks * 4;
  l.sums = align8(l.part + size_t(blocks) * 2 * 4);
  l.bytes = l.sums + size_t(n) * 2 * 8;
  return l;
}

// The ring: kSlots chunks of WS rows of (sw + WS - 1) * c floats, x and y,
// each row padded to whole 16-byte groups.
__host__ __device__ constexpr int row_pitch(int ws, int c, int sw) {
  return ((sw + ws - 1) * c + 3) & ~3;
}

__host__ __device__ inline size_t smem_bytes(int ws, int c, int sw) {
  return size_t(2) * kSlots * ws * row_pitch(ws, c, sw) * sizeof(float);
}

inline int range_blocks_per_sample(int n, long long count) {
  long long per = (kRangeBlocks + n - 1) / n;
  const long long chunk = 4LL * kRangeUnroll * kRangeThreads;   // floats a block's one sweep
  const long long most = (count + chunk - 1) / chunk;
  if (per > most) per = most;
  return per < 1 ? 1 : static_cast<int>(per);
}

__device__ __forceinline__ float dyn_range(float mn, float mx) {
  const float max_val = mx > 128.0f ? 255.0f : 1.0f;
  const float min_val = mn < -0.5f ? -1.0f : 0.0f;
  return max_val - min_val;
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// min and max of a block's threads, in every thread's hands after the call
__device__ void block_minmax(float& mn, float& mx) {
  __shared__ float red[2][32];
  __syncthreads();   // red may still be read from an earlier call
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, d));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, d));
  }
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, warps = blockDim.x / 32;
  if (lane == 0) {
    red[0][warp] = mn;
    red[1][warp] = mx;
  }
  __syncthreads();
  mn = red[0][0];
  mx = red[1][0];
  for (int i = 1; i < warps; ++i) {
    mn = fminf(mn, red[0][i]);
    mx = fmaxf(mx, red[1][i]);
  }
}

// Sum of every thread's v in a fixed order (shuffles within a warp, then the
// warps in order); thread 0 holds the result.
template <typename T>
__device__ T block_sum(T v) {
  __shared__ T red[32];
  __syncthreads();
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xffffffffu, v, d);
  const int warps = (blockDim.x + 31) / 32;
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    v = red[0];
    for (int i = 1; i < warps; ++i) v += red[i];
  }
  return v;
}

// grid (blocks per sample, n), kRangeThreads threads.  x (n, count) fp32.
__global__ void __launch_bounds__(kRangeThreads)
range_kernel(const float* __restrict__ x, long long count, unsigned char* __restrict__ ws) {
  const int n = gridDim.y, nb = gridDim.x, s = blockIdx.y;
  const Layout lay = layout(n, nb, 0);
  float* rmin = reinterpret_cast<float*>(ws + lay.rmin);
  float* rmax = reinterpret_cast<float*>(ws + lay.rmax);

  const float* base = x + size_t(s) * count;
  float mn = __int_as_float(0x7f800000), mx = -mn;
  const long long stride = static_cast<long long>(nb) * kRangeThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kRangeThreads + threadIdx.x;
  long long done = 0;
  if ((reinterpret_cast<uintptr_t>(base) & 15) == 0) {
    const float4* b4 = reinterpret_cast<const float4*>(base);
    const long long nvec = count / 4;
    for (long long i = first; i < nvec; i += kRangeUnroll * stride) {
      float4 v[kRangeUnroll];   // independent loads in flight (a repeat past the end)
#pragma unroll
      for (int u = 0; u < kRangeUnroll; ++u) {
        const long long k = i + u * stride;
        v[u] = __ldg(b4 + (k < nvec ? k : i));
      }
#pragma unroll
      for (int u = 0; u < kRangeUnroll; ++u) {
        mn = fminf(mn, fminf(fminf(v[u].x, v[u].y), fminf(v[u].z, v[u].w)));
        mx = fmaxf(mx, fmaxf(fmaxf(v[u].x, v[u].y), fmaxf(v[u].z, v[u].w)));
      }
    }
    done = nvec * 4;
  }
  for (long long i = done + first; i < count; i += stride) {
    const float v = __ldg(base + i);
    mn = fminf(mn, v);
    mx = fmaxf(mx, v);
  }
  block_minmax(mn, mx);
  if (threadIdx.x == 0) {
    rmin[s * nb + blockIdx.x] = mn;
    rmax[s * nb + blockIdx.x] = mx;
  }
}

// grid (strips of sw columns, strips of `rows` rows, n); sw * c threads
// rounded up to whole warps (the threads past sw * c stage rows and take
// part in the sums, but read as the last pair does and count nothing).
// out: the mean (size_average) or n per-sample means, then cs.  CT: C as a
// constant (1 or 3, with sw = kStrip, so that every shared-memory read of the
// row pass takes an immediate offset), or 0 for C and sw given at run time.
template <int WS, int CT>
__global__ void __launch_bounds__(kMaxThreads)
ssim_kernel(const float* __restrict__ x, const float* __restrict__ y, Taps taps,
            unsigned char* __restrict__ ws, int range_blocks, float* __restrict__ out, int h,
            int w, int c_arg, int sw_arg, int rows, int per_sample, int size_average) {
  const int c = CT > 0 ? CT : c_arg;
  const int sw = CT > 0 ? kStrip : sw_arg;
  // the ring: static where C and sw are constants (the compiler then gives
  // every read an absolute address), dynamic otherwise
  extern __shared__ float ring_dyn[];
  constexpr int kStaticFloats = CT > 0 ? 2 * kSlots * WS * row_pitch(WS, CT, kStrip) : 4;
  __shared__ __align__(16) float ring_static[kStaticFloats];
  float* ring_smem = CT > 0 ? ring_static : ring_dyn;
  const int n = gridDim.z, img = blockIdx.z;
  const int blocks_per_sample = gridDim.x * gridDim.y;
  const Layout lay = layout(n, range_blocks, n * blocks_per_sample);
  unsigned* ticket = reinterpret_cast<unsigned*>(ws);
  unsigned* tick = reinterpret_cast<unsigned*>(ws + lay.tick);
  float* dyn = reinterpret_cast<float*>(ws + lay.dyn);
  const float* rmin = reinterpret_cast<const float*>(ws + lay.rmin);
  const float* rmax = reinterpret_cast<const float*>(ws + lay.rmax);
  float* part = reinterpret_cast<float*>(ws + lay.part);
  double* sums = reinterpret_cast<double*>(ws + lay.sums);

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int pair = min(tid, sw * c - 1);   // this thread's (column, channel)
  const int q = pair / c;
  const int w0 = blockIdx.x * sw, r0 = blockIdx.y * rows;
  const int vh = h - (WS - 1), vw = w - (WS - 1);
  const int rowlen = (sw + WS - 1) * c, pitch = row_pitch(WS, c, sw);
  const int in_rows = min(rows + WS - 1, h - r0);
  const int span = min(sw + WS - 1, w - w0) * c;   // floats of a row inside the image
  const size_t row_stride = size_t(w) * c;
  const size_t at0 = (size_t(img) * h + r0) * row_stride + size_t(w0) * c;
  float* sx = ring_smem;
  float* sy = ring_smem + kSlots * WS * pitch;
  // 16-byte copies where every row of the strip starts on 16 bytes in both
  // inputs (NHWC rows of W * C floats, strips of sw * C, both multiples of 4)
  const bool vec16 = row_stride % 4 == 0 && (size_t(w0) * c) % 4 == 0 &&
                     ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) & 15) == 0;

  // chunk k (rows k*WS .. k*WS+WS-1 of the strip) into slot k % kSlots; every
  // thread takes a share of the copies; a group is committed even when empty
  auto stage = [&](int k) {
    const int r0k = k * WS, nr = max(min(WS, in_rows - r0k), 0);
    const int slot = (k % kSlots) * WS * pitch;
    if (vec16) {
      const int groups = pitch / 4;          // 16-byte groups of a row
      for (int e = tid; e < nr * groups; e += nthreads) {
        const int r = e / groups, col = 4 * (e - r * groups);
        const int bytes = 4 * min(max(span - col, 0), 4);
        const size_t at = at0 + size_t(r0k + r) * row_stride + col;
        cp_async16(sx + slot + r * pitch + col, bytes ? x + at : x, bytes);
        cp_async16(sy + slot + r * pitch + col, bytes ? y + at : y, bytes);
      }
    } else {
      for (int e = tid; e < nr * rowlen; e += nthreads) {
        const int r = e / rowlen, col = e - r * rowlen;
        const bool in = col < span;
        const size_t at = at0 + size_t(r0k + r) * row_stride + col;
        cp_async4(sx + slot + r * pitch + col, in ? x + at : x, in);
        cp_async4(sy + slot + r * pitch + col, in ? y + at : y, in);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < kSlots - 1; ++k) stage(k);

  // L from the range pass's partials: this sample's, or the batch's
  float c1, c2;
  {
    const float inf = __int_as_float(0x7f800000);
    float mn = inf, mx = -inf;
    const int first = per_sample ? img * range_blocks : 0;
    const int count = per_sample ? range_blocks : n * range_blocks;
    for (int k = tid; k < count; k += nthreads) {
      mn = fminf(mn, rmin[first + k]);
      mx = fmaxf(mx, rmax[first + k]);
    }
    block_minmax(mn, mx);
    const float dyn_l = dyn_range(mn, mx);
    if (tid == 0 && blockIdx.x == 0 && blockIdx.y == 0) dyn[img] = dyn_l;
    const float k1 = 0.01f * dyn_l, k2 = 0.03f * dyn_l;
    c1 = __fmul_rn(k1, k1);
    c2 = __fmul_rn(k2, k2);
  }
  const bool counted = tid < sw * c && w0 + q < vw;

  float ring[5][WS];
  float ssim_sum = 0.0f, cs_sum = 0.0f;
  for (int base = 0; base < in_rows; base += WS) {
    cp_async_wait<kSlots - 2>();
    __syncthreads();                     // this chunk is in; the last one's slot is free
    stage(base / WS + kSlots - 1);
    const float* cx = sx + ((base / WS) % kSlots) * WS * pitch + pair;
    const float* cy = sy + ((base / WS) % kSlots) * WS * pitch + pair;
#pragma unroll
    for (int j = 0; j < WS; ++j) {
      const int i = base + j;
      if (i >= in_rows) break;           // the same for every thread of the block
      if (kLeaveOut >= 3) {
        ssim_sum += cx[j * pitch] + cy[j * pitch];
        continue;
      }

      // row pass (along W) of the five maps, taps 0..WS-1 in order
      const float* rx = cx + j * pitch;
      const float* ry = cy + j * pitch;
      float xv = rx[0], yv = ry[0];
      float ax = xv * taps.g[0], ay = yv * taps.g[0];
      float axx = __fmul_rn(xv, xv) * taps.g[0], ayy = __fmul_rn(yv, yv) * taps.g[0];
      float axy = __fmul_rn(xv, yv) * taps.g[0];
#pragma unroll
      for (int k = 1; k < WS; ++k) {
        xv = rx[k * c];
        yv = ry[k * c];
        const float g = taps.g[k];
        ax = fmaf(xv, g, ax);
        ay = fmaf(yv, g, ay);
        axx = fmaf(__fmul_rn(xv, xv), g, axx);
        ayy = fmaf(__fmul_rn(yv, yv), g, ayy);
        axy = fmaf(__fmul_rn(xv, yv), g, axy);
      }
      ring[0][j] = ax;
      ring[1][j] = ay;
      ring[2][j] = axx;
      ring[3][j] = ayy;
      ring[4][j] = axy;
      if (kLeaveOut >= 2) {
        ssim_sum += ax + ay + axx + ayy + axy;
        continue;
      }
      if (i < WS - 1) continue;

      // column pass (along H) over rows i-WS+1..i: slot (j + 1 + k) % WS
      float f[5];
#pragma unroll
      for (int m = 0; m < 5; ++m) {
        float acc = ring[m][(j + 1) % WS] * taps.g[0];
#pragma unroll
        for (int k = 1; k < WS; ++k) acc = fmaf(ring[m][(j + 1 + k) % WS], taps.g[k], acc);
        f[m] = acc;
      }
      if (kLeaveOut >= 1) {
        ssim_sum += f[0] + f[1] + f[2] + f[3] + f[4];
        continue;
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
      const float ssim_term = __fdiv_rn(num, den), cs_term = __fdiv_rn(v1, v2);
      ssim_sum += counted ? ssim_term : 0.0f;
      cs_sum += counted ? cs_term : 0.0f;
    }
  }
  cp_async_wait<0>();

  // one partial per block; the last block of a sample (its ticket) sums the
  // sample's partials; the last of those (the batch's ticket) sums the samples
  const float block_ssim = block_sum(ssim_sum);
  const float block_cs = block_sum(cs_sum);
  __shared__ bool last;
  if (tid == 0) {
    const int blk = img * blocks_per_sample + blockIdx.y * gridDim.x + blockIdx.x;
    part[2 * blk] = block_ssim;
    part[2 * blk + 1] = block_cs;
    __threadfence();
    last = atomicAdd(tick + img, 1u) == unsigned(blocks_per_sample) - 1u;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();

  const double valid = double(vh) * vw;
  double a = 0.0, b = 0.0;
  const float* mine = part + 2 * size_t(img) * blocks_per_sample;
  for (int k = tid; k < blocks_per_sample; k += nthreads) {
    a += double(__ldcg(mine + 2 * k));
    b += double(__ldcg(mine + 2 * k + 1));
  }
  a = block_sum(a);
  b = block_sum(b);
  if (tid == 0) {
    sums[2 * img] = a;
    sums[2 * img + 1] = b;
    if (!size_average) out[img] = float(a / (double(c) * valid));
    tick[img] = 0u;
    __threadfence();
    last = atomicAdd(ticket, 1u) == unsigned(n) - 1u;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();

  a = 0.0;
  b = 0.0;
  for (int s = tid; s < n; s += nthreads) {
    a += __ldcg(sums + 2 * s);
    b += __ldcg(sums + 2 * s + 1);
  }
  a = block_sum(a);
  b = block_sum(b);
  if (tid == 0) {
    const double count = double(n) * c * valid;
    if (size_average) out[0] = float(a / count);
    out[size_average ? 1 : n] = float(b / count);
    *ticket = 0u;
  }
}

template <int WS>
int launch(const float* x, const float* y, const Taps& taps, unsigned char* ws, float* out,
           int n, int h, int w, int c, int sw, int rows, int range_blocks, int per_sample,
           int size_average, cudaStream_t stream) {
  const int vh = h - (WS - 1), vw = w - (WS - 1);
  range_kernel<<<dim3(range_blocks, n), kRangeThreads, 0, stream>>>(
      x, static_cast<long long>(h) * w * c, ws);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((vw + sw - 1) / sw, (vh + rows - 1) / rows, n);
  const bool fixed = SSIM_STATIC_RING && sw == kStrip && (c == 1 || c == 3);
  const size_t smem = fixed ? 0 : smem_bytes(WS, c, sw);
  const int threads = (sw * c + 31) / 32 * 32;
  auto kernel = !fixed ? ssim_kernel<WS, 0> : c == 3 ? ssim_kernel<WS, 3> : ssim_kernel<WS, 1>;
  if (smem > 48 * 1024) {   // above 48 KB only after this, on the current device
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, stream>>>(x, y, taps, ws, range_blocks, out, h, w, c, sw, rows,
                                          per_sample, size_average);
  return cudaGetLastError();
}

bool valid_args(int n, int h, int w, int c, int ws, int sw, int rows) {
  if (n <= 0 || n > 65535 || c <= 0 || sw <= 0 || rows <= 0) return false;
  if (ws != 3 && ws != 5 && ws != 7 && ws != 9 && ws != 11) return false;
  if (h < ws || w < ws || sw * c > kMaxThreads || smem_bytes(ws, c, sw) > kMaxSmem) return false;
  return (h - ws + 1 + rows - 1) / rows <= 65535;
}

}  // namespace

extern "C" {

// Bytes of the workspace of a call at this shape and plan (0 if refused).
long long ssim_workspace_bytes(int n, int h, int w, int c, int ws, int sw, int rows) {
  if (!valid_args(n, h, w, c, ws, sw, rows)) return 0;
  const int blocks = ((w - ws + 1 + sw - 1) / sw) * ((h - ws + 1 + rows - 1) / rows) * n;
  const int rb = range_blocks_per_sample(n, static_cast<long long>(h) * w * c);
  return static_cast<long long>(layout(n, rb, blocks).bytes);
}

// Where in the workspace the last call wrote the L of every sample (n floats).
long long ssim_range_offset() { return 16; }

// x, y (n, h, w, c) fp32 NHWC contiguous; taps_host: ws floats in HOST
// memory; ws_buf: ssim_workspace_bytes() bytes, zeroed before its first use
// and used by one stream at a time; out: 2 floats (size_average) or n + 1.
// sw output columns by `rows` output rows per block, sw * c <= 256.  Two
// launches on `stream`; returns cudaGetLastError().
int ssim_launch(const void* x, const void* y, const float* taps_host, void* ws_buf, void* out,
                int n, int h, int w, int c, int ws, int sw, int rows, int per_sample,
                int size_average, void* stream) {
  if (!valid_args(n, h, w, c, ws, sw, rows)) return cudaErrorInvalidValue;
  Taps taps;
  for (int k = 0; k < kMaxTaps; ++k) taps.g[k] = k < ws ? taps_host[k] : 0.0f;
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  unsigned char* wb = static_cast<unsigned char*>(ws_buf);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rb = range_blocks_per_sample(n, static_cast<long long>(h) * w * c);
  switch (ws) {
    case 3: return launch<3>(xf, yf, taps, wb, of, n, h, w, c, sw, rows, rb, per_sample, size_average, s);
    case 5: return launch<5>(xf, yf, taps, wb, of, n, h, w, c, sw, rows, rb, per_sample, size_average, s);
    case 7: return launch<7>(xf, yf, taps, wb, of, n, h, w, c, sw, rows, rb, per_sample, size_average, s);
    case 9: return launch<9>(xf, yf, taps, wb, of, n, h, w, c, sw, rows, rb, per_sample, size_average, s);
    case 11: return launch<11>(xf, yf, taps, wb, of, n, h, w, c, sw, rows, rb, per_sample, size_average, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* ssim_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// x4 RDDBNet upsample tail at trunk resolution, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel srcgan_tpu/ops/pallas/tail_kernel.py::tail_x4_fused
// with two launches.  tail_x4_kernel: for each of deconv1's 4 phase blocks b,
// three chained GEMMs per row of the trunk output t0 (M = N*H*W rows of nf
// bf16 values),
//
//     t1   = lrelu(t0 . W1[b])          (M, nf)  x (nf, nf)
//     z2   = lrelu(t1 . W2m)            (M, nf)  x (nf, 4nf)
//     zall += z2 . Wall[b]              (M, 4nf) x (4nf, 144*ou)
//
// t1 and z2 rounded to bf16 (as the TPU kernel stages them), zall summed in
// fp32 and written once as bf16.  finish_kernel: the 9-tap shift-reduce, the
// bias and the pixel shuffle in one pass, zall -> (N, 4H, 4W, ou).
//
// What bounds the main kernel: at nf=64, ou=1 it does 458,752 FLOP per trunk
// row and moves 416 bytes, far above the bf16 ridge (~295 FLOP/byte): the
// tensor cores (61 us at (8,128,128,64)).  The design:
//
// - wgmma m64nNk16 with A from registers, and the intermediates never touch
//   shared memory.  The fp32 accumulator of a 64 x 16 column slice is,
//   register for register, the A fragment of one k16 step: thread t of warp w
//   holds rows 16w + t/4 and +8, columns 2(t%4), +1 and +8, +9 in both (to_a).
//   So t1 (m64nNF) after LeakyReLU and bf16 is GEMM 2's A operand; GEMM 2 runs
//   in 64-column chunks of z2, and each chunk (m64n64, 32 registers) after
//   LeakyReLU and bf16 is the A operand of the matching 64-deep k chunk of
//   GEMM 3 (m64n144).  The two interleave: the next chunk's GEMM 2 is in
//   flight while this chunk's GEMM 3 runs.  zall (m64n144, 72 registers) stays
//   in registers across all four b and all chunks.
// - Weights by bulk copies, laid out by ops/kernels/tail_kernel.py::prepare as
//   core matrices of 8 rows x 16 bytes that a descriptor without swizzle reads
//   as they lie.  W1 (all four b) and W2m stay in shared memory (one copy per
//   block); Wall streams through a ring of kSlots slices of 64 k-rows x 144
//   columns (18 KB), filled by one producer thread and released by one
//   arrival per consumer warp.
// - t0 goes from L2 straight into the A fragments' registers (each warp reads
//   its own 16 rows once, in that layout), a tile ahead: the next tile's loads
//   are in flight while this tile's products run.
// - Persistent: one block per SM (two consumer warpgroups of 64 rows and a
//   producer warpgroup) walks items of 128 rows x 144 columns of zall: item i
//   is row tile i / ncol and column tile i % ncol, and block k takes items
//   k, k + gridDim.x, ...  With ou > 1 (ncol = ou) GEMMs 1-2 are recomputed
//   per column tile, as the first design did.
//
// Registers per consumer thread at nf=64: zall 72, one accumulator 32, t0's A
// fragments 16 and the next tile's 16, t1's 16, two sets of z2's 32: 184
// beside addresses, under the 232 that setmaxnreg gives the consumers (the
// producer warpgroup keeps 40).  Shared memory at nf=64: W1 32 KB + W2m 32 KB
// + the ring 147,456 B + barriers = 213,128 B.  L2: each item reads its column
// tile of Wall once, 288 KiB at nf=64, 302 MB per launch at (8,128,128,64).
//
// finish_kernel is bound by its bytes (zall read once, the image written
// once: 12.6 us at (8,128,128,64), ou=1): one thread per trunk pixel and 8 of
// its 16*ou columns gathers the 9 taps (16 bytes each), sums them in fp32 in
// tap order, adds the bias (a bf16 value) and rounds once to bf16, written at
// its pixel-shuffled place (channel co*16 + i*4 + j -> pixel (4y+i, 4x+j)).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int kColTile = 144;                        // zall columns per item: one m64n144 sum
constexpr int kChunk = 64;                           // z2 columns per chunk, Wall k-rows per slice
constexpr int kSliceBytes = kChunk * kColTile * 2;   // 18,432
constexpr int kSlots = 8;                            // slices in the ring
constexpr int kTileRows = 128;                       // rows per item: two warpgroups of 64
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 128;           // setmaxnreg moves whole warpgroups' registers

// W1 (4, nf, nf) and W2m (nf, 4nf): the weights that stay in shared memory.
__host__ __device__ constexpr int resident_bytes(int nf) { return 16 * nf * nf; }
// ops/kernels/tail_kernel.py::smem_bytes states the same formula.
constexpr int smem_bytes(int nf) {
  return resident_bytes(nf) + kSlots * kSliceBytes + (2 * kSlots + 1) * 8;
}

__device__ __forceinline__ float leaky(float v, float alpha) { return v >= 0.f ? v : alpha * v; }

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// The A fragments of the N/16 k16 steps of a wgmma accumulator of N columns,
// through LeakyReLU and bf16: register e of step s packs the accumulator's
// registers 8s + 2e and 8s + 2e + 1 (columns 16s + 2(t%4) + 8(e/2), row t/4 +
// 8(e%2) of the warp's 16: the layouts of wgmma's D and of its A from registers).
template <int N>
__device__ __forceinline__ void to_a(const float (&d)[N / 2], uint32_t (&a)[N / 16][4], float alpha) {
#pragma unroll
  for (int s = 0; s < N / 16; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      a[s][e] = pack_bf16(leaky(d[8 * s + 2 * e], alpha), leaky(d[8 * s + 2 * e + 1], alpha));
}

// Rows `row` and row + 8 of t0 (m, NF) as A fragments, k16 step s in a[s]:
// words 8s + q and 8s + q + 4 of each row.  A row past m (the second half of
// a ragged last tile) reads row m - 1 and is never stored.
template <int NF>
__device__ __forceinline__ void load_t0(uint32_t (&a)[NF / 16][4], const bf16* __restrict__ t0, int row,
                                        int m, int q) {
  const uint32_t* p0 = reinterpret_cast<const uint32_t*>(t0 + size_t(min(row, m - 1)) * NF) + q;
  const uint32_t* p1 = reinterpret_cast<const uint32_t*>(t0 + size_t(min(row + 8, m - 1)) * NF) + q;
#pragma unroll
  for (int s = 0; s < NF / 16; ++s) {
    a[s][0] = __ldg(p0 + 8 * s);
    a[s][1] = __ldg(p1 + 8 * s);
    a[s][2] = __ldg(p0 + 8 * s + 4);
    a[s][3] = __ldg(p1 + 8 * s + 4);
  }
}

// Descriptors of the packed weights (core matrices, no swizzle).  A K x N
// matrix is [K/16][2][N/8][8 n][8 k]: a k16 step is 32 N bytes, the two core
// matrices of a step's k are 16 N bytes apart (lbo), groups of 8 columns 128.
template <int NF> __device__ __forceinline__ uint64_t w1_desc(unsigned base, int b, int s) {
  return descriptor(base + b * NF * NF * 2 + s * 32 * NF, 16 * NF, 128, false);
}
template <int NF> __device__ __forceinline__ uint64_t w2_desc(unsigned base, int chunk, int s) {
  return descriptor(base + s * 128 * NF + chunk * 8 * 128, 64 * NF, 128, false);
}
__device__ __forceinline__ uint64_t wall_desc(unsigned slice, int s) {
  return descriptor(slice + s * 32 * kColTile, 16 * kColTile, 128, false);
}

template <int NF>
__global__ void __launch_bounds__(kThreads, 1)
tail_x4_kernel(const bf16* __restrict__ t0, const uint8_t* __restrict__ weights,
               bf16* __restrict__ zall, int m, int ncol, float alpha) {
  constexpr int KS = NF / 16;                        // k16 steps of GEMMs 1-2; chunks of z2
  constexpr int RES = resident_bytes(NF);
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* const ring = smem + RES;
  uint64_t* const full = reinterpret_cast<uint64_t*>(ring + kSlots * kSliceBytes);
  uint64_t* const empty = full + kSlots;
  uint64_t* const wbar = empty + kSlots;
  const int items = (m + kTileRows - 1) / kTileRows * ncol;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(full + s, 1);                        // the producer's arrival, with the bytes
      mbar_init(empty + s, kConsumers / 32);         // one arrival per consumer warp
    }
    mbar_init(wbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    // ---- the producer: the resident weights once, then for every item the
    // 4 x KS slices of its column tile of Wall, slice n into slot n % kSlots
    // once the consumers have let go of slice n - kSlots
    if (threadIdx.x == kConsumers) {
      mbar_expect(wbar, RES);
      bulk_copy(smem, weights, RES, wbar);
      const uint8_t* const wall = weights + RES;    // [b][column tile][chunk] slices
      int n = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const uint8_t* const tile = wall + size_t(item % ncol) * KS * kSliceBytes;
        for (int b = 0; b < 4; ++b)
          for (int c = 0; c < KS; ++c, ++n) {
            const int slot = n % kSlots;
            mbar_wait(empty + slot, ((n / kSlots) & 1) ^ 1);
            mbar_expect(full + slot, kSliceBytes);
            bulk_copy(ring + slot * kSliceBytes, tile + size_t(b * ncol * KS + c) * kSliceBytes,
                      kSliceBytes, full + slot);
          }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int lane = threadIdx.x & 31, q = lane & 3;
  const int slab = (threadIdx.x >> 7) * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  const unsigned w1s = smem_addr(smem), w2s = w1s + 4 * NF * NF * 2, ring_s = smem_addr(ring);
  const int c9 = ncol * kColTile;
  uint32_t a0[KS][4], an[KS][4];
  int item = blockIdx.x;
  if (item < items) load_t0<NF>(a0, t0, item / ncol * kTileRows + slab, m, q);
  mbar_wait(wbar, 0);
  int n = 0;                                         // slices consumed
  for (; item < items; item += gridDim.x) {
    const int next = item + gridDim.x;
    if (next < items) load_t0<NF>(an, t0, next / ncol * kTileRows + slab, m, q);
    float z[kColTile / 2];
#pragma unroll
    for (int i = 0; i < kColTile / 2; ++i) z[i] = 0.f;

#pragma unroll 1
    for (int b = 0; b < 4; ++b) {
      // GEMM 1: t1 = lrelu(t0 . W1[b]) as GEMM 2's A
      float d1[NF / 2];
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < KS; ++s) Rs<NF>::mma(d1, a0[s], w1_desc<NF>(w1s, b, s), s);
      wgmma_commit();
      wgmma_wait<0>();
      keep(d1);
      keep(a0);
      uint32_t t1[KS][4];
      to_a<NF>(d1, t1, alpha);
      // GEMM 2, chunk 0
      float d2[32];
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < KS; ++s) Rs<64>::mma(d2, t1[s], w2_desc<NF>(w2s, 0, s), s);
      wgmma_commit();
      wgmma_wait<0>();
      keep(d2);
      uint32_t zf[2][4][4];
      to_a<64>(d2, zf[0], alpha);
      // chunk c: GEMM 2 of chunk c + 1 and GEMM 3 of chunk c in flight together
#pragma unroll
      for (int c = 0; c < KS; ++c, ++n) {
        const int slot = n % kSlots;
        mbar_wait(full + slot, (n / kSlots) & 1);
        wgmma_fence();
        if (c + 1 < KS) {
#pragma unroll
          for (int s = 0; s < KS; ++s) Rs<64>::mma(d2, t1[s], w2_desc<NF>(w2s, c + 1, s), s);
          wgmma_commit();
        }
        const unsigned slice = ring_s + slot * kSliceBytes;
#pragma unroll
        for (int s = 0; s < 4; ++s) Rs<kColTile>::mma(z, zf[c & 1][s], wall_desc(slice, s), 1);
        wgmma_commit();
        if (c + 1 < KS) {
          wgmma_wait<1>();                           // GEMM 2 of c + 1 and GEMM 3 of c - 1 are done
          keep(d2);
          if (c > 0) keep(zf[(c + 1) & 1]);
          to_a<64>(d2, zf[(c + 1) & 1], alpha);
        } else {
          wgmma_wait<0>();
          keep(z);
          keep(zf[0]);
          keep(zf[1]);
          keep(t1);
        }
        if (lane == 0) {
          if (c > 0) mbar_arrive(empty + (n - 1) % kSlots);
          if (c + 1 == KS) mbar_arrive(empty + slot);
        }
      }
    }

    // zall: bf16, 4 bytes per n8 block and row (m % 64 == 0: a warp's 16 rows
    // are all in or all out)
    const int row = item / ncol * kTileRows + slab;
    if (row < m) {
      bf16* const o = zall + size_t(row) * c9 + (item % ncol) * kColTile + 2 * q;
#pragma unroll
      for (int j = 0; j < kColTile / 8; ++j) {
        *reinterpret_cast<uint32_t*>(o + 8 * j) = pack_bf16(z[4 * j], z[4 * j + 1]);
        *reinterpret_cast<uint32_t*>(o + size_t(8) * c9 + 8 * j) = pack_bf16(z[4 * j + 2], z[4 * j + 3]);
      }
    }
#pragma unroll
    for (int s = 0; s < KS; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) a0[s][e] = an[s][e];
  }
}

// One warpgroup, 64 rows: GEMM 1 and the first chunk of GEMM 2 exactly as the
// main kernel chains them, the chunk's raw fp32 sums written to out (64, 64).
// It holds the accumulator -> A fragment claim (to_a) on the card by itself.
template <int NF>
__global__ void __launch_bounds__(128, 1)
chain_kernel(const bf16* __restrict__ t0, const uint8_t* __restrict__ weights, float* __restrict__ out,
             int m, float alpha) {
  constexpr int KS = NF / 16;
  extern __shared__ __align__(16) uint8_t smem[];
  for (int i = threadIdx.x; i < resident_bytes(NF) / 16; i += 128)
    reinterpret_cast<uint4*>(smem)[i] = __ldg(reinterpret_cast<const uint4*>(weights) + i);
  __syncthreads();
  const int lane = threadIdx.x & 31, q = lane & 3;
  const int row = (threadIdx.x >> 5) * 16 + (lane >> 2);
  const unsigned w1s = smem_addr(smem), w2s = w1s + 4 * NF * NF * 2;
  uint32_t a0[KS][4], t1[KS][4];
  load_t0<NF>(a0, t0, row, m, q);
  float d1[NF / 2], d2[32];
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < KS; ++s) Rs<NF>::mma(d1, a0[s], w1_desc<NF>(w1s, 0, s), s);
  wgmma_commit();
  wgmma_wait<0>();
  keep(d1);
  keep(a0);
  to_a<NF>(d1, t1, alpha);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < KS; ++s) Rs<64>::mma(d2, t1[s], w2_desc<NF>(w2s, 0, s), s);
  wgmma_commit();
  wgmma_wait<0>();
  keep(d2);
  keep(t1);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float* o = out + size_t(row) * 64 + 8 * j + 2 * q;
    o[0] = d2[4 * j];
    o[1] = d2[4 * j + 1];
    o[8 * 64] = d2[4 * j + 2];
    o[8 * 64 + 1] = d2[4 * j + 3];
  }
}

// zall (n*h*w, 144*ou) -> out (n, 4h, 4w, ou); see the header.
__global__ void __launch_bounds__(256)
finish_kernel(const bf16* __restrict__ zall, const float* __restrict__ bias, bf16* __restrict__ out,
              int n, int h, int w, int ou) {
  const int co2 = 16 * ou, parts = 2 * ou;          // a part: 8 of a pixel's co2 columns
  const long long i = blockIdx.x * 256LL + threadIdx.x;
  if (i >= (long long)n * h * w * parts) return;
  const int part = int(i % parts);
  const long long pix = i / parts;
  const int x = int(pix % w), y = int(pix / w % h), img = int(pix / w / h);
  float s[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) s[e] = 0.f;
#pragma unroll
  for (int oy = 0; oy < 3; ++oy) {
    const int yy = y + oy - 1;
    if (yy < 0 || yy >= h) continue;
#pragma unroll
    for (int ox = 0; ox < 3; ++ox) {
      const int xx = x + ox - 1;
      if (xx < 0 || xx >= w) continue;
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(
          zall + ((size_t(img) * h + yy) * w + xx) * 9 * co2 + (oy * 3 + ox) * co2 + part * 8));
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(p[k]);
        s[2 * k] += f.x;
        s[2 * k + 1] += f.y;
      }
    }
  }
  // columns co*16 + 8*half + e: phase (2*half + e/4, e%4) of channel co
  const int co = part >> 1, half = part & 1;
  const float b = bias == nullptr ? 0.f : bias[co];
  const size_t w4 = size_t(4) * w;
  bf16* const o = out + ((size_t(img) * 4 * h + 4 * y + 2 * half) * w4 + 4 * x) * ou + co;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (ou == 1) {
      uint2 v;
      v.x = pack_bf16(s[4 * r] + b, s[4 * r + 1] + b);
      v.y = pack_bf16(s[4 * r + 2] + b, s[4 * r + 3] + b);
      *reinterpret_cast<uint2*>(o + r * w4) = v;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) o[(r * w4 + j) * ou] = __float2bfloat16_rn(s[4 * r + j] + b);
    }
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms;
}

template <int NF>
int launch(const void* t0, const void* weights, void* zall, int m, int ncol, float alpha,
           cudaStream_t stream) {
  constexpr int smem = smem_bytes(NF);
  cudaError_t err = cudaFuncSetAttribute(tail_x4_kernel<NF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int items = (m + kTileRows - 1) / kTileRows * ncol, sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const int grid = items < sms ? items : sms;       // persistent: at most one block per SM
  tail_x4_kernel<NF><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(t0), static_cast<const uint8_t*>(weights), static_cast<bf16*>(zall),
      m, ncol, alpha);
  return cudaGetLastError();
}

template <int NF>
int launch_chain(const void* t0, const void* weights, void* out, int m, float alpha,
                 cudaStream_t stream) {
  constexpr int smem = resident_bytes(NF);
  cudaError_t err = cudaFuncSetAttribute(chain_kernel<NF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  chain_kernel<NF><<<1, 128, smem, stream>>>(static_cast<const bf16*>(t0),
                                             static_cast<const uint8_t*>(weights),
                                             static_cast<float*>(out), m, alpha);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// t0 (m, nf) bf16 and the packed weights of prepare (W1, W2m, then Wall's
// slices; bf16) -> zall (m, 144 * ncol) bf16, every pointer 16-byte aligned.
// m % 64 == 0, nf in {16, 32, 48, 64}, ncol = ou >= 1.  Launches on `stream`
// and returns cudaGetLastError().
int tail_x4_launch(const void* t0, const void* weights, void* zall, int m, int nf, int ncol,
                   float alpha, void* stream) {
  if (m <= 0 || m % 64 != 0 || ncol <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nf) {
    case 16: return launch<16>(t0, weights, zall, m, ncol, alpha, s);
    case 32: return launch<32>(t0, weights, zall, m, ncol, alpha, s);
    case 48: return launch<48>(t0, weights, zall, m, ncol, alpha, s);
    case 64: return launch<64>(t0, weights, zall, m, ncol, alpha, s);
    default: return cudaErrorInvalidValue;
  }
}

// zall (n*h*w, 144 * ou) bf16, bias (ou) fp32 holding bf16 values or null ->
// out (n, 4h, 4w, ou) bf16.  zall 16-byte aligned, out 8-byte aligned.
int tail_x4_finish_launch(const void* zall, const void* bias, void* out, int n, int h, int w, int ou,
                          void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || ou <= 0) return cudaErrorInvalidValue;
  const long long threads = (long long)n * h * w * 2 * ou;
  finish_kernel<<<unsigned((threads + 255) / 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(zall), static_cast<const float*>(bias), static_cast<bf16*>(out), n, h,
      w, ou);
  return cudaGetLastError();
}

// The chain check (chain_kernel): t0's first 64 rows (m >= 64) and the packed
// weights -> out (64, 64) fp32, t1 . W2m[:, :64] with t1 = bf16(lrelu(t0 . W1[0])).
int tail_x4_chain_launch(const void* t0, const void* weights, void* out, int m, int nf, float alpha,
                         void* stream) {
  if (m < 64) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nf) {
    case 16: return launch_chain<16>(t0, weights, out, m, alpha, s);
    case 32: return launch_chain<32>(t0, weights, out, m, alpha, s);
    case 48: return launch_chain<48>(t0, weights, out, m, alpha, s);
    case 64: return launch_chain<64>(t0, weights, out, m, alpha, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* tail_x4_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

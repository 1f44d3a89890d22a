// Tensor-core and data-movement probes for Hopper (sm_90a).
//
// Replaces the six Pallas TPU probe kernels of the JAX package's scripts:
//
//   scripts/pallas_matmul_probe.py::make_matmul        one (M,K)@(K,N) dot fed from HBM
//   scripts/pallas_mxu_probe.py::make                  B dependent dots, x resident (bf16, int8)
//   scripts/pallas_layout_probe3.py::probe_dots        the same at shallow K (bf16)
//   scripts/pallas_layout_probe3.py::probe_concat_dot  [a, a/2] @ w128 as one K=128 dot or two K=64 dots
//   scripts/pallas_layout_probe3.py::probe_roll        B dependent rolls of an (M,C) tensor along rows
//   scripts/pallas_layout_probe3.py::probe_stage1      B stages of nine rolled copies and a K=576 dot
//
// They ask what a 3x3 convolution written as tap matmuls reaches on this
// card: at K = 64, 192, 576 and N = 64..192, fed from HBM or from shared
// memory, with two K=64 taps stacked to K=128, and with the taps gathered by
// an im2col copy in shared memory or read shifted.
//
// One kernel template (dots_kernel) serves every dot probe.  A block of eight
// warps owns 64 rows of x and keeps them in shared memory across all B dots
// (the TPU held all of x in VMEM; 64 rows x 1,152 B are 74 KB of a block's
// 227 KB).  transpose_kernel first writes w column by column, k contiguous,
// in slices of 256 bytes of k laid out as the shared-memory stage holds them,
// and every block copies it from L2 slice by slice.  Where all of w fits
// beside the tile it is copied once and stays, as on the TPU; at K=576 with
// N >= 128 in bf16 it does not (221 KB at N=192), and streams through a ring
// of two to four stages, once per dot.  A slice is one bulk copy
// (cp.async.bulk, the TMA unit without a tensor map) started by one thread and
// awaited on an mbarrier: with per-thread cp.async the warps stood in the
// load queue and the copies did not overlap the products, and a slice has
// a cost of its own whatever its size, hence the large slices.  In 32-bit
// words the bf16 and int8 forms are alike (a k-step of one mma.sync spans 8
// words of a row: 16 bf16 or 32 int8), so both operands come out of shared
// memory with ldmatrix (one instruction per 16 x 32-byte A fragment, one per
// two B fragments), a k-step ahead of the products that use them, and rows
// are padded by 16 bytes so that the eight row addresses of a matrix fall in
// eight different 16-byte columns of the banks.  A warp computes a 32 x N/4
// tile (warps 2 along rows x 4 along columns, two to a scheduler) and reuses
// every B fragment on two A fragments.  What bounds it: the rate at which
// mma.sync is dispatched and a fixed cost per k-step, then the two block-wide syncs
// per dot and the pass that rewrites x between dots.
//
// The dependency between dots is the probes' own: the next x depends on
// y[0,0] of this dot.  On the TPU's one core that is a scalar read; here
// every block computes y[0,0] itself from its copy of row 0 (K products), so
// no block waits for another and the function is the same.  bf16: every
// element of x becomes bf16(x + bf16(y00 * 1e-36)), a real pass over the
// tile.  int8: the operand is x or clip(x + 1, -127, 127) by the parity of
// y00, applied as a saturating byte add to each A fragment.
//
// Modes of the template: plain (make_matmul's int8 form with B=1 and the
// output cast to int8, make, probe_dots); concat and twodots (probe_concat_dot:
// the stacked form rebuilds the [a, a/2] tile in shared memory every step,
// the other halves the A fragments of the second dot in registers); im2col
// and shifted (probe_stage1: a block holds its rows with a halo of stride+1
// rows each way, wrapped modulo M; im2col copies the nine shifted views into
// a 64 x 576 tile as the TPU kernel does in VMEM, shifted reads the A
// fragments at shifted rows and builds nothing).
//
// make_matmul in bf16 has a kernel of its own, matmul_kernel.  One dot fed
// from HBM is bound by its bytes (25.4 MB at (16384,576)@(576,192): 7.6 us at
// 3.35 TB/s), so what counts is keeping loads in flight and nothing else in
// the way.  A producer warp starts TMA loads through two tensor maps with the
// 128-byte swizzle into a ring of five stages on mbarriers: per stage a box of
// 128 rows x 64 k of x (the K-major A) and N/64 boxes of 64 k x 64 n of w,
// read as it lies, (K,N) row-major, as an MN-major B (the wgmma transpose
// bit): no transpose launch, no scratch.  Two consumer warpgroups each run
// m64nNk16 from both descriptors on their 64 of the block's 128 rows, keep one
// group in flight and release a stage once the group that read it is done.
// The fp32 sums are rounded to bf16 and exchanged within each quad of lanes,
// so that every thread stores 16 bytes.  At M = 16384, 128 blocks fill the
// 132 SMs in one wave.  The tensor maps are built per call on the host by
// cuTensorMapEncodeTiled, fetched through cudaGetDriverEntryPoint (so the
// library needs no -lcuda), and passed as __grid_constant__ parameters.  The
// int8 form stays on dots_kernel (plain mode, one dot, the int32 sum cast to
// int8): it is already faster than torch._int_mm.
//
// probe_roll has no dot: B steps of out[i] = bf16(in[(i - shift) mod M] + c)
// between two buffers that stay in L2, with a grid-wide barrier between
// steps (a cooperative launch, so every block is resident).  What bounds it
// is the barrier, not the 2 MB moved.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBM = 64;            // rows of x a block owns
constexpr int kThreads = 256;      // eight warps: 2 along rows x 4 along columns
constexpr int kChunk = 32;         // bytes of one mma k-step of a row: 8 words
constexpr int kSliceChunks = 8;    // k-steps per slice of w: 256 bytes of k
constexpr int kSliceBytes = kChunk * kSliceChunks;
constexpr int kSliceStride = kSliceBytes / 4 + 4;   // words between columns of a staged slice
constexpr int kColStride = 576 * 2 / 4 + 4;         // words between rows of the im2col tile
constexpr int kMaxStages = 16;     // barriers: stages of w when all of it stays (K <= 4096 bytes)
constexpr int kRingStages = 4;     // stages of the ring when w streams
constexpr int kHeadWords = 4 + 2 * kMaxStages;   // y[0,0], then one 8-byte barrier per stage
constexpr int kMaxSmem = 232448;

enum Mode { kPlain = 0, kConcat = 1, kTwoDots = 2, kIm2col = 3, kShifted = 4 };

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

// Four 8x8 matrices of 16-bit elements (8 rows of 16 bytes each): lanes
// 8i..8i+7 give the row addresses of matrix i; lane t receives word t%4 of
// row t/4 of each matrix, which is the mma.sync fragment layout.
__device__ __forceinline__ void ldmatrix4(uint32_t (&r)[4], const uint32_t* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float2 unpack(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

__device__ __forceinline__ uint32_t pack(float a, float b) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Two bf16 values plus d, each sum rounded to bf16.
__device__ __forceinline__ uint32_t bf2_add(uint32_t v, float d) {
  const float2 f = unpack(v);
  return pack(__fadd_rn(f.x, d), __fadd_rn(f.y, d));
}

// Two bf16 values times one half, rounded to bf16.
__device__ __forceinline__ uint32_t bf2_half(uint32_t v) {
  const float2 f = unpack(v);
  return pack(__fmul_rn(f.x, 0.5f), __fmul_rn(f.y, 0.5f));
}

// clip(x + 1, -127, 127) on four int8: x >= -128, so only the top saturates.
__device__ __forceinline__ uint32_t s8x4_next(uint32_t v) { return __vaddss4(v, 0x01010101u); }

// Row shift of tap t of the 3x3 stencil: (dy, dx) in row-major order, dy in
// rows of `stride` pixels; roll(x, s)[i] = x[i - s].
__device__ __forceinline__ int tap_shift(int t, int stride) {
  const int ty = t / 3;
  return (ty - 1) * stride + (t - ty * 3 - 1);
}

__device__ __forceinline__ int wrap(int r, int m) {
  r %= m;
  return r < 0 ? r + m : r;
}

// B dependent dots of a 64-row tile against w (see the header).  x: (M, row
// bytes) row-major; wt: (N, kb bytes), the transposed w; out: (M, N) fp32 or
// int32, or the input type when cast_out.  kb: bytes of the dot's depth.
template <int NT, bool S8, int MODE>
__global__ void __launch_bounds__(kThreads, 1)
dots_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ wt, void* __restrict__ out,
            int M, int kb, int B, int cast_out, int stride, int stages, int resident) {
  using Acc = typename std::conditional<S8, int, float>::type;
  constexpr int N = NT * 32;
  static_assert(NT % 2 == 0, "B fragments are loaded two column tiles at a time");
  constexpr bool kStage1 = MODE == kIm2col || MODE == kShifted;
  extern __shared__ __align__(16) uint32_t smem[];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3, wm = warp >> 2, wn = warp & 3;
  // ldmatrix row addresses of this lane.  A: matrices (rows 0-7, 8-15) x (k
  // bytes 0-15, 16-31) in the order of the fragment registers a0..a3.  B: two
  // column tiles x (k bytes 0-15, 16-31), giving b0, b1 of each.
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_word = (lane >> 4) * 4;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_word = ((lane >> 3) & 1) * 4;
  const int r0 = blockIdx.x * kBM;
  const int halo = kStage1 ? stride + 1 : 0;
  const int xrows = kBM + 2 * halo;                 // rows of the tile, halo included
  const int x0rows = kStage1 ? 9 : 1;               // copies of the rows y[0,0] reads
  const int grow = MODE == kPlain ? kb : 128;       // bytes of a row of x in global memory
  const int trow = MODE == kPlain ? kb : (MODE == kConcat ? 256 : 128);   // and in the tile
  const int xsw = trow / 4 + 4;                     // words between rows of the tile

  uint32_t* const y00_s = smem;
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem + 4);   // one barrier per stage
  uint32_t* const x0 = smem + kHeadWords;
  uint32_t* const xs = x0 + x0rows * xsw;
  uint32_t* const col = xs + xrows * xsw;
  uint32_t* const ws = col + (MODE == kIm2col ? kBM * kColStride : 0);

  const int nchunks = kb / kChunk;
  const int nslices = (nchunks + kSliceChunks - 1) / kSliceChunks;
  const int total = B * nslices;
  const bool chained = !(B == 1 && cast_out);       // make_matmul reads no y[0,0]

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(full + s, 1);
    mbar_init_fence();
  }
  __syncthreads();

  // ---- row 0 (or the nine rows the taps of row 0 read) and, except in plain
  // mode, the tile itself: one cp.async group
  {
    const int v16 = grow / 16;
    for (int i = tid; i < x0rows * v16; i += kThreads) {
      const int t = i / v16, v = i - t * v16;
      const int row = kStage1 ? wrap(-tap_shift(t, stride), M) : 0;
      cp_async16(x0 + t * xsw + v * 4, x + size_t(row) * grow + v * 16);
    }
    if (MODE != kPlain) {
      for (int i = tid; i < xrows * v16; i += kThreads) {
        const int r = i / v16, v = i - r * v16;
        const int row = wrap(r0 - halo + r, M);
        cp_async16(xs + r * xsw + v * 4, x + size_t(row) * grow + v * 16);
      }
    }
    cp_async_commit();
  }

  auto build_col = [&]() {        // the nine shifted views of the tile, side by side
    for (int i = tid; i < kBM * 9 * 8; i += kThreads) {
      const int v = i & 7, t = (i >> 3) % 9, r = i / 72;
      const uint32_t* src = xs + (r + halo - tap_shift(t, stride)) * xsw + v * 4;
      *reinterpret_cast<uint4*>(col + r * kColStride + t * 32 + v * 4) =
          *reinterpret_cast<const uint4*>(src);
    }
  };
  auto build_cat = [&](uint32_t* base, int rows) {   // [a, a/2]: the second half of each row
    for (int i = tid; i < rows * 32; i += kThreads) {
      const int r = i >> 5, w = i & 31;
      base[r * xsw + 32 + w] = bf2_half(base[r * xsw + w]);
    }
  };
  if (MODE == kConcat || MODE == kIm2col) {
    cp_async_wait<0>();
    __syncthreads();
    if (MODE == kConcat) build_cat(x0, 1 + kBM);     // x0 and xs are adjacent
    if (MODE == kIm2col) build_col();
  }

  // ---- w streams in slices, each one bulk copy of N padded rows as wt holds
  // them; in plain mode x arrives with the first dot's slices, a copy per row.
  // Warp 0 starts them all.  A stage was last read through ldmatrix by warps
  // that have since passed a block barrier, which is all a copy that
  // overwrites it needs (a proxy fence made every slice slower and ordered
  // nothing more).
  constexpr unsigned kWsBytes = N * kSliceStride * 4;
  auto load_slice = [&](int s) {
    const int ks = s % nslices;
    uint64_t* bar = full + s % stages;
    const bool with_x = MODE == kPlain && s < nslices;
    const int left = kb - ks * kSliceBytes;
    const unsigned xbytes = left < kSliceBytes ? left : kSliceBytes;
    if (lane == 0) mbar_expect(bar, kWsBytes + (with_x ? kBM * xbytes : 0u));
    __syncwarp();
    if (lane == 0)
      bulk_copy(ws + (s % stages) * (N * kSliceStride), wt + size_t(ks) * kWsBytes, kWsBytes, bar);
    if (with_x) {
      for (int r = lane; r < kBM; r += 32)
        bulk_copy(xs + r * xsw + ks * (kSliceBytes / 4),
                  x + size_t(r0 + r) * kb + ks * kSliceBytes, xbytes, bar);
    }
  };
  const int loads = resident ? nslices : total;    // resident: every slice has its own stage
  if (warp == 0) {
    const int ahead = resident ? nslices : stages - 1;
    for (int s = 0; s < ahead && s < loads; ++s) load_slice(s);
  }
  cp_async_wait<0>();             // row 0 and the tile; the loop's first barrier shows them

  Acc acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
  bool odd = false;               // int8: the operand is clip(x + 1) after an odd y[0,0]

  for (int it = 0; it < total; ++it) {
    if (it < loads) {
      mbar_wait(full + it % stages, (it / stages) & 1);
      __syncthreads();            // slice `it` has landed; slice it-1 is read by no one
      if (warp == 0 && !resident && it + stages - 1 < loads) load_slice(it + stages - 1);
    }
    const int ks = it % nslices;

    if (ks == 0 && chained && warp == 0) {
      // y[0,0] of this dot: row 0 of the operand times column 0 of w
      const uint32_t* w0 = reinterpret_cast<const uint32_t*>(wt);   // column 0: row 0 of each slice
      Acc part = 0;
      for (int j = lane; j < kb / 4; j += 32) {
        const int c = j >> 3, jj = j & 7;
        uint32_t av;
        if (MODE == kPlain || MODE == kConcat) {
          av = x0[j];
          if (S8 && odd) av = s8x4_next(av);
        } else if (MODE == kTwoDots) {
          av = x0[(c & 3) * 8 + jj];
          if (c >= 4) av = bf2_half(av);
        } else {
          av = x0[(c >> 2) * xsw + (c & 3) * 8 + jj];
        }
        constexpr int kSliceWords = kSliceBytes / 4;
        const uint32_t bv = __ldg(w0 + (j / kSliceWords) * (N * kSliceStride) + j % kSliceWords);
        if constexpr (S8) {
          part = __dp4a(int(av), int(bv), part);
        } else {
          const float2 fa = unpack(av), fb = unpack(bv);
          part = fmaf(fa.x, fb.x, part);
          part = fmaf(fa.y, fb.y, part);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
      if (lane == 0) {
        if constexpr (S8) y00_s[0] = uint32_t(part);
        else y00_s[0] = __float_as_uint(part);
      }
    }

    // ---- this slice's k-steps
    const uint32_t* wsl = ws + (it % stages) * (N * kSliceStride) +
                          (wn * NT * 8 + b_row) * kSliceStride + b_word;
    const int left = nchunks - ks * kSliceChunks;
    const int cnt = left < kSliceChunks ? left : kSliceChunks;
    // fragments of k-step cc: two A (16 rows each) and NT/2 B (two column tiles each)
    auto load_frag = [&](int cc, uint32_t (&a)[2][4], uint32_t (&b)[NT / 2][4]) {
      const int c = ks * kSliceChunks + cc;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = wm * 32 + mt * 16 + a_row;
        const uint32_t* p;
        if (MODE == kPlain || MODE == kConcat) p = xs + r * xsw + c * 8;
        else if (MODE == kTwoDots) p = xs + r * xsw + (c & 3) * 8;
        else if (MODE == kIm2col) p = col + r * kColStride + c * 8;
        else p = xs + (r + halo - tap_shift(c >> 2, stride)) * xsw + (c & 3) * 8;
        ldmatrix4(a[mt], p + a_word);
        if (MODE == kTwoDots && c >= 4) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[mt][e] = bf2_half(a[mt][e]);
        }
        if (S8 && odd) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[mt][e] = s8x4_next(a[mt][e]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) ldmatrix4(b[nt / 2], wsl + nt * 8 * kSliceStride + cc * 8);
    };
    auto products = [&](const uint32_t (&a)[2][4], const uint32_t (&b)[NT / 2][4]) {
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        mma(acc[0][nt], a[0], b[nt / 2][0], b[nt / 2][1]);
        mma(acc[1][nt], a[1], b[nt / 2][0], b[nt / 2][1]);
        mma(acc[0][nt + 1], a[0], b[nt / 2][2], b[nt / 2][3]);
        mma(acc[1][nt + 1], a[1], b[nt / 2][2], b[nt / 2][3]);
      }
    };
    // two sets of fragments under their own names (indexing a pair of sets
    // sent one instance's fragments to local memory)
    uint32_t a0[2][4], b0[NT / 2][4], a1[2][4], b1[NT / 2][4];
    if (cnt == kSliceChunks) {    // a k-step's loads go out before the products of the one before
      load_frag(0, a0, b0);
#pragma unroll
      for (int cc = 0; cc < kSliceChunks; cc += 2) {
        load_frag(cc + 1, a1, b1);
        products(a0, b0);
        if (cc + 2 < kSliceChunks) load_frag(cc + 2, a0, b0);
        products(a1, b1);
      }
    } else {
      for (int cc = 0; cc < cnt; ++cc) {
        load_frag(cc, a0, b0);
        products(a0, b0);
      }
    }

    // ---- between dots: the next operand depends on y[0,0]
    if (ks == nslices - 1 && chained) {
      __syncthreads();            // every warp is done with the tile; y00_s is written
      if constexpr (S8) {
        odd = (y00_s[0] & 1u) != 0u;
      } else {
        const float d = __bfloat162float(__float2bfloat16_rn(__uint_as_float(y00_s[0]) * 1e-36f));
        if (MODE == kConcat) {
          for (int i = tid; i < (1 + kBM) * 32; i += kThreads) {
            const int r = i >> 5, w = i & 31;
            const uint32_t v = bf2_add(x0[r * xsw + w], d);
            x0[r * xsw + w] = v;
            x0[r * xsw + 32 + w] = bf2_half(v);
          }
        } else {
          uint4* p = reinterpret_cast<uint4*>(x0);   // x0 and the tile are adjacent
          for (int i = tid; i < (x0rows + xrows) * xsw / 4; i += kThreads) {
            uint4 v = p[i];
            v.x = bf2_add(v.x, d); v.y = bf2_add(v.y, d);
            v.z = bf2_add(v.z, d); v.w = bf2_add(v.w, d);
            p[i] = v;
          }
          if (MODE == kIm2col) {
            __syncthreads();
            build_col();
          }
        }
      }
    }
  }

  // ---- the sums to global memory
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t row = size_t(r0 + wm * 32 + mt * 16 + g + 8 * h);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int cn = wn * (N / 4) + nt * 8 + 2 * q;
        const Acc v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
        if (!cast_out) {
          Acc* o = static_cast<Acc*>(out) + row * N + cn;
          o[0] = v0;
          o[1] = v1;
        } else if constexpr (S8) {
          // the int32 sum cast to int8 keeps its low byte
          *reinterpret_cast<uint16_t*>(static_cast<uint8_t*>(out) + row * N + cn) =
              uint16_t((uint32_t(v0) & 0xffu) | ((uint32_t(v1) & 0xffu) << 8));
        } else {
          *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(out) + row * N + cn) =
              pack(float(v0), float(v1));
        }
      }
    }
}

// (K, N) -> the staged form of w, for 1- or 2-byte elements; K and N
// multiples of 32.  wt holds one block per slice of kSliceBytes of k: N rows
// (the columns of w, k contiguous) at the padded stride of the shared-memory
// stage, so a slice is one contiguous copy.  The padding, and the tail of a
// last slice that K does not fill, are never read.
template <typename T>
__global__ void transpose_kernel(const T* __restrict__ w, T* __restrict__ wt, int K, int N) {
  constexpr int kPer = kSliceBytes / int(sizeof(T)), kStride = kSliceStride * 4 / int(sizeof(T));
  __shared__ T tile[32][33];
  const int k0 = blockIdx.y * 32, n0 = blockIdx.x * 32;
  for (int j = threadIdx.y; j < 32; j += 8) tile[j][threadIdx.x] = w[size_t(k0 + j) * N + n0 + threadIdx.x];
  __syncthreads();
  const int k = k0 + threadIdx.x;
  for (int j = threadIdx.y; j < 32; j += 8)
    wt[(size_t(k / kPer) * N + n0 + j) * kStride + k % kPer] = tile[threadIdx.x][j];
}

template <int NT, bool S8, int MODE>
int launch_dots(const uint8_t* x, const uint8_t* wt, void* out, int M, int kb, int B, int cast_out,
                int stride, cudaStream_t stream) {
  constexpr int N = NT * 32;
  constexpr bool kStage1 = MODE == kIm2col || MODE == kShifted;
  const int halo = kStage1 ? stride + 1 : 0;
  const int trow = MODE == kPlain ? kb : (MODE == kConcat ? 256 : 128);
  const int xsw = trow / 4 + 4;
  const int nslices = (kb / kChunk + kSliceChunks - 1) / kSliceChunks;
  const long fixed = kHeadWords + long((kStage1 ? 9 : 1) + kBM + 2 * halo) * xsw +
                     (MODE == kIm2col ? kBM * kColStride : 0);
  // w stays in shared memory across the dots where all its slices fit beside
  // the tile; else it streams through a ring of at least two stages (a slice
  // is asked for one iteration after the one that frees its stage).  A single
  // dot keeps the ring: less shared memory lets a second block share the SM.
  long stages = (kMaxSmem / 4 - fixed) / (N * kSliceStride);
  const int resident = B > 1 && stages >= nslices && nslices <= kMaxStages;
  if (resident) stages = nslices;
  else if (stages > kRingStages) stages = kRingStages;
  if (!resident && stages > nslices) stages = nslices > 2 ? nslices : 2;
  if (stages < 2 && !resident) return cudaErrorInvalidValue;
  const long words = fixed + stages * N * kSliceStride;
  if (words * 4 > kMaxSmem) return cudaErrorInvalidValue;
  const int smem = int(words * 4);
  cudaError_t err = cudaFuncSetAttribute(dots_kernel<NT, S8, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dots_kernel<NT, S8, MODE><<<M / kBM, kThreads, smem, stream>>>(x, wt, out, M, kb, B, cast_out,
                                                                  stride, int(stages), resident);
  return cudaGetLastError();
}

template <bool S8>
int launch_plain(int N, const uint8_t* x, const uint8_t* wt, void* out, int M, int kb, int B,
                 int cast_out, cudaStream_t s) {
  switch (N) {
    case 64: return launch_dots<2, S8, kPlain>(x, wt, out, M, kb, B, cast_out, 0, s);
    case 128: return launch_dots<4, S8, kPlain>(x, wt, out, M, kb, B, cast_out, 0, s);
    case 192: return launch_dots<6, S8, kPlain>(x, wt, out, M, kb, B, cast_out, 0, s);
  }
  return cudaErrorInvalidValue;
}

// ---- make_matmul in bf16 (see the header): a warp-specialised wgmma GEMM
// The switch of the ablation in chip_smoke.py (the default is the design that
// ships): PROBES_MM_PRODUCTS=0 leaves the products out (loads and stores only;
// the result is wrong).
#ifndef PROBES_MM_PRODUCTS
#define PROBES_MM_PRODUCTS 1
#endif
constexpr int kMmRows = 128;                     // rows of x per block: two warpgroups of 64
constexpr int kMmK = 64;                         // k per stage: one 128-byte swizzled row
constexpr int kMmStages = 5;
constexpr int kMmThreads = 288;                  // two consumer warpgroups, one producer warp
constexpr int kMmXBytes = kMmRows * kMmK * 2;    // the stage's box of x, 16 KB
constexpr int kMmWBox = kMmK * 64 * 2;           // one 64 x 64 box of w, 8 KB

template <int N> __host__ __device__ constexpr int mm_stage_bytes() {
  return kMmXBytes + (N / 64) * kMmWBox;
}
// the ring, its 2 x 5 barriers, and room to align the ring to 1024 bytes
template <int N> __host__ __device__ constexpr int mm_smem_bytes() {
  return 1024 + kMmStages * mm_stage_bytes<N>() + 2 * kMmStages * 8;
}

// Four threads of a quad hold words v[j] = columns 2q, 2q+1 of column block j
// of one row; afterwards thread q holds v[p] = columns 2p, 2p+1 of block q,
// i.e. the eight columns of block q in order.  Two exchanges: the off-diagonal
// 2 x 2 blocks with lane q ^ 2, then the off-diagonal elements with q ^ 1.
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int q) {
  const bool hi = q & 2, odd = q & 1;
  uint32_t r0 = __shfl_xor_sync(0xffffffffu, hi ? v[0] : v[2], 2);
  uint32_t r1 = __shfl_xor_sync(0xffffffffu, hi ? v[1] : v[3], 2);
  if (hi) { v[0] = r0; v[1] = r1; } else { v[2] = r0; v[3] = r1; }
  r0 = __shfl_xor_sync(0xffffffffu, odd ? v[0] : v[1], 1);
  r1 = __shfl_xor_sync(0xffffffffu, odd ? v[2] : v[3], 1);
  if (odd) { v[0] = r0; v[2] = r1; } else { v[1] = r0; v[3] = r1; }
}

template <int N>
__global__ void __launch_bounds__(kMmThreads, 1)
matmul_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
              __nv_bfloat16* __restrict__ out, int M, int K) {
  extern __shared__ uint8_t mm_smem[];
  constexpr int kStage = mm_stage_bytes<N>();
  uint8_t* const ring = mm_smem + ((1024u - (smem_addr(mm_smem) & 1023u)) & 1023u);
  uint64_t* const full = reinterpret_cast<uint64_t*>(ring + kMmStages * kStage);
  uint64_t* const empty = full + kMmStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * kMmRows, nk = (K + kMmK - 1) / kMmK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kMmStages; ++s) {
      mbar_init(full + s, 1);                     // the producer's arrival, with the bytes
      mbar_init(empty + s, 8);                    // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 8) {
    // ---- the producer: stage kb % 5 once the consumers have let go of kb - 5
    if (lane == 0) {
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % kMmStages;
        uint8_t* const st = ring + s * kStage;
        mbar_wait(empty + s, ((kb / kMmStages) & 1) ^ 1);
        mbar_expect(full + s, kStage);
        tma_load_2d(st, &xmap, kb * kMmK, m0, full + s);
#pragma unroll
        for (int j = 0; j < N / 64; ++j)
          tma_load_2d(st + kMmXBytes + j * kMmWBox, &wmap, j * 64, kb * kMmK, full + s);
      }
    }
  } else {
    // ---- the consumers: warpgroup wg owns rows m0 + 64 wg .. + 63
    const int wg = warp >> 2;
    float d[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
    for (int kb = 0; kb < nk; ++kb) {
      const int s = kb % kMmStages;
      mbar_wait(full + s, (kb / kMmStages) & 1);
      const unsigned xs = smem_addr(ring + s * kStage) + wg * 64 * 128;
      const unsigned ws = smem_addr(ring + s * kStage + kMmXBytes);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kMmK / 16; ++k)   // a k16 step: 32 bytes along x's rows, 16 rows of w
        if (PROBES_MM_PRODUCTS)
          SsT<N>::mma(d, descriptor(xs + k * 32, 16, 1024, true),
                      descriptor(ws + k * 16 * 128, kMmWBox, 1024, true), 1);
      wgmma_commit();
      wgmma_wait<1>();                      // the group of stage kb - 1 is done reading it
      if (kb > 0 && lane == 0) mbar_arrive(empty + (kb - 1) % kMmStages);
    }
    wgmma_wait<0>();
    keep(d);

    // ---- rounded to bf16, 16 bytes per thread and row half
    const int g = lane >> 2, q = lane & 3;
    const int row = m0 + wg * 64 + (warp & 3) * 16 + g;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int t = 0; t < N / 32; ++t) {
        uint32_t v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = pack(d[(4 * t + j) * 4 + 2 * h], d[(4 * t + j) * 4 + 2 * h + 1]);
        quad_transpose(v, q);
        if (row + 8 * h < M)
          *reinterpret_cast<uint4*>(out + size_t(row + 8 * h) * N + 32 * t + 8 * q) =
              make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
  }
}

// cuTensorMapEncodeTiled, a function of the CUDA driver API, fetched through
// the runtime so that the library needs no -lcuda; null where the installed
// CUDA driver lacks it.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                      : nullptr;
  }();
  return fn;
}

// A row-major (outer, inner) bf16 tensor in boxes of (box_outer, box_inner)
// with the 128-byte swizzle (box_inner * 2 == 128).
int bf16_map(CUtensorMap* map, const void* ptr, uint64_t inner, uint64_t outer, uint32_t box_inner,
             uint32_t box_outer) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {inner, outer}, strides[1] = {inner * 2};
  const cuuint32_t box[2] = {box_inner, box_outer}, steps[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                            strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int N>
int launch_matmul(const void* x, const void* w, void* out, int M, int K, cudaStream_t stream) {
  CUtensorMap xmap, wmap;
  int err = bf16_map(&xmap, x, K, M, kMmK, kMmRows);
  if (err == cudaSuccess) err = bf16_map(&wmap, w, N, K, 64, kMmK);
  if (err != cudaSuccess) return err;
  constexpr int smem = mm_smem_bytes<N>();
  err = cudaFuncSetAttribute(matmul_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (M + kMmRows - 1) / kMmRows;
  matmul_kernel<N><<<blocks, kMmThreads, smem, stream>>>(xmap, wmap,
                                                         static_cast<__nv_bfloat16*>(out), M, K);
  return cudaGetLastError();
}

// One roll step per grid barrier.  counter counts arrivals and is 0 at launch.
__device__ __forceinline__ void grid_barrier(unsigned* counter, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    while (*reinterpret_cast<volatile unsigned*>(counter) < target) {}
    __threadfence();
  }
  __syncthreads();
}

// B steps of dst[i] = bf16(src[(i - shift) mod M] + c) over rows of `vpr`
// 16-byte pieces; the last step writes `out`, the steps before alternate
// between `buf` and `out`.  Reads bypass L1: another SM wrote the source.
__global__ void __launch_bounds__(256)
roll_kernel(const uint4* __restrict__ a, uint4* buf, uint4* out, int M, int vpr, int shift, int B,
            float c, unsigned* counter) {
  const int total = M * vpr;
  const uint4* src = a;
  for (int b = 0; b < B; ++b) {
    uint4* dst = ((B - 1 - b) & 1) ? buf : out;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += gridDim.x * blockDim.x) {
      const int row = i / vpr, v = i - row * vpr;
      int from = row - shift;
      if (from < 0) from += M;
      uint4 val = __ldcg(src + size_t(from) * vpr + v);
      val.x = bf2_add(val.x, c); val.y = bf2_add(val.y, c);
      val.z = bf2_add(val.z, c); val.w = bf2_add(val.w, c);
      dst[i] = val;
    }
    if (b + 1 < B) grid_barrier(counter, unsigned(b + 1) * gridDim.x);
    src = dst;
  }
}

}  // namespace

extern "C" {

// A dot probe.  x: (M, K) for mode 0, (M, 64) bf16 for modes 1-4; w: (K, N)
// row-major; wt: scratch of ceil(K * element size / 256) * N * 272 bytes (w
// in slices, see transpose_kernel); out: (M, N) fp32 (bf16 forms) or int32
// (s8 != 0), or x's type when cast_out.  mode: 0 plain, 1 concat, 2 twodots
// (K = 128), 3 im2col, 4 shifted (K = 576, N = 192; stride is the row stride
// of the dy taps).  M % 64 == 0, K % 32 == 0, N in {64, 128, 192} (192 for
// modes 1-4); every pointer 16-byte aligned.  Launches the transpose of w and
// then the kernel on `stream`; returns cudaGetLastError().
int probes_dots_launch(const void* x, const void* w, void* wt, void* out, int M, int K, int N,
                       int B, int s8, int cast_out, int mode, int stride, void* stream) {
  if (M <= 0 || M % kBM != 0 || K <= 0 || K % 32 != 0 || N % 32 != 0 || B < 1 || mode < 0 ||
      mode > 4 || (mode != kPlain && (s8 || cast_out || N != 192)) ||
      ((mode == kConcat || mode == kTwoDots) && K != 128) ||
      ((mode == kIm2col || mode == kShifted) && (K != 576 || stride < 1)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 tgrid(N / 32, K / 32), tblock(32, 8);
  if (s8)
    transpose_kernel<uint8_t><<<tgrid, tblock, 0, s>>>(static_cast<const uint8_t*>(w),
                                                       static_cast<uint8_t*>(wt), K, N);
  else
    transpose_kernel<uint16_t><<<tgrid, tblock, 0, s>>>(static_cast<const uint16_t*>(w),
                                                        static_cast<uint16_t*>(wt), K, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const uint8_t* xb = static_cast<const uint8_t*>(x);
  const uint8_t* wb = static_cast<const uint8_t*>(wt);
  const int kb = s8 ? K : 2 * K;
  switch (mode) {
    case kPlain:
      return s8 ? launch_plain<true>(N, xb, wb, out, M, kb, B, cast_out, s)
                : launch_plain<false>(N, xb, wb, out, M, kb, B, cast_out, s);
    case kConcat: return launch_dots<6, false, kConcat>(xb, wb, out, M, kb, B, 0, 0, s);
    case kTwoDots: return launch_dots<6, false, kTwoDots>(xb, wb, out, M, kb, B, 0, 0, s);
    case kIm2col: return launch_dots<6, false, kIm2col>(xb, wb, out, M, kb, B, 0, stride, s);
    default: return launch_dots<6, false, kShifted>(xb, wb, out, M, kb, B, 0, stride, s);
  }
}

// make_matmul in bf16: x (M, K) and w (K, N), row-major bf16, into out (M, N)
// bf16, the fp32 sums rounded once.  M > 0, K > 0 and K % 32 == 0, N in {64,
// 128, 192}; every pointer 16-byte aligned.  Launches on `stream`; returns
// cudaGetLastError(), cudaErrorInvalidValue where a tensor map is refused, or
// cudaErrorNotSupported where the CUDA driver has no cuTensorMapEncodeTiled.
int probes_matmul_launch(const void* x, const void* w, void* out, int M, int K, int N,
                         void* stream) {
  if (M <= 0 || K <= 0 || K % 32 != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 64: return launch_matmul<64>(x, w, out, M, K, s);
    case 128: return launch_matmul<128>(x, w, out, M, K, s);
    case 192: return launch_matmul<192>(x, w, out, M, K, s);
  }
  return cudaErrorInvalidValue;
}

// B dependent rolls of a (M, C) bf16 tensor along rows by `shift` in [0, M),
// each followed by + c (c a bf16 value).  buf: scratch of a's size; counter:
// 4 bytes of scratch.  C % 8 == 0.  A cooperative launch on `stream`.
int probes_roll_launch(const void* a, void* buf, void* out, void* counter, int M, int C, int shift,
                       int B, float c, void* stream) {
  if (M <= 0 || C <= 0 || C % 8 != 0 || shift < 0 || shift >= M || B < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaMemsetAsync(counter, 0, sizeof(unsigned), s);
  if (err != cudaSuccess) return err;
  int vpr = C / 8;
  const int total = M * vpr;
  int grid = (total + 255) / 256;
  if (grid > sms) grid = sms;      // one block per SM: all resident, as the barrier needs
  const uint4* ap = static_cast<const uint4*>(a);
  uint4* bp = static_cast<uint4*>(buf);
  uint4* op = static_cast<uint4*>(out);
  unsigned* cp = static_cast<unsigned*>(counter);
  void* args[] = {&ap, &bp, &op, &M, &vpr, &shift, &B, &c, &cp};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(roll_kernel), dim3(grid),
                                    dim3(256), args, 0, s);
  return err != cudaSuccess ? err : cudaGetLastError();
}

const char* probes_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

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
// The dependent-dot chain of make and probe_dots (B dots of one x against w,
// each x perturbed by the dot before) has a kernel of its own, chain_kernel.
// What bounds it is the products: 16 dots of (8320,576)@(576,192) are 29.8 us
// of bf16 tensor work on an H100 and their bytes (9.6 MB of x, 6.4 MB of sums)
// 4.8 us; so the products must run back to back with nothing between them.
//   - w stays in shared memory for all the dots: bf16 w read as it lies, by
//     TMA boxes of 64 k x 64 n with the 128-byte swizzle, an MN-major B (the
//     wgmma transpose bit), a barrier per chunk of 64 k that the first dot
//     waits on chunk by chunk; s8 w must be K-major (wgmma has no transpose
//     for 8-bit operands), so a launch before the chain's writes w's K-major
//     swizzled image once (s8_image_kernel, 110.6 KB at K=576, N=192) and every
//     block bulk-copies it chunk by chunk (each block transposing w itself, one
//     launch a call, took 4-5 us more: 130 blocks reading the same 110 KB).
//   - a block of two warpgroups takes a tile of 64 rows (130 tiles at M =
//     8320, 130 of 132 SMs).  The warpgroups split its k steps (m64nNk16 or
//     m64nNk32 over all of N, halves of the sums exchanged through shared
//     memory at the end) or, for bf16 at K <= 128 and N >= 128, its columns
//     (each over all of K, no exchange); where the exchange has bytes of its
//     own a block walks over tiles with w resident.
//   - bf16 A is in registers (the m16n8k16 fragment layout, loaded once from
//     device memory); between dots the perturbation is added to them with
//     add.rn.bf16x2 after wgmma.wait_group, nothing rewritten in shared
//     memory.  s8 A stays in shared memory twice, x and clip(x + 1) (written
//     beside x once it lands), and a dot picks one by its descriptor.
//   - y[0,0] depends on row 0 of x and column 0 of w only, so every warp keeps
//     its own copy of both and computes the chain itself (K products and a
//     shuffle reduction while its wgmmas run); no warp waits for another
//     between dots, and no block barrier falls between them.
// The ablation (python -m srcgan_tpu_torch.probes chain) times the designs
// it was chosen over and the builds with work left out (PROBES_CHAIN_*).
//
// One kernel template (dots_kernel) serves the other dot probes, and the
// chain where PROBES_CHAIN=0 (the first design, kept as the ablation's
// yardstick).  A block of eight warps owns 64 rows of x and keeps them in shared memory across all B dots
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
// output cast to int8; the chain where PROBES_CHAIN=0); concat and twodots (probe_concat_dot:
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
// int8); chip_smoke.py times it beside torch._int_mm.
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

// The same sum with one rounding (add.rn.bf16x2), d2 a pair of bf16: equal to
// bf2_add's, because the fp32 sum of two bf16 values is exact wherever its
// rounding could move the bf16 result (tests/test_torch_probes.py checks it).
__device__ __forceinline__ uint32_t bf2_add_once(uint32_t v, uint32_t d2) {
  const __nv_bfloat162 r = __hadd2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                                   *reinterpret_cast<const __nv_bfloat162*>(&d2));
  return *reinterpret_cast<const uint32_t*>(&r);
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

// A row-major (outer, inner) tensor of bf16 (or of bytes, s8) in boxes of
// (box_outer, box_inner) with the 128-byte swizzle (box_inner elements are 128
// bytes).  Elements outside the tensor arrive as zeros.
int swizzled_map(CUtensorMap* map, const void* ptr, uint64_t inner, uint64_t outer,
                 uint32_t box_inner, uint32_t box_outer, bool s8 = false) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {inner, outer}, strides[1] = {inner * (s8 ? 1 : 2)};
  const cuuint32_t box[2] = {box_inner, box_outer}, steps[2] = {1, 1};
  const CUresult r = encode(map, s8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                            2, const_cast<void*>(ptr), dims, strides, box, steps,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int N>
int launch_matmul(const void* x, const void* w, void* out, int M, int K, cudaStream_t stream) {
  CUtensorMap xmap, wmap;
  int err = swizzled_map(&xmap, x, K, M, kMmK, kMmRows);
  if (err == cudaSuccess) err = swizzled_map(&wmap, w, N, K, 64, kMmK);
  if (err != cudaSuccess) return err;
  constexpr int smem = mm_smem_bytes<N>();
  err = cudaFuncSetAttribute(matmul_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (M + kMmRows - 1) / kMmRows;
  matmul_kernel<N><<<blocks, kMmThreads, smem, stream>>>(xmap, wmap,
                                                         static_cast<__nv_bfloat16*>(out), M, K);
  return cudaGetLastError();
}

// ---- the dependent-dot chain of probe_mxu and probe_dots (see the header)
// Switches of the ablation (python -m srcgan_tpu_torch.probes chain); the
// defaults are the design that ships.  PROBES_CHAIN=0 sends the chain to
// dots_kernel's plain mode, the first design, with its transpose launch and
// scratch.  PROBES_CHAIN_LEAVE_OUT=1 leaves the wgmma instructions out (the
// loads, the y[0,0] chain, the operand updates and the stores only); =2 the
// dots too (the loads of the operands and the stores); =3 the loads as well
// (start, sums exchanged, stores).  Their results are wrong.
// PROBES_CHAIN_BLOCKS=1 asks ptxas for one block an SM where the design that
// ships asks for two (K <= 128).  How the warpgroups share a tile's bf16
// products: PROBES_CHAIN_SPLIT=-1 (ships) splits N at K <= 128 with N >= 128
// and K elsewhere, =0 splits K everywhere, =1 N everywhere.  Split by N, each
// warpgroup holds all of K's A in registers and computes columns [0, 64
// ceil(N/128)) or the rest, and no sums are exchanged.  PROBES_CHAIN_A_SMEM=1
// keeps bf16 A in shared memory (x by TMA beside w, swizzled like it; K split)
// and each warpgroup rewrites its own k columns of the tile between dots
// behind a barrier of its own warps (where x fits beside w and K is a depth
// class).  PROBES_CHAIN_S8_IMAGE=0 has every block transpose the s8 w itself
// (one launch a call) where the design that ships writes w's K-major image
// once by a launch of its own and the blocks copy it chunk by chunk.
// PROBES_CHAIN_DB=1 gives the column split two sets of A registers in turn
// and a master copy, so that a warpgroup makes the next dot's operand while
// the dot runs instead of waiting for it.
#ifndef PROBES_CHAIN
#define PROBES_CHAIN 1
#endif
#ifndef PROBES_CHAIN_LEAVE_OUT
#define PROBES_CHAIN_LEAVE_OUT 0
#endif
#ifndef PROBES_CHAIN_BLOCKS
#define PROBES_CHAIN_BLOCKS 2
#endif
#ifndef PROBES_CHAIN_SPLIT
#define PROBES_CHAIN_SPLIT -1
#endif
#ifndef PROBES_CHAIN_A_SMEM
#define PROBES_CHAIN_A_SMEM 0
#endif
#ifndef PROBES_CHAIN_DB
#define PROBES_CHAIN_DB 0
#endif
#ifndef PROBES_CHAIN_S8_IMAGE
#define PROBES_CHAIN_S8_IMAGE 1
#endif

#if PROBES_CHAIN
constexpr int kChThreads = 256;    // two warpgroups over a tile of 64 rows
constexpr int kChMaxK = 576;

// k16 steps (bf16) or k32 steps (s8) of a depth class KC; four steps make a
// chunk, one 128-byte swizzled row of k.
template <int KC, bool S8> __host__ __device__ constexpr int ch_steps() { return KC / (S8 ? 32 : 16); }
template <int KC, bool S8> __host__ __device__ constexpr int ch_chunks() {
  return (ch_steps<KC, S8>() + 3) / 4;
}
// Bytes of the operands in shared memory: w resident (bf16: N/64 boxes of 64
// k x 64 n a chunk, MN-major; s8: N rows of 128 bytes of k a chunk,
// K-major), for s8 then x and clip(x + 1) (64 rows x 128 bytes a chunk each).
template <int N, int KC, bool S8> __host__ __device__ constexpr int ch_operands() {
  return ch_chunks<KC, S8>() * (N * 128 + (S8 ? 2 * 8192 : (PROBES_CHAIN_A_SMEM ? 8192 : 0)));
}
// Whether the warpgroups split a tile's columns (bf16 only), else its k steps.
template <int N, int KC, bool S8> __host__ __device__ constexpr bool ch_nsplit() {
  return !S8 && !PROBES_CHAIN_A_SMEM &&
         (PROBES_CHAIN_SPLIT == 1 || (PROBES_CHAIN_SPLIT < 0 && KC <= 128 && N >= 128));
}
// Bytes of the halves of the sums the warpgroups exchange after a k split.
template <int N, int KC, bool S8> __host__ __device__ constexpr int ch_exchange() {
  return ch_nsplit<N, KC, S8>() ? 0 : N * 256;
}
// Whether the exchange fits beside the operands; then a block can walk over
// several tiles with w resident.  Where it does not (bf16 K=576, N=192) it
// reuses the operands' bytes and a block takes one tile.
template <int N, int KC, bool S8> __host__ __device__ constexpr bool ch_separate() {
  return 1024 + ch_operands<N, KC, S8>() + ch_exchange<N, KC, S8>() +
                 8 * (ch_chunks<KC, S8>() + 1) <= kMaxSmem &&
         !PROBES_CHAIN_A_SMEM;
}
template <int N, int KC, bool S8> __host__ __device__ constexpr int ch_region() {
  constexpr int ops = ch_operands<N, KC, S8>(), ex = ch_exchange<N, KC, S8>();
  return ch_separate<N, KC, S8>() ? ops + ex : ops > ex ? ops : ex;
}
// the region aligned to 1024 bytes, then one mbarrier per chunk of w and
// (s8) one for x
template <int N, int KC, bool S8> __host__ __device__ constexpr int ch_smem_bytes() {
  return 1024 + ch_region<N, KC, S8>() + 8 * (ch_chunks<KC, S8>() + 1);
}

// ---- s8 w in the K-major form of the 128-byte swizzle: chunks of 128 k, each
// N rows (one a column of w) of 128 bytes, zero past K.  A piece is 128 k of
// 32 columns: lane l reads 32 bytes (one sector) of each of rows k..k+3 of w,
// k = 128 c + 4 l, and turns each 4 x 4 block of bytes into 4 words of 4 k by
// byte permutes; the 32 lanes then store one whole 128-byte row of each
// column, every bank (or every byte of a line) once.
struct S8Piece {
  uint32_t r[4][8];                               // row, word
};
__device__ __forceinline__ void s8_load(S8Piece& p, const uint8_t* w, int piece, int K, int N,
                                        bool valid) {
  const int k = (piece / (N / 32)) * 128 + 4 * (threadIdx.x & 31), n0 = (piece % (N / 32)) * 32;
  const bool in = valid && k < K;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const uint4* src = reinterpret_cast<const uint4*>(w + size_t(k + t) * N + n0);
    const uint4 lo = in ? __ldg(src) : make_uint4(0u, 0u, 0u, 0u);
    const uint4 hi = in ? __ldg(src + 1) : make_uint4(0u, 0u, 0u, 0u);
    p.r[t][0] = lo.x; p.r[t][1] = lo.y; p.r[t][2] = lo.z; p.r[t][3] = lo.w;
    p.r[t][4] = hi.x; p.r[t][5] = hi.y; p.r[t][6] = hi.z; p.r[t][7] = hi.w;
  }
}
__device__ __forceinline__ void s8_store(const S8Piece& p, uint8_t* dst, int piece, int N) {
  const int c = piece / (N / 32), n0 = (piece % (N / 32)) * 32, kr = 4 * (threadIdx.x & 31);
  uint8_t* const base = dst + size_t(c) * N * 128 + (kr & 15);
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    const uint32_t t0 = __byte_perm(p.r[0][v], p.r[1][v], 0x5140);
    const uint32_t t1 = __byte_perm(p.r[2][v], p.r[3][v], 0x5140);
    const uint32_t t2 = __byte_perm(p.r[0][v], p.r[1][v], 0x7362);
    const uint32_t t3 = __byte_perm(p.r[2][v], p.r[3][v], 0x7362);
    const uint32_t col[4] = {__byte_perm(t0, t1, 0x5410), __byte_perm(t0, t1, 0x7632),
                             __byte_perm(t2, t3, 0x5410), __byte_perm(t2, t3, 0x7632)};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * v + j;             // the swizzle XORs the 16-byte piece with n % 8
      *reinterpret_cast<uint32_t*>(base + n * 128 + (((kr >> 4) ^ (n & 7)) << 4)) = col[j];
    }
  }
}

// w's image for the blocks of the chain kernel to copy as it lies: a warp a
// piece, `pieces` = chunks * N / 32.
__global__ void __launch_bounds__(256) s8_image_kernel(const uint8_t* __restrict__ w,
                                                       uint8_t* __restrict__ img, int K, int N,
                                                       int pieces) {
  const int piece = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (piece >= pieces) return;
  S8Piece p;
  s8_load(p, w, piece, K, N, true);
  s8_store(p, img, piece, N);
}

// mbar_wait that traps after 2^24 polls instead of hanging the card where a
// copy never completes (a tensor map the copy engine refused).
__device__ __forceinline__ void chain_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  for (long spin = 0; !done; ++spin) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (spin > (1l << 24)) __trap();
  }
}

// Both warpgroups arrive, from their own code (a named barrier counts warps).
__device__ __forceinline__ void block_sync() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }

// bf16 words j = lane + 32 i of row 0 of x and of column 0 of w (as bf16
// pairs), zero past K; then each dot's y[0,0] in a fixed order.
template <int CW>
__device__ __forceinline__ float row0_dot(const uint32_t (&x0)[CW], const uint32_t (&wc)[CW]) {
  float y = 0.f;
#pragma unroll
  for (int i = 0; i < CW; ++i) {
    const float2 a = unpack(x0[i]), b = unpack(wc[i]);
    y = fmaf(a.x, b.x, y);
    y = fmaf(a.y, b.y, y);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) y += __shfl_xor_sync(0xffffffffu, y, o);
  return y;
}

// The warpgroup's part of a tile's sums out of its registers into `out`: it
// sends the half of its columns the other warpgroup stores through `ex` and
// adds the other's half of its own (warpgroup 0 stores columns [0, N/2)).
// Both add in the order acc0 + acc1, so the sum is the same everywhere.
template <int N, int WG, typename Acc>
__device__ __forceinline__ void ch_store(Acc (&d)[N / 2], uint8_t* ex, Acc* out, int row, int q) {
  constexpr int H = N / 4;                        // registers of a half
  const int t = threadIdx.x & 127;
  Acc* const box = reinterpret_cast<Acc*>(ex);    // box w at w * H * 128 is for warpgroup w
  block_sync();                                   // both are done with the tile (and with ex)
#pragma unroll
  for (int i = 0; i < H; ++i) box[(1 - WG) * H * 128 + i * 128 + t] = d[(WG ? 0 : H) + i];
  block_sync();
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const Acc other = box[WG * H * 128 + i * 128 + t];
    d[WG * H + i] = WG ? other + d[WG * H + i] : d[WG * H + i] + other;
  }
#pragma unroll
  for (int jj = 0; jj < N / 16; ++jj) {
    const int j = WG * (N / 16) + jj, col = 8 * j + 2 * q;
    using Acc2 = typename std::conditional<std::is_same<Acc, int>::value, int2, float2>::type;
    *reinterpret_cast<Acc2*>(out + size_t(row) * N + col) = Acc2{d[4 * j], d[4 * j + 1]};
    *reinterpret_cast<Acc2*>(out + size_t(row + 8) * N + col) = Acc2{d[4 * j + 2], d[4 * j + 3]};
  }
}

// bf16: warpgroup WG's k16 steps [S0, S1) of every dot, A from registers
// (PROBES_CHAIN_A_SMEM: from shared memory), for each tile of the block.
template <int N, int KC, int WG>
__device__ __forceinline__ void chain_bf16(const uint8_t* x, const uint8_t* w, float* out,
                                           uint8_t* region, uint8_t* ex, uint64_t* full, int M,
                                           int K, int B) {
  constexpr int KS = ch_steps<KC, false>(), S0 = WG ? KS / 2 : 0, S1 = WG ? KS : KS / 2;
  constexpr int NS = S1 - S0, CW = (KC / 2 + 31) / 32;
  const int lane = threadIdx.x & 31, wl = (threadIdx.x >> 5) & 3, g = lane >> 2, q = lane & 3;
  const int kw = K / 2;                           // words of a row of x
  const uint32_t* xw = reinterpret_cast<const uint32_t*>(x);
  const uint16_t* wh = reinterpret_cast<const uint16_t*>(w);
  const unsigned wbase = smem_addr(region);
  const unsigned xbase = wbase + ch_chunks<KC, false>() * N * 128;   // PROBES_CHAIN_A_SMEM's x
  const int cv = (K + 63) / 64;                   // chunks of w that hold k < K

  for (int tile = blockIdx.x; tile < M / 64; tile += gridDim.x) {
    const int row = tile * 64 + 16 * wl + g;
    // A: this warp's 16 rows of the tile in the m16n8k16 fragment layout, the
    // steps past K zero (their descriptors point at chunk 0: finite products of 0)
    uint32_t a[NS][4];
#pragma unroll
    for (int s = 0; s < (PROBES_CHAIN_A_SMEM ? 0 : NS); ++s) {
      const bool in = PROBES_CHAIN_LEAVE_OUT < 3 && 16 * (S0 + s) < K;
      const size_t c = size_t(8 * (S0 + s) + q);
      a[s][0] = in ? __ldg(xw + size_t(row) * kw + c) : 0u;
      a[s][1] = in ? __ldg(xw + size_t(row + 8) * kw + c) : 0u;
      a[s][2] = in ? __ldg(xw + size_t(row) * kw + c + 4) : 0u;
      a[s][3] = in ? __ldg(xw + size_t(row + 8) * kw + c + 4) : 0u;
    }
    // the warp's own copy of row 0 of x and of column 0 of w
    uint32_t x0[CW], wc[CW];
#pragma unroll
    for (int i = 0; i < CW; ++i) {
      const int j = lane + 32 * i;
      const bool in = PROBES_CHAIN_LEAVE_OUT < 3 && j < kw;
      x0[i] = in ? __ldg(xw + j) : 0u;
      wc[i] = in ? uint32_t(__ldg(wh + size_t(2 * j) * N)) |
                       (uint32_t(__ldg(wh + size_t(2 * j + 1) * N)) << 16)
                 : 0u;
    }

    float d[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
    for (int b = 0; b < (PROBES_CHAIN_LEAVE_OUT >= 2 ? 0 : B); ++b) {
      // the dot: a commit group per chunk of w, each behind that chunk's
      // barrier (waited on once; later dots and tiles find it complete)
#pragma unroll
      for (int s = S0; s < S1; ++s) {
        if (s == S0 || s % 4 == 0) {
          if (s != S0) wgmma_commit();
          chain_wait(full + (s / 4 < cv ? s / 4 : 0), 0);
          wgmma_fence();
        }
        const int c = 16 * s < K ? s / 4 : 0;
        const uint64_t wdesc = descriptor(wbase + c * N * 128 + (s % 4) * 2048, 8192, 1024, true);
        if (PROBES_CHAIN_LEAVE_OUT == 0 && PROBES_CHAIN_A_SMEM)
          SsT<N>::mma(d, descriptor(xbase + (s / 4) * 8192 + (s % 4) * 32, 16, 1024, true), wdesc, 1);
        else if (PROBES_CHAIN_LEAVE_OUT == 0)
          RsT<N>::mma(d, a[s - S0], wdesc, 1);
      }
      wgmma_commit();
      // meanwhile the chain: y[0,0] of this dot, and the perturbation of the next x
      const float dd = __bfloat162float(__float2bfloat16_rn(row0_dot(x0, wc) * 1e-36f));
      const uint32_t dd2 = pack(dd, dd);
#pragma unroll
      for (int i = 0; i < CW; ++i)
        if (lane + 32 * i < kw) x0[i] = bf2_add_once(x0[i], dd2);
      wgmma_wait<0>();                            // the dot has read its A registers
      keep(d);
      if constexpr (PROBES_CHAIN_A_SMEM) {
        // the warpgroup's own k columns of all 64 rows: 16-byte pieces 2(s%4)
        // and 2(s%4)+1 of each row of a chunk, where the swizzle put them
        for (int i = threadIdx.x & 127; i < 64 * NS * 2; i += 128) {
          const int r = i / (NS * 2), rem = i - r * (NS * 2), st = S0 + rem / 2;
          const int piece = 2 * (st % 4) + (rem & 1);
          uint4* p = reinterpret_cast<uint4*>(region + ch_chunks<KC, false>() * N * 128 +
                                              (st / 4) * 8192 + r * 128 + ((piece ^ (r & 7)) << 4));
          uint4 v = *p;
          v.x = bf2_add_once(v.x, dd2); v.y = bf2_add_once(v.y, dd2);
          v.z = bf2_add_once(v.z, dd2); v.w = bf2_add_once(v.w, dd2);
          *p = v;
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync %0, 128;\n" ::"r"(2 + WG) : "memory");   // the warpgroup's warps only
      } else {
        keep(a);
#pragma unroll
        for (int s = 0; s < NS; ++s)
          if (16 * (S0 + s) < K) {                // the steps past K stay zero
#pragma unroll
            for (int e = 0; e < 4; ++e) a[s][e] = bf2_add_once(a[s][e], dd2);
          }
      }
    }
    ch_store<N, WG>(d, ex, out, row, q);
  }
}

// bf16 split by N: warpgroup WG computes columns [C0, C0 + NW) of each tile
// of the block over all of K, A from registers, and stores them itself.
template <int N, int KC, int WG>
__device__ __forceinline__ void chain_bf16_nsplit(const uint8_t* x, const uint8_t* w, float* out,
                                                  uint8_t* region, uint64_t* full, int M, int K,
                                                  int B) {
  constexpr int KS = ch_steps<KC, false>(), CW = (KC / 2 + 31) / 32;
  constexpr int N0 = N >= 128 ? 64 * ((N / 64 + 1) / 2) : N;
  constexpr int C0 = WG ? N0 : 0, NW = WG ? N - N0 : N0;
  const int lane = threadIdx.x & 31, wl = (threadIdx.x >> 5) & 3, g = lane >> 2, q = lane & 3;
  const int kw = K / 2;
  const uint32_t* xw = reinterpret_cast<const uint32_t*>(x);
  const uint16_t* wh = reinterpret_cast<const uint16_t*>(w);
  const unsigned wbase = smem_addr(region) + (C0 / 64) * 8192;
  const int cv = (K + 63) / 64;
  if constexpr (NW > 0) {
    for (int tile = blockIdx.x; tile < M / 64; tile += gridDim.x) {
      const int row = tile * 64 + 16 * wl + g;
      uint32_t a[KS][4];
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        const bool in = PROBES_CHAIN_LEAVE_OUT < 3 && 16 * s < K;
        const size_t c = size_t(8 * s + q);
        a[s][0] = in ? __ldg(xw + size_t(row) * kw + c) : 0u;
        a[s][1] = in ? __ldg(xw + size_t(row + 8) * kw + c) : 0u;
        a[s][2] = in ? __ldg(xw + size_t(row) * kw + c + 4) : 0u;
        a[s][3] = in ? __ldg(xw + size_t(row + 8) * kw + c + 4) : 0u;
      }
      uint32_t x0[CW], wc[CW];
#pragma unroll
      for (int i = 0; i < CW; ++i) {
        const int j = lane + 32 * i;
        const bool in = PROBES_CHAIN_LEAVE_OUT < 3 && j < kw;
        x0[i] = in ? __ldg(xw + j) : 0u;
        wc[i] = in ? uint32_t(__ldg(wh + size_t(2 * j) * N)) |
                         (uint32_t(__ldg(wh + size_t(2 * j + 1) * N)) << 16)
                   : 0u;
      }
      float d[NW / 2];
#pragma unroll
      for (int i = 0; i < NW / 2; ++i) d[i] = 0.f;
      // a dot with A from `src`, a commit group per chunk of w
      auto dot = [&](const uint32_t (&src)[KS][4]) {
#pragma unroll
        for (int s = 0; s < KS; ++s) {
          if (s % 4 == 0) {
            if (s != 0) wgmma_commit();
            chain_wait(full + (s / 4 < cv ? s / 4 : 0), 0);
            wgmma_fence();
          }
          const int c = 16 * s < K ? s / 4 : 0;
          if (PROBES_CHAIN_LEAVE_OUT == 0)
            RsT<NW>::mma(d, src[s], descriptor(wbase + c * N * 128 + (s % 4) * 2048, 8192, 1024, true), 1);
        }
        wgmma_commit();
      };
      // this dot's perturbation from row 0, which then moves on
      auto perturbation = [&]() {
        const float dd = __bfloat162float(__float2bfloat16_rn(row0_dot(x0, wc) * 1e-36f));
        const uint32_t dd2 = pack(dd, dd);
#pragma unroll
        for (int i = 0; i < CW; ++i)
          if (lane + 32 * i < kw) x0[i] = bf2_add_once(x0[i], dd2);
        return dd2;
      };
      auto perturb = [&](uint32_t (&v)[KS][4], uint32_t dd2) {
#pragma unroll
        for (int s = 0; s < KS; ++s)
          if (16 * s < K) {                       // the steps past K stay zero
#pragma unroll
            for (int e = 0; e < 4; ++e) v[s][e] = bf2_add_once(v[s][e], dd2);
          }
      };
      const int dots = PROBES_CHAIN_LEAVE_OUT >= 2 ? 0 : B;
      if constexpr (!PROBES_CHAIN_DB) {
        for (int b = 0; b < dots; ++b) {
          dot(a);
          const uint32_t dd2 = perturbation();
          wgmma_wait<0>();                        // the dot has read its A registers
          keep(d);
          keep(a);
          perturb(a, dd2);
        }
      } else {
        // two sets of A registers in turn and a master copy that no wgmma
        // reads: the next dot's operand is made while this one runs
        uint32_t m[KS][4], a1[KS][4];
#pragma unroll
        for (int s = 0; s < KS; ++s)
#pragma unroll
          for (int e = 0; e < 4; ++e) m[s][e] = a[s][e];
        for (int b = 0; b < dots; b += 2) {
          dot(a);
          perturb(m, perturbation());
          wgmma_wait<1>();                        // the dot before, which read a1, is done
          keep(a1);
#pragma unroll
          for (int s = 0; s < KS; ++s)
#pragma unroll
            for (int e = 0; e < 4; ++e) a1[s][e] = m[s][e];
          if (b + 1 == dots) break;
          dot(a1);
          perturb(m, perturbation());
          wgmma_wait<1>();                        // dot b, which read a, is done
          keep(a);
#pragma unroll
          for (int s = 0; s < KS; ++s)
#pragma unroll
            for (int e = 0; e < 4; ++e) a[s][e] = m[s][e];
        }
        wgmma_wait<0>();
        keep(d);
      }
#pragma unroll
      for (int j = 0; j < NW / 8; ++j) {
        const int col = C0 + 8 * j + 2 * q;
        *reinterpret_cast<float2*>(out + size_t(row) * N + col) = float2{d[4 * j], d[4 * j + 1]};
        *reinterpret_cast<float2*>(out + size_t(row + 8) * N + col) =
            float2{d[4 * j + 2], d[4 * j + 3]};
      }
    }
  }
}

// s8: warpgroup WG's k32 steps [S0, S1) of every dot, A and B through
// descriptors, for each tile of the block; the operand of a dot, x or
// clip(x + 1), is a choice of base.  x arrives by TMA on barrier full[NCH], a
// phase per tile, and both warpgroups write clip(x + 1) beside it; w's chunks
// arrive on full[0..NCH) (copies of img; PROBES_CHAIN_S8_IMAGE=0: the
// block's own transpose, complete before the first tile).
template <int N, int KC, int WG>
__device__ __forceinline__ void chain_s8(const CUtensorMap* xmap, const uint8_t* x,
                                         const uint8_t* w, const uint8_t* img, int* out,
                                         uint8_t* region, uint8_t* ex, uint64_t* full, int M,
                                         int K, int B) {
  constexpr int KS = ch_steps<KC, true>(), S0 = WG ? KS / 2 : 0, S1 = WG ? KS : KS / 2;
  constexpr int NCH = ch_chunks<KC, true>(), CW = (KC / 4 + 31) / 32;
  const int lane = threadIdx.x & 31, wl = (threadIdx.x >> 5) & 3, g = lane >> 2, q = lane & 3;
  const int cv = (K + 127) / 128;                 // chunks that hold k < K

  // y[0,0] of either operand, by the warp itself: x[0] . w[:, 0] and
  // clip(x[0] + 1) . w[:, 0]; column 0 of w is row 0 of the image's chunks,
  // which the swizzle leaves in place
  int y0 = 0, y1 = 0;
  const uint32_t* xw = reinterpret_cast<const uint32_t*>(x);
#pragma unroll
  for (int i = 0; i < CW; ++i) {
    const int j = lane + 32 * i;
    if (j < K / 4 && PROBES_CHAIN_LEAVE_OUT < 3) {
      const uint32_t xv = __ldg(xw + j);
      uint32_t wv = 0;
      if (PROBES_CHAIN_S8_IMAGE) {
        wv = __ldg(reinterpret_cast<const uint32_t*>(img + size_t(j / 32) * N * 128) + j % 32);
      } else {
#pragma unroll
        for (int t = 0; t < 4; ++t) wv |= uint32_t(__ldg(w + size_t(4 * j + t) * N)) << (8 * t);
      }
      y0 = __dp4a(int(xv), int(wv), y0);
      y1 = __dp4a(int(s8x4_next(xv)), int(wv), y1);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    y0 += __shfl_xor_sync(0xffffffffu, y0, o);
    y1 += __shfl_xor_sync(0xffffffffu, y1, o);
  }

  uint8_t* const xs = region + NCH * N * 128;
  const unsigned ws = smem_addr(region), xsa = smem_addr(xs), x1sa = xsa + NCH * 8192;
  for (int tile = blockIdx.x, it = 0; tile < M / 64; tile += gridDim.x, ++it) {
    if (PROBES_CHAIN_LEAVE_OUT < 3) {
      // the tile's x (the first tile's is on its way; the last tile's reads
      // ended at ch_store's first barrier)
      if (threadIdx.x == 0 && it > 0) {
        mbar_expect(full + NCH, cv * 8192);
        for (int c = 0; c < cv; ++c) tma_load_2d(xs + c * 8192, xmap, c * 128, tile * 64, full + NCH);
      }
      chain_wait(full + NCH, it & 1);
      const uint4* xv = reinterpret_cast<const uint4*>(xs);
      uint4* x1 = reinterpret_cast<uint4*>(xs + NCH * 8192);
      for (int i = threadIdx.x; i < cv * 512; i += kChThreads) {
        uint4 v = xv[i];
        v.x = s8x4_next(v.x); v.y = s8x4_next(v.y); v.z = s8x4_next(v.z); v.w = s8x4_next(v.w);
        x1[i] = v;
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // for the wgmma reads
    }
    block_sync();

    int d[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) d[i] = 0;
    int odd = 0;                                  // the operand is clip(x + 1) after an odd y[0,0]
    wgmma_fence();
    for (int b = 0; b < (PROBES_CHAIN_LEAVE_OUT >= 2 ? 0 : B); ++b) {
      const unsigned base = odd ? x1sa : xsa;
#pragma unroll
      for (int s = S0; s < S1; ++s) {
        if (PROBES_CHAIN_S8_IMAGE && (s == S0 || s % 4 == 0)) {
          // a commit group per chunk of w, behind its barrier (the first dot
          // of the first tile waits; the others find it complete)
          if (s != S0) wgmma_commit();
          chain_wait(full + s / 4, 0);
          wgmma_fence();
        }
        if (PROBES_CHAIN_LEAVE_OUT == 0)
          Ss8<N>::mma(d, descriptor(base + (s / 4) * 8192 + (s % 4) * 32, 16, 1024, true),
                      descriptor(ws + (s / 4) * N * 128 + (s % 4) * 32, 16, 1024, true), 1);
      }
      wgmma_commit();
      odd = (odd ? y1 : y0) & 1;
      wgmma_wait<1>();                            // at most two dots in flight
    }
    wgmma_wait<0>();
    keep(d);
    ch_store<N, WG>(d, ex, out, tile * 64 + 16 * wl + g, q);
  }
}

template <int N, int KC, bool S8>
__global__ void __launch_bounds__(kChThreads, KC <= 128 ? PROBES_CHAIN_BLOCKS : 1)
chain_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
             const uint8_t* __restrict__ x, const uint8_t* __restrict__ w,
             const uint8_t* __restrict__ img, void* __restrict__ out, int M, int K, int B) {
  constexpr int NCH = ch_chunks<KC, S8>();
  extern __shared__ uint8_t ch_smem[];
  uint8_t* const region = ch_smem + ((1024u - (smem_addr(ch_smem) & 1023u)) & 1023u);
  uint8_t* const ex = region + (ch_separate<N, KC, S8>() ? ch_operands<N, KC, S8>() : 0);
  uint64_t* const full = reinterpret_cast<uint64_t*>(region + ch_region<N, KC, S8>());
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int c = 0; c <= NCH; ++c) mbar_init(full + c, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if constexpr (!S8) {
    // w read as it lies, a barrier per chunk of 64 k, once for all the block's tiles
    const int cv = (K + 63) / 64;
    if (tid == 0 && PROBES_CHAIN_LEAVE_OUT < 3) {
      for (int c = 0; c < cv; ++c) {
        mbar_expect(full + c, N * 128 + (PROBES_CHAIN_A_SMEM ? 8192 : 0));
        for (int j = 0; j < N / 64; ++j)
          tma_load_2d(region + c * N * 128 + j * 8192, &wmap, j * 64, c * 64, full + c);
        if (PROBES_CHAIN_A_SMEM)      // one tile a block
          tma_load_2d(region + NCH * N * 128 + c * 8192, &xmap, c * 64, blockIdx.x * 64, full + c);
      }
    }
    if constexpr (ch_nsplit<N, KC, S8>()) {
      if (tid < 128) chain_bf16_nsplit<N, KC, 0>(x, w, static_cast<float*>(out), region, full, M, K, B);
      else chain_bf16_nsplit<N, KC, 1>(x, w, static_cast<float*>(out), region, full, M, K, B);
    } else {
      if (tid < 128) chain_bf16<N, KC, 0>(x, w, static_cast<float*>(out), region, ex, full, M, K, B);
      else chain_bf16<N, KC, 1>(x, w, static_cast<float*>(out), region, ex, full, M, K, B);
    }
  } else {
    if (PROBES_CHAIN_LEAVE_OUT < 3) {
      // the first tile's x, 64 rows x 128 bytes a chunk, and w's chunks as the
      // image holds them, one bulk copy each, all under way at once
      const int cv = (K + 127) / 128;
      if (tid == 0) {
        mbar_expect(full + NCH, cv * 8192);
        for (int c = 0; c < cv; ++c)
          tma_load_2d(region + NCH * N * 128 + c * 8192, &xmap, c * 128, blockIdx.x * 64, full + NCH);
        if (PROBES_CHAIN_S8_IMAGE) {
          for (int c = 0; c < NCH; ++c) {
            mbar_expect(full + c, N * 128);
            bulk_copy(region + c * N * 128, img + size_t(c) * N * 128, N * 128, full + c);
          }
        }
      }
      if (!PROBES_CHAIN_S8_IMAGE) {
        // every block its own transpose of w, two pieces a warp in flight at a
        // time, each block starting at another piece so that the blocks do not
        // all ask the same lines of L2 at once; the first tile's barrier
        // orders these stores before the wgmmas
        constexpr int kWarps = kChThreads / 32, kPieces = NCH * (N / 32);
        for (int p0 = tid >> 5; p0 < kPieces; p0 += 2 * kWarps) {
          S8Piece pc[2];
#pragma unroll
          for (int u = 0; u < 2; ++u)
            s8_load(pc[u], w, (p0 + u * kWarps + blockIdx.x) % kPieces, K, N, p0 + u * kWarps < kPieces);
#pragma unroll
          for (int u = 0; u < 2; ++u)
            if (p0 + u * kWarps < kPieces) s8_store(pc[u], region, (p0 + u * kWarps + blockIdx.x) % kPieces, N);
        }
      }
    }
    if (tid < 128) chain_s8<N, KC, 0>(&xmap, x, w, img, static_cast<int*>(out), region, ex, full, M, K, B);
    else chain_s8<N, KC, 1>(&xmap, x, w, img, static_cast<int*>(out), region, ex, full, M, K, B);
  }
}

// Blocks of the chain kernel a launch takes: every tile its own block where
// the exchange shares the operands' bytes (or a variant holds one tile),
// else no more than the card holds at once, each walking over tiles.
template <int N, int KC, bool S8>
int chain_grid(int tiles, int* grid) {
  *grid = tiles;
  if (!ch_separate<N, KC, S8>()) return cudaSuccess;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chain_kernel<N, KC, S8>, kChThreads,
                                                        ch_smem_bytes<N, KC, S8>());
  if (err != cudaSuccess) return err;
  if (per_sm > 0 && sms * per_sm < tiles) *grid = sms * per_sm;
  return cudaSuccess;
}

template <int N, int KC, bool S8>
int launch_chain(const void* x, const void* w, void* img, void* out, int M, int K, int B,
                 cudaStream_t stream) {
  constexpr int smem = ch_smem_bytes<N, KC, S8>();
  static_assert(smem <= kMaxSmem || (PROBES_CHAIN_A_SMEM && !S8), "the chain's region does not fit a block");
  if (smem > kMaxSmem || (PROBES_CHAIN_A_SMEM && !S8 && K != KC)) return cudaErrorInvalidValue;
  CUtensorMap xmap{}, wmap{};
  int err = S8 ? swizzled_map(&xmap, x, K, M, 128, 64, true) : swizzled_map(&wmap, w, N, K, 64, 64);
  if (err == cudaSuccess && PROBES_CHAIN_A_SMEM && !S8) err = swizzled_map(&xmap, x, K, M, 64, 64);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(chain_kernel<N, KC, S8>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int grid = 0;
  if (err == cudaSuccess) err = chain_grid<N, KC, S8>(M / 64, &grid);
  if (err != cudaSuccess) return err;
  if (S8 && PROBES_CHAIN_S8_IMAGE) {
    constexpr int pieces = ch_chunks<KC, S8>() * (N / 32);
    s8_image_kernel<<<(pieces + 7) / 8, 256, 0, stream>>>(static_cast<const uint8_t*>(w),
                                                         static_cast<uint8_t*>(img), K, N, pieces);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  chain_kernel<N, KC, S8><<<grid, kChThreads, smem, stream>>>(
      xmap, wmap, static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(w),
      static_cast<const uint8_t*>(img), out, M, K, B);
  return cudaGetLastError();
}

// The depth class of K: the smallest instance whose steps cover it.
template <int N, bool S8>
int launch_chain_n(const void* x, const void* w, void* img, void* out, int M, int K, int B,
                   cudaStream_t s) {
  if constexpr (!S8)
    if (K <= 32) return launch_chain<N, 32, S8>(x, w, img, out, M, K, B, s);
  if (K <= 64) return launch_chain<N, 64, S8>(x, w, img, out, M, K, B, s);
  if (K <= 128) return launch_chain<N, 128, S8>(x, w, img, out, M, K, B, s);
  if (K <= 192) return launch_chain<N, 192, S8>(x, w, img, out, M, K, B, s);
  if (K <= 288) return launch_chain<N, 288, S8>(x, w, img, out, M, K, B, s);
  return launch_chain<N, 576, S8>(x, w, img, out, M, K, B, s);
}
#endif  // PROBES_CHAIN

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

// Scratch bytes probes_chain_launch needs: none for bf16; for s8 w's K-major
// image (chunks of 128 k, N rows of 128 bytes); w's staged form where the
// build routes the chain to dots_kernel (PROBES_CHAIN=0).
int probes_chain_scratch_bytes(int K, int N, int s8) {
#if PROBES_CHAIN
  if (!s8 || !PROBES_CHAIN_S8_IMAGE) return 0;
  // s8: w's K-major image, the chunks of K's depth class
  const int kc = K <= 64 ? 64 : K <= 128 ? 128 : K <= 192 ? 192 : K <= 288 ? 288 : 576;
  return (kc / 32 + 3) / 4 * N * 128;
#else
  return (K * (s8 ? 1 : 2) + kSliceBytes - 1) / kSliceBytes * N * kSliceStride * 4;
#endif
}

// B dependent dots of probe_mxu / probe_dots (see the header): x (M, K), w
// (K, N), both bf16 or both s8 (s8 != 0), row-major; out (M, N) fp32 or int32.
// M % 64 == 0, K % 32 == 0 and K <= 576, N in {64, 128, 192}, B >= 1; every
// pointer 16-byte aligned.  wt: scratch of probes_chain_scratch_bytes (none
// for bf16).  One launch on `stream` for bf16, two for s8 (w's image, then
// the chain); returns
// cudaGetLastError(), cudaErrorInvalidValue for a shape it does not take or a
// tensor map refused, cudaErrorNotSupported without cuTensorMapEncodeTiled.
int probes_chain_launch(const void* x, const void* w, void* wt, void* out, int M, int K, int N,
                        int B, int s8, void* stream) {
  if (M <= 0 || M % 64 != 0 || K <= 0 || K % 32 != 0 || B < 1 ||
      (N != 64 && N != 128 && N != 192))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#if PROBES_CHAIN
  void* const img = wt;
  if (K > kChMaxK || (s8 && PROBES_CHAIN_S8_IMAGE && img == nullptr)) return cudaErrorInvalidValue;
  switch (N) {
    case 64: return s8 ? launch_chain_n<64, true>(x, w, img, out, M, K, B, s)
                       : launch_chain_n<64, false>(x, w, img, out, M, K, B, s);
    case 128: return s8 ? launch_chain_n<128, true>(x, w, img, out, M, K, B, s)
                        : launch_chain_n<128, false>(x, w, img, out, M, K, B, s);
    default: return s8 ? launch_chain_n<192, true>(x, w, img, out, M, K, B, s)
                       : launch_chain_n<192, false>(x, w, img, out, M, K, B, s);
  }
#else
  return probes_dots_launch(x, w, wt, out, M, K, N, B, s8, 0, kPlain, 0, s);
#endif
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

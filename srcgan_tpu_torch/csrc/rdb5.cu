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
// cores bound it, and what a design decides is how the operands reach them.
// The TPU kernel holds a whole padded image in its 100 MB of VMEM; a block
// here has 227 KB.  A block owns a 16x16 tile of outputs of one image and
// keeps everything the tile needs in shared memory: x with a 5-pixel halo
// (26x26x64) and x1..x4 on shrinking regions (24^2, 22^2, 20^2, 18^2 x 32),
// 200,704 B in bf16 and 100,352 B in int8.  The halo is recomputed by
// neighbouring tiles (1.34x the operations).  The work goes by stage, not by
// source as on the TPU: stage i sums its sources 0..i out of shared memory
// into 32- or 64-wide accumulators in registers, which is the same function
// (the int32 sums are exact in any order, and the bf16 form never rounds a
// partial sum).  There is no im2col: the nine taps are nine shifted reads of
// the source tile.  x1..x4 are written as ZERO outside the image, as the
// convolutions' zero padding has them (not as lrelu(bias)), on all four edges
// and on a ragged last tile.
//
// How the operands arrive.  The weights (479 KB in bf16) do not fit beside the
// tiles, so they stream through a ring of 8 KB slices in the shared memory
// that is left (3 slices in bf16, 8 in int8).  A third warpgroup is the
// producer: one thread of it waits until the eight consumer warps have
// released a slice (an mbarrier with eight arrivals) and starts one bulk copy
// (cp.async.bulk, the TMA unit without a tensor map) that completes on the
// slice's other mbarrier.  Every weight therefore reaches the SM once per
// block and stage, not once per warp, and the next slices are in flight while
// this one is multiplied, across stages too.  The wrapper writes the weights
// in the order the copy wants (ops/kernels/rdb5_kernel.py::_fragments): per
// stage, source, tap and k-step a block of 8-row x 16-byte core matrices,
// [k half][8 columns of the stage][16 bytes of k], with no padding; a tap's
// block never straddles a slice.  One such layout serves both instructions:
// ldmatrix reads a core matrix as one 8x8 matrix (128 contiguous bytes, no
// bank conflict), and a wgmma matrix descriptor without swizzle names the
// same core matrices by two strides.  Activations: a 16-pixel x 32-byte A
// fragment is one ldmatrix.x4 at the shifted pixel addresses; the 16-byte
// pieces are XOR-swizzled with the address bits above their 128-byte line so
// that eight neighbouring pixels fall in eight different 16-byte columns of
// the banks (padding would not fit), which costs a shift and one logic
// operation per address.
//
// The products.  RDB5_WGMMA=1: wgmma.mma_async m64nNk16 (bf16 -> f32) or
// m64nNk32 (s8 -> s32), N the stage's width, A from registers (the ldmatrix
// fragments, one warp of a warpgroup per 16 rows of a 64-pixel tile), B from
// the slice through the descriptor; a warpgroup keeps one or two k-steps
// pending behind the one that runs while it loads the fragments of a later
// one, and takes the registers for that from the producer's warpgroup
// (setmaxnreg).  What bounds the products is shared memory, not the tensor
// cores: in a narrow stage (N = 32) a k-step of both warpgroups reads 20 KB
// of A fragments and 10 KB of B for ten instructions, 234 cycles at 128 bytes
// a cycle where the tensor cores need about 180; with the loads of A left out
// the products take half the time (the timeline of `python -m
// srcgan_tpu_torch.probes rdb5`).  The int8 form moves half the bytes per
// product and is twice as fast there.  The epilogues (a fifth of the time)
// and x's load come on top, one after the other, since a block's eight warps
// share one tile.  RDB5_WGMMA=0: mma.sync m16n8k16 / m16n8k32 on the same
// fragments, B by ldmatrix too, the loads of a k-step started before the
// products of the one before.  Which of the two is built is a compile-time switch (the
// default below is the one that ships, for every shape); the other switches
// restore parts of the earlier design so that `python -m
// srcgan_tpu_torch.probes rdb5` can time what each step bought:
// RDB5_WEIGHTS_L2=1 reads B fragments from global memory in every warp (no
// ring), RDB5_SCALAR_A=1 reads A fragments as four 32-bit words.
//
// Every fp32 step of the int8 form uses _rn intrinsics, so nvcc contracts no
// multiply-add that the plain version (separate torch ops) lacks: one ulp can
// flip a requantization round.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#ifndef RDB5_WGMMA
#define RDB5_WGMMA 1
#endif
#ifndef RDB5_WEIGHTS_L2
#define RDB5_WEIGHTS_L2 0
#endif
#ifndef RDB5_SCALAR_A
#define RDB5_SCALAR_A 0
#endif
#if RDB5_WGMMA && (RDB5_WEIGHTS_L2 || RDB5_SCALAR_A)
#error "the wgmma form reads B from the ring and A through ldmatrix"
#endif
// For measuring only.  RDB5_TIMELINE=1 notes the clock at the end of every
// phase of one block of a late wave (rdb5_timeline() reads the notes).
// RDB5_LEAVE_OUT leaves work out, so the result is wrong and only the time
// means something: bit 0 the products, bit 1 the loads of the A fragments.
#ifndef RDB5_TIMELINE
#define RDB5_TIMELINE 0
#endif
#ifndef RDB5_LEAVE_OUT
#define RDB5_LEAVE_OUT 0
#endif

namespace {

// Notes of the timeline: [warpgroup][phase], phase 0 the start, 1 x loaded, 2
// the barrier after it, then per stage: products done, epilogue done, barrier.
constexpr int kPhases = 3 + 3 * 5;
#if RDB5_TIMELINE
__device__ long long g_timeline[2][kPhases];
__device__ __forceinline__ void stamp(int phase) {
  const int warp = threadIdx.x >> 5;
  if (blockIdx.x == gridDim.x / 2 && blockIdx.y == gridDim.y / 2 &&
      blockIdx.z == gridDim.z / 2 + 1 && (threadIdx.x & 31) == 0 && (warp == 0 || warp == 7))
    g_timeline[warp / 4][phase] = clock64();
}
#else
__device__ __forceinline__ void stamp(int) {}
#endif
constexpr bool kNoProducts = (RDB5_LEAVE_OUT & 1) != 0;
constexpr bool kNoALoads = (RDB5_LEAVE_OUT & 2) != 0;

constexpr bool kWgmma = RDB5_WGMMA != 0;
constexpr bool kWeightsL2 = RDB5_WEIGHTS_L2 != 0;
constexpr bool kScalarA = RDB5_SCALAR_A != 0;

constexpr int kTile = 16;     // outputs per block, each way
constexpr int kHalo = 5;      // context a chain of five 3x3 convolutions needs
constexpr int kWarps = 8;     // consumer warps: two warpgroups
constexpr int kConsumers = kWarps * 32;
constexpr int kThreads = kConsumers + 128;  // and the producer's warpgroup (one warp of it works)
constexpr int kNF = 64;       // channels of x and of the output
constexpr int kGC = 32;       // channels of x1..x4
constexpr int kSlice = 8192;  // bytes of one slice of weights in the ring
constexpr int kMaxSmem = 232448;

// Source j (0 = x, k = x_k) lives on a side(j) x side(j) region around the
// tile; stage i (0..4) writes source i+1, and stage 4 the 16x16 output.
__host__ __device__ constexpr int side(int j) { return kTile + 2 * (kHalo - j); }
__host__ __device__ constexpr int chans(int j) { return j == 0 ? kNF : kGC; }
__host__ __device__ constexpr int width(int i) { return i == 4 ? kNF : kGC; }

// Operand elements per 32-bit word: 2 bf16 or 4 int8.  In bytes the two forms
// then look alike: a k-step of one mma spans 32 bytes of a pixel.
template <bool Q> __host__ __device__ constexpr int elems() { return Q ? 4 : 2; }
template <bool Q> __host__ __device__ constexpr int wpp(int j) { return chans(j) / elems<Q>(); }
template <bool Q> __host__ __device__ constexpr int slots() { return Q ? 8 : 3; }

// Word offset of source j's tile in shared memory; buf_off(5) is the total.
template <bool Q> __host__ __device__ constexpr int buf_off(int j) {
  int o = 0;
  for (int k = 0; k < j; ++k) o += side(k) * side(k) * wpp<Q>(k);
  return o;
}

// The weights as the wrapper writes them: stage by stage, in a stage source by
// source, then [tap][k-step][k half][width(i) / 8][8][16 bytes].  All in bytes.
template <bool Q> __host__ __device__ constexpr int tap_bytes(int i, int j) {
  return wpp<Q>(j) * 4 * width(i);
}
template <bool Q> __host__ __device__ constexpr int src_off(int i, int j) {
  int o = 0;
  for (int b = 0; b < j; ++b) o += 9 * tap_bytes<Q>(i, b);
  return o;
}
template <bool Q> __host__ __device__ constexpr int stage_bytes(int i) {
  return src_off<Q>(i, i + 1);
}
template <bool Q> __host__ __device__ constexpr int stage_off(int i) {
  int o = 0;
  for (int a = 0; a < i; ++a) o += stage_bytes<Q>(a);
  return o;
}
// Slices of the ring a stage takes (its last one may be short), and the
// number of the stage's first slice within a tile.
template <bool Q> __host__ __device__ constexpr int slices(int i) {
  return (stage_bytes<Q>(i) + kSlice - 1) / kSlice;
}
template <bool Q> __host__ __device__ constexpr int slice_base(int i) {
  int n = 0;
  for (int a = 0; a < i; ++a) n += slices<Q>(a);
  return n;
}
// No tap's block straddles a slice: the largest block of a stage (source 0)
// divides the slice and comes first, and every later block divides it.
template <bool Q> __host__ __device__ constexpr bool slices_align() {
  for (int i = 0; i < 5; ++i)
    for (int j = 0; j <= i; ++j)
      if (kSlice % tap_bytes<Q>(i, 0) != 0 || tap_bytes<Q>(i, 0) % tap_bytes<Q>(i, j) != 0)
        return false;
  return true;
}
static_assert(slices_align<false>() && slices_align<true>(), "a tap's weights straddle a slice");

template <bool Q> __host__ __device__ constexpr int smem_bytes() {
  return buf_off<Q>(5) * 4 + slots<Q>() * kSlice + 2 * slots<Q>() * 8;
}
static_assert(smem_bytes<false>() <= kMaxSmem && smem_bytes<true>() <= kMaxSmem,
              "the tiles and the ring exceed a Hopper block's shared memory");

// Where byte `off` of the tiles (counted from the start of shared memory,
// which is 1024-byte aligned) really lies.  PIXB: bytes of a pixel of the
// tile, 128, 64 or 32.  The index of the 16-byte piece within a 128-byte line
// is XORed with the address bits above the line, as many bits as a pixel has
// pieces, so that 8 consecutive pixels put one piece in 8 different 16-byte
// columns of the banks; within a pixel the pieces are only permuted.
template <int PIXB> __host__ __device__ constexpr unsigned swz(unsigned off) {
  return off ^ ((off >> 3) & unsigned((PIXB / 16 - 1) << 4));
}
template <bool Q> __host__ __device__ constexpr int pixel_bytes(int j) { return wpp<Q>(j) * 4; }
template <bool Q> __host__ __device__ constexpr int tile_off(int j) { return buf_off<Q>(j) * 4; }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
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

// Four 8x8 matrices of 16-bit elements (8 rows of 16 bytes each): lanes
// 8i..8i+7 give the row addresses of matrix i; lane t receives word t%4 of
// row t/4 of each matrix, which is the mma.sync (and wgmma A) fragment layout.
__device__ __forceinline__ uint32_t lds32(unsigned saddr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(saddr));
  return v;
}

__device__ __forceinline__ void ldmatrix4(uint32_t (&r)[4], unsigned saddr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(saddr));
}

// ---- wgmma: one 64-row tile per warpgroup and instruction, A from registers,
// B from shared memory through a matrix descriptor, the sums in registers.
#define RDB5_D4(c, j) c(d[j][0]), c(d[j][1]), c(d[j][2]), c(d[j][3])
#define RDB5_D16(c) RDB5_D4(c, 0), RDB5_D4(c, 1), RDB5_D4(c, 2), RDB5_D4(c, 3)
#define RDB5_D32(c)                                                                       \
  RDB5_D16(c), RDB5_D4(c, 4), RDB5_D4(c, 5), RDB5_D4(c, 6), RDB5_D4(c, 7)
#define RDB5_F(x) "+f"(x)
#define RDB5_R(x) "+r"(x)
// scale-d, the "add to the sums" flag of every instruction, is a predicate
#define RDB5_TRUE(op) "{\n.reg .pred p;\nsetp.ne.b32 p, " op ", 0;\n"
#define RDB5_REGS16 "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}"
#define RDB5_REGS32                                                                       \
  "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"                               \
  "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}"

__device__ __forceinline__ void wgmma(float (&d)[4][4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(RDB5_TRUE("%21") "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " RDB5_REGS16
               ", {%16,%17,%18,%19}, %20, p, 1, 1, 0;\n}\n"
               : RDB5_D16(RDB5_F)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma(float (&d)[8][4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(RDB5_TRUE("%37") "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " RDB5_REGS32
               ", {%32,%33,%34,%35}, %36, p, 1, 1, 0;\n}\n"
               : RDB5_D32(RDB5_F)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma(int (&d)[4][4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(RDB5_TRUE("%21") "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 " RDB5_REGS16
               ", {%16,%17,%18,%19}, %20, p;\n}\n"
               : RDB5_D16(RDB5_R)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma(int (&d)[8][4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(RDB5_TRUE("%37") "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " RDB5_REGS32
               ", {%32,%33,%34,%35}, %36, p;\n}\n"
               : RDB5_D32(RDB5_R)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// A wgmma reads its register operands until its group has been waited for:
// this keeps them alive (and unmoved) up to that point.
template <int M> __device__ __forceinline__ void keep(uint32_t (&a)[M][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}
__device__ __forceinline__ void keep(float& v) { asm volatile("" : "+f"(v)::"memory"); }
__device__ __forceinline__ void keep(int& v) { asm volatile("" : "+r"(v)::"memory"); }

// The descriptor of a k-step's block of B without swizzle: core matrices of
// 8 rows x 16 bytes; `lbo` bytes between the two halves of k, `sbo` bytes
// between groups of eight columns of the stage.
__device__ __forceinline__ uint64_t b_descriptor(unsigned saddr, int lbo, int sbo) {
  return uint64_t((saddr & 0x3ffffu) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32);
}

// ---- mbarriers and the bulk copy of a slice
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// Returns once the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}
__device__ __forceinline__ void bulk_copy(void* smem, const void* gmem, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(smem)),
      "l"(gmem), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
// The eight consumer warps; the producer warp never joins.
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ int quantize(float v, float r) {
  const float q = rintf(__fmul_rn(v, r));            // round half to even
  return int(fminf(fmaxf(q, -127.f), 127.f));
}

__device__ __forceinline__ float leaky(float v, float alpha) {
  return v >= 0.f ? v : __fmul_rn(alpha, v);
}

// What a consumer warp needs of shared memory.
struct Ring {
  unsigned tiles;           // shared-memory address of the tiles (1024-byte aligned)
  unsigned base;            // and of slice 0 of the ring
  uint64_t* full;           // [slots] a slice has landed
  uint64_t* empty;          // [slots] the eight warps have let go of it
  const uint8_t* weights;   // the same bytes in global memory (RDB5_WEIGHTS_L2)
};

// Source J's contribution to stage I for this warp's MT slabs of 16 pixels.
// (py, px)[i][r]: the pixel, in the stage's region, of the slab row whose
// fragment address this lane gives (ldmatrix: row lane % 16; scalar reads:
// rows g and g + 8).
//
// The source's 9 * KS k-steps run row of taps by row of taps: the loop over dy
// stays a loop, the 3 * KS k-steps of a row are unrolled, so that everything
// about a k-step but dy is a constant and a fragment address costs an add, a
// shift and one logic operation.
template <bool Q, int I, int J, int MT, int NT, int ROWS, typename Acc>
__device__ __forceinline__ void accumulate(const Ring& ring, const int (&py)[MT][ROWS],
                                           const int (&px)[MT][ROWS], const bool (&on)[MT],
                                           Acc (&acc)[MT][NT][4], int lane) {
  constexpr int P = side(J);             // row pitch of the source tile, pixels
  constexpr int PIXB = pixel_bytes<Q>(J);
  constexpr int KS = PIXB / 32;          // k-steps of a tap: 32 bytes of a pixel each
  constexpr int OFF = I - J;             // the stage's region inside the source's
  constexpr int N = width(I);
  constexpr int KB = N * 32;             // bytes of a k-step's block of weights
  constexpr int TAPB = KS * KB;
  constexpr int PER = 3 * KS;            // k-steps of a row of taps
  constexpr int T = 3 * PER;             // k-steps of this source
  constexpr int NS = slots<Q>();
  constexpr int SRC = src_off<Q>(I, J);  // this source's weights within the stage's, bytes
  constexpr int STAGE = stage_off<Q>(I), SLICE0 = slice_base<Q>(I);
  [[maybe_unused]] const int g = lane >> 2, tq = lane & 3;

  // ldmatrix addresses of this lane.  A: matrices (rows 0-7, 8-15) x (k bytes
  // 0-15, 16-31) in the order of the fragment registers a0..a3.  B: two
  // groups of eight columns x (k bytes 0-15, 16-31), giving b0, b1 of each.
  const unsigned a_lane = kScalarA ? tq * 4 : (lane >> 4) * 16;
  [[maybe_unused]] const unsigned b_lane = ((((lane >> 3) & 1) * (N / 8) + (lane >> 4)) * 8 + (lane & 7)) * 16;
  // unswizzled address of this lane's row(s) of slab i at tap (0, 0), k-step 0
  unsigned lin0[MT][ROWS];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      lin0[i][r] = ring.tiles + tile_off<Q>(J) +
                   ((py[i][r] + OFF) * P + px[i][r] + OFF) * PIXB + a_lane;

  // k-step u of the trip of the loop that starts at row dy0 of the taps (u
  // may run past the trip: the k-steps follow each other): its tap, and how
  // far its fragments lie from those of tap (0, 0), k-step 0
  auto tap_of = [&](int dy0, int u) { return (dy0 + u / PER) * 3 + (u % PER) / KS; };
  auto a_off = [&](int dy0, int u) {
    return unsigned((dy0 + u / PER) * (P * PIXB) + ((u % PER) / KS) * PIXB + (u % KS) * 32);
  };
  // byte offset of tap's block in the stage's weights; its slice and where
  // the block starts inside the ring
  auto tap_off = [&](int tap) { return SRC + tap * TAPB; };
  auto slice_of = [&](int tap) { return SLICE0 + tap_off(tap) / kSlice; };
  auto ring_at = [&](int tap) {
    return ring.base + (slice_of(tap) % NS) * kSlice + tap_off(tap) % kSlice;
  };

  auto load_a = [&](int dy0, int u, uint32_t (&a)[MT][4]) {
    const unsigned step = a_off(dy0, u);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (!on[i] || kNoALoads) continue;   // the same for every lane of the warp
      if constexpr (kScalarA) {
        const unsigned la = lin0[i][0] + step, lb = lin0[i][ROWS - 1] + step;
        a[i][0] = lds32(swz<PIXB>(la));
        a[i][1] = lds32(swz<PIXB>(lb));
        a[i][2] = lds32(swz<PIXB>(la + 16));
        a[i][3] = lds32(swz<PIXB>(lb + 16));
      } else {
        ldmatrix4(a[i], swz<PIXB>(lin0[i][0] + step));
      }
    }
  };
  // the first k-step of a slice waits until the slice has landed
  auto acquire = [&](int tap) {
    if constexpr (!kWeightsL2) {
      if (tap_off(tap) % kSlice == 0) {
        const int n = slice_of(tap);
        mbar_wait(ring.full + n % NS, (n / NS) & 1);
      }
    }
  };
  // after the last k-step of a slice (or of the stage) the warp lets go of it
  auto release = [&](int tap) {
    if constexpr (!kWeightsL2) {
      if ((tap_off(tap) + TAPB) % kSlice == 0 || (J == I && tap == 8)) {
        __syncwarp();
        if (lane == 0) mbar_arrive(ring.empty + slice_of(tap) % NS);
      }
    }
  };

  if constexpr (kWgmma) {
    // A warpgroup starts the k-step's MT instructions as one group and then
    // waits until at most W groups are pending; the set of fragments of the
    // group that has finished is loaded anew for k-step u + 2, so a k-step's
    // fragments are on their way a whole k-step before its group is started.
    // With one group pending the tensor cores run dry while the next loads
    // land (the fragment loads cost a quarter of the loop, measured by leaving
    // them out); a second pending group covers that where the loop is short
    // enough to be unrolled whole (sources of 2 or 1 k-steps per tap: all of
    // the int8 form, x1..x4 of the bf16 form).
    auto mma_step = [&](int dy0, int u, uint32_t (&a)[MT][4]) {
      const int tap = tap_of(dy0, u);
      if (u % KS == 0) acquire(tap);
      const uint64_t desc = b_descriptor(ring_at(tap) + (u % KS) * KB, (N / 8) * 128, 128);
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < MT; ++i)
        if (!kNoProducts) wgmma(acc[i], a[i], desc);
      wgmma_commit();
    };
    constexpr int S = KS >= 4 ? 3 : 4;   // sets of fragments: one running, W pending, one loading
    constexpr int W = S - 2;             // groups that may wait behind the one that runs
    constexpr int TRIP = KS >= 4 ? PER : T;   // k-steps of a trip of the loop: a row of taps, or all
    uint32_t a[S][MT][4] = {};
#pragma unroll 1
    for (int dy0 = 0; dy0 < 3; dy0 += TRIP / PER) {
      // a trip is a pipeline of its own, filled here and drained at its end
      load_a(dy0, 0, a[0]);
      load_a(dy0, 1, a[1]);
#pragma unroll
      for (int u = 0; u < TRIP; ++u) {
        mma_step(dy0, u, a[u % S]);
        wgmma_wait<W>();                 // the group of k-step u - W is done:
        keep(a[(u + 2) % S]);            // its set of fragments is free for k-step u + 2
        if (u >= W && (u - W) % KS == KS - 1) release(tap_of(dy0, u - W));
        if (u + 2 < TRIP) load_a(dy0, u + 2, a[(u + 2) % S]);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int u = TRIP - W; u < TRIP; ++u)
        if (u % KS == KS - 1) release(tap_of(dy0, u));
#pragma unroll
      for (int k = 0; k < S; ++k) keep(a[k]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) keep(acc[i][j][e]);
  } else {
    auto load = [&](int dy0, int u, uint32_t (&a)[MT][4], uint32_t (&b)[NT / 2][4]) {
      const int tap = tap_of(dy0, u), ks = u % KS;
      if (ks == 0) acquire(tap);
      if constexpr (kWeightsL2) {
        const uint32_t* w = reinterpret_cast<const uint32_t*>(ring.weights + STAGE + tap_off(tap) +
                                                              ks * KB);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          b[j / 2][(j & 1) * 2] = __ldg(w + (j * 8 + g) * 4 + tq);
          b[j / 2][(j & 1) * 2 + 1] = __ldg(w + ((N / 8 + j) * 8 + g) * 4 + tq);
        }
      } else {
        const unsigned w = ring_at(tap) + ks * KB + b_lane;
#pragma unroll
        for (int q = 0; q < NT / 2; ++q) ldmatrix4(b[q], w + q * 256);
      }
      load_a(dy0, u, a);
    };
    auto products = [&](int dy0, int u, const uint32_t (&a)[MT][4],
                        const uint32_t (&b)[NT / 2][4]) {
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (!on[i] || kNoProducts) continue;
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma(acc[i][j], a[i], b[j / 2][(j & 1) * 2], b[j / 2][(j & 1) * 2 + 1]);
      }
      if (u % KS == KS - 1) release(tap_of(dy0, u));
    };
    // two sets of fragments: the loads of a k-step go out before the products
    // of the one before.  A trip of the loop has an even number of k-steps, or
    // is the only one (KS == 1: all nine taps unrolled).
    constexpr int ROWS_PER_TRIP = KS % 2 == 0 ? 1 : 3;
    uint32_t a[2][MT][4], b[2][NT / 2][4];
    load(0, 0, a[0], b[0]);
#pragma unroll 1
    for (int dy0 = 0; dy0 < 3; dy0 += ROWS_PER_TRIP) {
#pragma unroll
      for (int u = 0; u < ROWS_PER_TRIP * PER; ++u) {
        if (dy0 * PER + u + 1 < T) load(dy0, u + 1, a[(u + 1) % 2], b[(u + 1) % 2]);
        products(dy0, u, a[u % 2], b[u % 2]);
      }
    }
  }
}

// Stage I of the block for one tile: sum sources 0..I, then the epilogue.
// I < 4 writes source I+1 into shared memory; I == 4 writes the output.
template <bool Q, int I>
__device__ __forceinline__ void stage(uint8_t* smem, const Ring& ring,
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
  constexpr int ROWS = kScalarA ? 2 : 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  // Slab warp + 8 i: warps 0-3 and 4-7 each own every other 64-pixel tile, a
  // warp 16 rows of it, so one mapping serves mma.sync and wgmma.  The wgmma
  // form runs all MT tiles of a warpgroup, also the one or two of a stage that
  // lie past the region (their rows read a valid pixel and are not stored): an
  // instruction under a condition on the warp's index is taken for divergent,
  // and ptxas then serializes every wgmma of the loop.
  int py[MT][ROWS], px[MT][ROWS];
  bool on[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int slab = warp + i * kWarps;
    on[i] = kWgmma || slab < SLABS;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int m = slab * 16 + (kScalarA ? g + 8 * r : lane & 15);
      const int mc = m < M ? m : M - 1;   // rows past the region read a valid pixel
      py[i][r] = mc / R;
      px[i][r] = mc - py[i][r] * R;
    }
  }
  Acc acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  accumulate<Q, I, 0, MT, NT, ROWS>(ring, py, px, on, acc, lane);
  if constexpr (I >= 1) accumulate<Q, I, 1, MT, NT, ROWS>(ring, py, px, on, acc, lane);
  if constexpr (I >= 2) accumulate<Q, I, 2, MT, NT, ROWS>(ring, py, px, on, acc, lane);
  if constexpr (I >= 3) accumulate<Q, I, 3, MT, NT, ROWS>(ring, py, px, on, acc, lane);
  if constexpr (I >= 4) accumulate<Q, I, 4, MT, NT, ROWS>(ring, py, px, on, acc, lane);

  stamp(3 + 3 * I);
  // ---- the epilogue, written without branches but around the stores (a
  // branch per row kept the rows from overlapping and cost more than the work)
  constexpr int kOut = kHalo - 1 - I;    // halo of the stage's region around the tile
  // this lane's channels are c = 8 j + 2 t and c + 1: their per-channel constants
  float bia[NT][2], swv[Q ? NT : 1][2], rqv[Q && I < 4 ? NT : 1][2];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = j * 8 + 2 * t + e;
      bia[j][e] = __ldg(bias + I * kNF + c);
      if constexpr (Q) swv[j][e] = __ldg(sw + I * kNF + c);
      if constexpr (Q && I < 4) rqv[j][e] = __ldg(rq + (I + 1) * kNF + c);
    }
  auto value = [&](int i, int j, int h, int e) {
    if constexpr (Q)
      return __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * h + e]), swv[j][e]), bia[j][e]);
    else
      return __fadd_rn(acc[i][j][2 * h + e], bia[j][e]);
  };
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    if (!on[i]) continue;                // the same for every lane of the warp
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = (warp + i * kWarps) * 16 + g + 8 * h;   // this lane's rows: g, g + 8
      const bool row = m < M;
      const int mc = row ? m : M - 1;
      const int my = mc / R, mx = mc - my * R;
      const int gy = ty0 - kOut + my, gx = tx0 - kOut + mx;
      const bool inside = row && gy >= 0 && gy < H && gx >= 0 && gx < W;
      if constexpr (I < 4) {
        // x_{I+1}: zero outside the image, as the next convolution's padding
        constexpr int PIXB = pixel_bytes<Q>(I + 1);
        const unsigned at = tile_off<Q>(I + 1) + mc * PIXB + 2 * t * (Q ? 1 : 2);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float v0 = inside ? leaky(value(i, j, h, 0), alpha) : 0.f;
          const float v1 = inside ? leaky(value(i, j, h, 1), alpha) : 0.f;
          if constexpr (Q) {
            const int q0 = quantize(v0, rqv[j][0]), q1 = quantize(v1, rqv[j][1]);
            const uint16_t two = uint16_t((q0 & 0xff) | ((q1 & 0xff) << 8));
            if (row) *reinterpret_cast<uint16_t*>(smem + swz<PIXB>(at + j * 8)) = two;
          } else {
            const __nv_bfloat162 two = __floats2bfloat162_rn(v0, v1);
            if (row) *reinterpret_cast<__nv_bfloat162*>(smem + swz<PIXB>(at + j * 16)) = two;
          }
        }
      } else {
        // out = x5 * lemda + x; a ragged last tile stores only what is inside
        const size_t at = ((size_t(img) * H + (inside ? gy : 0)) * W + (inside ? gx : 0)) * kNF + 2 * t;
        if constexpr (Q) {
          // the fp32 x of this row, all loads in flight before the first store
          float2 x[NT];
#pragma unroll
          for (int j = 0; j < NT; ++j)
            x[j] = __ldg(reinterpret_cast<const float2*>(static_cast<const float*>(xg) + at + j * 8));
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            float2 o;
            o.x = __fadd_rn(__fmul_rn(value(i, j, h, 0), lemda), x[j].x);
            o.y = __fadd_rn(__fmul_rn(value(i, j, h, 1), lemda), x[j].y);
            if (inside) *reinterpret_cast<float2*>(static_cast<float*>(outg) + at + j * 8) = o;
          }
        } else {
          // the bf16 x is source 0's tile itself: the pixel kHalo in from its corner
          constexpr int PIXB = pixel_bytes<Q>(0);
          const unsigned xat = ((my + kHalo) * side(0) + mx + kHalo) * PIXB + 4 * t;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const float2 x = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(smem + swz<PIXB>(xat + j * 16)));
            const __nv_bfloat162 o =
                __floats2bfloat162_rn(__fadd_rn(__fmul_rn(value(i, j, h, 0), lemda), x.x),
                                      __fadd_rn(__fmul_rn(value(i, j, h, 1), lemda), x.y));
            if (inside)
              *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(outg) + at + j * 8) = o;
          }
        }
      }
    }
  }
}

template <bool Q>
__global__ void __launch_bounds__(kThreads, 1)
rdb5_kernel(const void* __restrict__ xg, const uint8_t* __restrict__ weights,
            const float* __restrict__ sw, const float* __restrict__ rq,
            const float* __restrict__ bias, void* __restrict__ outg, int H, int W, float alpha,
            float lemda) {
  extern __shared__ __align__(1024) uint8_t smem[];
  constexpr int NS = slots<Q>();
  uint8_t* const slices_s = smem + tile_off<Q>(5);
  uint64_t* const full = reinterpret_cast<uint64_t*>(slices_s + NS * kSlice);
  uint64_t* const empty = full + NS;
  const int img = blockIdx.z, ty0 = blockIdx.y * kTile, tx0 = blockIdx.x * kTile;

  stamp(0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + s, 1);            // the producer's arrival, with the bytes to expect
      mbar_init(empty + s, kWarps);      // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async;\n" ::: "memory");
  }
  __syncthreads();

  // A thread of the three warpgroups starts with 65,536 / 384 = 168 registers.
  // The producer's warpgroup hands 128 of them back (a whole warpgroup, idle
  // but for one thread, because consumers can only take what a warpgroup of
  // the block has given up) and the consumers take the 64 more that four sets
  // of fragments beside 80 sums need.
  if (threadIdx.x >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    // ---- the producer: slice n of the tile goes to slot n % NS once the
    // consumers have let go of slice n - NS
    if (!kWeightsL2 && threadIdx.x == kConsumers) {
      int n = 0;
      for (int i = 0; i < 5; ++i) {
        const uint8_t* stage_w = weights + stage_off<Q>(i);
        const int bytes = stage_bytes<Q>(i);
        for (int o = 0; o < bytes; o += kSlice, ++n) {
          const int slot = n % NS;
          mbar_wait(empty + slot, ((n / NS) & 1) ^ 1);
          const unsigned part = bytes - o < kSlice ? bytes - o : kSlice;
          mbar_expect(full + slot, part);
          bulk_copy(slices_s + slot * kSlice, stage_w + o, part, full + slot);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  // ---- the consumers: x with its halo into shared memory, zero outside the
  // image; a thread keeps kBatch loads in flight, all of one 16-byte column
  // of the pixels (256 threads are a multiple of the loads of a pixel)
  constexpr int P0 = side(0), PIXB0 = pixel_bytes<Q>(0);
  constexpr int VECS = Q ? kNF / 4 : kNF / 8;   // loads per pixel: 16 float4 or 8 uint4
  constexpr int kBatch = 8, kPixels = kConsumers / VECS;
  using Vec = typename std::conditional<Q, float4, uint4>::type;
  const int v = threadIdx.x % VECS;
  float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
  if constexpr (Q) r = __ldg(reinterpret_cast<const float4*>(rq) + v);
  for (int p0 = threadIdx.x / VECS; p0 < P0 * P0; p0 += kBatch * kPixels) {
    Vec val[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int p = p0 + k * kPixels;
      const int y = p / P0, x = p - y * P0;
      const int gy = ty0 - kHalo + y, gx = tx0 - kHalo + x;
      const bool inside = p < P0 * P0 && gy >= 0 && gy < H && gx >= 0 && gx < W;
      const size_t pix = (size_t(img) * H + (inside ? gy : 0)) * W + (inside ? gx : 0);
      val[k] = __ldg(reinterpret_cast<const Vec*>(xg) + pix * VECS + v);
      if (!inside) {
        if constexpr (Q) val[k] = make_float4(0.f, 0.f, 0.f, 0.f);
        else val[k] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int p = p0 + k * kPixels;
      if (p >= P0 * P0) continue;
      if constexpr (Q) {
        // four fp32 channels -> four int8 in one word
        const float4 f = val[k];
        *reinterpret_cast<uint32_t*>(smem + swz<PIXB0>(p * PIXB0 + v * 4)) =
            uint32_t(quantize(f.x, r.x) & 0xff) | (uint32_t(quantize(f.y, r.y) & 0xff) << 8) |
            (uint32_t(quantize(f.z, r.z) & 0xff) << 16) |
            (uint32_t(quantize(f.w, r.w) & 0xff) << 24);
      } else {
        *reinterpret_cast<uint4*>(smem + swz<PIXB0>(p * PIXB0 + v * 16)) = val[k];
      }
    }
  }
  const Ring ring{smem_addr(smem), smem_addr(slices_s), full, empty, weights};
  stamp(1);
  consumer_sync();
  stamp(2);
  stage<Q, 0>(smem, ring, sw, rq, bias, xg, outg, img, ty0, tx0, H, W, alpha, lemda);
  stamp(4);
  consumer_sync();
  stamp(5);
  stage<Q, 1>(smem, ring, sw, rq, bias, xg, outg, img, ty0, tx0, H, W, alpha, lemda);
  stamp(7);
  consumer_sync();
  stamp(8);
  stage<Q, 2>(smem, ring, sw, rq, bias, xg, outg, img, ty0, tx0, H, W, alpha, lemda);
  stamp(10);
  consumer_sync();
  stamp(11);
  stage<Q, 3>(smem, ring, sw, rq, bias, xg, outg, img, ty0, tx0, H, W, alpha, lemda);
  stamp(13);
  consumer_sync();
  stamp(14);
  stage<Q, 4>(smem, ring, sw, rq, bias, xg, outg, img, ty0, tx0, H, W, alpha, lemda);
  stamp(16);
}

template <bool Q>
int launch(const void* x, const void* weights, const float* sw, const float* rq,
           const float* bias, void* out, int n, int h, int w, float alpha, float lemda,
           cudaStream_t stream) {
  constexpr int smem = smem_bytes<Q>();
  cudaError_t err = cudaFuncSetAttribute(rdb5_kernel<Q>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(w / kTile, (h + kTile - 1) / kTile, n);
  rdb5_kernel<Q><<<grid, kThreads, smem, stream>>>(x, static_cast<const uint8_t*>(weights), sw,
                                                   rq, bias, out, h, w, alpha, lemda);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One RDB5 on x (n, h, w, 64), contiguous NHWC, into out of the same shape
// and type.  quant == 0: x and out bf16, frag the bf16 weights in the order
// described above (119,808 words), bias (5, 64) fp32; sw and rq are not read.
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

// The clock notes of the last launch of a RDB5_TIMELINE build, 2 x 18 values
// (warpgroup, phase; see kPhases) into `out` on the host; waits for the card.
// No other build has it.
#if RDB5_TIMELINE
int rdb5_timeline(long long* out) {
  return cudaMemcpyFromSymbol(out, g_timeline, sizeof(g_timeline));
}
#endif

const char* rdb5_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

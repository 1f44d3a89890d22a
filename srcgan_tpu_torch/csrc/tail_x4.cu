// x4 RDDBNet upsample tail at trunk resolution, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel srcgan_tpu/ops/pallas/tail_kernel.py::tail_x4_fused.
// For each of deconv1's 4 phase blocks b, three chained GEMMs per row of the
// trunk output t0 (M = N*H*W rows of nf bf16 values):
//
//     t1   = lrelu(t0 . W1[b])          (M, nf)  x (nf, nf)
//     z2   = lrelu(t1 . W2m)            (M, nf)  x (nf, 4nf)
//     zall += z2 . Wall[b]              (M, 4nf) x (4nf, 9*16*ou)
//
// t1 and z2 are staged as bf16 (as the TPU kernel does) and never leave the
// SM; zall accumulates in fp32 registers over the 4 blocks and is written once
// as bf16.  The 9-tap shift-reduce, the bias and the pixel shuffle stay as
// torch ops in the wrapper (ops/kernels/tail_kernel.py).
//
// What bounds it: at nf=64, ou=1 the kernel does 458,752 FLOP per trunk row
// and moves 128 B in + 288 B out, about 1,100 FLOP/byte, far above the H100's
// bf16 ridge (~295), so tensor-core throughput bounds it.  The design keeps the
// tensor cores fed from shared memory: every GEMM is bf16 wmma 16x16x16 with
// fp32 accumulators, each warp owns 16 rows end to end (its t1/z2 slabs live in
// its own shared-memory slice, so the three GEMMs need no block barrier), and
// the 8 warps of a block share one copy of the weights.  Every shared-memory
// row is padded by 16 bytes so that the 8 rows a fragment load reads at once
// fall in different banks.  The TPU kernel held all of Wall in VMEM; here
// Wall[b] is streamed per phase block and tiled in 144-column slices (one
// grid.y step per slice), which fits any ou in a block's 227 KB of shared
// memory.  wgmma, TMA and a persistent schedule are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>
#include <cstdint>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockRows = kWarps * 16;   // each warp owns one 16-row slab
constexpr int kColTile = 144;             // zall columns per block (9 fragments)
constexpr int kColFrags = kColTile / 16;
constexpr int kPad = 8;                   // bf16 elements added to each smem row
constexpr int kScratchLd = 16 + 4;        // fp32 scratch row, padded likewise

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// Shared memory of one block, in bytes; ops/kernels/tail_kernel.py::smem_bytes
// states the same formula.
constexpr size_t smem_bytes(int nf) {
  return sizeof(bf16) * (size_t(4 * nf) * (kColTile + kPad)   // Wall[b] column tile
                         + size_t(nf) * (4 * nf + kPad)       // W2m
                         + size_t(nf) * (nf + kPad))          // W1[b]
         + size_t(kWarps) * (sizeof(bf16) * 16 * (nf + kPad + 4 * nf + kPad)  // t1, z2
                             + sizeof(float) * 16 * kScratchLd);               // scratch
}

__device__ __forceinline__ void leaky_relu(FragC& f, float alpha) {
#pragma unroll
  for (int i = 0; i < f.num_elements; ++i) {
    const float v = f.x[i];
    f.x[i] = v >= 0.f ? v : alpha * v;
  }
}

// Round a 16x16 fp32 fragment to bf16 and store it at dst (row stride ld):
// through the warp's scratch, each lane then writes 8 values as one 16-byte store.
__device__ __forceinline__ void store_bf16(const FragC& f, float* scratch, bf16* dst,
                                           int ld, int lane) {
  wmma::store_matrix_sync(scratch, f, kScratchLd, wmma::mem_row_major);
  __syncwarp();
  const int row = lane >> 1, col = (lane & 1) * 8;
  const float* s = scratch + row * kScratchLd + col;
  uint4 packed;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = __floats2bfloat162_rn(s[2 * i], s[2 * i + 1]);
  *reinterpret_cast<uint4*>(dst + size_t(row) * ld + col) = packed;
  __syncwarp();
}

// Copy a rows x cols bf16 tile (cols % 8 == 0) from global memory with row
// stride src_ld into shared memory with row stride cols + kPad, 16 bytes per
// thread per step.
__device__ __forceinline__ void copy_tile(bf16* dst, const bf16* src, int rows, int cols,
                                          int src_ld) {
  const int vecs = cols / 8;
  for (int i = threadIdx.x; i < rows * vecs; i += kThreads) {
    const int r = i / vecs, v = i - r * vecs;
    reinterpret_cast<uint4*>(dst + r * (cols + kPad))[v] =
        reinterpret_cast<const uint4*>(src + size_t(r) * src_ld)[v];
  }
}

template <int NF>
__global__ void __launch_bounds__(kThreads)
tail_x4_kernel(const bf16* __restrict__ t0, const bf16* __restrict__ w1s,
               const bf16* __restrict__ w2m, const bf16* __restrict__ wall,
               bf16* __restrict__ zall, int m, int c9, float alpha) {
  constexpr int K2 = 4 * NF;        // z2 width
  constexpr int KT1 = NF / 16;      // k-steps of the first two GEMMs
  constexpr int KT2 = K2 / 16;      // k-steps of the third GEMM
  constexpr int LD1 = NF + kPad;    // smem row strides, in elements
  constexpr int LD2 = K2 + kPad;
  constexpr int LDW = kColTile + kPad;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* s_wall = reinterpret_cast<bf16*>(smem);    // K2 x kColTile
  bf16* s_w2 = s_wall + K2 * LDW;                  // NF x K2
  bf16* s_w1 = s_w2 + NF * LD2;                    // NF x NF
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* s_t1 = s_w1 + NF * LD1 +                   // 16 x NF
               warp * (16 * (LD1 + LD2) + 16 * kScratchLd * 2);
  bf16* s_z2 = s_t1 + 16 * LD1;                                     // 16 x K2
  float* s_scratch = reinterpret_cast<float*>(s_z2 + 16 * LD2);     // 16 x 16

  const int row0 = blockIdx.x * kBlockRows + warp * 16;
  const bool active = row0 < m;     // m % 16 == 0: a slab is all in or all out
  const int col0 = blockIdx.y * kColTile;

  copy_tile(s_w2, w2m, NF, K2, K2);
  FragA a_t0[KT1];                  // this warp's t0 slab, read once
  if (active) {
#pragma unroll
    for (int k = 0; k < KT1; ++k)
      wmma::load_matrix_sync(a_t0[k], t0 + size_t(row0) * NF + k * 16, NF);
  }
  FragC acc[kColFrags];
#pragma unroll
  for (int c = 0; c < kColFrags; ++c) wmma::fill_fragment(acc[c], 0.f);

  for (int b = 0; b < 4; ++b) {
    __syncthreads();                // every warp is done with block b-1's weights
    copy_tile(s_w1, w1s + b * NF * NF, NF, NF, NF);
    copy_tile(s_wall, wall + size_t(b) * K2 * c9 + col0, K2, kColTile, c9);
    __syncthreads();
    if (!active) continue;

    // t1 = lrelu(t0 . W1[b]), bf16
#pragma unroll
    for (int j = 0; j < KT1; ++j) {
      FragC f;
      wmma::fill_fragment(f, 0.f);
#pragma unroll
      for (int k = 0; k < KT1; ++k) {
        FragB w;
        wmma::load_matrix_sync(w, s_w1 + k * 16 * LD1 + j * 16, LD1);
        wmma::mma_sync(f, a_t0[k], w, f);
      }
      leaky_relu(f, alpha);
      store_bf16(f, s_scratch, s_t1 + j * 16, LD1, lane);
    }

    // z2 = lrelu(t1 . W2m), bf16
    FragA a_t1[KT1];
#pragma unroll
    for (int k = 0; k < KT1; ++k) wmma::load_matrix_sync(a_t1[k], s_t1 + k * 16, LD1);
    for (int j = 0; j < KT2; ++j) {
      FragC f;
      wmma::fill_fragment(f, 0.f);
#pragma unroll
      for (int k = 0; k < KT1; ++k) {
        FragB w;
        wmma::load_matrix_sync(w, s_w2 + k * 16 * LD2 + j * 16, LD2);
        wmma::mma_sync(f, a_t1[k], w, f);
      }
      leaky_relu(f, alpha);
      store_bf16(f, s_scratch, s_z2 + j * 16, LD2, lane);
    }

    // zall += z2 . Wall[b][:, col0:col0+kColTile], fp32
    for (int k = 0; k < KT2; ++k) {
      FragA a;
      wmma::load_matrix_sync(a, s_z2 + k * 16, LD2);
#pragma unroll
      for (int c = 0; c < kColFrags; ++c) {
        FragB w;
        wmma::load_matrix_sync(w, s_wall + k * 16 * LDW + c * 16, LDW);
        wmma::mma_sync(acc[c], a, w, acc[c]);
      }
    }
  }

  if (!active) return;
#pragma unroll
  for (int c = 0; c < kColFrags; ++c)
    store_bf16(acc[c], s_scratch, zall + size_t(row0) * c9 + col0 + c * 16, c9, lane);
}

template <int NF>
int launch(const void* t0, const void* w1s, const void* w2m, const void* wall, void* zall,
           int m, int c9, float alpha, cudaStream_t stream) {
  const size_t smem = smem_bytes(NF);
  cudaError_t err = cudaFuncSetAttribute(
      tail_x4_kernel<NF>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((m + kBlockRows - 1) / kBlockRows, c9 / kColTile);
  tail_x4_kernel<NF><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(t0), static_cast<const bf16*>(w1s),
      static_cast<const bf16*>(w2m), static_cast<const bf16*>(wall),
      static_cast<bf16*>(zall), m, c9, alpha);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// t0 (m, nf), w1s (4, nf, nf), w2m (nf, 4nf), wall (4, 4nf, c9) -> zall (m, c9),
// all bf16, contiguous and 16-byte aligned.  m % 16 == 0, c9 % 144 == 0,
// nf in {16, 32, 48, 64}.  Launches on `stream` and returns cudaGetLastError().
int tail_x4_launch(const void* t0, const void* w1s, const void* w2m, const void* wall,
                   void* zall, int m, int nf, int c9, float alpha, void* stream) {
  if (m <= 0 || m % 16 != 0 || c9 <= 0 || c9 % kColTile != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nf) {
    case 16: return launch<16>(t0, w1s, w2m, wall, zall, m, c9, alpha, s);
    case 32: return launch<32>(t0, w1s, w2m, wall, zall, m, c9, alpha, s);
    case 48: return launch<48>(t0, w1s, w2m, wall, zall, m, c9, alpha, s);
    case 64: return launch<64>(t0, w1s, w2m, wall, zall, m, c9, alpha, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* tail_x4_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

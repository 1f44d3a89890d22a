// Hopper (sm_90a) building blocks shared by tail_x4.cu and probes.cu: shared-
// memory addresses, mbarriers, one-thread bulk copies and TMA tensor loads,
// and wgmma.mma_async m64nNk16 (bf16 operands, fp32 sums) and m64nNk32 (s8
// operands, s32 sums) with their matrix descriptors.  ops/kernels/build.py
// hashes this header into the key of every source that includes it, so an
// edit here rebuilds those two.
#pragma once

#include <cuda.h>   // CUtensorMap and its enums; no CUDA driver API call is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace hopper {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// ---- mbarriers: `count` arrivals complete a phase, together with the bytes
// announced by mbar_expect when copies report to it
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// Fence the barriers' initialisation for the async proxy (the copy engine).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async;\n" ::: "memory");
}
// One arrival, and `bytes` more that the copies of this phase will bring.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// Returns once the phase of `bar` with this parity has completed (a fresh
// barrier counts its phase of parity 1 as completed).
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

// ---- copies by the TMA unit, started by one thread, completing on `bar`
// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned).
__device__ __forceinline__ void bulk_copy(void* smem, const void* gmem, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(smem)),
      "l"(gmem), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
// The box of a 2-D tensor map at element coordinates (c0 innermost, c1).
// Elements outside the tensor arrive as zeros and count as bytes all the same.
__device__ __forceinline__ void tma_load_2d(void* smem, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(smem)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// ---- wgmma: a warpgroup's 64 x N product per instruction, the sums in
// registers.  A comes from registers (rs) or through a descriptor (ss).
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Returns once at most N committed groups of this warpgroup are in flight.
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// An asm statement that claims to change its operands: the values must exist
// in registers here, after a wgmma.wait_group, and nothing computed from them
// moves above it.  A wgmma reads and writes its registers until its group is
// waited for, which the compiler does not see.
__device__ __forceinline__ void keep(float& v) { asm volatile("" : "+f"(v)::"memory"); }
__device__ __forceinline__ void keep(uint32_t& v) { asm volatile("" : "+r"(v)::"memory"); }
__device__ __forceinline__ void keep(int& v) { asm volatile("" : "+r"(v)::"memory"); }
template <int N> __device__ __forceinline__ void keep(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) keep(d[i]);
}
template <int N> __device__ __forceinline__ void keep(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) keep(d[i]);
}
template <int S> __device__ __forceinline__ void keep(uint32_t (&a)[S][4]) {
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) keep(a[s][e]);
}

// A matrix descriptor.  Without swizzle (swizzle128 false) the operand is
// made of core matrices of 8 rows x 16 bytes stored whole (128 contiguous
// bytes): `lbo` bytes between the two core matrices of a k16 step along k,
// `sbo` bytes between neighbouring groups of 8 rows (of M or N).  With the
// 128-byte swizzle of a TMA box whose rows are 128 bytes: K-major, `sbo` bytes
// between groups of 8 rows (lbo unused); MN-major, `lbo` bytes between blocks
// of 64 elements of M or N and `sbo` bytes between groups of 8 rows of k.
// The start address must then lie in a 1024-byte aligned swizzle atom.
__device__ __forceinline__ uint64_t descriptor(unsigned saddr, unsigned lbo, unsigned sbo,
                                               bool swizzle128) {
  return uint64_t((saddr & 0x3ffffu) >> 4) | (uint64_t((lbo >> 4) & 0x3fffu) << 16) |
         (uint64_t((sbo >> 4) & 0x3fffu) << 32) | (uint64_t(swizzle128 ? 1 : 0) << 62);
}

// The operand lists of the instructions: the N/2 fp32 sums of a thread.
#define HOPPER_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define HOPPER_F8(i) HOPPER_F4(i), HOPPER_F4(i + 4)
#define HOPPER_F16(i) HOPPER_F8(i), HOPPER_F8(i + 8)
#define HOPPER_F32(i) HOPPER_F16(i), HOPPER_F16(i + 16)
#define HOPPER_R4(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define HOPPER_R8(i) HOPPER_R4(i), HOPPER_R4(i + 4)
#define HOPPER_R16(i) HOPPER_R8(i), HOPPER_R8(i + 8)
#define HOPPER_R32(i) HOPPER_R16(i), HOPPER_R16(i + 16)
#define HOPPER_D8 "{%0,%1,%2,%3,%4,%5,%6,%7}"
#define HOPPER_D16 "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}"
#define HOPPER_D24                                                                          \
  "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23}"
#define HOPPER_D32                                                                          \
  "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23," \
  "%24,%25,%26,%27,%28,%29,%30,%31}"
#define HOPPER_D64                                                                          \
  "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23," \
  "%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,"    \
  "%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}"
#define HOPPER_D72                                                                          \
  "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23," \
  "%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,"    \
  "%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,%64,%65,"    \
  "%66,%67,%68,%69,%70,%71}"
#define HOPPER_D96                                                                          \
  "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23," \
  "%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,"    \
  "%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,%64,%65,"    \
  "%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,%80,%81,%82,%83,%84,%85,%86,"    \
  "%87,%88,%89,%90,%91,%92,%93,%94,%95}"
// scale-d (add to the sums, else overwrite them) is a predicate
#define HOPPER_PRED(op) "{\n.reg .pred p;\nsetp.ne.b32 p, " op ", 0;\n"

// rs: A (64 x 16, bf16) from four registers, each warp's 16 rows in the
// mma.sync m16n8k16 fragment layout; B (16 x N) K-major through descriptor b.
template <int N> struct Rs;

template <> struct Rs<16> {
  static __device__ __forceinline__ void mma(float (&d)[8], const uint32_t (&a)[4], uint64_t b,
                                             int scale) {
    asm volatile(HOPPER_PRED("%13") "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
                 HOPPER_D8 ", {%8,%9,%10,%11}, %12, p, 1, 1, 0;\n}\n"
                 : HOPPER_F8(0)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale));
  }
};

template <> struct Rs<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                             int scale) {
    asm volatile(HOPPER_PRED("%21") "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
                 HOPPER_D16 ", {%16,%17,%18,%19}, %20, p, 1, 1, 0;\n}\n"
                 : HOPPER_F16(0)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale));
  }
};

template <> struct Rs<48> {
  static __device__ __forceinline__ void mma(float (&d)[24], const uint32_t (&a)[4], uint64_t b,
                                             int scale) {
    asm volatile(HOPPER_PRED("%29") "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
                 HOPPER_D24 ", {%24,%25,%26,%27}, %28, p, 1, 1, 0;\n}\n"
                 : HOPPER_F16(0), HOPPER_F8(16)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale));
  }
};

template <> struct Rs<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                             int scale) {
    asm volatile(HOPPER_PRED("%37") "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
                 HOPPER_D32 ", {%32,%33,%34,%35}, %36, p, 1, 1, 0;\n}\n"
                 : HOPPER_F32(0)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale));
  }
};

template <> struct Rs<144> {
  static __device__ __forceinline__ void mma(float (&d)[72], const uint32_t (&a)[4], uint64_t b,
                                             int scale) {
    asm volatile(HOPPER_PRED("%77") "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 "
                 HOPPER_D72 ", {%72,%73,%74,%75}, %76, p, 1, 1, 0;\n}\n"
                 : HOPPER_F32(0), HOPPER_F32(32), HOPPER_F8(64)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale));
  }
};


// ss with B MN-major (transposed: N contiguous in each row of k), A K-major;
// both through descriptors.
template <int N> struct SsT;

template <> struct SsT<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t a, uint64_t b, int scale) {
    asm volatile(HOPPER_PRED("%34") "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
                 HOPPER_D32 ", %32, %33, p, 1, 1, 0, 1;\n}\n"
                 : HOPPER_F32(0)
                 : "l"(a), "l"(b), "r"(scale));
  }
};

template <> struct SsT<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b, int scale) {
    asm volatile(HOPPER_PRED("%66") "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
                 HOPPER_D64 ", %64, %65, p, 1, 1, 0, 1;\n}\n"
                 : HOPPER_F32(0), HOPPER_F32(32)
                 : "l"(a), "l"(b), "r"(scale));
  }
};

template <> struct SsT<192> {
  static __device__ __forceinline__ void mma(float (&d)[96], uint64_t a, uint64_t b, int scale) {
    asm volatile(HOPPER_PRED("%98") "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
                 HOPPER_D96 ", %96, %97, p, 1, 1, 0, 1;\n}\n"
                 : HOPPER_F32(0), HOPPER_F32(32), HOPPER_F32(64)
                 : "l"(a), "l"(b), "r"(scale));
  }
};

// rs with B MN-major (N contiguous in each row of k, the transpose bit), A
// from four registers as in Rs.
template <int N> struct RsT;

template <> struct RsT<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                             int scale) {
    asm volatile(HOPPER_PRED("%37") "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
                 HOPPER_D32 ", {%32,%33,%34,%35}, %36, p, 1, 1, 1;\n}\n"
                 : HOPPER_F32(0)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale));
  }
};

template <> struct RsT<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                             int scale) {
    asm volatile(HOPPER_PRED("%69") "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
                 HOPPER_D64 ", {%64,%65,%66,%67}, %68, p, 1, 1, 1;\n}\n"
                 : HOPPER_F32(0), HOPPER_F32(32)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale));
  }
};

template <> struct RsT<192> {
  static __device__ __forceinline__ void mma(float (&d)[96], const uint32_t (&a)[4], uint64_t b,
                                             int scale) {
    asm volatile(HOPPER_PRED("%101") "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
                 HOPPER_D96 ", {%96,%97,%98,%99}, %100, p, 1, 1, 1;\n}\n"
                 : HOPPER_F32(0), HOPPER_F32(32), HOPPER_F32(64)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale));
  }
};

// ss for s8 operands, s32 sums, k32: A and B both K-major through
// descriptors (an 8-bit operand has no transpose bit).
template <int N> struct Ss8;

template <> struct Ss8<64> {
  static __device__ __forceinline__ void mma(int (&d)[32], uint64_t a, uint64_t b, int scale) {
    asm volatile(HOPPER_PRED("%34") "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
                 HOPPER_D32 ", %32, %33, p;\n}\n"
                 : HOPPER_R32(0)
                 : "l"(a), "l"(b), "r"(scale));
  }
};

template <> struct Ss8<128> {
  static __device__ __forceinline__ void mma(int (&d)[64], uint64_t a, uint64_t b, int scale) {
    asm volatile(HOPPER_PRED("%66") "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
                 HOPPER_D64 ", %64, %65, p;\n}\n"
                 : HOPPER_R32(0), HOPPER_R32(32)
                 : "l"(a), "l"(b), "r"(scale));
  }
};

template <> struct Ss8<192> {
  static __device__ __forceinline__ void mma(int (&d)[96], uint64_t a, uint64_t b, int scale) {
    asm volatile(HOPPER_PRED("%98") "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 "
                 HOPPER_D96 ", %96, %97, p;\n}\n"
                 : HOPPER_R32(0), HOPPER_R32(32), HOPPER_R32(64)
                 : "l"(a), "l"(b), "r"(scale));
  }
};

}  // namespace hopper

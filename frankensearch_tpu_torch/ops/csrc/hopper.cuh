// Hopper (sm_90a) primitives for K1 and K4 (group_max.cu): mbarriers, 2-D
// TMA loads, and warpgroup matrix multiplies (wgmma) reading both operands
// from shared memory laid out by a TMA load with 128-byte swizzle.
//
// The wgmma wrappers exist once per width N = 8 .. 256 (the register list
// of an m64nN product is N/2 registers a thread), for bf16 and f16
// operands (m64nNk16, f32 sums) and int8 operands (m64nNk32, s32 sums),
// both K-major; either form takes one 32-byte k step of a 128-byte row.
// Accumulator register i of a thread holds row 16*warp + lane/4 +
// 8*((i/2) % 2) and column 8*(i/4) + 2*(lane%4) + i%2 of the 64 x N tile
// (warp = its warp in the warpgroup), whatever the type.

#pragma once

#include <stdint.h>

namespace fs_hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// One arrival that also tells the barrier to expect `bytes` of TMA data.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

// Whether the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// TMA: the box at (x = inner coordinate, y = row) of the 2-D tensor map
// into shared memory, completing `bytes` on the barrier.
__device__ __forceinline__ void tma_load_2d(void* dst, const void* map, int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_addr(bar))
      : "memory");
}

// A shared-memory matrix descriptor for a K-major operand of 128-byte rows
// (64 bf16/f16 or 128 int8 elements) in TMA's 128-byte swizzle: 8-row
// atoms of 1,024 bytes (the stride byte offset); the leading byte offset
// is unused in this layout. `p` must lie 1,024-byte aligned plus the k
// offset: +32 bytes (+2 in the address field) steps one k16 (bf16/f16) or
// k32 (int8) slice along the row.
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  uint64_t d = static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>(16 >> 4) << 16;
  d |= static_cast<uint64_t>(1024 >> 4) << 32;
  d |= static_cast<uint64_t>(1) << 62;  // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Keeps the compiler from moving reads of the accumulators above a
// wgmma_wait(): the asynchronous product writes them behind its back.
template <int kR>
__device__ __forceinline__ void fence_operands(float (&d)[kR]) {
#pragma unroll
  for (int i = 0; i < kR; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int kR>
__device__ __forceinline__ void fence_operands(int (&d)[kR]) {
#pragma unroll
  for (int i = 0; i < kR; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The accumulator list of an m64nN product, N/2 registers a thread: its
// register names in the instruction (FS_REGS_<N/2>) and its operands
// (FS_D<N/2>(C, 0), each written C(d[i]): "+f" for f32, "+r" for s32).
#define FS_REGS_4 "%0, %1, %2, %3"
#define FS_REGS_8 FS_REGS_4 ", %4, %5, %6, %7"
#define FS_REGS_16 FS_REGS_8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define FS_REGS_32 FS_REGS_16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define FS_REGS_64 FS_REGS_32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define FS_REGS_128 FS_REGS_64 ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
#define FS_D4(C, i) C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3])
#define FS_D8(C, i) FS_D4(C, i), FS_D4(C, i + 4)
#define FS_D16(C, i) FS_D8(C, i), FS_D8(C, i + 8)
#define FS_D32(C, i) FS_D16(C, i), FS_D16(C, i + 16)
#define FS_D64(C, i) FS_D32(C, i), FS_D32(C, i + 32)
#define FS_D128(C, i) FS_D64(C, i), FS_D64(C, i + 64)
#define FS_F32(x) "+f"(x)
#define FS_S32(x) "+r"(x)

// One wgmma: INSTR on the accumulators REGS (operands in the variadic
// part), descriptors da and db at operand indices A and B, scale_d at P;
// TAIL is the f16/bf16 forms' scale-a, scale-b and transpose immediates
// (the integer form has none).
#define FS_WGMMA_ASM(INSTR, REGS, A, B, P, TAIL, ...)                                   \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" P ", 0;\n" INSTR " {" REGS "}, %" A \
               ", %" B ", p" TAIL ";\n}\n"                                              \
               : __VA_ARGS__                                                           \
               : "l"(da), "l"(db), "r"(scale_d))

// d (+)= A (64 rows, descriptor da) x B (N rows, descriptor db)^T over one
// 32-byte k step, both operands K-major: fma() for bf16 or f16 (k16, f32
// sums), fma_s8() for int8 (k32, exact s32 sums). With scale_d == 0 the
// product overwrites d.
template <int kN>
struct Wgmma;

#define FS_WGMMA_WIDTH(N, R, A, B, P)                                                                   \
  template <>                                                                                           \
  struct Wgmma<N> {                                                                                     \
    template <bool kBf16>                                                                               \
    static __device__ __forceinline__ void fma(float (&d)[R], uint64_t da, uint64_t db, int scale_d) {  \
      if constexpr (kBf16)                                                                              \
        FS_WGMMA_ASM("wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16", FS_REGS_##R, #A, #B,   \
                     #P, ", 1, 1, 0, 0", FS_D##R(FS_F32, 0));                                            \
      else                                                                                              \
        FS_WGMMA_ASM("wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.f16.f16", FS_REGS_##R, #A, #B, #P, \
                     ", 1, 1, 0, 0", FS_D##R(FS_F32, 0));                                                \
    }                                                                                                   \
    static __device__ __forceinline__ void fma_s8(int (&d)[R], uint64_t da, uint64_t db, int scale_d) { \
      FS_WGMMA_ASM("wgmma.mma_async.sync.aligned.m64n" #N "k32.s32.s8.s8", FS_REGS_##R, #A, #B, #P, "",  \
                   FS_D##R(FS_S32, 0));                                                                  \
    }                                                                                                   \
  };
FS_WGMMA_WIDTH(8, 4, 4, 5, 6)
FS_WGMMA_WIDTH(16, 8, 8, 9, 10)
FS_WGMMA_WIDTH(32, 16, 16, 17, 18)
FS_WGMMA_WIDTH(64, 32, 32, 33, 34)
FS_WGMMA_WIDTH(128, 64, 64, 65, 66)
FS_WGMMA_WIDTH(256, 128, 128, 129, 130)

#undef FS_WGMMA_WIDTH
#undef FS_WGMMA_ASM
#undef FS_F32
#undef FS_S32
#undef FS_REGS_4
#undef FS_D4
#undef FS_REGS_8
#undef FS_D8
#undef FS_REGS_16
#undef FS_D16
#undef FS_REGS_32
#undef FS_D32
#undef FS_REGS_64
#undef FS_D64
#undef FS_REGS_128
#undef FS_D128
}  // namespace fs_hopper

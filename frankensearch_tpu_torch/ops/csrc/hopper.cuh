// Hopper (sm_90a) primitives for K1 (group_max.cu): mbarriers, 2-D TMA
// loads, and warpgroup matrix multiplies (wgmma) reading both operands
// from shared memory laid out by a TMA load with 128-byte swizzle.
//
// The wgmma wrappers are written out once per width N (the register list
// of an m64nNk16 product with f32 accumulators is N/2 registers a thread),
// for bf16 and f16 operands, both K-major. Accumulator register i of a
// thread holds row 16*warp + lane/4 + 8*((i/2) % 2) and column
// 8*(i/4) + 2*(lane%4) + i%2 of the 64 x N tile (warp = its warp in the
// warpgroup).

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

// A shared-memory matrix descriptor for a K-major operand of 64-element
// (128-byte) rows in TMA's 128-byte swizzle: 8-row atoms of 1,024 bytes
// (the stride byte offset); the leading byte offset is unused in this
// layout. `p` must lie 1,024-byte aligned plus the k offset: +32 bytes
// (+2 in the address field) steps one k16 slice along the row.
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

// d (+)= A (64 x 16, descriptor da) x B (N x 16, descriptor db)^T; with
// scale_d == 0 the product overwrites d.
template <int kN>
struct Wgmma;

#define FS_WGMMA(TY)                                                        \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"                      \
               "wgmma.mma_async.sync.aligned.m64n8k16.f32." TY "." TY " {"  \
               "%0, %1, %2, %3"  \
               "}, %4, %5, p, 1, 1, 0, 0;\n}\n"  \
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])  \
               : "l"(da), "l"(db), "r"(scale_d))
template <>
struct Wgmma<8> {
  template <bool kBf16>
  static __device__ __forceinline__ void fma(float (&d)[4], uint64_t da, uint64_t db, int scale_d) {
    if constexpr (kBf16) FS_WGMMA("bf16"); else FS_WGMMA("f16");
  }
};
#undef FS_WGMMA

#define FS_WGMMA(TY)                                                        \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"                      \
               "wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY " {"  \
               "%0, %1, %2, %3, %4, %5, %6, %7"  \
               "}, %8, %9, p, 1, 1, 0, 0;\n}\n"  \
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])  \
               : "l"(da), "l"(db), "r"(scale_d))
template <>
struct Wgmma<16> {
  template <bool kBf16>
  static __device__ __forceinline__ void fma(float (&d)[8], uint64_t da, uint64_t db, int scale_d) {
    if constexpr (kBf16) FS_WGMMA("bf16"); else FS_WGMMA("f16");
  }
};
#undef FS_WGMMA

#define FS_WGMMA(TY)                                                        \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                      \
               "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {"  \
               "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"  \
               "}, %16, %17, p, 1, 1, 0, 0;\n}\n"  \
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),  \
                 "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])  \
               : "l"(da), "l"(db), "r"(scale_d))
template <>
struct Wgmma<32> {
  template <bool kBf16>
  static __device__ __forceinline__ void fma(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
    if constexpr (kBf16) FS_WGMMA("bf16"); else FS_WGMMA("f16");
  }
};
#undef FS_WGMMA

#define FS_WGMMA(TY)                                                        \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                      \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"  \
               "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
               "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"  \
               "}, %32, %33, p, 1, 1, 0, 0;\n}\n"  \
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),  \
                 "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),  \
                 "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
                 "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])  \
               : "l"(da), "l"(db), "r"(scale_d))
template <>
struct Wgmma<64> {
  template <bool kBf16>
  static __device__ __forceinline__ void fma(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
    if constexpr (kBf16) FS_WGMMA("bf16"); else FS_WGMMA("f16");
  }
};
#undef FS_WGMMA

#define FS_WGMMA(TY)                                                        \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                      \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"  \
               "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
               "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "  \
               "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "  \
               "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"  \
               "}, %64, %65, p, 1, 1, 0, 0;\n}\n"  \
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),  \
                 "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),  \
                 "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
                 "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),  \
                 "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),  \
                 "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),  \
                 "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),  \
                 "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])  \
               : "l"(da), "l"(db), "r"(scale_d))
template <>
struct Wgmma<128> {
  template <bool kBf16>
  static __device__ __forceinline__ void fma(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
    if constexpr (kBf16) FS_WGMMA("bf16"); else FS_WGMMA("f16");
  }
};
#undef FS_WGMMA

#define FS_WGMMA(TY)                                                        \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"                      \
               "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " {"  \
               "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
               "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "  \
               "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "  \
               "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "  \
               "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "  \
               "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "  \
               "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "  \
               "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"  \
               "}, %128, %129, p, 1, 1, 0, 0;\n}\n"  \
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),  \
                 "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),  \
                 "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
                 "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),  \
                 "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),  \
                 "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),  \
                 "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),  \
                 "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),  \
                 "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),  \
                 "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),  \
                 "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),  \
                 "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),  \
                 "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),  \
                 "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),  \
                 "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),  \
                 "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])  \
               : "l"(da), "l"(db), "r"(scale_d))
template <>
struct Wgmma<256> {
  template <bool kBf16>
  static __device__ __forceinline__ void fma(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
    if constexpr (kBf16) FS_WGMMA("bf16"); else FS_WGMMA("f16");
  }
};
#undef FS_WGMMA
}  // namespace fs_hopper

// The per-group scoring body of K5 (tile_topk.cu), for sm_90a.
//
// score_group_with() computes, for one 128-row group of the slab and a tile
// of 64 queries, the dot products dot(bf16(q[b]), slab[r]) with bf16 (or
// f16) products accumulated in f32 on the tensor cores (mma.sync
// m16n8k16, k16 steps in ascending order), and hands them, with the
// group's mask staged in shared memory, to an epilogue. K1 (group_max.cu)
// computes the same dot products with wgmma in the same k order, and the
// card tests hold it to these bits (K1_DIGESTS: unchanged since K1 ran this
// body), so K5's scores are the values K1 takes the maximum of, bit for
// bit.
//
// Layout:
//   * 4 warps, each owning 32 rows x 64 queries (2 x 8 mma tiles, 64 f32
//     accumulators per thread);
//   * the group's rows and the query tile are staged through shared memory
//     in 64-dim chunks with 16-byte loads; rows are padded to 72 elements so
//     the fragment loads are free of bank conflicts;

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace fs_scan {

constexpr int kGroup = 128;       // rows per group
constexpr int kQTile = 64;        // queries per block
constexpr int kChunk = 64;        // dims staged per step
constexpr int kLds = kChunk + 8;  // padded shared-memory row stride
constexpr int kWarps = 4;         // each warp: 32 rows x 64 queries
constexpr int kThreads = kWarps * 32;

struct GroupSmem {
  __align__(16) uint16_t rows[kGroup * kLds];
  __align__(16) uint16_t q[kQTile * kLds];
  float mask[kGroup];
};

template <bool kBf16>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  if constexpr (kBf16) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

__device__ __forceinline__ uint32_t lds32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Accumulators of score_group_with(): acc[mt][nt][c] is the dot product of
// row warp*32 + mt*16 + g (+8 for c >= 2) of the group with query
// nt*8 + 2t + (c & 1) of the tile, where g = lane / 4 and t = lane % 4.
using GroupAcc = float[2][8][4];

// Scores rows row0 .. row0+127 of the slab against queries q0 .. q0+63
// (missing queries past b score as zero rows) and calls epi(acc) with every
// thread's accumulators, sm.mask holding the group's mask. Every thread of
// the block must call it. The staged rows and queries are dead when epi
// runs (all threads have passed the barrier after the last chunk); the
// mask is live until epi's own barrier.
template <bool kBf16, class Epilogue>
__device__ __forceinline__ void score_group_with(const uint16_t* __restrict__ q,
                                                 const uint16_t* __restrict__ slab,
                                                 const float* __restrict__ mask,
                                                 int64_t row0, int q0, int b, int d,
                                                 GroupSmem& sm, Epilogue&& epi) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // mma groupID
  const int t = lane & 3;   // mma thread-in-group

  for (int i = tid; i < kGroup; i += kThreads) sm.mask[i] = mask[row0 + i];

  GroupAcc acc;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.0f;

  constexpr int kVecPerRow = kChunk / 8;  // 16-byte vectors per staged row
  for (int k0 = 0; k0 < d; k0 += kChunk) {
    for (int i = tid; i < kGroup * kVecPerRow; i += kThreads) {
      const int r = i / kVecPerRow;
      const int c = (i % kVecPerRow) * 8;
      *reinterpret_cast<uint4*>(&sm.rows[r * kLds + c]) =
          *reinterpret_cast<const uint4*>(slab + (row0 + r) * d + k0 + c);
    }
    for (int i = tid; i < kQTile * kVecPerRow; i += kThreads) {
      const int r = i / kVecPerRow;
      const int c = (i % kVecPerRow) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (q0 + r < b)
        v = *reinterpret_cast<const uint4*>(
            q + static_cast<int64_t>(q0 + r) * d + k0 + c);
      *reinterpret_cast<uint4*>(&sm.q[r * kLds + c]) = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const uint16_t* p = &sm.rows[(warp * 32 + mt * 16 + g) * kLds + kk + 2 * t];
        a[mt][0] = lds32(p);                 // row g,   k 2t..2t+1
        a[mt][1] = lds32(p + 8 * kLds);      // row g+8, k 2t..2t+1
        a[mt][2] = lds32(p + 8);             // row g,   k 2t+8..2t+9
        a[mt][3] = lds32(p + 8 * kLds + 8);  // row g+8, k 2t+8..2t+9
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const uint16_t* p = &sm.q[(nt * 8 + g) * kLds + kk + 2 * t];
        const uint32_t b0 = lds32(p);      // k 2t..2t+1,   query g
        const uint32_t b1 = lds32(p + 8);  // k 2t+8..2t+9, query g
        mma16816<kBf16>(acc[0][nt], a[0], b0, b1);
        mma16816<kBf16>(acc[1][nt], a[1], b0, b1);
      }
    }
    __syncthreads();
  }
  epi(acc);
}

}  // namespace fs_scan

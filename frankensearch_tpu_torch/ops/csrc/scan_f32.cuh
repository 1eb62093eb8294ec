// The f32 scoring body of K1 (group_max.cu), for sm_90a. K5's f32 entry
// (tile_topk.cu) scores with its own staging and the same fmaf chain, so
// the same bits.
//
// score_group_f32_with() computes, for one 128-row group of an f32 slab
// and a tile of kNT * 8 queries, the dot products dot(q[b], slab[r]) with
// f32 products and sums on the CUDA cores (FFMA), and hands them, with the
// group's mask staged in shared memory, to an epilogue. It is the TPU
// kernels' dot_general on an f32 slab. TF32 would round the operands, and
// the bf16 bodies' wgmma / mma.sync take no f32 operands, so this body
// does not touch the tensor cores.
//
// Every score is one chain of fmaf from +0.0 over the dims in ascending
// order, whatever the tile, the batch or the thread: K1's maxima and K5's
// candidates are the same bits, and a query's scores do not depend on its
// batchmates.
//
// What bounds it on the H100: FFMA. At 1,007,616 x 256 f32 and B = 256 the
// scan reads 1.03 GB (0.31 ms at 3.35 TB/s) and does 1.32e11 FLOP (1.97 ms
// at the 67 TFLOP/s f32 peak), so arithmetic. The design keeps the FFMA
// units fed from registers: each thread holds a 2 x kNT x 4 block of
// accumulators (32 rows x 64 queries a warp at kNT = 8) and reads, per 4
// dims, four 16-byte row vectors and two 16-byte query vectors per query
// column pair from shared memory: 32 FFMA per 16-byte load at kNT = 8.
//
// Layout (the accumulators are those of group_scan.cuh's mma.sync body,
// so the epilogues read them alike): 4 warps, warp w owning rows 32w ..
// 32w+31; acc[mt][nt][c] is row 32w + 16mt + g (+8 for c >= 2) against
// query 8nt + 2t + (c & 1), g = lane / 4, t = lane % 4. The group's rows
// and the query tile are staged in 32-dim chunks with 16-byte loads, rows
// padded to 36 floats: the fragment loads of a warp are free of bank
// conflicts (the 8 row addresses fall 4 banks apart, the 4 query addresses
// 8 apart).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace fs_scan_f32 {

constexpr int kGroup = 128;       // rows per group
constexpr int kMaxQ = 64;         // queries per tile at most (kNT = 8)
constexpr int kChunk = 32;        // dims staged per step
constexpr int kLds = kChunk + 4;  // padded shared-memory row stride (floats)
constexpr int kWarps = 4;         // each warp: 32 rows x kNT * 8 queries
constexpr int kThreads = kWarps * 32;

struct GroupSmemF32 {
  __align__(16) float rows[kGroup * kLds];
  __align__(16) float q[kMaxQ * kLds];
  float mask[kGroup];
};

template <int kNT>
using GroupAccF32 = float[2][kNT][4];

// Scores rows row0 .. row0+127 of the slab against queries q0 .. q0 +
// 8*kNT - 1 (queries past b score as zero rows) and calls epi(acc) with
// every thread's accumulators, sm.mask holding the group's mask. Every
// thread of the block must call it. The staged rows and queries are dead
// when epi runs (all threads have passed the barrier after the last
// chunk); the mask is live until epi's own barrier. Needs d % 32 == 0 and
// 16-byte aligned rows.
template <int kNT, class Epilogue>
__device__ __forceinline__ void score_group_f32_with(const float* __restrict__ q,
                                                     const float* __restrict__ slab,
                                                     const float* __restrict__ mask,
                                                     int64_t row0, int q0, int b, int d,
                                                     GroupSmemF32& sm, Epilogue&& epi) {
  constexpr int kQ = kNT * 8;
  constexpr int kVec = kChunk / 4;  // 16-byte vectors per staged row
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  for (int i = tid; i < kGroup; i += kThreads) sm.mask[i] = mask[row0 + i];

  float acc[2][kNT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.0f;

  for (int k0 = 0; k0 < d; k0 += kChunk) {
    for (int i = tid; i < kGroup * kVec; i += kThreads) {
      const int r = i / kVec;
      const int c = (i % kVec) * 4;
      *reinterpret_cast<float4*>(&sm.rows[r * kLds + c]) =
          __ldg(reinterpret_cast<const float4*>(slab + (row0 + r) * d + k0 + c));
    }
    for (int i = tid; i < kQ * kVec; i += kThreads) {
      const int r = i / kVec;
      const int c = (i % kVec) * 4;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (q0 + r < b) v = __ldg(reinterpret_cast<const float4*>(q + static_cast<int64_t>(q0 + r) * d + k0 + c));
      *reinterpret_cast<float4*>(&sm.q[r * kLds + c]) = v;
    }
    __syncthreads();
#pragma unroll 2
    for (int kk = 0; kk < kChunk; kk += 4) {
      float4 a[2][2];  // [mt][h]: rows 32w + 16mt + g + 8h, dims kk .. kk+3
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          a[mt][h] = *reinterpret_cast<const float4*>(&sm.rows[(warp * 32 + mt * 16 + g + 8 * h) * kLds + kk]);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float4 v = *reinterpret_cast<const float4*>(&sm.q[(nt * 8 + 2 * t + j) * kLds + kk]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float& s = acc[mt][nt][2 * h + j];
              s = fmaf(a[mt][h].x, v.x, s);
              s = fmaf(a[mt][h].y, v.y, s);
              s = fmaf(a[mt][h].z, v.z, s);
              s = fmaf(a[mt][h].w, v.w, s);
            }
        }
      }
    }
    __syncthreads();
  }
  epi(acc);
}

}  // namespace fs_scan_f32

// K4: masked per-group maxima of the int8 slab scan, for sm_90a.
//
// Replaces the TPU kernel frankensearch_tpu/ops/topk_scan.py
// `_group_max_int8_kernel` (the pallas_call in `scan_topk_hierarchical_int8`).
// For every 128-row group g of the int8 slab and every prepared int8 query b
//
//     out[b, g] = max_{r in g} ( float(sum_d q_i8[b, d] * slab_i8[r, d]) + mask[r] )
//
// The products and their sum are int32 and exact, and the cast to f32 is
// exact while |sum| < 2^24 (127 * 127 * 1024 < 2^24, so for dim <= 1024), so
// the result is bitwise the twin's and the TPU kernel's whatever the order
// of the sum.
//
// What bounds it on the H100: at the capacity lane's shape (1M x 256 int8
// slab, B = 256) it reads a 258 MB slab (0.077 ms at 3.35 TB/s) and does
// 2 * 256 * 256 * 1M = 132 G int8 operations (0.067 ms at 1,979 TOP/s):
// both about equal, so the products must run on the tensor cores, here
// with mma.sync m16n8k32 s8 x s8 -> s32.
//
// Design (the first K1's, mma.sync, with int8 fragments; correct and
// simple first):
//   * one block = one 128-row group x a tile of 64 queries, 4 warps; blocks
//     of one group are adjacent in the grid, so the group's rows come from
//     HBM once and from L2 for the other query tiles;
//   * rows and queries are staged through shared memory in 128-byte
//     chunks with 16-byte loads, rows padded to 144 bytes so that the
//     fragment loads hit 32 different banks;
//   * each warp owns 32 rows x 64 queries (2 x 8 mma tiles, 64 int32
//     accumulators per thread);
//   * the mask is added in f32 after the exact cast, the max over the 128
//     rows is taken in registers, across lanes with shuffles and across the
//     4 warps through shared memory; the result is written as (B, n_groups).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 128;        // rows per group == rows per block
constexpr int kQTile = 64;         // queries per block
constexpr int kChunk = 128;        // int8 dims (bytes) staged per step
constexpr int kLds = kChunk + 16;  // padded shared-memory row stride, bytes
constexpr int kWarps = 4;          // each warp: 32 rows x 64 queries
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ void mma16832(int (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(kThreads)
group_max_int8_kernel(const int8_t* __restrict__ q,     // (b, d) int8
                      const int8_t* __restrict__ slab,  // (n, d) int8
                      const float* __restrict__ mask,   // (n,) additive
                      float* __restrict__ out,          // (b, n_groups)
                      int b, int d, int n_groups, int n_qtiles) {
  __shared__ __align__(16) int8_t s_rows[kGroup * kLds];
  __shared__ __align__(16) int8_t s_q[kQTile * kLds];
  __shared__ float s_mask[kGroup];
  __shared__ float s_red[kWarps][kQTile];

  const int qtile = blockIdx.x % n_qtiles;
  const int group = blockIdx.x / n_qtiles;
  const int q0 = qtile * kQTile;
  const int64_t row0 = static_cast<int64_t>(group) * kGroup;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // mma groupID
  const int t = lane & 3;   // mma thread-in-group

  for (int i = tid; i < kGroup; i += kThreads) s_mask[i] = mask[row0 + i];

  int acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0;

  constexpr int kVecPerRow = kChunk / 16;  // 16-byte vectors per staged row
  for (int k0 = 0; k0 < d; k0 += kChunk) {
    for (int i = tid; i < kGroup * kVecPerRow; i += kThreads) {
      const int r = i / kVecPerRow;
      const int c = (i % kVecPerRow) * 16;
      *reinterpret_cast<uint4*>(&s_rows[r * kLds + c]) =
          *reinterpret_cast<const uint4*>(slab + (row0 + r) * d + k0 + c);
    }
    for (int i = tid; i < kQTile * kVecPerRow; i += kThreads) {
      const int r = i / kVecPerRow;
      const int c = (i % kVecPerRow) * 16;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (q0 + r < b)
        v = *reinterpret_cast<const uint4*>(
            q + static_cast<int64_t>(q0 + r) * d + k0 + c);
      *reinterpret_cast<uint4*>(&s_q[r * kLds + c]) = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += 32) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int8_t* p = &s_rows[(warp * 32 + mt * 16 + g) * kLds + kk + 4 * t];
        a[mt][0] = lds32(p);                  // row g,   k 4t..4t+3
        a[mt][1] = lds32(p + 8 * kLds);       // row g+8, k 4t..4t+3
        a[mt][2] = lds32(p + 16);             // row g,   k 4t+16..4t+19
        a[mt][3] = lds32(p + 8 * kLds + 16);  // row g+8, k 4t+16..4t+19
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int8_t* p = &s_q[(nt * 8 + g) * kLds + kk + 4 * t];
        const uint32_t b0 = lds32(p);       // k 4t..4t+3,       query g
        const uint32_t b1 = lds32(p + 16);  // k 4t+16..4t+19,   query g
        mma16832(acc[0][nt], a[0], b0, b1);
        mma16832(acc[1][nt], a[1], b0, b1);
      }
    }
    __syncthreads();
  }

  // acc[mt][nt][c] is the sum of row warp*32 + mt*16 + g (+8 for c >= 2)
  // against query nt*8 + 2t + (c & 1).
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float m = -INFINITY;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = warp * 32 + mt * 16 + g;
        m = fmaxf(m, __int2float_rn(acc[mt][nt][j]) + s_mask[r]);
        m = fmaxf(m, __int2float_rn(acc[mt][nt][j + 2]) + s_mask[r + 8]);
      }
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 4));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 8));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 16));
      if (g == 0) s_red[warp][nt * 8 + 2 * t + j] = m;
    }
  }
  __syncthreads();
  for (int c = tid; c < kQTile; c += kThreads) {
    const int qi = q0 + c;
    if (qi < b) {
      float m = s_red[0][c];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) m = fmaxf(m, s_red[w][c]);
      out[static_cast<int64_t>(qi) * n_groups + group] = m;
    }
  }
}

}  // namespace

// q: (b, d) int8 prepared queries, slab: (n, d) int8, mask: (n,) f32,
// out: (b, n / 128) f32. Needs n % 128 == 0, d % 128 == 0, b >= 1 and
// 16-byte aligned pointers (the Python wrapper checks all of these).
// Returns cudaGetLastError() after the launch.
extern "C" int fs_group_max_int8(const void* q, const void* slab, const void* mask,
                                 void* out, int b, int d, long long n, void* stream) {
  if (b < 1 || d < kChunk || d % kChunk != 0 || n < kGroup || n % kGroup != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_groups = n / kGroup;
  const long long n_qtiles = (b + kQTile - 1) / kQTile;
  const long long blocks = n_groups * n_qtiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  group_max_int8_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(slab),
      static_cast<const float*>(mask), static_cast<float*>(out), b, d,
      static_cast<int>(n_groups), static_cast<int>(n_qtiles));
  return static_cast<int>(cudaGetLastError());
}

// K1: masked per-group maxima of the slab scan scores, for sm_90a.
//
// Replaces the TPU kernel frankensearch_tpu/ops/topk_scan.py
// `_group_max_kernel` (the pallas_call in `scan_topk_hierarchical`).
// For every 128-row group g of the slab and every query b it computes
//
//     out[b, g] = max_{r in g} ( dot(bf16(q[b]), slab[r]) + mask[r] )
//
// with bf16 (or f16) products accumulated in f32. The query arrives already
// rounded to the slab dtype, exactly like the TPU kernel's astype.
//
// What bounds it on the H100: at the headline shape (1M x 256 bf16 slab,
// B = 256) the scan is ~134 GFLOP over a 0.5 GB slab, about 260 FLOP per
// slab byte: close to the bf16 ridge (~295 FLOP/B). A CUDA-core FMA loop
// would be ~10x off the roof, so the products run on the tensor cores with
// mma.sync m16n8k16 (f32 accumulate).
//
// Design (correct and simple first; wgmma/TMA pipelines are later work):
//   * one block = one 128-row group x a tile of 64 queries, 4 warps;
//     blocks for the same group are adjacent in the grid so the slab tile
//     is read from HBM once and served from L2 to the other query tiles;
//   * the group's rows and the query tile are staged through shared memory
//     in 64-dim chunks with 16-byte loads; rows are padded to 72 elements so
//     the fragment loads are free of bank conflicts;
//   * each warp owns 32 rows x 64 queries (2 x 8 mma tiles, 64 f32
//     accumulators per thread);
//   * the mask is added in f32 before the max, the max over the 128 rows is
//     taken in registers, across lanes with shuffles and across the 4 warps
//     through shared memory;
//   * the result is written straight as (B, n_groups): no tile-major layout
//     and no transpose afterwards.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 128;           // rows per group == rows per block
constexpr int kQTile = 64;            // queries per block
constexpr int kChunk = 64;            // dims staged per step
constexpr int kLds = kChunk + 8;      // padded shared-memory row stride
constexpr int kWarps = 4;             // each warp: 32 rows x 64 queries
constexpr int kThreads = kWarps * 32;

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

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
group_max_kernel(const uint16_t* __restrict__ q,     // (b, d) slab dtype
                 const uint16_t* __restrict__ slab,  // (n, d)
                 const float* __restrict__ mask,     // (n,) additive
                 float* __restrict__ out,            // (b, n_groups)
                 int b, int d, int n_groups, int n_qtiles) {
  __shared__ __align__(16) uint16_t s_rows[kGroup * kLds];
  __shared__ __align__(16) uint16_t s_q[kQTile * kLds];
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

  float acc[2][8][4];
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
      *reinterpret_cast<uint4*>(&s_rows[r * kLds + c]) =
          *reinterpret_cast<const uint4*>(slab + (row0 + r) * d + k0 + c);
    }
    for (int i = tid; i < kQTile * kVecPerRow; i += kThreads) {
      const int r = i / kVecPerRow;
      const int c = (i % kVecPerRow) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (q0 + r < b)
        v = *reinterpret_cast<const uint4*>(
            q + static_cast<int64_t>(q0 + r) * d + k0 + c);
      *reinterpret_cast<uint4*>(&s_q[r * kLds + c]) = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const uint16_t* p = &s_rows[(warp * 32 + mt * 16 + g) * kLds + kk + 2 * t];
        a[mt][0] = lds32(p);                 // row g,   k 2t..2t+1
        a[mt][1] = lds32(p + 8 * kLds);      // row g+8, k 2t..2t+1
        a[mt][2] = lds32(p + 8);             // row g,   k 2t+8..2t+9
        a[mt][3] = lds32(p + 8 * kLds + 8);  // row g+8, k 2t+8..2t+9
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const uint16_t* p = &s_q[(nt * 8 + g) * kLds + kk + 2 * t];
        const uint32_t b0 = lds32(p);      // k 2t..2t+1,   query g
        const uint32_t b1 = lds32(p + 8);  // k 2t+8..2t+9, query g
        mma16816<kBf16>(acc[0][nt], a[0], b0, b1);
        mma16816<kBf16>(acc[1][nt], a[1], b0, b1);
      }
    }
    __syncthreads();
  }

  // acc[mt][nt][c] is the score of row warp*32 + mt*16 + g (+8 for c >= 2)
  // against query nt*8 + 2t + (c & 1).
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float m = -INFINITY;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = warp * 32 + mt * 16 + g;
        m = fmaxf(m, acc[mt][nt][j] + s_mask[r]);
        m = fmaxf(m, acc[mt][nt][j + 2] + s_mask[r + 8]);
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

// q: (b, d) bf16/f16, slab: (n, d) same dtype, mask: (n,) f32,
// out: (b, n / 128) f32. Needs n % 128 == 0, d % 64 == 0, b >= 1 and
// 16-byte aligned pointers (the Python wrapper checks all of these).
// Returns cudaGetLastError() after the launch.
extern "C" int fs_group_max(const void* q, const void* slab, const void* mask,
                            void* out, int b, int d, long long n, int is_bf16,
                            void* stream) {
  if (b < 1 || d < kChunk || d % kChunk != 0 || n < kGroup || n % kGroup != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_groups = n / kGroup;
  const long long n_qtiles = (b + kQTile - 1) / kQTile;
  const long long blocks = n_groups * n_qtiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const uint16_t*>(q);
  const auto* sp = static_cast<const uint16_t*>(slab);
  const auto* mp = static_cast<const float*>(mask);
  auto* op = static_cast<float*>(out);
  if (is_bf16)
    group_max_kernel<true><<<grid, kThreads, 0, s>>>(
        qp, sp, mp, op, b, d, static_cast<int>(n_groups), static_cast<int>(n_qtiles));
  else
    group_max_kernel<false><<<grid, kThreads, 0, s>>>(
        qp, sp, mp, op, b, d, static_cast<int>(n_groups), static_cast<int>(n_qtiles));
  return static_cast<int>(cudaGetLastError());
}

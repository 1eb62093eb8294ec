// K6: per-tile group candidates of the slab scan scores, for sm_90a.
//
// Replaces the TPU kernel frankensearch_tpu/ops/ab_primitives.py
// `_group_candidates_kernel` (the pallas_call of
// `scan_topk_hierarchical_ab(emit="tile_topk")`). For each tile of tile_n
// slab rows and each query b it
//   1. computes the tile's g_tile = tile_n / 128 group maxima of
//      bf16(q[b]) . slab[r] + mask[r] (bf16 or f16 products, f32 sums), with
//      the scoring body of group_scan.cuh, whose bits K1 gives too;
//   2. runs t argmax passes over them: pass j takes the largest maximum m
//      (+0.0 above -0.0, as `jnp.max`), the FIRST group whose maximum == m
//      (so -0.0 ties +0.0), writes m to out_v[tile, j, b] and the global
//      group id tile * g_tile + local to out_g[tile, j, b], and knocks the
//      group out with -inf. Once every group is -inf the pass takes group 0
//      of the tile again, as the TPU kernel does.
//
// What bounds it on the H100: the slab is read once (1M x 256 bf16: 516 MB,
// about 0.16 ms at 3.35 TB/s; its 134 G bf16 operations take 0.13 ms at
// 989 TFLOP/s), so bytes, as for K1. The t selection passes run on 64 group
// maxima per query held in registers and add no device-memory traffic.
//
// Design (correct and simple first):
//   * one block = one tile x a tile of 64 queries, 4 warps; the blocks of
//     one tile are adjacent in the grid, so the tile comes from HBM once;
//   * the block walks the tile's groups with score_group() and keeps the
//     64 x g_tile maxima in shared memory (16.6 KB at tile_n = 8192);
//   * then one warp per query: each lane holds two maxima (groups lane and
//     lane + 32), a shuffle reduction finds the pass's maximum, a second
//     one the lowest group index holding it, and the owning lane knocks it
//     out.

#include "group_scan.cuh"

using namespace fs_scan;

namespace {

constexpr int kMaxGroupsPerTile = 64;  // tile_n <= 8192
constexpr int kLdG = kMaxGroupsPerTile + 1;

// Integer key whose order is the float total order (-0.0 below +0.0), the
// order `float_order_key` gives the plain twin.
__device__ __forceinline__ int order_key(float x) {
  const int bits = __float_as_int(x);
  return bits >= 0 ? bits : bits ^ 0x7fffffff;
}

__device__ __forceinline__ float total_max(float a, float b) {
  return order_key(b) > order_key(a) ? b : a;
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
group_candidates_kernel(const uint16_t* __restrict__ q,     // (b, d) slab dtype
                        const uint16_t* __restrict__ slab,  // (n, d)
                        const float* __restrict__ mask,     // (n,) additive
                        float* __restrict__ out_v,          // (n_tiles, t, b)
                        int32_t* __restrict__ out_g,        // (n_tiles, t, b)
                        int b, int d, int g_tile, int t, int n_qtiles) {
  __shared__ GroupSmem sm;
  __shared__ float s_gmax[kQTile * kLdG];

  const int tile = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * kQTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int lg = 0; lg < g_tile; ++lg) {
    const int64_t row0 = (static_cast<int64_t>(tile) * g_tile + lg) * kGroup;
    score_group<kBf16>(q, slab, mask, row0, q0, b, d, sm);
    for (int c = threadIdx.x; c < kQTile; c += kThreads) s_gmax[c * kLdG + lg] = group_max_of(sm, c);
  }
  __syncthreads();

  const int gid0 = tile * g_tile;
  for (int ql = warp; ql < kQTile; ql += kWarps) {
    const int qi = q0 + ql;
    if (qi >= b) break;
    const float* row = s_gmax + ql * kLdG;
    float v0 = lane < g_tile ? row[lane] : -INFINITY;
    float v1 = lane + 32 < g_tile ? row[lane + 32] : -INFINITY;
    for (int j = 0; j < t; ++j) {
      float m = total_max(v0, v1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) m = total_max(m, __shfl_xor_sync(0xffffffffu, m, off));
      // lanes past g_tile hold -inf too, but group 0 is -inf whenever they
      // tie the maximum, and it is the lower index
      int c = v0 == m ? lane : (v1 == m ? lane + 32 : g_tile);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) c = min(c, __shfl_xor_sync(0xffffffffu, c, off));
      if (lane == 0) {
        const int64_t o = (static_cast<int64_t>(tile) * t + j) * b + qi;
        out_v[o] = m;
        out_g[o] = gid0 + c;
      }
      if (c == lane) v0 = -INFINITY;
      else if (c == lane + 32) v1 = -INFINITY;
    }
  }
}

}  // namespace

// q: (b, d) bf16/f16, slab: (n, d) same dtype, mask: (n,) f32, out_v /
// out_g: (n / tile_n, t, b) f32 / int32. Needs d % 64 == 0, tile_n a
// multiple of 128 with 128 <= tile_n <= 8192 and n % tile_n == 0,
// 1 <= t <= tile_n / 128, b >= 1 and 16-byte aligned pointers (the Python
// wrapper checks all of these). Returns cudaGetLastError() after the launch.
extern "C" int fs_group_candidates(const void* q, const void* slab, const void* mask,
                                   void* out_v, void* out_g, int b, int d, long long n,
                                   int tile_n, int t, int is_bf16, void* stream) {
  if (b < 1 || d < kChunk || d % kChunk != 0 || tile_n < kGroup || tile_n % kGroup != 0 ||
      tile_n > kGroup * kMaxGroupsPerTile || n < tile_n || n % tile_n != 0 || t < 1 ||
      t > tile_n / kGroup)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_tiles = n / tile_n;
  const long long n_qtiles = (b + kQTile - 1) / kQTile;
  const long long blocks = n_tiles * n_qtiles;
  if (blocks > 0x7fffffffLL || n_tiles * (tile_n / kGroup) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const uint16_t*>(q);
  const auto* sp = static_cast<const uint16_t*>(slab);
  const auto* mp = static_cast<const float*>(mask);
  auto* vp = static_cast<float*>(out_v);
  auto* gp = static_cast<int32_t*>(out_g);
  const int g_tile = tile_n / kGroup;
  if (is_bf16)
    group_candidates_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        qp, sp, mp, vp, gp, b, d, g_tile, t, static_cast<int>(n_qtiles));
  else
    group_candidates_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        qp, sp, mp, vp, gp, b, d, g_tile, t, static_cast<int>(n_qtiles));
  return static_cast<int>(cudaGetLastError());
}

// K6: per-tile group candidates of the slab scan scores, for sm_90a.
//
// Replaces the TPU kernel frankensearch_tpu/ops/ab_primitives.py
// `_group_candidates_kernel` (the pallas_call of
// `scan_topk_hierarchical_ab(emit="tile_topk")`). For each tile of tile_n
// slab rows and each query b it takes the tile's g = tile_n / 128 group
// maxima of bf16(q[b]) . slab[r] + mask[r] and runs t argmax passes over
// them: pass j takes the largest maximum m (+0.0 above -0.0, as
// `jnp.max`), the FIRST group whose maximum == m (so -0.0 ties +0.0),
// writes m to out_v[tile, j, b] and the global group id tile * g + local to
// out_g[tile, j, b], and knocks the group out with -inf. Once every group is
// -inf the pass takes group 0 of the tile again, as the TPU kernel does.
//
// The wrapper (topk_scan.group_candidates) makes two launches: K1
// (group_max.cu, fs_group_max) writes the (B, n_groups) maxima, so they are
// K1's bits by construction, and fs_tile_select below does the passes' work
// in one ranking step.
//
// The passes as a ranking. Of a row's g maxima x_0 .. x_{g-1}, let f be the
// number that are not -inf (maxima are never NaN). Then, for j < t:
//   * group i (x_i not -inf) is emitted by pass
//       rank(i) = #{k : x_k > x_i} + #{k < i : x_k == x_i}
//     (IEEE compares: by value, equal maxima in ascending group order, and
//     +0.0 and -0.0 equal);
//   * pass j < f emits as its value x_i of the group i it emits, except in
//     the class of zeros: there the passes take the groups in group order
//     while the pass's maximum stays +0.0 until the last +0.0 group is out,
//     so every pass up to the one that emits the last +0.0 group emits
//     +0.0, and the later ones -0.0, whichever group each names;
//   * pass j >= f emits (-inf, group 0 of the tile): every group is -inf.
//
// What bounds it on the H100: K1's scan (0.158 ms at 1M x 256 bf16, B =
// 256). The selection reads the maxima once (4 B n_groups bytes: 8 MB at
// B = 256) and writes 8 t B bytes a tile (15 MB at t = 60): 7 us at 3.35
// TB/s. The passes of the first port (t rounds of two 5-step shuffle
// reductions per query and tile, about 0.7 ms at B = 256, t = 60) become
// g compare steps per group.
//
// Design: one block = one tile x 32 queries, 8 warps. The block stages its
// 32 rows of maxima in shared memory; a warp ranks one row at a time (two
// maxima a lane, g steps against the row broadcast from shared memory) and
// puts each emitted (value, id) at its pass in a staging buffer; then the
// block writes out[tile, j, b0 .. b0+31] as one 128-byte span per pass j.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxG = 64;             // groups a tile (tile_n <= 8192)
constexpr int kQ = 32;                // queries a block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kLdOut = kQ + 1;        // staging row stride: a warp's 32 ranks hit distinct banks

__global__ void __launch_bounds__(kThreads)
tile_select_kernel(const float* __restrict__ gm,  // (b, n_groups) group maxima
                   float* __restrict__ out_v,     // (n_tiles, t, b)
                   int32_t* __restrict__ out_g,   // (n_tiles, t, b)
                   int b, int n_groups, int g, int t, int n_qblocks) {
  __shared__ float s_row[kQ * kMaxG];
  __shared__ float s_v[kMaxG * kLdOut];
  __shared__ int32_t s_g[kMaxG * kLdOut];

  const int tile = blockIdx.x / n_qblocks;
  const int b0 = (blockIdx.x % n_qblocks) * kQ;
  const int nq = min(kQ, b - b0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid0 = tile * g;

  for (int i = threadIdx.x; i < nq * g; i += kThreads) {
    const int ql = i / g, k = i - ql * g;
    s_row[ql * kMaxG + k] = gm[static_cast<int64_t>(b0 + ql) * n_groups + gid0 + k];
  }
  __syncthreads();

  for (int ql = warp; ql < nq; ql += kWarps) {
    const float* row = s_row + ql * kMaxG;
    const int i0 = lane, i1 = lane + 32;
    const float v0 = i0 < g ? row[i0] : -INFINITY;
    const float v1 = i1 < g ? row[i1] : -INFINITY;
    int r0 = 0, r1 = 0;
#pragma unroll 4
    for (int k = 0; k < g; ++k) {
      const float x = row[k];
      r0 += (x > v0) | ((x == v0) & (k < i0));
      r1 += (x > v1) | ((x == v1) & (k < i1));
    }
    const unsigned all = 0xffffffffu;
    const int f = __popc(__ballot_sync(all, v0 != -INFINITY)) + __popc(__ballot_sync(all, v1 != -INFINITY));
    // the pass that emits the last +0.0 group (in group order), or -1
    const int plus_last = __reduce_max_sync(
        all, max(__float_as_int(v0) == 0 ? r0 : -1, __float_as_int(v1) == 0 ? r1 : -1));
    auto emit = [&](float v, int r, int i) {
      if (v == -INFINITY || r >= t) return;
      s_v[r * kLdOut + ql] = v == 0.0f ? (r <= plus_last ? 0.0f : -0.0f) : v;
      s_g[r * kLdOut + ql] = gid0 + i;
    };
    emit(v0, r0, i0);
    emit(v1, r1, i1);
    for (int r = f + lane; r < t; r += 32) {
      s_v[r * kLdOut + ql] = -INFINITY;
      s_g[r * kLdOut + ql] = gid0;
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < t * kQ; i += kThreads) {
    const int j = i / kQ, c = i % kQ;
    if (c < nq) {
      const int64_t o = (static_cast<int64_t>(tile) * t + j) * b + b0 + c;
      out_v[o] = s_v[j * kLdOut + c];
      out_g[o] = s_g[j * kLdOut + c];
    }
  }
}

}  // namespace

// gm: (b, n_groups) f32 group maxima (K1's output), out_v / out_g:
// (n_groups / g, t, b) f32 / int32, g = tile_n / 128 groups a tile. Needs
// 1 <= g <= 64, n_groups % g == 0, 1 <= t <= g, b >= 1 (the Python wrapper
// checks all of these). Returns cudaGetLastError() after the launch.
extern "C" int fs_tile_select(const void* gm, void* out_v, void* out_g, int b, long long n_groups, int g, int t,
                              void* stream) {
  if (b < 1 || g < 1 || g > kMaxG || n_groups < g || n_groups % g != 0 || n_groups > 0x7fffffffLL || t < 1 ||
      t > g)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_qblocks = (b + kQ - 1) / kQ;
  const long long blocks = n_groups / g * n_qblocks;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  tile_select_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gm), static_cast<float*>(out_v), static_cast<int32_t*>(out_g), b,
      static_cast<int>(n_groups), g, t, static_cast<int>(n_qblocks));
  return static_cast<int>(cudaGetLastError());
}

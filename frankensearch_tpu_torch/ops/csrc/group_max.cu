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
//   * the scoring body (staging, mma.sync fragments, mask add, max over the
//     128 rows) is score_group() of group_scan.cuh, which K6
//     (group_candidates.cu) shares, so the two kernels' maxima are the same
//     bits;
//   * the result is written straight as (B, n_groups): no tile-major layout
//     and no transpose afterwards.

#include "group_scan.cuh"

using namespace fs_scan;

namespace {

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
group_max_kernel(const uint16_t* __restrict__ q,     // (b, d) slab dtype
                 const uint16_t* __restrict__ slab,  // (n, d)
                 const float* __restrict__ mask,     // (n,) additive
                 float* __restrict__ out,            // (b, n_groups)
                 int b, int d, int n_groups, int n_qtiles) {
  __shared__ GroupSmem sm;
  const int qtile = blockIdx.x % n_qtiles;
  const int group = blockIdx.x / n_qtiles;
  const int q0 = qtile * kQTile;
  score_group<kBf16>(q, slab, mask, static_cast<int64_t>(group) * kGroup, q0, b, d, sm);
  for (int c = threadIdx.x; c < kQTile; c += kThreads) {
    const int qi = q0 + c;
    if (qi < b) out[static_cast<int64_t>(qi) * n_groups + group] = group_max_of(sm, c);
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

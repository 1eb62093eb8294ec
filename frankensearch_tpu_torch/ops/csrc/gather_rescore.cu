// K2: gather each query's selected 128-row groups and score them exactly,
// for sm_90a.
//
// Replaces the TPU kernel frankensearch_tpu/ops/topk_scan.py
// `_gather_rescore_kernel` (the pallas_call in `_gather_rescore_pallas`,
// reached from `_rescore_groups`). For query b and its j-th selected group
//
//     out[b, j*128 + r] = dot(bf16(q[b]), slab[groups[b, j]*128 + r])
//
// with the query rounded to the slab dtype (as the TPU kernel does on the
// main path) and products accumulated in f32.
//
// What bounds it on the H100: it is a gather-bound GEMV, 2 FLOP per element
// read, so only bytes matter, and the bytes it must move are the DISTINCT
// groups the batch selected. At B = 256, kk = 60 on the 1M x 256 slab the
// queries pick about 6,900 distinct groups (451 MB, 0.135 ms at 3.35 TB/s)
// in 15,360 (query, group) pairs. The first port (one block per pair, in
// query order) read a group again for every query that chose it, far apart
// in time, so L2 rarely served it: 1.0 GB a call, above half the bound even
// at full HBM speed.
//
// Design: group-major. A counting sort on the card (`fs_gather_plan`: a
// count per group, a scan, a scatter; no host sync and no library sort,
// whose host cost alone was twice the kernel's at B = 8) puts the B*kk
// pairs in group order: the ids with equal ids adjacent and the pair each
// came from. Batches too small to share
// groups (the wrapper's GATHER_GROUP_MIN_B; a singleton's groups are
// distinct) skip it and pass their pairs in pair order. One block of 4
// warps (32 rows each) per
// sorted position; a block scores the run of equal ids that starts at its
// position (at most kRunPairs of them: a group every query chose still
// spreads over many blocks) and every other block exits at once. A block
// reads its group's 128 rows from HBM once into registers (each lane holds
// 16-byte chunks c = lane, lane + 32, ... of its warp's rows, 64 registers
// of them at a time: 16 rows at d <= 256), then loops over the run's
// queries. The dot order is the first port's, so the output bits are too:
// lane c sums 8 fmaf over chunk c, then c + 32, ...; the 32 lane sums meet
// in the butterfly xor 16, 8, 4, 2, 1, done here as a reduce-scatter (each
// round halves the rows a lane holds, computing the same sums), after
// which each lane holds whole rows and the warp writes 128 contiguous
// bytes. Ids outside [0, n/128) poison their 128 outputs with NaN. Any
// b >= 1 and kk >= 1 launch.
//
// K2's f32 form (kind 2: an f32 slab and query, f32 products and sums, the
// TPU kernel on an f32 slab) is the same kernel, plan and pair order with
// 16-byte chunks of 4 floats in place of 8 bf16/f16: lane c sums 4 fmaf
// over chunk c, then c + 32, ..., and the same reduce-scatter. A lane holds
// at most 32 chunks of a row, so d <= 4096. Its bound is bytes as K2's,
// twice the bf16 form's: the distinct groups at 4 bytes a dim. The IVF
// probe (index/ivf.py) calls this f32 form on an f32 arm, with kk = nprobe
// x groups per cluster sorted per query; a bf16 or f16 arm probes with
// K2-ivf (ivf_probe.cu), which streams each probed cluster once and keeps
// the top-k on the card. The plan's counting sort (fs_gather_plan) serves
// K2-ivf too, over clusters in place of groups.
//
// K2-i8, `fs_gather_rescore_i8` and `fs_gather_rescore_i8_sorted` below,
// replaces the same TPU kernel in its `compute_f32` form, which the
// reference's int8 lane (`scan_topk_hierarchical_int8`) reaches through
// `_gather_rescore_pallas`: int8 rows cast up to f32 and dotted with an f32
// query that carries the per-dim dequant scale,
//
//     out[b, j*128 + r] = dot(q_scaled[b], float(slab_i8[groups[b, j]*128 + r]))
//
// with f32 products and sums. Its bound is bytes: the distinct groups the
// batch chose (about 6,750 at B = 256, kk = 60 on the 1M x 256 slab, 221 MB,
// plus the 7.9 MB output: 0.068 ms at 3.35 TB/s; 2 FLOP a byte read is far
// below the f32 rate). What held the first port (one block per pair, one
// row per warp) back, and what this design does about each:
//  1. Pair order read a group again for every query that chose it (503 MB).
//     From GATHER_I8_GROUP_MIN_B queries up it runs on K2's plan as K2 does:
//     one block per run of equal ids reads the group's 128 rows once into
//     registers and loops over the run's queries; below, pair order.
//  2. A row's d/16 chunks took one lane each, so at d = 256 lanes 16-31
//     idled. Now at d <= 256 a row takes p lanes (the power of two >=
//     d/16) and a lane holds its chunk of up to 8 rows (at d = 256 a warp
//     takes its 32 rows in two steps of 16); the reduction leaves each row
//     on one lane (two at d = 256), so a step's stores are contiguous.
//     Wider rows keep a row per warp step (K2's layout: 16 chunks a lane
//     across rows).
//  3. `static_cast<float>` of a byte is an I2F, which runs at 16 results per
//     clock per SM against 128 for FFMA: 503 M of them in half-empty warps
//     were about the first port's whole 0.28 ms of device time. Now the
//     byte x ^ 0x80 (= x + 128) goes into the low mantissa byte of 2^23 by
//     one PRMT and one FADD takes 2^23 + 128 off: float(x) exactly.
// The output bits are the first port's: each lane's chain is unchanged
// (fmaf over a 16-byte chunk in dim order, then the chunk 32 further on,
// from +0.0), and where that port's butterfly rounds xor 16 ... p met only
// empty lanes (each adding +0.0), this one adds +0.0f once and runs the
// rounds xor p/2 ... 1 inside the p-lane group
// (tests/test_torch_gather_i8_order.py models both; K2I8_DIGESTS in
// tests/test_torch_kernels_cuda.py pins them on the card). The query is
// read from global memory (L1/L2) in 16-byte loads. Any d % 16 == 0 with
// 16 <= d <= 12288.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 128;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kGroup / kWarps;
constexpr int kRunPairs = 16;  // most (query, group) pairs one block scores

// The operands' element type: the entry points' `kind` argument.
enum Kind : int { kF16 = 0, kBf16 = 1, kF32 = 2 };

// Elements in a 16-byte chunk.
__host__ __device__ constexpr int chunk_elems(int kind) { return kind == kF32 ? 4 : 8; }

template <int kKind>
__device__ __forceinline__ float to_f32(uint16_t x) {
  if constexpr (kKind == kBf16) {
    return __uint_as_float(static_cast<uint32_t>(x) << 16);
  } else {
    return __half2float(__ushort_as_half(x));
  }
}

// One 16-byte chunk of a row dotted with the query's chunk qv, in dim
// order, onto acc.
template <int kKind>
__device__ __forceinline__ float dot_chunk(const uint4& v, const float* qv, float acc) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  if constexpr (kKind == kF32) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc = fmaf(__uint_as_float(w[i]), qv[i], acc);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc = fmaf(to_f32<kKind>(static_cast<uint16_t>(w[i] & 0xffffu)), qv[2 * i], acc);
      acc = fmaf(to_f32<kKind>(static_cast<uint16_t>(w[i] >> 16)), qv[2 * i + 1], acc);
    }
  }
  return acc;
}

// One round of the butterfly over lanes `m` apart, as a reduce-scatter: a
// list of kW >= 2 row sums keeps half (the upper half on the lane whose bit
// m is set) and adds the partner's sums for it; a single sum adds the
// partner's. Either way each kept sum is own + partner, the butterfly's.
template <int kW, int kRows>
__device__ __forceinline__ void sum_round(float (&s)[kRows], int lane, int m) {
  if constexpr (kW >= 2) {
    const bool up = (lane & m) != 0;
#pragma unroll
    for (int i = 0; i < kW / 2; ++i) {
      const float lo = s[i], hi = s[kW / 2 + i];
      s[i] = (up ? hi : lo) + __shfl_xor_sync(0xffffffffu, up ? lo : hi, m);
    }
  } else {
    s[0] = s[0] + __shfl_xor_sync(0xffffffffu, s[0], m);
  }
}

// Rounds xor kM, kM/2, ..., 1 of the butterfly as a reduce-scatter: kW
// sums a lane holds going in, halved each round down to one.
template <int kW, int kM, int kRows>
__device__ __forceinline__ void reduce_rows(float (&s)[kRows], int lane) {
  if constexpr (kM >= 1) {
    sum_round<kW>(s, lane, kM);
    reduce_rows<(kW >= 2 ? kW / 2 : 1), kM / 2>(s, lane);
  }
}

// kCpl: 16-byte chunks of a row a lane holds (a power of two), so a warp
// holds kRows = 16 / kCpl rows at once in 64 registers (one row in 128 at
// kCpl = 32). Holding 32 rows at kCpl = 1 spills.
template <int kKind, int kCpl>
__global__ void __launch_bounds__(kThreads)
gather_rescore_kernel(const uint16_t* __restrict__ q,      // (b, d) slab dtype (f32: 2 halves an element)
                      const uint16_t* __restrict__ slab,   // (n, d)
                      const int32_t* __restrict__ gids,    // (b*kk,) group ids, equal ids adjacent
                      const int32_t* __restrict__ order,   // (b*kk,) pair of each position; null: itself
                      float* __restrict__ out,             // (b, kk*128)
                      int total, int kk, int d, int n_groups) {
  constexpr int kRows = kCpl <= 16 ? 16 / kCpl : 1;
  const int p0 = blockIdx.x;
  const int gid = gids[p0];
  if (p0 % kRunPairs != 0 && gids[p0 - 1] == gid) return;  // inside another block's run
  int p1 = p0 + 1;
  while (p1 < total && p1 % kRunPairs != 0 && gids[p1] == gid) ++p1;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (gid < 0 || gid >= n_groups) {  // never produced by the scan; poison
    for (int p = p0; p < p1; ++p) {
      const int64_t pair = order ? order[p] : p;
      out[pair * kGroup + threadIdx.x] = NAN;
    }
    return;
  }

  constexpr int kE = chunk_elems(kKind);
  constexpr int kHalves = kKind == kF32 ? 2 : 1;  // 16-bit words an element
  const int n_vec = d / kE;  // 16-byte chunks per row
  const int ld = d * kHalves;  // a row's 16-bit words
  const uint16_t* rows = slab + (static_cast<int64_t>(gid) * kGroup + warp * kRowsPerWarp) * ld;
  for (int r0 = 0; r0 < kRowsPerWarp; r0 += kRows) {
    uint4 v[kRows][kCpl];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int ci = 0; ci < kCpl; ++ci) {
        const int c = lane + 32 * ci;
        v[r][ci] = c < n_vec ? __ldg(reinterpret_cast<const uint4*>(rows + static_cast<int64_t>(r0 + r) * ld + c * 8))
                             : make_uint4(0u, 0u, 0u, 0u);
      }
    for (int p = p0; p < p1; ++p) {
      const int64_t pair = order ? order[p] : p;
      const uint16_t* qrow = q + (pair / kk) * ld;
      float s[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r] = 0.0f;
#pragma unroll
      for (int ci = 0; ci < kCpl; ++ci) {
        const int c = lane + 32 * ci;
        if (c < n_vec) {
          const uint4 qw = __ldg(reinterpret_cast<const uint4*>(qrow + c * 8));
          const uint32_t w[4] = {qw.x, qw.y, qw.z, qw.w};
          float qv[8];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if constexpr (kKind == kF32) {
              qv[i] = __uint_as_float(w[i]);
            } else {
              qv[2 * i] = to_f32<kKind>(static_cast<uint16_t>(w[i] & 0xffffu));
              qv[2 * i + 1] = to_f32<kKind>(static_cast<uint16_t>(w[i] >> 16));
            }
          }
#pragma unroll
          for (int r = 0; r < kRows; ++r) s[r] = dot_chunk<kKind>(v[r][ci], qv, s[r]);
        }
      }
      reduce_rows<kRows, 16>(s, lane);
      // lane l now holds row l / (32 / kRows) of the batch; its neighbours
      // below the next multiple of 32 / kRows hold the same bits
      if (lane % (32 / kRows) == 0)
        out[pair * kGroup + warp * kRowsPerWarp + r0 + lane / (32 / kRows)] = s[0];
    }
  }
}

template <int kKind>
int launch_rescore(int cpl, const uint16_t* q, const uint16_t* slab, const int32_t* gids, const int32_t* order,
                   float* out, int total, int kk, int d, int n_groups, cudaStream_t s) {
  const unsigned grid = static_cast<unsigned>(total);
  switch (cpl) {
    case 1: gather_rescore_kernel<kKind, 1><<<grid, kThreads, 0, s>>>(q, slab, gids, order, out, total, kk, d, n_groups); break;
    case 2: gather_rescore_kernel<kKind, 2><<<grid, kThreads, 0, s>>>(q, slab, gids, order, out, total, kk, d, n_groups); break;
    case 4: gather_rescore_kernel<kKind, 4><<<grid, kThreads, 0, s>>>(q, slab, gids, order, out, total, kk, d, n_groups); break;
    case 8: gather_rescore_kernel<kKind, 8><<<grid, kThreads, 0, s>>>(q, slab, gids, order, out, total, kk, d, n_groups); break;
    case 16: gather_rescore_kernel<kKind, 16><<<grid, kThreads, 0, s>>>(q, slab, gids, order, out, total, kk, d, n_groups); break;
    default: gather_rescore_kernel<kKind, 32><<<grid, kThreads, 0, s>>>(q, slab, gids, order, out, total, kk, d, n_groups); break;
  }
  return static_cast<int>(cudaGetLastError());
}

int gather_rescore(const void* q, const void* slab, const void* gids, const void* order, void* out, int b, int kk,
                   int d, long long n, int kind, void* stream) {
  const int elems = chunk_elems(kind);
  if (b < 1 || kk < 1 || kind < kF16 || kind > kF32 || d < 8 || d % 8 != 0 || d > 32 * 32 * elems || n < kGroup ||
      n % kGroup != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(b) * kk;
  if (total > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  int cpl = 1;  // chunks a lane holds per row: ceil(d / elems / 32), rounded up to a power of two
  while (cpl * 32 * elems < d) cpl *= 2;
  const auto* qp = static_cast<const uint16_t*>(q);
  const auto* sp = static_cast<const uint16_t*>(slab);
  const auto* gp = static_cast<const int32_t*>(gids);
  const auto* op = static_cast<const int32_t*>(order);
  auto* outp = static_cast<float*>(out);
  const int n_groups = static_cast<int>(n / kGroup);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int t = static_cast<int>(total);
  if (kind == kF32) return launch_rescore<kF32>(cpl, qp, sp, gp, op, outp, t, kk, d, n_groups, s);
  if (kind == kBf16) return launch_rescore<kBf16>(cpl, qp, sp, gp, op, outp, t, kk, d, n_groups, s);
  return launch_rescore<kF16>(cpl, qp, sp, gp, op, outp, t, kk, d, n_groups, s);
}

constexpr int kPlanThreads = 256;  // count and scatter: one thread a pair
constexpr int kScanThreads = 1024;

// Bin of group id g: g itself, or n_groups for an id outside the slab.
__device__ __forceinline__ int plan_bin(int g, int n_groups) {
  return static_cast<unsigned>(g) < static_cast<unsigned>(n_groups) ? g : n_groups;
}

__global__ void __launch_bounds__(kPlanThreads)
gather_plan_count(const int32_t* __restrict__ groups, int32_t* __restrict__ cnt, int total, int n_groups) {
  const int p = blockIdx.x * kPlanThreads + threadIdx.x;
  if (p < total) atomicAdd(&cnt[plan_bin(groups[p], n_groups)], 1);
}

// One block: the exclusive scan of the bins' counts into start, the sorted
// ids written bin by bin (ids outside the slab as -1), and the counts
// zeroed for the scatter's cursors. The counts pass through shared memory
// a tile of bins at a time (one coalesced load each); thread t scans
// kScanPer consecutive bins of the tile.
constexpr int kScanPer = 8;
constexpr int kScanTile = kScanThreads * kScanPer;

__global__ void __launch_bounds__(kScanThreads)
gather_plan_scan(int32_t* __restrict__ cnt, int32_t* __restrict__ start, int32_t* __restrict__ gids, int n_bins,
                 int n_groups) {
  __shared__ int32_t tile[kScanTile];
  __shared__ int32_t warp_sum[kScanThreads / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int carry = 0;  // pairs in the tiles before this one
  for (int t0 = 0; t0 < n_bins; t0 += kScanTile) {
    const int nb = min(kScanTile, n_bins - t0);
    for (int i = tid; i < nb; i += kScanThreads) {
      tile[i] = cnt[t0 + i];
      cnt[t0 + i] = 0;
    }
    __syncthreads();
    const int lo = tid * kScanPer;
    int own = 0;
#pragma unroll
    for (int i = 0; i < kScanPer; ++i) own += lo + i < nb ? tile[lo + i] : 0;
    int incl = own;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int w = warp_sum[lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, w, off);
        if (lane >= off) w += v;
      }
      warp_sum[lane] = w;  // inclusive over warps
    }
    __syncthreads();
    int next = carry + incl - own + (warp > 0 ? warp_sum[warp - 1] : 0);
    for (int i = 0; i < kScanPer && lo + i < nb; ++i) {
      const int bin = t0 + lo + i;
      const int c = tile[lo + i];
      const int id = bin < n_groups ? bin : -1;
      start[bin] = next;
      for (int j = 0; j < c; ++j) gids[next + j] = id;
      next += c;
    }
    carry += warp_sum[kScanThreads / 32 - 1];
    __syncthreads();  // the next tile reuses tile and warp_sum
  }
  if (tid == 0) start[n_bins] = carry;
}

// Each pair to its bin's next slot. The order within a bin follows the
// atomics and varies from call to call; the scores do not depend on it.
__global__ void __launch_bounds__(kPlanThreads)
gather_plan_scatter(const int32_t* __restrict__ groups, const int32_t* __restrict__ start, int32_t* __restrict__ cursor,
                    int32_t* __restrict__ order, int total, int n_groups) {
  const int p = blockIdx.x * kPlanThreads + threadIdx.x;
  if (p >= total) return;
  const int bin = plan_bin(groups[p], n_groups);
  order[start[bin] + atomicAdd(&cursor[bin], 1)] = p;
}

}  // namespace

// q: (b, d) of the slab's dtype, slab: (n, d) f16 (kind 0), bf16 (kind 1)
// or f32 (kind 2), groups: (b, kk) int32 group ids in pair order, out: (b,
// kk * 128) f32. Equal ids that sit side by side share one read of their
// group. Needs n % 128 == 0, d % 8 == 0, d <= 8192 (f32: 4096) and 16-byte
// aligned pointers (the Python wrapper checks all of these). Returns
// cudaGetLastError() after the launch.
extern "C" int fs_gather_rescore(const void* q, const void* slab, const void* groups, void* out, int b, int kk,
                                 int d, long long n, int kind, void* stream) {
  return gather_rescore(q, slab, groups, nullptr, out, b, kk, d, n, kind, stream);
}

// K2's group order, a counting sort: groups (total,) int32 ids -> in
// scratch (int32 words), with n_bins = n_groups + 1 (the last bin takes the
// ids outside the slab): counts [n_bins], starts [n_bins + 1], then gids
// [total], the ids in bin order (equal ids adjacent, outside ids as -1),
// then order [total], the index in groups of each. Four launches (a
// memset, a count, a one-block scan, a scatter), no host sync. Returns
// cudaGetLastError() after the last.
extern "C" int fs_gather_plan(const void* groups, void* scratch, int total, int n_groups, void* stream) {
  if (total < 1 || n_groups < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_bins = n_groups + 1;
  auto* cnt = static_cast<int32_t*>(scratch);
  int32_t* start = cnt + n_bins;
  int32_t* gids = start + n_bins + 1;
  int32_t* order = gids + total;
  const auto* gp = static_cast<const int32_t*>(groups);
  const unsigned blocks = static_cast<unsigned>((total + kPlanThreads - 1) / kPlanThreads);
  cudaError_t err = cudaMemsetAsync(cnt, 0, static_cast<size_t>(n_bins) * sizeof(int32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_plan_count<<<blocks, kPlanThreads, 0, s>>>(gp, cnt, total, n_groups);
  gather_plan_scan<<<1, kScanThreads, 0, s>>>(cnt, start, gids, n_bins, n_groups);
  gather_plan_scatter<<<blocks, kPlanThreads, 0, s>>>(gp, start, cnt, order, total, n_groups);
  return static_cast<int>(cudaGetLastError());
}

// The group-major entry: gids (b*kk,) int32 with equal ids adjacent and
// order (b*kk,) int32 the pair b_i * kk + j of each (fs_gather_plan's
// gids and order). Otherwise as fs_gather_rescore.
extern "C" int fs_gather_rescore_sorted(const void* q, const void* slab, const void* gids, const void* order,
                                        void* out, int b, int kk, int d, long long n, int kind, void* stream) {
  return gather_rescore(q, slab, gids, order, out, b, kk, d, n, kind, stream);
}

namespace {

constexpr int kMaxDimI8 = 12288;  // the first port's widest row (its query took 48 KB of shared memory)
// Rows a lane holds where a row takes fewer than 32 lanes, and the blocks
// an SM must hold at 128 < d <= 256 (kP = 16; it caps the registers at 80).
// Left to itself ptxas gives that form 189 registers (255 and spills at 16
// rows a lane): two blocks an SM, whose loads then hardly overlap the
// other's arithmetic. Of the settings tried on the H100 (4 to 16 rows, 1
// to 6 blocks, and a persistent grid), 8 rows and 6 blocks ran fastest.
constexpr int kMaxRowsI8 = 8;
constexpr int kMinBlocks16 = 6;

// Byte k of w (already xor 0x80808080) as an exact f32: the byte x ^ 0x80
// = x + 128 (0..255) becomes the low mantissa byte of 2^23, and 2^23 + 128
// comes off exactly. One PRMT and one FADD, in place of an I2F.
template <int k>
__device__ __forceinline__ float i8_to_f32(uint32_t wx) {
  return __int_as_float(static_cast<int>(__byte_perm(wx, 0x4B000000u, 0x7540u | k))) - 8388736.0f;
}

// The first port's lane chain over one 16-byte chunk (its bytes xor 0x80):
// 16 fmaf in dim order.
__device__ __forceinline__ float dot16_i8(const uint4& v, const float (&qv)[16], float acc) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc = fmaf(i8_to_f32<0>(w[i]), qv[4 * i], acc);
    acc = fmaf(i8_to_f32<1>(w[i]), qv[4 * i + 1], acc);
    acc = fmaf(i8_to_f32<2>(w[i]), qv[4 * i + 2], acc);
    acc = fmaf(i8_to_f32<3>(w[i]), qv[4 * i + 3], acc);
  }
  return acc;
}

// kP: lanes a row takes (a power of two); kC: 16-byte chunks of a row a
// lane holds (more than one only at kP = 32). Lane l takes chunks c = l %
// kP + kP * i of kH rows at a time: rows r0 + (l / kP) * kH + h, h < kH,
// where kH is kP up to kMaxRowsI8 at kP < 32 and 16 / kC (1 at kC = 32)
// at kP = 32, as K2 holds them. The reduction leaves the row r0 + (l /
// kP) * kH + (l % kP) / (kP / kH) on lane l (row l where kH = kP); the
// lanes kP / kH apart below it hold the same bits.
template <int kP, int kC>
__global__ void __launch_bounds__(kThreads, kP == 16 ? kMinBlocks16 : 1)
gather_rescore_i8_kernel(const float* __restrict__ q,         // (b, d) f32, scale folded in
                         const int8_t* __restrict__ slab,     // (n, d) int8
                         const int32_t* __restrict__ gids,    // (b*kk,) group ids, equal ids adjacent
                         const int32_t* __restrict__ order,   // (b*kk,) pair of each position; null: itself
                         float* __restrict__ out,             // (b, kk*128)
                         int total, int kk, uint64_t kk_magic, int d, int n_groups) {
  constexpr int kH = kP < 32 ? (kP < kMaxRowsI8 ? kP : kMaxRowsI8) : (kC <= 16 ? 16 / kC : 1);
  constexpr int kSpan = kH * (32 / kP);  // rows a warp holds at a time
  constexpr int kShare = kP / kH;        // lanes that end with the same row
  const int p0 = blockIdx.x;
  const int gid = gids[p0];
  if (p0 % kRunPairs != 0 && gids[p0 - 1] == gid) return;  // inside another block's run
  int p1 = p0 + 1;
  while (p1 < total && p1 % kRunPairs != 0 && gids[p1] == gid) ++p1;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (gid < 0 || gid >= n_groups) {  // never produced by the scan; poison
    for (int p = p0; p < p1; ++p) {
      const int64_t pair = order ? order[p] : p;
      out[pair * kGroup + threadIdx.x] = NAN;
    }
    return;
  }

  const int n_vec = d / 16;  // 16-byte chunks per row
  const int sub = lane % kP;
  const int row0 = (lane / kP) * kH;
  const int8_t* rows = slab + (static_cast<int64_t>(gid) * kGroup + warp * kRowsPerWarp + row0) * d;
  for (int r0 = 0; r0 < kRowsPerWarp; r0 += kSpan) {
    uint4 v[kH][kC];
#pragma unroll
    for (int h = 0; h < kH; ++h)
#pragma unroll
      for (int ci = 0; ci < kC; ++ci) {
        const int c = sub + kP * ci;
        v[h][ci] = make_uint4(0u, 0u, 0u, 0u);
        if (c < n_vec) {
          const uint4 w = __ldg(reinterpret_cast<const uint4*>(rows + static_cast<int64_t>(r0 + h) * d + c * 16));
          v[h][ci] = make_uint4(w.x ^ 0x80808080u, w.y ^ 0x80808080u, w.z ^ 0x80808080u, w.w ^ 0x80808080u);
        }
      }
    for (int p = p0; p < p1; ++p) {
      const int64_t pair = order ? order[p] : p;
      const int64_t bq = kk > 1 ? static_cast<int64_t>(__umul64hi(static_cast<uint64_t>(pair), kk_magic)) : pair;
      const float* qrow = q + bq * d;
      float s[kH];
#pragma unroll
      for (int h = 0; h < kH; ++h) s[h] = 0.0f;
#pragma unroll
      for (int ci = 0; ci < kC; ++ci) {
        const int c = sub + kP * ci;
        if (c < n_vec) {
          float qv[16];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 f = __ldg(reinterpret_cast<const float4*>(qrow + c * 16) + i);
            qv[4 * i] = f.x;
            qv[4 * i + 1] = f.y;
            qv[4 * i + 2] = f.z;
            qv[4 * i + 3] = f.w;
          }
#pragma unroll
          for (int h = 0; h < kH; ++h) s[h] = dot16_i8(v[h][ci], qv, s[h]);
        }
      }
      if constexpr (kP < 32) {
        // the first port's rounds xor 16 ... kP met only empty lanes (+0.0)
#pragma unroll
        for (int h = 0; h < kH; ++h) s[h] = s[h] + 0.0f;
      }
      reduce_rows<kH, kP / 2>(s, lane);
      if (sub % kShare == 0) out[pair * kGroup + warp * kRowsPerWarp + r0 + row0 + sub / kShare] = s[0];
    }
  }
}

template <int kP, int kC>
void launch_i8(const float* q, const int8_t* slab, const int32_t* gids, const int32_t* order, float* out, int total,
               int kk, int d, int n_groups, cudaStream_t s) {
  // pair / kk as a high product: with m = floor((2^64 - 1) / kk) + 1 and
  // pair < 2^31, floor(pair * m / 2^64) is exact (the error is below 2^-33,
  // the gap to the next integer at least 1 / kk); no integer divide, whose
  // reciprocal costs I2F and F2I
  const uint64_t magic = kk > 1 ? UINT64_MAX / static_cast<uint64_t>(kk) + 1 : 0;
  gather_rescore_i8_kernel<kP, kC><<<static_cast<unsigned>(total), kThreads, 0, s>>>(q, slab, gids, order, out,
                                                                                    total, kk, magic, d, n_groups);
}

int gather_rescore_i8(const void* q, const void* slab, const void* gids, const void* order, void* out, int b,
                      int kk, int d, long long n, void* stream) {
  if (b < 1 || kk < 1 || d < 16 || d % 16 != 0 || d > kMaxDimI8 || n < kGroup || n % kGroup != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(b) * kk;
  if (total > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto* qp = static_cast<const float*>(q);
  const auto* sp = static_cast<const int8_t*>(slab);
  const auto* gp = static_cast<const int32_t*>(gids);
  const auto* op = static_cast<const int32_t*>(order);
  auto* outp = static_cast<float*>(out);
  const int t = static_cast<int>(total);
  const int n_groups = static_cast<int>(n / kGroup);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_vec = d / 16;
  if (n_vec <= 1) launch_i8<1, 1>(qp, sp, gp, op, outp, t, kk, d, n_groups, s);
  else if (n_vec <= 2) launch_i8<2, 1>(qp, sp, gp, op, outp, t, kk, d, n_groups, s);
  else if (n_vec <= 4) launch_i8<4, 1>(qp, sp, gp, op, outp, t, kk, d, n_groups, s);
  else if (n_vec <= 8) launch_i8<8, 1>(qp, sp, gp, op, outp, t, kk, d, n_groups, s);
  else if (n_vec <= 16) launch_i8<16, 1>(qp, sp, gp, op, outp, t, kk, d, n_groups, s);
  else if (n_vec <= 32) launch_i8<32, 1>(qp, sp, gp, op, outp, t, kk, d, n_groups, s);
  else if (n_vec <= 64) launch_i8<32, 2>(qp, sp, gp, op, outp, t, kk, d, n_groups, s);
  else if (n_vec <= 128) launch_i8<32, 4>(qp, sp, gp, op, outp, t, kk, d, n_groups, s);
  else if (n_vec <= 256) launch_i8<32, 8>(qp, sp, gp, op, outp, t, kk, d, n_groups, s);
  else if (n_vec <= 512) launch_i8<32, 16>(qp, sp, gp, op, outp, t, kk, d, n_groups, s);
  else launch_i8<32, 32>(qp, sp, gp, op, outp, t, kk, d, n_groups, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (b, d) f32 (query x per-dim scale), slab: (n, d) int8, groups: (b, kk)
// int32 group ids in pair order, out: (b, kk * 128) f32. Equal ids that sit
// side by side share one read of their group. Needs n % 128 == 0, d % 16
// == 0, 16 <= d <= 12288 and 16-byte aligned pointers (the Python wrapper
// checks all of these). Returns cudaGetLastError() after the launch.
extern "C" int fs_gather_rescore_i8(const void* q, const void* slab, const void* groups, void* out, int b, int kk,
                                    int d, long long n, void* stream) {
  return gather_rescore_i8(q, slab, groups, nullptr, out, b, kk, d, n, stream);
}

// The group-major entry: gids and order as fs_gather_plan gives them (see
// fs_gather_rescore_sorted). Otherwise as fs_gather_rescore_i8.
extern "C" int fs_gather_rescore_i8_sorted(const void* q, const void* slab, const void* gids, const void* order,
                                           void* out, int b, int kk, int d, long long n, void* stream) {
  return gather_rescore_i8(q, slab, gids, order, out, b, kk, d, n, stream);
}

// K2-ivf: the IVF probe's exact scores and their top-k, for sm_90a.
//
// Replaces, at the IVF probe, the TPU kernel frankensearch_tpu/ops/
// topk_scan.py `_gather_rescore_kernel` (the pallas_call that the
// reference's `_ivf_probe_rescore`, frankensearch_tpu/index/ivf.py, reaches
// through `_gather_rescore_pallas`) and the XLA tail after it there: the
// mask add, the top-k and the position gather. The arm's slab is sorted by
// cluster (cluster c owns rows c*cap .. c*cap + cap - 1, cap a multiple of
// 128), and query b probes the clusters probe[b, 0 .. nprobe-1]. Each
// (query, probed cluster) pair is cut into `splits` runs of `gs` groups of
// 128 rows, and for each run it writes the top kp rows by
//
//     s[r] = dot(q[b], slab[r]) + mask[r]
//
// (the query rounded to the slab's bf16 or f16, f32 sums on wgmma in
// ascending k order: K1's products and bits) as kp (score, slab position)
// pairs, by score descending (+0.0 above -0.0), then position ascending;
// masked rows and empty slots come back as (-inf, -1). The wrapper
// (topk_scan.ivf_probe_topk) merges a query's nprobe x splits lists by
// (score, position): the reference's top-k over the probed rows, with its
// tiebreak. Above kp = 64 (the list's length) a run writes every row's
// score instead, in position order (kp = gs * 128). Probe ids outside [0,
// C) are not streamed: their lists come back as (NaN, -1).
//
// What bounds it on the H100: bytes. A probe must read each DISTINCT probed
// cluster's rows and mask once: at 1M docs (2,000 clusters of 768 rows x
// 256 bf16, 393 KB a cluster) the full probe reads all of them, 786 MB,
// 0.235 ms at 3.35 TB/s. Its products are few: B = 256 at nprobe 256 puts
// about 33 queries on a cluster, 26 GFLOP, under 0.03 ms on the tensor
// cores. K2, which the probe called before on bf16/f16 arms, took it as
// (query, group) pairs: below 64 queries in pair order, so the full probe
// at B = 8 read each group eight times; above, on a counting sort of
// 128-row groups, one block a run of at most 16 pairs, each group in
// registers with no load in flight behind it; and a (B, nprobe * cap) f32
// score matrix and an int64 key of every candidate went through device
// memory to the top-k.
//
// Design:
//   * cluster-major work: the (B, nprobe) probe table goes through K2's
//     counting sort (fs_gather_plan over C bins: each cluster's probing
//     pairs side by side), and one block (ivf_units) cuts each cluster's
//     pairs into units of up to q_tile (8 or 16) queries x one of `splits`
//     runs of its groups, in cluster order; no host sync. Small probes (up
//     to the wrapper's IVF_PAIR_ORDER_MAX pairs) skip the sort: a unit is
//     one pair. Where the units would not fill the card, a run is one group;
//   * persistent blocks (as many as fit on the SMs) take the units in a
//     stride. A producer warp streams each unit's groups through a ring of
//     128-row x 128-byte stages (2-D TMA, 128-byte swizzle, mbarriers: K1's
//     loads) while two consumer warpgroups score them with wgmma (m64nNk16,
//     N = q_tile) against the unit's queries, gathered into shared memory in
//     the same swizzle with 16-byte loads;
//   * the epilogue adds the mask and parks the group's 128 x N scores in
//     shared memory; a warp takes two queries at a time and keeps each
//     one's top kp of the run as a sorted list of unique keys (score's
//     total-order bits, then the inverted position): the run's first group
//     sorted (a warp's bitonic sort), each later one filtered by the list's
//     last key and its survivors merged by rank (topk_list.cuh, K5's
//     sort and merge). The lists go out at the run's end: kp values a pair
//     and run, no score matrix.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"
#include "topk_list.cuh"

using namespace fs_hopper;

// K2's counting sort (gather_rescore.cu), in the same library.
extern "C" int fs_gather_plan(const void* groups, void* scratch, int total, int n_groups, void* stream);

namespace {

enum Kind : int { kF16 = 0, kBf16 = 1 };  // the entry's `kind` argument (K2's numbering)

constexpr int kGroup = 128;                  // rows per group
constexpr int kRowBytes = 128;               // bytes of a row per stage: 64 bf16/f16 dims
constexpr int kChunkElems = kRowBytes / 2;
constexpr int kStageBytes = kGroup * kRowBytes;
constexpr int kConsumerWarps = 8;            // two warpgroups
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kThreads = kConsumers + 32;    // + the producer warp
constexpr int kMaxStages = 8;
constexpr int kSmemMax = 232448;             // 227 KB a block may use
constexpr int kSmemTwo = 115712;             // a block's share when two fit an SM (1 KB each reserved)
constexpr int kLdS = kGroup + 4;             // staged score row stride (floats): conflict-free stores
constexpr int kListK = fs_list::kListMax;    // the longest list: kp above it writes every row
constexpr int kMaxDim = 8192;
constexpr int kUnitThreads = 1024;

// One unit of work: `n_q` pairs probing `cluster` (clusters: the plan's
// sorted positions first ..; pair order: the pair `first` alone), scored
// over run `split` of its groups.
struct Unit {
  int cluster, first, n_q, split;
};

__device__ __forceinline__ Unit unit_at(int u, const int4* units, const int32_t* probe, int splits) {
  if (units != nullptr) {
    const int4 v = units[u];
    return {v.x, v.y, v.z, v.w};
  }
  const int p = u / splits;
  return {probe[p], p, 1, u - p * splits};
}

// The shared memory of a block, in this order: the unit's query tile
// (n_chunks x [kN rows][128 bytes], swizzled), the ring, the staged scores
// [kN][kLdS], the lists [kN][kListK] and the warps' survivor rows
// [8][2][128] (both only below kListK), the unit's pairs [kN], the
// barriers.
struct Layout {
  int n_chunks, kN, stages;
  bool wide;
  __host__ __device__ constexpr size_t ring() const { return static_cast<size_t>(n_chunks) * kN * kRowBytes; }
  __host__ __device__ constexpr size_t staged() const { return ring() + static_cast<size_t>(stages) * kStageBytes; }
  __host__ __device__ constexpr size_t lists() const { return staged() + sizeof(float) * kN * kLdS; }
  __host__ __device__ constexpr size_t slots() const { return lists() + (wide ? 0 : 8 * kN * kListK); }
  __host__ __device__ constexpr size_t pairs() const { return slots() + (wide ? 0 : 16 * kConsumerWarps * kGroup); }
  __host__ __device__ constexpr size_t bars() const { return (pairs() + 4 * kN + 7) & ~size_t(7); }
  // bytes from the 1,024-aligned base, and the slack to align it
  __host__ __device__ constexpr size_t bytes() const { return 1024 + bars() + 16 * stages; }
};

// Key of (score, slab position): larger ranks first. The high word is the
// score's total-order bits (+0.0 above -0.0), the low word the inverted
// position; never 0, the empty slot.
__device__ __forceinline__ unsigned long long probe_key(float s, int pos) {
  const unsigned bits = __float_as_uint(s);
  const unsigned u = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) | static_cast<unsigned>(~pos);
}

__device__ __forceinline__ float key_score(unsigned long long k) {
  const unsigned u = static_cast<unsigned>(k >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ int key_pos(unsigned long long k) { return static_cast<int>(~static_cast<unsigned>(k)); }

__device__ __forceinline__ void consumer_sync() { asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory"); }

// Makes the consumers' plain stores to shared memory (the query tile)
// visible to wgmma, which reads its operands through the async proxy.
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

constexpr int kMergeQ = 2;  // queries a warp selects for at once, their steps interleaved

// The step of a warp's kMergeQ queries (those `live`) over one group's
// staged scores (srow[q], 128 rows from slab position pos0). The run's
// first group fills each list: a bitonic sort of the group's keys (finite
// scores only), the top kp kept. A later group's keys above the list's
// last key survive, are packed into the query's slot row and merged into
// its list, 32 at a time, the queries' merges interleaved.
__device__ __forceinline__ void select_group(const float* const (&srow)[kMergeQ],
                                             unsigned long long* const (&list)[kMergeQ],
                                             const bool (&live)[kMergeQ], int pos0, int kp, bool first,
                                             unsigned long long (*slot)[kGroup], int lane) {
  if (first) {
#pragma unroll
    for (int q = 0; q < kMergeQ; ++q) {
      if (!live[q]) continue;
      unsigned long long v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = srow[q][e * 32 + lane];
        v[e] = x > -INFINITY ? probe_key(x, pos0 + e * 32 + lane) : 0ull;
      }
      fs_list::warp_sort128_desc(v, lane);
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (e * 32 + lane < kp) list[q][e * 32 + lane] = v[e];
    }
    __syncwarp();
    return;
  }
  const unsigned below = (1u << lane) - 1u;
  int n[kMergeQ];
#pragma unroll
  for (int q = 0; q < kMergeQ; ++q) {
    n[q] = 0;
    if (!live[q]) continue;
    const unsigned long long thr = list[q][kp - 1];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e * 32 + lane;
      const float x = srow[q][r];
      const bool keep = x > -INFINITY && probe_key(x, pos0 + r) > thr;
      const unsigned m = __ballot_sync(0xffffffffu, keep);
      if (keep) slot[q][n[q] + __popc(m & below)] = probe_key(x, pos0 + r);
      n[q] += __popc(m);
    }
  }
  __syncwarp();
  int n_max = 0;
#pragma unroll
  for (int q = 0; q < kMergeQ; ++q) n_max = max(n_max, n[q]);
  for (int r0 = 0; r0 < n_max; r0 += 32) {
    int nr[kMergeQ];
    unsigned long long key[kMergeQ];
#pragma unroll
    for (int q = 0; q < kMergeQ; ++q) {
      nr[q] = min(32, max(0, n[q] - r0));
      key[q] = lane < nr[q] ? slot[q][r0 + lane] : 0ull;
    }
    fs_list::merge_survivors<kMergeQ>(list, kp, key, nr, lane);
  }
}

template <int kKind, int kN, bool kWide>
__global__ void __launch_bounds__(kThreads, 2)
ivf_probe_kernel(const __grid_constant__ CUtensorMap slab_map,  // (C * cap, d), box 128 bytes x 128 rows
                 const uint16_t* __restrict__ q,                // (b, d) slab dtype
                 const float* __restrict__ mask,                // (C * cap,) additive
                 const int32_t* __restrict__ probe,             // (b * nprobe,) cluster ids
                 const int4* __restrict__ units,                // clusters: the units; pair order: null
                 const int32_t* __restrict__ n_units_dev,       // clusters: their count; pair order: null
                 const int32_t* __restrict__ order,             // clusters: the pair of each sorted position
                 float* __restrict__ out_s,                     // (b * nprobe * splits, kp)
                 int32_t* __restrict__ out_i,
                 int n_units_arg, int nprobe, int d, int n_chunks, int n_clusters, int gpc, int splits, int gs,
                 int kp, int stages) {
  constexpr int kR = kN / 2;  // accumulators a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const Layout lay{n_chunks, kN, stages, kWide};
  uint8_t* q_s = smem;
  uint8_t* ring = smem + lay.ring();
  auto* staged = reinterpret_cast<float(*)[kLdS]>(smem + lay.staged());
  auto* lists = reinterpret_cast<unsigned long long(*)[kListK]>(smem + lay.lists());
  auto* slots = reinterpret_cast<unsigned long long(*)[kMergeQ][kGroup]>(smem + lay.slots());
  auto* qpair = reinterpret_cast<int32_t*>(smem + lay.pairs());
  auto* full = reinterpret_cast<uint64_t*>(smem + lay.bars());
  uint64_t* empty = full + stages;

  const int n_units = n_units_dev != nullptr ? *n_units_dev : n_units_arg;
  const int cap = gpc * kGroup;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // the producer
    if (lane != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
      const Unit w = unit_at(u, units, probe, splits);
      if (w.cluster < 0 || w.cluster >= n_clusters) continue;  // poisoned: nothing to stream
      const int g1 = min(gpc, (w.split + 1) * gs);
      for (int g = w.split * gs; g < g1; ++g)
        for (int kc = 0; kc < n_chunks; ++kc) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_arrive_expect_tx(&full[stage], kStageBytes);
          tma_load_2d(ring + stage * kStageBytes, &slab_map, kc * kChunkElems, w.cluster * cap + g * kGroup,
                      &full[stage]);
          if (++stage == stages) {
            stage = 0;
            phase ^= 1;
          }
        }
    }
    return;
  }

  // the consumers: warpgroup wg scores rows 64*wg .. 64*wg+63 of each group
  const int tid = threadIdx.x;
  const int wg = warp >> 2;
  const int t = lane & 3;
  const int r_lo = wg * 64 + (warp & 3) * 16 + (lane >> 2);  // and r_lo + 8
  float acc[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) acc[i] = 0.0f;
  int stage = 0;
  uint32_t phase = 0;
  for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
    const Unit w = unit_at(u, units, probe, splits);
    if (tid < kN) qpair[tid] = tid < w.n_q ? (units != nullptr ? order[w.first + tid] : w.first) : -1;
    consumer_sync();
    auto out_at = [&](int c) { return (static_cast<int64_t>(qpair[c]) * splits + w.split) * kp; };
    if (w.cluster < 0 || w.cluster >= n_clusters) {  // an id outside the arm: poison its lists
      for (int i = tid; i < w.n_q * kp; i += kConsumers) {
        const int64_t o = out_at(i / kp) + i % kp;
        out_s[o] = NAN;
        out_i[o] = -1;
      }
      consumer_sync();
      continue;
    }
    // the unit's queries, swizzled as TMA would (16-byte unit j of row r at
    // j ^ (r % 8)); rows past the unit and dims past d are zeros
    for (int i = tid; i < n_chunks * kN * 8; i += kConsumers) {
      const int kc = i / (kN * 8);
      const int r = (i >> 3) % kN;
      const int j = i & 7;
      const int col = kc * kChunkElems + j * 8;
      const int pair = qpair[r];
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (pair >= 0 && col < d)
        v = __ldg(reinterpret_cast<const uint4*>(q + static_cast<int64_t>(pair / nprobe) * d + col));
      *reinterpret_cast<uint4*>(q_s + (kc * kN + r) * kRowBytes + ((j ^ (r & 7)) << 4)) = v;
    }
    fence_proxy_async();
    consumer_sync();

    const int g0 = w.split * gs;
    const int g1 = min(gpc, g0 + gs);
    for (int g = g0; g < g1; ++g) {
      const int row0 = w.cluster * cap + g * kGroup;
      int prev = -1;
      for (int kc = 0; kc < n_chunks; ++kc) {
        mbar_wait(&full[stage], phase);
        wgmma_fence();
        const uint64_t da = desc_sw128(ring + stage * kStageBytes + wg * 64 * kRowBytes);
        const uint64_t db = desc_sw128(q_s + kc * kN * kRowBytes);
#pragma unroll
        for (int k = 0; k < kRowBytes / 32; ++k)  // k16 steps
          Wgmma<kN>::template fma<kKind == kBf16>(acc, da + 2 * k, db + 2 * k, (kc | k) != 0);
        wgmma_commit();
        if (prev >= 0) {
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(&empty[prev]);
        }
        prev = stage;
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_operands(acc);
      if (lane == 0) mbar_arrive(&empty[prev]);

      // score + mask (K1's add) into staged[query][row]: register 4j + e
      // holds row r_lo, 4j + 2 + e row r_lo + 8, both of query 8j + 2t + e
      const float m_lo = __ldg(mask + row0 + r_lo);
      const float m_hi = __ldg(mask + row0 + r_lo + 8);
#pragma unroll
      for (int j = 0; j < kN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          staged[8 * j + 2 * t + e][r_lo] = acc[4 * j + e] + m_lo;
          staged[8 * j + 2 * t + e][r_lo + 8] = acc[4 * j + 2 + e] + m_hi;
        }
      consumer_sync();
      if constexpr (kWide) {  // every row, in position order
        const int rel = (g - g0) * kGroup;
        for (int i = tid; i < w.n_q * kGroup; i += kConsumers) {
          const int c = i / kGroup;
          const int r = i % kGroup;
          const int64_t o = out_at(c) + rel + r;
          out_s[o] = staged[c][r];
          out_i[o] = row0 + r;
        }
      } else {  // warp w: queries w, w + 8 (then w + 16, w + 24, ...)
        for (int c = warp; c < w.n_q; c += kMergeQ * kConsumerWarps) {
          const int c1 = min(c + kConsumerWarps, w.n_q - 1);
          const float* const srow[kMergeQ] = {staged[c], staged[c1]};
          unsigned long long* const lrow[kMergeQ] = {lists[c], lists[c1]};
          const bool live[kMergeQ] = {true, c + kConsumerWarps < w.n_q};
          select_group(srow, lrow, live, row0, kp, g == g0, slots[warp], lane);
        }
      }
      consumer_sync();  // the next group's scores overwrite staged
    }

    if constexpr (kWide) {  // a short last run pads its rows
      const int used = (g1 - g0) * kGroup;
      for (int i = tid; i < w.n_q * (kp - used); i += kConsumers) {
        const int64_t o = out_at(i / (kp - used)) + used + i % (kp - used);
        out_s[o] = -INFINITY;
        out_i[o] = -1;
      }
    } else {
      for (int i = tid; i < w.n_q * kp; i += kConsumers) {
        const unsigned long long key = lists[i / kp][i % kp];
        const int64_t o = out_at(i / kp) + i % kp;
        out_s[o] = key != 0ull ? key_score(key) : -INFINITY;
        out_i[o] = key != 0ull ? key_pos(key) : -1;
      }
    }
    consumer_sync();  // the next unit overwrites the pairs, queries and lists
  }
}

// The units of the cluster-major plan (one block): bin c of the counting
// sort (count cnt[c], first sorted position start[c]) gives ceil(cnt /
// q_tile) x splits units in bin order, a unit up to q_tile of its pairs
// and one run; the last bin (ids outside [0, C)) gives units of cluster
// -1. Writes the units and their count.
__global__ void __launch_bounds__(kUnitThreads)
ivf_units(const int32_t* __restrict__ cnt, const int32_t* __restrict__ start, int4* __restrict__ units,
          int32_t* __restrict__ n_units, int n_bins, int q_tile, int splits) {
  __shared__ int warp_sum[kUnitThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int carry = 0;  // units of the bins before this tile
  for (int b0 = 0; b0 < n_bins; b0 += kUnitThreads) {
    const int bin = b0 + threadIdx.x;
    const int c = bin < n_bins ? cnt[bin] : 0;
    const int own = (c + q_tile - 1) / q_tile * splits;
    int incl = own;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int s = warp_sum[lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, s, off);
        if (lane >= off) s += v;
      }
      warp_sum[lane] = s;  // inclusive over warps
    }
    __syncthreads();
    int next = carry + incl - own + (warp > 0 ? warp_sum[warp - 1] : 0);
    const int cluster = bin < n_bins - 1 ? bin : -1;
    for (int f = 0; f < c; f += q_tile)
      for (int s = 0; s < splits; ++s) units[next++] = make_int4(cluster, start[bin] + f, min(q_tile, c - f), s);
    carry += warp_sum[kUnitThreads / 32 - 1];
    __syncthreads();  // the next tile reuses warp_sum
  }
  if (threadIdx.x == 0) *n_units = carry;
}

struct Args {
  const void *q, *slab, *mask;
  const int32_t *probe, *order;
  const int4* units;
  const int32_t* n_units_dev;
  float* out_s;
  int32_t* out_i;
  int n_units, b, nprobe, d, n_clusters, gpc, splits, gs, kp;
};

// The stages a block of layout `lay` holds: as many as fit with two blocks
// an SM (at least 4), else with one (at least 2); 0 if none fit.
int stages_for(Layout lay) {
  lay.stages = 0;
  const size_t fixed = lay.bytes();
  const auto fit = [&](size_t budget) {
    return budget > fixed ? static_cast<int>(std::min<size_t>(kMaxStages, (budget - fixed) / (kStageBytes + 16))) : 0;
  };
  if (fit(kSmemTwo) >= 4) return fit(kSmemTwo);
  return fit(kSmemMax) >= 2 ? fit(kSmemMax) : 0;
}

template <int kKind, int kN, bool kWide>
int launch(const Args& a, cudaStream_t s) {
  alignas(64) CUtensorMap slab_map;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(a.d), static_cast<cuuint64_t>(a.n_clusters) * a.gpc * kGroup};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(a.d) * 2};
  const cuuint32_t box[2] = {kChunkElems, kGroup};
  const cuuint32_t elem[2] = {1, 1};
  // columns past d (the last chunk of a dim that is not a multiple of 64) read as zeros
  if (enc(&slab_map, kKind == kBf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16, 2,
          const_cast<void*>(a.slab), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  Layout lay{(a.d + kChunkElems - 1) / kChunkElems, kN, 0, kWide};
  lay.stages = stages_for(lay);
  if (lay.stages == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = lay.bytes();
  auto* kernel = ivf_probe_kernel<kKind, kN, kWide>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = std::max(1, std::min(a.n_units, sms * std::max(per_sm, 1)));
  ivf_probe_kernel<kKind, kN, kWide><<<grid, kThreads, smem, s>>>(
      slab_map, static_cast<const uint16_t*>(a.q), static_cast<const float*>(a.mask), a.probe, a.units,
      a.n_units_dev, a.order, a.out_s, a.out_i, a.n_units, a.nprobe, a.d, lay.n_chunks, a.n_clusters, a.gpc,
      a.splits, a.gs, a.kp, lay.stages);
  return static_cast<int>(cudaGetLastError());
}

// Whether a query tile of kN rows leaves room for a ring at width d.
bool tile_fits(int kN, int d, bool wide) {
  return stages_for(Layout{(d + kChunkElems - 1) / kChunkElems, kN, 0, wide}) > 0;
}

template <int kKind, bool kWide>
int dispatch(int q_tile, const Args& a, cudaStream_t s) {
  return q_tile == 8 ? launch<kKind, 8, kWide>(a, s) : launch<kKind, 16, kWide>(a, s);
}

}  // namespace

// The IVF probe. q: (b, d) of the slab's dtype (f16: kind 0, bf16: kind
// 1), slab: (n_clusters * gpc * 128, d) sorted by cluster, mask: (rows,)
// f32, probe: (b, nprobe) int32 cluster ids. plan: null for pair order
// (one unit a pair), else fs_gather_plan's scratch for b * nprobe ids over
// n_clusters bins; units: with plan, 4 * b * nprobe * splits + 1 int32
// (the units, then their count). out_s / out_i: (b * nprobe * splits, kp)
// f32 / int32, pair-major (pair b_i * nprobe + j), run-minor. Each run is
// ceil(gpc / splits) groups; kp <= 64 keeps each run's top kp (a list),
// kp = 128 * ceil(gpc / splits) every row. q_tile (8 or 16) is the
// queries a unit takes, halved while its tile does not fit; 1 <= splits
// <= gpc. Needs d % 8 == 0, d <= 8192 and 16-byte aligned pointers (the
// Python wrapper checks all of these). Returns the first CUDA error of its
// launches, or cudaGetLastError() after the last.
extern "C" int fs_ivf_probe(const void* q, const void* slab, const void* mask, const void* probe, void* plan,
                            void* units, void* out_s, void* out_i, int b, int nprobe, int d, int n_clusters, int gpc,
                            int splits, int q_tile, int kp, int kind, void* stream) {
  const long long total = static_cast<long long>(b) * nprobe;
  if (b < 1 || nprobe < 1 || d < 8 || d % 8 != 0 || d > kMaxDim || n_clusters < 1 || gpc < 1 || splits < 1 ||
      splits > gpc || kp < 1 || (q_tile != 8 && q_tile != 16) ||
      (kind != kF16 && kind != kBf16) || total * splits > 0x7fffffffLL / 4 ||
      static_cast<long long>(n_clusters) * gpc * kGroup > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int gs = (gpc + splits - 1) / splits;
  const bool wide = kp > kListK;
  if (wide && kp != gs * kGroup) return static_cast<int>(cudaErrorInvalidValue);
  while (q_tile > 8 && !tile_fits(q_tile, d, wide)) q_tile /= 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a{q, slab, mask, static_cast<const int32_t*>(probe), nullptr, nullptr, nullptr,
         static_cast<float*>(out_s), static_cast<int32_t*>(out_i), static_cast<int>(total * splits),
         b, nprobe, d, n_clusters, gpc, splits, gs, kp};
  if (plan != nullptr) {
    const int t = static_cast<int>(total);
    const int rc = fs_gather_plan(probe, plan, t, n_clusters, stream);
    if (rc != 0) return rc;
    const int n_bins = n_clusters + 1;
    const auto* cnt = static_cast<const int32_t*>(plan);
    a.order = cnt + 2 * n_bins + 1 + t;  // fs_gather_plan's layout: counts, starts, ids, order
    a.units = static_cast<const int4*>(units);
    a.n_units_dev = static_cast<const int32_t*>(units) + 4 * a.n_units;
    ivf_units<<<1, kUnitThreads, 0, s>>>(cnt, cnt + n_bins, static_cast<int4*>(units),
                                         static_cast<int32_t*>(units) + 4 * a.n_units, n_bins, q_tile, splits);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (kind == kBf16) return wide ? dispatch<kBf16, true>(q_tile, a, s) : dispatch<kBf16, false>(q_tile, a, s);
  return wide ? dispatch<kF16, true>(q_tile, a, s) : dispatch<kF16, false>(q_tile, a, s);
}

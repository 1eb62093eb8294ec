// K5: per-tile top-k of the slab scan scores, for sm_90a.
//
// Replaces the TPU kernel frankensearch_tpu/ops/topk_scan.py
// `_tile_topk_kernel` (the pallas_call in `scan_topk_pallas`). For each
// 2048-row tile T of the slab and each query b it scores
//
//     s[r] = dot(bf16(q[b]), slab[T*2048 + r]) + mask[T*2048 + r]
//
// (bf16 or f16 products, f32 sums) and returns the tile's top kk as
// out_s[T, j, b] / out_i[T, j, b] (score, slab row), j = 0 .. kk-1, in the
// order of kk argmax passes: score descending, the FIRST column among equal
// scores (== ties -0.0 with +0.0), the element's own score. Once the finite
// scores run out, every remaining slot is column 0 at -inf, as the TPU
// kernel's passes give (the caller turns those entries into row -1).
//
// What bounds it on the H100: the scan reads the slab once (1M x 256 bf16:
// 516 MB, 0.154 ms at 3.35 TB/s; its 134 G bf16 operations take 0.136 ms at
// 989 TFLOP/s), so bytes; the selection adds no device-memory traffic.
//
// Two entries:
//
// fs_tile_topk (kk <= 64, the searcher's budgets), the design:
//   * the scores are K1's bits: one block = one tile x 64 queries, 4 warps,
//     walking the tile's 16 groups with score_group_with() of
//     group_scan.cuh (16-byte staged loads, mma.sync). The epilogue adds the
//     mask exactly as K1 does and parks the group's 128 x 64 scores in
//     shared memory, over the dead staging buffers;
//   * selection without passes: every (score, column) gets a 64-bit key
//     (score with -0.0 read as +0.0, then column ascending; one key per
//     column, so no two are equal), and each query keeps its running top kk
//     as a sorted list of keys in shared memory, whose kk-th key is a
//     threshold. The first group fills the lists with a bitonic sort of its
//     128 keys (warp shuffles). For every later group all 128 threads first
//     compare the 64 x 128 new scores with their query's threshold, in
//     parallel, into 32-bit masks; then each query's few survivors (a warp
//     per query, round robin, so a small batch still uses every warp) are
//     packed into lanes and merged into the list by rank: a survivor's
//     place is its rank among the survivors plus the list keys above it (a
//     binary search over the list in registers), a list key's is its index
//     plus the survivors above it. A warp merges two queries at once: their
//     steps are independent, so one's latency hides the other's (the
//     merges are latency-bound). No atomics; the result depends on no order
//     of anything;
//   * 33 KB of shared memory for the score block (sharing its bytes with
//     the group staging), 33 KB of lists, 2 KB of survivor rows and masks:
//     three blocks per SM.
//
// fs_tile_topk_wide (64 < kk <= 2048): the first port's body, kept for the
// wide budgets. One block = one tile x 16 queries, 8 warps: it scores the
// tile into a (16 x 2048) f32 block of shared memory (128 KB), then runs kk
// argmax passes per query, a warp-shuffle reduction each.
//
// The f32 forms (kind 2: an f32 slab and query, f32 products and sums, the
// TPU kernel on an f32 slab) keep both entries' selection code and score by
// FFMA in place of mma.sync: the list entry with K1's f32 body
// (scan_f32.cuh, the same accumulator layout, so K5's candidates are K1's
// f32 scores bit for bit), the wide entry with one row a lane against the
// 16 queries, the same fmaf chain (dims ascending from +0.0), so the same
// bits. The wide f32 entry takes d <= 1024 (its f32 query rows share the
// block's shared memory with the 128 KB score block). The f32 scan is
// FFMA-bound: 1.32e11 FLOP at 1M x 256, B = 256 (1.97 ms at 67 TFLOP/s).

#include "group_scan.cuh"
#include "scan_f32.cuh"

using namespace fs_scan;

namespace {

constexpr int kTile = 2048;                       // slab rows per tile
constexpr int kGroupsPerTile = kTile / kGroup;    // 16
constexpr int kMaxK = 64;                         // the list fits kk <= 64
constexpr int kLdSt = kGroup + 4;                 // staged score row stride
constexpr int kLdL = kMaxK + 1;                   // list stride (64-bit words)
constexpr int kChunks = kGroup / 32;              // 32-row chunks per group
constexpr int kQPerWarp = kQTile / kWarps;        // 16
constexpr int kMergeQ = 2;  // queries a warp merges at once, their steps interleaved
constexpr int kF32 = 2;     // the `kind` of an f32 slab (0 f16, 1 bf16)

struct TopkSmem {
  union {
    GroupSmem g;                     // staging of score_group_with()
    fs_scan_f32::GroupSmemF32 gf;    // staging of score_group_f32_with()
    float staged[kQTile][kLdSt];     // the group's scores, query-major
  } u;
  unsigned long long list[kQTile][kLdL];   // running top kk keys, descending
  unsigned char slots[kWarps][kMergeQ][kGroup];  // a warp's packed survivor rows
  unsigned pass[kQTile][kChunks];          // survivor masks of the group
};

// Order key of (score, column): larger is better. The high word is the
// score's total-order bits with -0.0 read as +0.0; the low word holds
// (kTile - 1 - column) << 1 and, in bit 0, whether the score was -0.0.
// Callers pass scores above -inf, whose keys are never 0: 0 is the empty
// slot.
__device__ __forceinline__ unsigned long long make_key(float s, int col) {
  const unsigned bits = __float_as_uint(s);
  const unsigned neg_zero = bits == 0x80000000u ? 1u : 0u;
  const unsigned nb = neg_zero ? 0u : bits;
  const unsigned u = (nb & 0x80000000u) ? ~nb : (nb | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) |
         (static_cast<unsigned>(kTile - 1 - col) << 1) | neg_zero;
}

// The key's score with -0.0 read as +0.0 (the threshold's float form).
__device__ __forceinline__ float key_score_norm(unsigned long long k) {
  const unsigned u = static_cast<unsigned>(k >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ float key_score(unsigned long long k) {
  return (k & 1ull) ? -0.0f : key_score_norm(k);
}

__device__ __forceinline__ int key_col(unsigned long long k) {
  return kTile - 1 - static_cast<int>((k & 0xffffffffull) >> 1);
}

// Sorts the warp's 128 keys (v[e] at position e*32 + lane) descending with
// a bitonic network: positions 32 apart swap inside a lane, closer ones
// across lanes with shuffles.
__device__ __forceinline__ void warp_sort128_desc(unsigned long long (&v)[4], int lane) {
#pragma unroll
  for (int k = 2; k <= 128; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool desc = ((e * 32 + lane) & k) == 0;  // this k-block sorts descending
        if (j >= 32) {
          const int ep = e ^ (j >> 5);
          if (ep > e && ((v[e] < v[ep]) == desc)) {
            const unsigned long long x = v[e];
            v[e] = v[ep];
            v[ep] = x;
          }
        } else {
          const unsigned long long o = __shfl_xor_sync(0xffffffffu, v[e], j);
          const bool keep_max = ((lane & j) == 0) == desc;  // the pair's lower position
          v[e] = keep_max ? (v[e] > o ? v[e] : o) : (v[e] < o ? v[e] : o);
        }
      }
    }
  }
}

// Merges, for each of kMQ queries q, nr[q] <= 32 survivors (lanes 0 ..
// nr[q]-1 of key[q]; the other lanes hold 0) into its descending list L[q]
// of kk keys, keeping the top kk. The queries' steps are independent and
// interleave. Warp-uniform call.
template <int kMQ>
__device__ __forceinline__ void merge_survivors(unsigned long long* const (&L)[kMQ], int kk,
                                                const unsigned long long (&key)[kMQ],
                                                const int (&nr)[kMQ], int lane) {
  unsigned long long e0[kMQ], e1[kMQ];
  int rank[kMQ], add0[kMQ], add1[kMQ], lo[kMQ], hi[kMQ];
  int n = 0;
#pragma unroll
  for (int q = 0; q < kMQ; ++q) {
    e0[q] = lane < kk ? L[q][lane] : 0ull;
    e1[q] = lane + 32 < kk ? L[q][lane + 32] : 0ull;
    rank[q] = add0[q] = add1[q] = 0;
    lo[q] = 0;
    hi[q] = kk;
    n = max(n, nr[q]);
  }
  for (int src = 0; src < n; ++src) {  // a lane past nr[q] holds 0 and counts nowhere
#pragma unroll
    for (int q = 0; q < kMQ; ++q) {
      const unsigned long long ks = __shfl_sync(0xffffffffu, key[q], src);
      rank[q] += ks > key[q];
      add0[q] += ks > e0[q];
      add1[q] += ks > e1[q];
    }
  }
  // list keys above each survivor: a binary search over the list, whose
  // position p sits in lane p % 32 (e0 below 32, e1 above)
#pragma unroll
  for (int step = 0; step < 7; ++step) {  // 2^7 > kMaxK
#pragma unroll
    for (int q = 0; q < kMQ; ++q) {
      const int mid = (lo[q] + hi[q]) >> 1;
      const unsigned long long a = __shfl_sync(0xffffffffu, e0[q], mid & 31);
      const unsigned long long c = __shfl_sync(0xffffffffu, e1[q], mid & 31);
      if (lo[q] < hi[q]) {
        if ((mid < 32 ? a : c) > key[q]) lo[q] = mid + 1;
        else hi[q] = mid;
      }
    }
  }
  __syncwarp();  // every lane has read the lists
#pragma unroll
  for (int q = 0; q < kMQ; ++q) {
    if (lane < nr[q] && rank[q] + lo[q] < kk) L[q][rank[q] + lo[q]] = key[q];
    if (lane < kk && lane + add0[q] < kk) L[q][lane + add0[q]] = e0[q];
    if (lane + 32 < kk && lane + 32 + add1[q] < kk) L[q][lane + 32 + add1[q]] = e1[q];
  }
  __syncwarp();
}

// The scores of one group (score_group_with, or its f32 form) into epi.
template <int kKind, class Epilogue>
__device__ __forceinline__ void score_group(const void* q, const void* slab, const float* mask, int64_t row0,
                                            int q0, int b, int d, TopkSmem& sm, Epilogue&& epi) {
  if constexpr (kKind == kF32) {
    static_assert(fs_scan_f32::kMaxQ == kQTile && fs_scan_f32::kThreads == kThreads, "one block shape");
    fs_scan_f32::score_group_f32_with<kQTile / 8>(static_cast<const float*>(q), static_cast<const float*>(slab),
                                                  mask, row0, q0, b, d, sm.u.gf, epi);
  } else {
    score_group_with<kKind == 1>(static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(slab), mask, row0,
                                 q0, b, d, sm.u.g, epi);
  }
}

template <int kKind>
__global__ void __launch_bounds__(kThreads)
tile_topk_kernel(const void* __restrict__ q,     // (b, d) slab dtype
                 const void* __restrict__ slab,  // (n, d)
                 const float* __restrict__ mask,     // (n,) additive
                 float* __restrict__ out_s,          // (n_tiles, kk, b)
                 int32_t* __restrict__ out_i,        // (n_tiles, kk, b)
                 int b, int d, int kk, int n_qtiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TopkSmem& sm = *reinterpret_cast<TopkSmem*>(smem_raw);

  const int tile = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * kQTile;
  const int live = min(kQTile, b - q0);
  const int64_t row_base = static_cast<int64_t>(tile) * kTile;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const unsigned lanes_below = (1u << lane) - 1u;

  const float* gmask = kKind == kF32 ? sm.u.gf.mask : sm.u.g.mask;  // the group's staged mask
  for (int lg = 0; lg < kGroupsPerTile; ++lg) {
    score_group<kKind>(q, slab, mask, row_base + lg * kGroup, q0, b, d, sm, [&](auto& acc) {
      // score + mask, the add K1 makes before its maximum
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[mt][nt][c] = acc[mt][nt][c] + gmask[warp * 32 + mt * 16 + g + (c >> 1) * 8];
      __syncthreads();  // the score block overwrites the mask and the staging
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            sm.u.staged[nt * 8 + 2 * t + (c & 1)][warp * 32 + mt * 16 + g + (c >> 1) * 8] =
                acc[mt][nt][c];
      __syncthreads();
    });

    const int col0 = lg * kGroup;
    if (lg == 0) {  // the first group fills the lists: sort its 128 keys
      for (int ci = 0; ci < kQPerWarp; ++ci) {
        const int c = ci * kWarps + warp;  // round robin: a small batch still uses every warp
        if (c >= live) break;
        unsigned long long v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float s = sm.u.staged[c][e * 32 + lane];
          v[e] = s > -INFINITY ? make_key(s, e * 32 + lane) : 0ull;
        }
        warp_sort128_desc(v, lane);
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (e * 32 + lane < kk) sm.list[c][e * 32 + lane] = v[e];
      }
      __syncthreads();
      continue;
    }

    // the filter, all threads: (live query, chunk) pairs, 32 compares each
    for (int w = tid; w < live * kChunks; w += kThreads) {
      const int c = w / kChunks;
      const int ch = w % kChunks;
      const unsigned long long thr = sm.list[c][kk - 1];
      const float thr_s = thr ? key_score_norm(thr) : -INFINITY;
      const float* row = sm.u.staged[c] + ch * 32;
      unsigned bits = 0u, ties = 0u;
#pragma unroll 8
      for (int j = 0; j < 32; ++j) {
        const int jj = (j + lane) & 31;  // rotated: lanes spread over the banks
        const float s = row[jj];
        bits |= static_cast<unsigned>(s > thr_s) << jj;
        ties |= static_cast<unsigned>(s == thr_s) << jj;
      }
      if (thr) {  // at the threshold's own score the key decides (-0.0 == +0.0)
        for (unsigned m = ties; m; m &= m - 1) {
          const int jj = __ffs(static_cast<int>(m)) - 1;
          if (make_key(row[jj], col0 + ch * 32 + jj) > thr) bits |= 1u << jj;
        }
      }
      sm.pass[c][ch] = bits;
    }
    __syncthreads();

    for (int ci = 0; ci < kQPerWarp; ci += kMergeQ) {
      if (ci * kWarps + warp >= live) break;
      // pack each query's survivors into its slots, in column order
      unsigned long long* L[kMergeQ];
      int cq[kMergeQ], n[kMergeQ];
#pragma unroll
      for (int q = 0; q < kMergeQ; ++q) {
        cq[q] = (ci + q) * kWarps + warp;
        L[q] = sm.list[cq[q]];
        n[q] = 0;
        if (cq[q] >= live) continue;
#pragma unroll
        for (int ch = 0; ch < kChunks; ++ch) {
          const unsigned m = sm.pass[cq[q]][ch];
          if ((m >> lane) & 1u) sm.slots[warp][q][n[q] + __popc(m & lanes_below)] = ch * 32 + lane;
          n[q] += __popc(m);
        }
      }
      __syncwarp();
      int n_max = 0;
#pragma unroll
      for (int q = 0; q < kMergeQ; ++q) n_max = max(n_max, n[q]);
      for (int r0 = 0; r0 < n_max; r0 += 32) {
        unsigned long long key[kMergeQ];
        int nr[kMergeQ];
#pragma unroll
        for (int q = 0; q < kMergeQ; ++q) {
          nr[q] = min(32, max(0, n[q] - r0));
          const int row = lane < nr[q] ? sm.slots[warp][q][r0 + lane] : 0;
          key[q] = lane < nr[q] ? make_key(sm.u.staged[cq[q]][row], col0 + row) : 0ull;
        }
        merge_survivors<kMergeQ>(L, kk, key, nr, lane);
      }
    }
    __syncthreads();  // the next group's staging overwrites the score block
  }

  for (int i = tid; i < kk * kQTile; i += kThreads) {
    const int j = i / kQTile;
    const int c = i % kQTile;
    if (c >= live) continue;
    const unsigned long long k = sm.list[c][j];
    const int64_t o = (static_cast<int64_t>(tile) * kk + j) * b + q0 + c;
    out_s[o] = k ? key_score(k) : -INFINITY;
    out_i[o] = static_cast<int32_t>(row_base + (k ? key_col(k) : 0));
  }
}

// ---------------------------------------------------------------------------
// the wide entry (64 < kk <= 2048)
// ---------------------------------------------------------------------------

constexpr int kWQChunk = 16;             // queries per block
constexpr int kWWarps = 8;
constexpr int kWThreads = kWWarps * 32;
constexpr int kWRowsPerWarp = kTile / kWWarps;  // 256
constexpr int kWPerLane = kTile / 32;           // 64 columns per lane
// score row stride: + 4 floats, so the 4 query rows one mma fragment
// writes to fall in different banks
constexpr int kWLdS = kTile + 4;

__device__ __forceinline__ uint32_t ldg32(const uint16_t* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// (value, column) of the better of two candidates: the larger value, the
// lower column among equal ones (== ties -0.0 with +0.0).
__device__ __forceinline__ void better(float& v, int& c, float ov, int oc) {
  if (ov > v || (ov == v && oc < c)) {
    v = ov;
    c = oc;
  }
}

// Best (value, first column) over this lane's columns lane, lane+32, ...
__device__ __forceinline__ void lane_best(const float* s, int lane, float& v, int& c) {
  v = -INFINITY;
  c = lane;
  for (int i = 0; i < kWPerLane; ++i) {
    const float x = s[lane + 32 * i];
    if (x > v) {
      v = x;
      c = lane + 32 * i;
    }
  }
}

// The wide entry's f32 scores: lane l of warp w takes row 256w + r32 + l
// against the chunk's 16 queries (broadcast from shared memory), one fmaf
// chain over the dims in ascending order each, K1's f32 bits.
__device__ __forceinline__ void wide_scores_f32(const float* __restrict__ q, const float* __restrict__ slab,
                                                const float* __restrict__ mask, float* s_scores, float* s_q,
                                                int64_t row_base, int q0, int b, int d) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int ldq = d + 4;
  for (int i = tid; i < kWQChunk * (d / 4); i += kWThreads) {
    const int r = i / (d / 4);
    const int c = (i % (d / 4)) * 4;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (q0 + r < b) v = __ldg(reinterpret_cast<const float4*>(q + static_cast<int64_t>(q0 + r) * d + c));
    *reinterpret_cast<float4*>(&s_q[r * ldq + c]) = v;
  }
  __syncthreads();
  for (int r32 = 0; r32 < kWRowsPerWarp; r32 += 32) {
    const int r = warp * kWRowsPerWarp + r32 + lane;
    const float* row = slab + (row_base + r) * d;
    float acc[kWQChunk];
#pragma unroll
    for (int j = 0; j < kWQChunk; ++j) acc[j] = 0.0f;
    for (int k = 0; k < d; k += 4) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(row + k));
#pragma unroll
      for (int j = 0; j < kWQChunk; ++j) {
        const float4 v = *reinterpret_cast<const float4*>(&s_q[j * ldq + k]);
        acc[j] = fmaf(x.x, v.x, acc[j]);
        acc[j] = fmaf(x.y, v.y, acc[j]);
        acc[j] = fmaf(x.z, v.z, acc[j]);
        acc[j] = fmaf(x.w, v.w, acc[j]);
      }
    }
    const float m = mask[row_base + r];
#pragma unroll
    for (int j = 0; j < kWQChunk; ++j) s_scores[j * kWLdS + r] = acc[j] + m;
  }
}

template <int kKind>
__global__ void __launch_bounds__(kWThreads)
tile_topk_wide_kernel(const void* __restrict__ q_any,     // (b, d) slab dtype
                      const void* __restrict__ slab_any,  // (n, d)
                      const float* __restrict__ mask,     // (n,) additive
                      float* __restrict__ out_s,          // (n_tiles, kk, b)
                      int32_t* __restrict__ out_i,        // (n_tiles, kk, b)
                      int b, int d, int kk, int n_qchunks) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_scores = reinterpret_cast<float*>(smem);  // [kWQChunk][kWLdS]

  const int tile = blockIdx.x / n_qchunks;
  const int q0 = (blockIdx.x % n_qchunks) * kWQChunk;
  const int64_t row_base = static_cast<int64_t>(tile) * kTile;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  if constexpr (kKind == kF32) {
    wide_scores_f32(static_cast<const float*>(q_any), static_cast<const float*>(slab_any), mask, s_scores,
                    s_scores + kWQChunk * kWLdS, row_base, q0, b, d);
  } else {
    constexpr bool kBf16 = kKind == 1;
    const auto* q = static_cast<const uint16_t*>(q_any);
    const auto* slab = static_cast<const uint16_t*>(slab_any);
    uint16_t* s_q = reinterpret_cast<uint16_t*>(s_scores + kWQChunk * kWLdS);
    const int ldq = d + 8;  // padded query row stride (bank-conflict free)
    const int g = lane >> 2;
    const int t = lane & 3;

    for (int i = tid; i < kWQChunk * (d / 2); i += kWThreads) {
      const int r = i / (d / 2);
      const int c = (i % (d / 2)) * 2;
      uint32_t v = 0u;
      if (q0 + r < b) v = *reinterpret_cast<const uint32_t*>(q + static_cast<int64_t>(q0 + r) * d + c);
      *reinterpret_cast<uint32_t*>(&s_q[r * ldq + c]) = v;
  }
  __syncthreads();

  // scores: each warp 256 rows, 32 rows (2 mma row tiles) x 16 queries at a time
  for (int r32 = 0; r32 < kWRowsPerWarp; r32 += 32) {
    float acc[2][2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.0f;
    const int64_t rbase = row_base + warp * kWRowsPerWarp + r32;
    for (int k = 0; k < d; k += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const uint16_t* p = slab + (rbase + mt * 16 + g) * d + k + 2 * t;
        a[mt][0] = ldg32(p);              // row g,   k 2t..2t+1
        a[mt][1] = ldg32(p + 8 * d);      // row g+8, k 2t..2t+1
        a[mt][2] = ldg32(p + 8);          // row g,   k 2t+8..2t+9
        a[mt][3] = ldg32(p + 8 * d + 8);  // row g+8, k 2t+8..2t+9
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const uint16_t* p = &s_q[(nt * 8 + g) * ldq + k + 2 * t];
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(p);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(p + 8);
        mma16816<kBf16>(acc[0][nt], a[0], b0, b1);
        mma16816<kBf16>(acc[1][nt], a[1], b0, b1);
      }
    }
    // acc[mt][nt][c]: row mt*16 + g (+8 for c >= 2), query nt*8 + 2t + (c & 1)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = warp * kWRowsPerWarp + r32 + mt * 16 + g + 8 * half;
        const float m = mask[row_base + r];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            s_scores[(nt * 8 + 2 * t + j) * kWLdS + r] = acc[mt][nt][2 * half + j] + m;
      }
    }
  }
  }
  __syncthreads();

  // selection: warp w serves queries 2w and 2w+1 of the chunk
  for (int ql = warp * 2; ql < warp * 2 + 2; ++ql) {
    const int qi = q0 + ql;
    if (qi >= b) break;
    float* s = s_scores + ql * kWLdS;
    float v;
    int c;
    lane_best(s, lane, v, c);
    for (int j = 0; j < kk; ++j) {
      float wv = v;
      int wc = c;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        better(wv, wc, __shfl_xor_sync(0xffffffffu, wv, off),
               __shfl_xor_sync(0xffffffffu, wc, off));
      if (lane == 0) {
        const int64_t o = (static_cast<int64_t>(tile) * kk + j) * b + qi;
        out_s[o] = wv;
        out_i[o] = static_cast<int32_t>(row_base + wc);
      }
      if (lane == (wc & 31)) {  // the owner knocks the column out, rescans
        s[wc] = -INFINITY;
        lane_best(s, lane, v, c);
      }
      __syncwarp();
    }
  }
}

template <class Kernel>
int launch(Kernel kernel, unsigned blocks, int threads, size_t smem, cudaStream_t s,
           const void* q, const void* slab, const void* mask, void* out_s, void* out_i,
           int b, int d, int kk, int per_tile) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, threads, smem, s>>>(
      q, slab, static_cast<const float*>(mask), static_cast<float*>(out_s), static_cast<int32_t*>(out_i),
      b, d, kk, per_tile);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (b, d) of the slab's dtype, slab: (n, d) f16 (kind 0), bf16 (kind 1)
// or f32 (kind 2), mask: (n,) f32, out_s / out_i: (n / 2048, kk, b) f32 /
// int32. Needs n % 2048 == 0, d % 64 == 0, 1 <= kk <= 64, b >= 1 and
// 16-byte aligned pointers (the Python wrapper checks all of these).
// Returns cudaGetLastError() after the launch.
extern "C" int fs_tile_topk(const void* q, const void* slab, const void* mask,
                            void* out_s, void* out_i, int b, int d, long long n,
                            int kk, int kind, void* stream) {
  if (b < 1 || d < kChunk || d % kChunk != 0 || n < kTile || n % kTile != 0 ||
      kk < 1 || kk > kMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_qtiles = (b + kQTile - 1) / kQTile;
  const long long blocks = n / kTile * n_qtiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(TopkSmem);
  const unsigned grid = static_cast<unsigned>(blocks);
  const int per_tile = static_cast<int>(n_qtiles);
  if (kind == kF32)
    return launch(tile_topk_kernel<kF32>, grid, kThreads, smem, s, q, slab, mask, out_s, out_i, b, d, kk, per_tile);
  if (kind == 1)
    return launch(tile_topk_kernel<1>, grid, kThreads, smem, s, q, slab, mask, out_s, out_i, b, d, kk, per_tile);
  return launch(tile_topk_kernel<0>, grid, kThreads, smem, s, q, slab, mask, out_s, out_i, b, d, kk, per_tile);
}

// The wide entry: as fs_tile_topk, for 1 <= kk <= 2048, d % 16 == 0,
// d <= 2048 (f32: 1024) and 16-byte aligned pointers.
extern "C" int fs_tile_topk_wide(const void* q, const void* slab, const void* mask,
                                 void* out_s, void* out_i, int b, int d, long long n,
                                 int kk, int kind, void* stream) {
  if (b < 1 || d < 16 || d % 16 != 0 || d > (kind == kF32 ? 1024 : 2048) || n < kTile || n % kTile != 0 ||
      kk < 1 || kk > kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_qchunks = (b + kWQChunk - 1) / kWQChunk;
  const long long blocks = n / kTile * n_qchunks;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t q_bytes = kind == kF32 ? static_cast<size_t>(kWQChunk) * (d + 4) * sizeof(float)
                                      : static_cast<size_t>(kWQChunk) * (d + 8) * sizeof(uint16_t);
  const size_t smem = static_cast<size_t>(kWQChunk) * kWLdS * sizeof(float) + q_bytes;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(blocks);
  const int per_tile = static_cast<int>(n_qchunks);
  if (kind == kF32)
    return launch(tile_topk_wide_kernel<kF32>, grid, kWThreads, smem, s, q, slab, mask, out_s, out_i, b, d, kk,
                  per_tile);
  if (kind == 1)
    return launch(tile_topk_wide_kernel<1>, grid, kWThreads, smem, s, q, slab, mask, out_s, out_i, b, d, kk,
                  per_tile);
  return launch(tile_topk_wide_kernel<0>, grid, kWThreads, smem, s, q, slab, mask, out_s, out_i, b, d, kk,
                per_tile);
}

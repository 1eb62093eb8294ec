// K5: per-tile top-k of the slab scan scores, for sm_90a.
//
// Replaces the TPU kernel frankensearch_tpu/ops/topk_scan.py
// `_tile_topk_kernel` (the pallas_call in `scan_topk_pallas`). For each
// 2048-row tile T of the slab and each query b it scores
//
//     s[r] = dot(q[b], slab[T*2048 + r]) + mask[T*2048 + r]
//
// (the query rounded to the slab's type: bf16 or f16 products with f32
// sums, or f32 products and sums on an f32 slab) and returns the tile's top
// kk as out_s[T, j, b] / out_i[T, j, b] (score, slab row), j = 0 .. kk-1,
// in the order of kk argmax passes: score descending, the FIRST column
// among equal scores (== ties -0.0 with +0.0), the element's own score.
// Once the finite scores run out, every remaining slot is column 0 at -inf,
// as the TPU kernel's passes give (the caller turns those entries into row
// -1). Both list entries rank by a 64-bit key per (score, column): the
// score with -0.0 read as +0.0, then column ascending; one key per column,
// so no two are equal, and the top kk by that total order depends on no
// order of groups, warps or candidates.
//
// Three entries:
//
// fs_tile_topk, bf16/f16 (kk <= 64, the searcher's budgets). What bounds
// it on the H100: the scan reads the slab once (1M x 256 bf16: 516 MB,
// 0.154 ms at 3.35 TB/s; its 134 G bf16 operations take 0.136 ms at 989
// TFLOP/s), so bytes; the selection adds no device-memory traffic.
//   * the scores are K1's bits: one block = one tile x 64 queries, 4 warps,
//     walking the tile's 16 groups with score_group_with() of
//     group_scan.cuh (16-byte staged loads, mma.sync). The epilogue adds the
//     mask exactly as K1 does and parks the group's 128 x 64 scores in
//     shared memory, over the dead staging buffers;
//   * selection without passes: each query keeps its running top kk as a
//     sorted list of keys in shared memory, whose kk-th key is a
//     threshold. The first group fills the lists with a bitonic sort of its
//     128 keys (warp shuffles). For every later group all 128 threads first
//     compare the 64 x 128 new scores with their query's threshold, in
//     parallel, into 32-bit masks; then each query's few survivors (a warp
//     per query, round robin, so a small batch still uses every warp) are
//     packed into lanes and merged into the list by rank: a survivor's
//     place is its rank among the survivors plus the list keys above it (a
//     binary search over the list in registers), a list key's is its index
//     plus the survivors above it. A warp merges two queries at once: their
//     steps are independent, so one's latency hides the other's;
//   * 33 KB of shared memory for the score block (sharing its bytes with
//     the group staging), 33 KB of lists, 2 KB of survivor rows and masks:
//     three blocks per SM.
//
// fs_tile_topk, f32 (kind 2, kk <= 64): the TPU kernel on an f32 slab. Its
// dot products are f32 products and sums, which neither wgmma nor mma.sync
// takes (TF32 rounds the operands), so it scores on the CUDA cores: each
// score is one fmaf chain from +0.0 over the dims in ascending order, then
// + mask, the bits of K1's f32 form (scan_f32.cuh), whatever the query
// tile, batch or thread. What bounds it: at B = 256 FFMA (1,007,616 x 256:
// 1.32e11 FLOP, 1.97 ms at the 67 TFLOP/s f32 peak; the slab is 1.03 GB,
// 0.31 ms), at B <= 8 the slab's bytes (0.31 ms). The first port ran the
// scan and the selection one after the other in the same four warps (248
// registers a thread, two blocks an SM), re-staged the query tile for
// every group and tiled 64 queries at any batch. The design:
//   * two roles in one block: 8 scan warps score group g+1 while 12
//     selection warps filter and merge group g. The scores go through two
//     buffers of (queries x 128) f32 in shared memory, handed over with
//     named barriers (bar.arrive / bar.sync: "full" and "empty" per
//     buffer), so the FFMA units wait for the selection only when it falls
//     a whole group behind. The selection is the bf16 entry's (the same
//     lists, filter and merges), spread over 12 warps: its merges are
//     latency-bound chains of shuffles, and more warps hide more of them;
//   * the query tile is as wide as the batch needs (8, 16, 32 or 64
//     queries, as K1's f32 form) and is staged in shared memory once per
//     block, i.e. once per 2048-row tile, for d up to what fits (64
//     queries: d <= 256; 32: d <= 768); wider rows stage it with each
//     chunk of rows, as the first port did;
//   * the tile's rows stream through a ring of 3 (64 queries) or 4 stages
//     of 128 rows x 32 dims with cp.async, so the next chunks are in flight
//     while the current one is scored; one 256-thread named barrier a
//     chunk;
//   * a scan warp owns 32 rows x (queries / 2) (16 rows x 8 at 8 queries):
//     per 4 dims it loads its rows' and queries' float4s from shared
//     memory (bank-conflict free: rows padded to 36 floats, resident query
//     rows to d + 4) and issues up to 128 FFMA;
//   * one block of 20 warps an SM (up to 222 KB of shared memory: lists,
//     two score buffers, survivor rows, the ring and the resident query
//     tile; 96 registers a thread). At 64 queries the scan warpgroups take
//     128 registers a thread from the selection's (setmaxnreg, 72 left).
// What holds it back at B = 256 (measured, PERF.md): the scan's 12
// shared-memory loads of 16 bytes per 128 FFMA keep the load pipe busier
// than the FFMA units, and the selection's shuffles share that pipe, so
// the two roles slow each other down.
//
// fs_tile_topk_wide (64 < kk <= 2048): the first port's body, kept for the
// wide budgets. One block = one tile x 16 queries, 8 warps: it scores the
// tile into a (16 x 2048) f32 block of shared memory (128 KB), then runs kk
// argmax passes per query, a warp-shuffle reduction each. Its f32 form
// scores one row a lane against the 16 queries, the same fmaf chain (dims
// ascending from +0.0), so the same bits, and takes d <= 1024 (its f32
// query rows share the block's shared memory with the score block).

#include "group_scan.cuh"
#include "topk_list.cuh"

using namespace fs_scan;
using fs_list::merge_survivors;
using fs_list::warp_sort128_desc;

namespace {

constexpr int kTile = 2048;                       // slab rows per tile
constexpr int kGroupsPerTile = kTile / kGroup;    // 16
constexpr int kMaxK = 64;                         // the list fits kk <= 64
constexpr int kLdSt = kGroup + 4;                 // staged score row stride
constexpr int kLdL = kMaxK + 1;                   // list stride (64-bit words)
constexpr int kChunks = kGroup / 32;              // 32-row chunks per group
constexpr int kMergeQ = 2;  // queries a warp merges at once, their steps interleaved
constexpr int kF32 = 2;     // the `kind` of an f32 slab (0 f16, 1 bf16)

struct TopkSmem {
  union {
    GroupSmem g;                     // staging of score_group_with()
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

using ListRow = unsigned long long[kLdL];
using ScoreRow = float[kLdSt];

// The selection's three steps over one group's scores (staged[query][row],
// 128 rows, the live queries 0 .. live-1), shared by both list entries;
// the callers put the barriers between them. The steps of the first group:
// warp `warp` of `n_warps` sorts its queries' 128 keys into their lists.
__device__ __forceinline__ void select_first(const ScoreRow* staged, ListRow* list, int live, int kk,
                                             int warp, int n_warps, int lane) {
  for (int c = warp; c < live; c += n_warps) {  // round robin: a small batch still uses every warp
    unsigned long long v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float s = staged[c][e * 32 + lane];
      v[e] = s > -INFINITY ? make_key(s, e * 32 + lane) : 0ull;
    }
    warp_sort128_desc(v, lane);
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (e * 32 + lane < kk) list[c][e * 32 + lane] = v[e];
  }
}

// The filter of a later group (columns col0 ..): thread `tid` of
// `n_threads` takes (live query, 32-row chunk) pairs, 32 compares each,
// into pass[query][chunk].
__device__ __forceinline__ void select_filter(const ScoreRow* staged, const ListRow* list,
                                              unsigned (*pass)[kChunks], int live, int kk, int col0,
                                              int tid, int n_threads) {
  const int lane = tid & 31;
  for (int w = tid; w < live * kChunks; w += n_threads) {
    const int c = w / kChunks;
    const int ch = w % kChunks;
    const unsigned long long thr = list[c][kk - 1];
    const float thr_s = thr ? key_score_norm(thr) : -INFINITY;
    const float* row = staged[c] + ch * 32;
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
    pass[c][ch] = bits;
  }
}

// The merges of a later group: warp `warp` of `n_warps` packs its queries'
// survivors (pass) into slots (its own [kMergeQ][kGroup] rows), in column
// order, and merges them into the lists, kMergeQ queries at a time.
__device__ __forceinline__ void select_merge(const ScoreRow* staged, ListRow* list,
                                             const unsigned (*pass)[kChunks], unsigned char (*slots)[kGroup],
                                             int live, int kk, int col0, int warp, int n_warps, int lane) {
  const unsigned lanes_below = (1u << lane) - 1u;
  for (int c0 = warp; c0 < live; c0 += kMergeQ * n_warps) {
    unsigned long long* L[kMergeQ];
    int cq[kMergeQ], n[kMergeQ];
#pragma unroll
    for (int q = 0; q < kMergeQ; ++q) {
      cq[q] = c0 + q * n_warps;
      L[q] = list[min(cq[q], live - 1)];  // past the batch: n[q] = 0, the merge leaves it alone
      n[q] = 0;
      if (cq[q] >= live) continue;
#pragma unroll
      for (int ch = 0; ch < kChunks; ++ch) {
        const unsigned m = pass[cq[q]][ch];
        if ((m >> lane) & 1u) slots[q][n[q] + __popc(m & lanes_below)] = ch * 32 + lane;
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
        const int row = lane < nr[q] ? slots[q][r0 + lane] : 0;
        key[q] = lane < nr[q] ? make_key(staged[cq[q]][row], col0 + row) : 0ull;
      }
      merge_survivors<kMergeQ>(L, kk, key, nr, lane);
    }
  }
}

// The lists as the outputs: thread `tid` of `n_threads` writes (score,
// row) of slots j < kk of the live queries; an empty slot is column 0 at
// -inf.
__device__ __forceinline__ void write_lists(const ListRow* list, float* __restrict__ out_s,
                                            int32_t* __restrict__ out_i, int tile, int q0, int live, int b,
                                            int kk, int n_q, int tid, int n_threads) {
  const int64_t row_base = static_cast<int64_t>(tile) * kTile;
  for (int i = tid; i < kk * n_q; i += n_threads) {
    const int j = i / n_q;
    const int c = i % n_q;
    if (c >= live) continue;
    const unsigned long long k = list[c][j];
    const int64_t o = (static_cast<int64_t>(tile) * kk + j) * b + q0 + c;
    out_s[o] = k ? key_score(k) : -INFINITY;
    out_i[o] = static_cast<int32_t>(row_base + (k ? key_col(k) : 0));
  }
}

// The scores of one group (score_group_with) into epi.
template <int kKind, class Epilogue>
__device__ __forceinline__ void score_group(const void* q, const void* slab, const float* mask, int64_t row0,
                                            int q0, int b, int d, TopkSmem& sm, Epilogue&& epi) {
  score_group_with<kKind == 1>(static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(slab), mask, row0,
                               q0, b, d, sm.u.g, epi);
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
  const float* gmask = sm.u.g.mask;  // the group's staged mask
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

    if (lg == 0) {  // the first group fills the lists: sort its 128 keys
      select_first(sm.u.staged, sm.list, live, kk, warp, kWarps, lane);
    } else {
      select_filter(sm.u.staged, sm.list, sm.pass, live, kk, lg * kGroup, tid, kThreads);
      __syncthreads();
      select_merge(sm.u.staged, sm.list, sm.pass, sm.slots[warp], live, kk, lg * kGroup, warp, kWarps, lane);
    }
    __syncthreads();  // the next group's staging overwrites the score block
  }

  write_lists(sm.list, out_s, out_i, tile, q0, live, b, kk, kQTile, tid, kThreads);
}

// ---------------------------------------------------------------------------
// the f32 list entry: 8 scan warps and 12 selection warps, overlapped
// ---------------------------------------------------------------------------

constexpr int kScanWarps = 8;
constexpr int kSelWarps = 12;
// registers a thread of each role takes (setmaxnreg) at 64 queries, where
// the scan's 32 sums and operands need more than the launch bound's share
constexpr int kScanRegs = 128, kSelRegs = 72;
constexpr int kScanThreads = kScanWarps * 32;
constexpr int kSelThreads = kSelWarps * 32;
constexpr int kF32Threads = kScanThreads + kSelThreads;  // 640
constexpr int kCh = 32;               // dims per ring stage
constexpr int kLdR = kCh + 4;         // staged row stride (floats)
constexpr int kRingRows = kGroup * kLdR;  // floats of a stage's rows
// named barriers (0 is __syncthreads): the scan warps' ring, the selection
// warps' filter -> merge step, and per score buffer "full" (the scan
// arrives, the selection waits) and "empty" (the other way round)
constexpr int kBarScan = 1;
constexpr int kBarSel = 2;
constexpr int kBarFull = 3;   // + buffer
constexpr int kBarEmpty = 5;  // + buffer

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int kN>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kN) : "memory");
}

// The f32 entry's shared memory, in this order: lists, two score buffers,
// survivor masks and rows, the row ring (a stage: 128 rows x kLdR, then,
// without a resident query tile, the stage's query chunk), the resident
// query tile (n_q rows of d + 4 floats). Every part starts 16-byte aligned.
struct F32Layout {
  int n_q, stages;
  bool resident;
  __host__ __device__ constexpr size_t lists() const { return 0; }
  __host__ __device__ constexpr size_t scores() const { return lists() + sizeof(unsigned long long) * n_q * kLdL; }
  __host__ __device__ constexpr size_t pass() const { return scores() + sizeof(float) * 2 * n_q * kLdSt; }
  __host__ __device__ constexpr size_t slots() const { return pass() + sizeof(unsigned) * n_q * kChunks; }
  __host__ __device__ constexpr size_t ring() const { return slots() + kSelWarps * kMergeQ * kGroup; }
  __host__ __device__ constexpr int stage_floats() const { return kRingRows + (resident ? 0 : n_q * kLdR); }
  __host__ __device__ constexpr size_t qres() const { return ring() + sizeof(float) * stages * stage_floats(); }
  __host__ __device__ constexpr size_t bytes(int d) const {
    return qres() + (resident ? sizeof(float) * n_q * (d + 4) : 0);
  }
};

// The scan role (warps 0-7): scores the tile's 16 groups against the query
// tile and hands each group's scores + mask to the selection through score
// buffer g % 2. Warp w owns rows rw*16*kMT .. (+16*kMT) of a group (rw = w
// % kRW) against queries qw*8*kWN .. (qw = w / kRW); acc[mt][nt][c] is row
// 16mt + lane/4 (+8 for c >= 2) of those against query 8nt + 2(lane%4) +
// (c & 1), one fmaf chain over the dims in ascending order from +0.0.
template <int kNT, bool kRes, int kStages>
__device__ __forceinline__ void scan_role(const float* __restrict__ q, const float* __restrict__ slab,
                                          const float* __restrict__ mask, int64_t row_base, int q0, int live,
                                          int d, float* ring, const float* qres, float (*scores)[8 * kNT][kLdSt]) {
  constexpr int kQ = 8 * kNT;
  constexpr int kMT = kNT == 1 ? 1 : 2;       // 16-row slices a warp owns
  constexpr int kWN = kNT == 1 ? 1 : kNT / 2;  // 8-query slices a warp owns
  constexpr int kRW = kGroup / (16 * kMT);    // warps along the rows (8 or 4)
  static_assert(kRW * (kQ / (8 * kWN)) == kScanWarps, "8 scan warps cover a group x the query tile");
  constexpr F32Layout lay{kQ, kStages, kRes};
  constexpr int kStage = lay.stage_floats();
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = (warp % kRW) * 16 * kMT;
  const int c0 = (warp / kRW) * 8 * kWN;
  const int n_ch = d / kCh;
  const int total = kGroupsPerTile * n_ch;  // ring stages over the tile
  const int ldq = kRes ? d + 4 : kLdR;

  // stage `it` (group it / n_ch, dims (it % n_ch) * 32 ..) into its slot;
  // every thread commits one cp.async group per call, empty or not
  auto issue = [&](int it) {
    if (it < total) {
      float* st = ring + (it % kStages) * kStage;
      const int k0 = (it % n_ch) * kCh;
      const float* src = slab + (row_base + (it / n_ch) * kGroup) * d + k0;
      for (int i = tid; i < kGroup * (kCh / 4); i += kScanThreads) {
        const int r = i / (kCh / 4);
        const int c = (i % (kCh / 4)) * 4;
        cp_async16(st + r * kLdR + c, src + static_cast<int64_t>(r) * d + c);
      }
      if constexpr (!kRes) {  // rows past the batch stay stale: their scores are never read
        for (int i = tid; i < live * (kCh / 4); i += kScanThreads) {
          const int r = i / (kCh / 4);
          const int c = (i % (kCh / 4)) * 4;
          cp_async16(st + kRingRows + r * kLdR + c, q + static_cast<int64_t>(q0 + r) * d + k0 + c);
        }
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int it = 0; it < kStages - 1; ++it) issue(it);
  for (int grp = 0; grp < kGroupsPerTile; ++grp) {
    float m[kMT][2];  // the mask of the thread's rows
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) m[mt][h] = __ldg(mask + row_base + grp * kGroup + r0 + mt * 16 + g + 8 * h);
    float acc[kMT][kWN][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kWN; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.0f;

    for (int kc = 0; kc < n_ch; ++kc) {
      const int it = grp * n_ch + kc;
      cp_async_wait<kStages - 2>();    // this thread's copies of stage it have landed
      bar_sync(kBarScan, kScanThreads);  // everyone's have; stage it - 1 is consumed
      issue(it + kStages - 1);
      const float* rows = ring + (it % kStages) * kStage;
      const float* qs = kRes ? qres + kc * kCh : rows + kRingRows;
#pragma unroll
      for (int k = 0; k < kCh; k += 4) {
        float4 a[kMT][2];  // rows r0 + 16mt + g + 8h, dims k .. k+3
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            a[mt][h] = *reinterpret_cast<const float4*>(&rows[(r0 + mt * 16 + g + 8 * h) * kLdR + k]);
#pragma unroll
        for (int nt = 0; nt < kWN; ++nt) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float4 v = *reinterpret_cast<const float4*>(&qs[(c0 + nt * 8 + 2 * t + j) * ldq + k]);
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt)
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
    }

    // score + mask (the add K1 makes before its maximum) into buffer grp % 2
    const int buf = grp & 1;
    if (grp >= 2) bar_sync(kBarEmpty + buf, kF32Threads);  // the selection is done with group grp - 2
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kWN; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          scores[buf][c0 + nt * 8 + 2 * t + (c & 1)][r0 + mt * 16 + g + 8 * (c >> 1)] =
              acc[mt][nt][c] + m[mt][c >> 1];
    bar_arrive(kBarFull + buf, kF32Threads);
  }
  cp_async_wait<0>();
}

// The selection role (warps 8-19): group by group, as the scan hands them
// over, the first group's sort or a later group's filter and merges; then
// the outputs.
template <int kQ>
__device__ __forceinline__ void select_role(float (*scores)[kQ][kLdSt], ListRow* list, unsigned (*pass)[kChunks],
                                            unsigned char (*slots)[kMergeQ][kGroup], float* __restrict__ out_s,
                                            int32_t* __restrict__ out_i, int tile, int q0, int live, int b,
                                            int kk) {
  const int tid = threadIdx.x - kScanThreads;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  for (int grp = 0; grp < kGroupsPerTile; ++grp) {
    const int buf = grp & 1;
    bar_sync(kBarFull + buf, kF32Threads);  // also orders the lists of the previous group
    const ScoreRow* staged = scores[buf];
    if (grp == 0) {
      select_first(staged, list, live, kk, warp, kSelWarps, lane);
    } else {
      select_filter(staged, list, pass, live, kk, grp * kGroup, tid, kSelThreads);
      bar_sync(kBarSel, kSelThreads);
      select_merge(staged, list, pass, slots[warp], live, kk, grp * kGroup, warp, kSelWarps, lane);
    }
    __syncwarp();
    if (grp + 2 < kGroupsPerTile) bar_arrive(kBarEmpty + buf, kF32Threads);  // the scan may refill it
  }
  bar_sync(kBarSel, kSelThreads);
  write_lists(list, out_s, out_i, tile, q0, live, b, kk, kQ, tid, kSelThreads);
}

template <int kNT, bool kRes, int kStages>
__global__ void __launch_bounds__(kF32Threads, 1)
tile_topk_f32_kernel(const float* __restrict__ q,     // (b, d)
                     const float* __restrict__ slab,  // (n, d)
                     const float* __restrict__ mask,  // (n,) additive
                     float* __restrict__ out_s,       // (n_tiles, kk, b)
                     int32_t* __restrict__ out_i,     // (n_tiles, kk, b)
                     int b, int d, int kk, int n_qtiles) {
  constexpr int kQ = 8 * kNT;
  constexpr F32Layout lay{kQ, kStages, kRes};
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto* list = reinterpret_cast<ListRow*>(smem_raw + lay.lists());
  auto* scores = reinterpret_cast<float (*)[kQ][kLdSt]>(smem_raw + lay.scores());
  auto* pass = reinterpret_cast<unsigned (*)[kChunks]>(smem_raw + lay.pass());
  auto* slots = reinterpret_cast<unsigned char (*)[kMergeQ][kGroup]>(smem_raw + lay.slots());
  auto* ring = reinterpret_cast<float*>(smem_raw + lay.ring());
  auto* qres = reinterpret_cast<float*>(smem_raw + lay.qres());

  const int tile = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * kQ;
  const int live = min(kQ, b - q0);
  if constexpr (kRes) {  // the query tile, once per block (rows past the batch: zeros)
    const int vecs = d / 4;
    for (int i = threadIdx.x; i < kQ * vecs; i += kF32Threads) {
      const int r = i / vecs;
      const int c = (i % vecs) * 4;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (r < live) v = __ldg(reinterpret_cast<const float4*>(q + static_cast<int64_t>(q0 + r) * d + c));
      *reinterpret_cast<float4*>(&qres[r * (d + 4) + c]) = v;
    }
    __syncthreads();
  }
  if (threadIdx.x < kScanThreads) {
    if constexpr (kNT == 8) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kScanRegs));
    scan_role<kNT, kRes, kStages>(q, slab, mask, static_cast<int64_t>(tile) * kTile, q0, live, d, ring, qres,
                                  scores);
  } else {
    if constexpr (kNT == 8) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kSelRegs));
    select_role<kQ>(scores, list, pass, slots, out_s, out_i, tile, q0, live, b, kk);
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

// Launches a K5 kernel (operands of type T) with `smem` bytes of dynamic
// shared memory.
template <class T>
int launch(void (*kernel)(const T*, const T*, const float*, float*, int32_t*, int, int, int, int), unsigned blocks,
           int threads, size_t smem, cudaStream_t s, const void* q, const void* slab, const void* mask, void* out_s,
           void* out_i, int b, int d, int kk, int per_tile) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, threads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(slab), static_cast<const float*>(mask),
      static_cast<float*>(out_s), static_cast<int32_t*>(out_i), b, d, kk, per_tile);
  return static_cast<int>(cudaGetLastError());
}

constexpr size_t kSmemMax = 232448;  // dynamic shared memory a block may take (227 KB)

// The f32 list entry at a query tile of 8 * kNT: the query tile resident
// in shared memory where it fits (3 ring stages at 64 queries, 4 below),
// else staged with each chunk of rows (4 stages).
template <int kNT>
int launch_f32(const void* q, const void* slab, const void* mask, void* out_s, void* out_i, int b, int d,
               long long n_tiles, int kk, cudaStream_t s) {
  constexpr int kQ = 8 * kNT;
  constexpr int kResStages = kNT == 8 ? 3 : 4;
  const long long n_qtiles = (b + kQ - 1) / kQ;
  const long long blocks = n_tiles * n_qtiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(blocks);
  const int per_tile = static_cast<int>(n_qtiles);
  const size_t resident = F32Layout{kQ, kResStages, true}.bytes(d);
  if (resident <= kSmemMax)
    return launch(
        tile_topk_f32_kernel<kNT, true, kResStages>, grid, kF32Threads, resident, s, q, slab, mask, out_s, out_i,
        b, d, kk, per_tile);
  return launch(
      tile_topk_f32_kernel<kNT, false, 4>, grid, kF32Threads, F32Layout{kQ, 4, false}.bytes(d), s, q, slab, mask,
      out_s, out_i, b, d, kk, per_tile);
}

}  // namespace

// q: (b, d) of the slab's dtype, slab: (n, d) f16 (kind 0), bf16 (kind 1)
// or f32 (kind 2), mask: (n,) f32, out_s / out_i: (n / 2048, kk, b) f32 /
// int32. Needs n % 2048 == 0, d % 64 == 0, 1 <= kk <= 64, b >= 1 and
// 16-byte aligned pointers (the Python wrapper checks all of these). An
// f32 slab takes the smallest query tile of 8, 16, 32, 64 that holds b.
// Returns cudaGetLastError() after the launch.
extern "C" int fs_tile_topk(const void* q, const void* slab, const void* mask,
                            void* out_s, void* out_i, int b, int d, long long n,
                            int kk, int kind, void* stream) {
  if (b < 1 || d < kChunk || d % kChunk != 0 || n < kTile || n % kTile != 0 ||
      kk < 1 || kk > kMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == kF32) {
    if (b <= 8) return launch_f32<1>(q, slab, mask, out_s, out_i, b, d, n / kTile, kk, s);
    if (b <= 16) return launch_f32<2>(q, slab, mask, out_s, out_i, b, d, n / kTile, kk, s);
    if (b <= 32) return launch_f32<4>(q, slab, mask, out_s, out_i, b, d, n / kTile, kk, s);
    return launch_f32<8>(q, slab, mask, out_s, out_i, b, d, n / kTile, kk, s);
  }
  const long long n_qtiles = (b + kQTile - 1) / kQTile;
  const long long blocks = n / kTile * n_qtiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(TopkSmem);
  const unsigned grid = static_cast<unsigned>(blocks);
  const int per_tile = static_cast<int>(n_qtiles);
  if (kind == 1)
    return launch(tile_topk_kernel<1>, grid, kThreads, smem, s, q,
                                                               slab, mask, out_s, out_i, b, d, kk, per_tile);
  return launch(tile_topk_kernel<0>, grid, kThreads, smem, s, q,
                                                              slab, mask, out_s, out_i, b, d, kk, per_tile);
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
    return launch(tile_topk_wide_kernel<kF32>, grid, kWThreads, smem,
                                                                s, q, slab, mask, out_s, out_i, b, d, kk, per_tile);
  if (kind == 1)
    return launch(tile_topk_wide_kernel<1>, grid, kWThreads, smem, s, q,
                                                             slab, mask, out_s, out_i, b, d, kk, per_tile);
  return launch(tile_topk_wide_kernel<0>, grid, kWThreads, smem, s, q,
                                                           slab, mask, out_s, out_i, b, d, kk, per_tile);
}

// The sorted top-k lists of K5 (tile_topk.cu) and of the IVF probe
// (ivf_probe.cu): a descending list of at most 64 unique 64-bit keys in
// shared memory, which a warp fills from its first 128 keys (a bitonic
// sort) and merges later survivors into. The keys' meaning (score and
// column) is the caller's: these only compare them, and 0 is the empty
// slot below every key.

#pragma once

#include <cuda_runtime.h>

namespace fs_list {

constexpr int kListMax = 64;  // the longest list merge_survivors keeps

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
// of kk keys, keeping the top kk; a query without survivors is left alone
// (its L[q] need not be a list). A survivor's place is its rank among the
// survivors plus the list keys above it, a list key's is its index plus
// the survivors above it (the list keys above a survivor: a binary search
// over the list, in lanes). The queries' steps are independent and
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
    const bool any = nr[q] > 0;
    e0[q] = any && lane < kk ? L[q][lane] : 0ull;
    e1[q] = any && lane + 32 < kk ? L[q][lane + 32] : 0ull;
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
  for (int step = 0; step < 7; ++step) {  // 2^7 > kListMax
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
    if (nr[q] == 0) continue;
    if (lane < nr[q] && rank[q] + lo[q] < kk) L[q][rank[q] + lo[q]] = key[q];
    if (lane < kk && lane + add0[q] < kk) L[q][lane + add0[q]] = e0[q];
    if (lane + 32 < kk && lane + 32 + add1[q] < kk) L[q][lane + 32 + add1[q]] = e1[q];
  }
  __syncwarp();
}

}  // namespace fs_list

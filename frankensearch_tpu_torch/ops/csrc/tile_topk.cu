// K5: per-tile top-k of the slab scan scores, for sm_90a.
//
// Replaces the TPU kernel frankensearch_tpu/ops/topk_scan.py
// `_tile_topk_kernel` (the pallas_call in `scan_topk_pallas`). For each
// 2048-row tile T of the slab and each query b it scores
//
//     s[r] = dot(bf16(q[b]), slab[T*2048 + r]) + mask[T*2048 + r]
//
// (bf16 or f16 products, f32 sums) and then runs kk argmax passes: pass j
// takes the FIRST column whose score equals the maximum (so -0.0 and +0.0
// tie, as in `jnp.argmax`), writes its score to out_s[T, j, b] and its slab
// row to out_i[T, j, b], and knocks the column out with -inf. Once every
// column is -inf the pass takes column 0 again, as the TPU kernel does; the
// caller turns those -inf entries into row -1.
//
// What bounds it on the H100: the scan reads the slab once (1M x 256 bf16:
// 516 MB, 0.154 ms at 3.35 TB/s; its 134 G bf16 operations take 0.136 ms at
// 989 TFLOP/s). The kk selection passes are extra work on top, on scores
// held in shared memory, that the bound does not count.
//
// Design (correct and simple first):
//   * one block = one 2048-row tile x a chunk of 16 queries, 8 warps;
//     blocks of one tile are adjacent, so the tile comes from HBM once;
//   * the chunk's queries sit in shared memory; each warp scores 256 rows
//     with mma.sync m16n8k16 (A fragments loaded straight from the slab,
//     every 32-byte sector used whole), and writes score + mask into a
//     (16 x 2048) f32 block of dynamic shared memory (128 KB, rows padded);
//   * each warp then selects for 2 queries: every lane keeps the best
//     (score, first column) of its 64 strided columns, a shuffle reduction
//     picks the warp's, and only the lane that owned the winner rescans
//     its columns for the next pass.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 2048;             // slab rows per tile
constexpr int kQChunk = 16;             // queries per block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kTile / kWarps;  // 256
constexpr int kPerLane = kTile / 32;          // 64 columns per lane
// score row stride: + 4 floats, so the 4 query rows one mma fragment
// writes to fall in different banks
constexpr int kLdS = kTile + 4;

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
  for (int i = 0; i < kPerLane; ++i) {
    const float x = s[lane + 32 * i];
    if (x > v) {
      v = x;
      c = lane + 32 * i;
    }
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
tile_topk_kernel(const uint16_t* __restrict__ q,     // (b, d) slab dtype
                 const uint16_t* __restrict__ slab,  // (n, d)
                 const float* __restrict__ mask,     // (n,) additive
                 float* __restrict__ out_s,          // (n_tiles, kk, b)
                 int32_t* __restrict__ out_i,        // (n_tiles, kk, b)
                 int b, int d, int kk, int n_qchunks) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_scores = reinterpret_cast<float*>(smem);  // [kQChunk][kLdS]
  uint16_t* s_q = reinterpret_cast<uint16_t*>(s_scores + kQChunk * kLdS);
  const int ldq = d + 8;  // padded query row stride (bank-conflict free)

  const int tile = blockIdx.x / n_qchunks;
  const int q0 = (blockIdx.x % n_qchunks) * kQChunk;
  const int64_t row_base = static_cast<int64_t>(tile) * kTile;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  for (int i = tid; i < kQChunk * (d / 2); i += kThreads) {
    const int r = i / (d / 2);
    const int c = (i % (d / 2)) * 2;
    uint32_t v = 0u;
    if (q0 + r < b) v = *reinterpret_cast<const uint32_t*>(q + static_cast<int64_t>(q0 + r) * d + c);
    *reinterpret_cast<uint32_t*>(&s_q[r * ldq + c]) = v;
  }
  __syncthreads();

  // scores: each warp 256 rows, 32 rows (2 mma row tiles) x 16 queries at a time
  for (int r32 = 0; r32 < kRowsPerWarp; r32 += 32) {
    float acc[2][2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.0f;
    const int64_t rbase = row_base + warp * kRowsPerWarp + r32;
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
        const int r = warp * kRowsPerWarp + r32 + mt * 16 + g + 8 * half;
        const float m = mask[row_base + r];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            s_scores[(nt * 8 + 2 * t + j) * kLdS + r] = acc[mt][nt][2 * half + j] + m;
      }
    }
  }
  __syncthreads();

  // selection: warp w serves queries 2w and 2w+1 of the chunk
  for (int ql = warp * 2; ql < warp * 2 + 2; ++ql) {
    const int qi = q0 + ql;
    if (qi >= b) break;
    float* s = s_scores + ql * kLdS;
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

}  // namespace

// q: (b, d) bf16/f16, slab: (n, d) same dtype, mask: (n,) f32, out_s /
// out_i: (n / 2048, kk, b) f32 / int32. Needs n % 2048 == 0, d % 16 == 0,
// d <= 2048, 1 <= kk <= 2048, b >= 1 and 4-byte aligned pointers (the
// Python wrapper checks all of these). Returns cudaGetLastError() after the
// launch.
extern "C" int fs_tile_topk(const void* q, const void* slab, const void* mask,
                            void* out_s, void* out_i, int b, int d, long long n,
                            int kk, int is_bf16, void* stream) {
  if (b < 1 || d < 16 || d % 16 != 0 || d > 2048 || n < kTile || n % kTile != 0 ||
      kk < 1 || kk > kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_tiles = n / kTile;
  const long long n_qchunks = (b + kQChunk - 1) / kQChunk;
  const long long blocks = n_tiles * n_qchunks;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(kQChunk) * kLdS * sizeof(float) +
                      static_cast<size_t>(kQChunk) * (d + 8) * sizeof(uint16_t);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const uint16_t*>(q);
  const auto* sp = static_cast<const uint16_t*>(slab);
  const auto* mp = static_cast<const float*>(mask);
  auto* osp = static_cast<float*>(out_s);
  auto* oip = static_cast<int32_t*>(out_i);
  cudaError_t err;
  if (is_bf16) {
    err = cudaFuncSetAttribute(tile_topk_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    tile_topk_kernel<true><<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
        qp, sp, mp, osp, oip, b, d, kk, static_cast<int>(n_qchunks));
  } else {
    err = cudaFuncSetAttribute(tile_topk_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    tile_topk_kernel<false><<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
        qp, sp, mp, osp, oip, b, d, kk, static_cast<int>(n_qchunks));
  }
  return static_cast<int>(cudaGetLastError());
}

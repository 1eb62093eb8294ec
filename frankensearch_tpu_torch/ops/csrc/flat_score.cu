// K3: one length class of the flat BM25 lane, scored and reduced in one
// pass, for sm_90a.
//
// Replaces the TPU kernel frankensearch_tpu/lexical/device_bm25.py
// `_flat_score_kernel` (the pallas_call in `_flat_class_scores_pallas`,
// reached from `_graded_scan_flat`) together with the post-pass the
// reference runs on its output, `_flat_class_poststats` ->
// `_flat_hot_mask_stats` (the reference fuses that epilogue into the scoring
// step only on its XLA path, `_flat_class_fused_xla`). For block p of the
// class, query b, slot d and 128-slot group g:
//
//   raw[p, b, d]    = sum_l sum_j qw[b, j] * tf[p, l, d] * (term[p, l, d] == qi[b, j])
//   s               = raw + hot[b, off + p * d_pad + d]      (if a hot partial is given)
//   scores[p, b, d] = dmap[p, d] >= 0 ? s : -inf
//   gmax[p, b, g]   = max of scores[p, b, g*128 .. g*128+127]
//   grow[p, b, g]   = dmap[p, g*128 + the lowest lane whose score == gmax]
//
// raw is summed from +0.0f with l outer and j inner, one rounded product
// and one rounded add per hit (`__fmul_rn`/`__fadd_rn`, never contracted
// into a fused multiply-add), then one rounded add of the hot element: the
// order of the plain twin (`flat_class_fused_plain`), so the two agree bit
// for bit. A miss adds nothing instead of +0.0f, which changes no bit: every
// addend is a product of non-negative values, so the sum never reaches
// -0.0f. An all -inf group's row is lane 0's, as the twin's first-max rule
// gives.
//
// What bounds it on the H100: bytes. Each slot's term and tf words are read
// once per query tile, the hot slice once, and the masked scores written
// once; the raw scores never reach device memory (the two-pass form wrote
// them, then read and rewrote matrices of the same size several times).
// The naive compare count, B * T per (l, slot), is larger than the bytes'
// time at the INT32 rate; the filter below leaves one probe per (l, slot)
// and the compares of the few slots whose term a query of the tile holds.
//
// Design:
//   * a block owns up to 64 query rows (fewer when T is large, so their ids
//     and weights fit shared memory) and walks the class's 128-slot groups
//     (grid-stride), 4 warps, warp w on slots 32w .. 32w+31 of the group;
//   * a bitset of the block's query term ids (32,768 bits, hashed, built
//     once per block with integer atomicOr) filters each (l, slot): a lane
//     whose term can match raises a ballot bit, and the warp then runs the
//     hit through every query row, lane = row, T compares each, adding into
//     a (rows x 128) f32 block in shared memory. Hits go in lane order
//     within an l and l ascending, so each cell sees its adds in (l, j)
//     order;
//   * the epilogue (warp w on 4 rows at a time, their hot loads in flight
//     together): add the hot slice, mask, write the scores with coalesced
//     stores, and reduce each row's 128 slots to (max, row of the lowest
//     lane equal to it) with shuffles.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kSlots = 128;          // slots per group
constexpr int kWarps = kSlots / 32;  // 4
constexpr int kThreads = kWarps * 32;
constexpr int kMaxRows = 64;         // query rows per block
constexpr int kLdAcc = kSlots + 1;   // accumulator row stride (bank-conflict free)
constexpr int kBitsLog2 = 15;        // filter bitset: 32,768 bits
constexpr int kBitWords = (1 << kBitsLog2) / 32;
constexpr int kIdBudget = 4096;      // (id, weight) pairs a block stages
constexpr int kLUnroll = 4;          // (l, slot) words loaded ahead
constexpr int kRowBatch = 4;         // epilogue rows per warp step

__device__ __forceinline__ unsigned filter_bit(int32_t t) {
  return (static_cast<unsigned>(t) * 2654435761u) >> (32 - kBitsLog2);
}

__global__ void __launch_bounds__(kThreads)
flat_fused_kernel(const int32_t* __restrict__ qi,    // (b, t_q)
                  const float* __restrict__ qw,      // (b, t_q)
                  const int32_t* __restrict__ term,  // (n_c, l_c, d_pad)
                  const float* __restrict__ tf,      // (n_c, l_c, d_pad)
                  const float* __restrict__ hot,     // (b, ld_hot) or null
                  const int32_t* __restrict__ dmap,  // (n_c, d_pad)
                  float* __restrict__ out,           // (n_c, b, d_pad)
                  float* __restrict__ gmax,          // (n_c, b, gc)
                  int32_t* __restrict__ grow,        // (n_c, b, gc)
                  int n_c, int l_c, int d_pad, int b, int t_q, int ldt, int rows_per_block,
                  long long ld_hot, long long off) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* s_bits = reinterpret_cast<unsigned*>(smem);                    // kBitWords
  float* s_acc = reinterpret_cast<float*>(s_bits + kBitWords);             // rows x kLdAcc
  int32_t* s_ids = reinterpret_cast<int32_t*>(s_acc + rows_per_block * kLdAcc);  // rows x ldt
  float* s_w = reinterpret_cast<float*>(s_ids + rows_per_block * ldt);     // rows x ldt

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b0 = blockIdx.y * rows_per_block;
  const int rows = min(rows_per_block, b - b0);
  const int gc = d_pad / kSlots;

  for (int i = tid; i < kBitWords; i += kThreads) s_bits[i] = 0u;
  for (int i = tid; i < rows_per_block * kLdAcc; i += kThreads) s_acc[i] = 0.0f;
  __syncthreads();
  for (int i = tid; i < rows * t_q; i += kThreads) {
    const int r = i / t_q;
    const int j = i % t_q;
    const int32_t id = qi[static_cast<int64_t>(b0 + r) * t_q + j];
    s_ids[r * ldt + j] = id;
    s_w[r * ldt + j] = qw[static_cast<int64_t>(b0 + r) * t_q + j];
    const unsigned h = filter_bit(id);
    atomicOr(&s_bits[h >> 5], 1u << (h & 31));
  }
  __syncthreads();

  const long long n_groups = static_cast<long long>(n_c) * gc;
  for (long long gi = blockIdx.x; gi < n_groups; gi += gridDim.x) {
    const int p = static_cast<int>(gi / gc);
    const int g = static_cast<int>(gi % gc);
    const int dl = warp * 32 + lane;  // this lane's slot in the group
    const int64_t col = static_cast<int64_t>(g) * kSlots + dl;
    const int64_t base = static_cast<int64_t>(p) * l_c * d_pad + col;

    for (int l0 = 0; l0 < l_c; l0 += kLUnroll) {
      int32_t tt[kLUnroll];
      float ff[kLUnroll];
#pragma unroll
      for (int u = 0; u < kLUnroll; ++u) {
        tt[u] = -1;
        ff[u] = 0.0f;
        if (l0 + u < l_c) {
          tt[u] = __ldg(term + base + static_cast<int64_t>(l0 + u) * d_pad);
          ff[u] = __ldg(tf + base + static_cast<int64_t>(l0 + u) * d_pad);
        }
      }
#pragma unroll
      for (int u = 0; u < kLUnroll; ++u) {
        bool maybe = false;
        if (tt[u] >= 0) {  // slot padding (term -1, tf 0) matches no query term
          const unsigned h = filter_bit(tt[u]);
          maybe = (s_bits[h >> 5] >> (h & 31)) & 1u;
        }
        for (unsigned m = __ballot_sync(0xffffffffu, maybe); m; m &= m - 1) {
          const int src = __ffs(static_cast<int>(m)) - 1;
          const int32_t t = __shfl_sync(0xffffffffu, tt[u], src);
          const float f = __shfl_sync(0xffffffffu, ff[u], src);
          const int slot = warp * 32 + src;
          for (int r = lane; r < rows; r += 32) {
            const int32_t* ids = s_ids + r * ldt;
            const float* w = s_w + r * ldt;
            float a = s_acc[r * kLdAcc + slot];
            for (int j = 0; j < t_q; ++j)
              if (ids[j] == t) a = __fadd_rn(a, __fmul_rn(w[j], f));
            s_acc[r * kLdAcc + slot] = a;
          }
        }
      }
    }
    __syncthreads();

    int32_t dm[kSlots / 32];
    const int32_t* dmp = dmap + static_cast<int64_t>(p) * d_pad + static_cast<int64_t>(g) * kSlots;
#pragma unroll
    for (int i = 0; i < kSlots / 32; ++i) dm[i] = __ldg(dmp + lane + 32 * i);
    const int64_t hoff = off + static_cast<int64_t>(p) * d_pad + static_cast<int64_t>(g) * kSlots;
    for (int r0 = warp * kRowBatch; r0 < rows; r0 += kWarps * kRowBatch) {
      float hv[kRowBatch][kSlots / 32];  // the batch's hot loads, all in flight at once
#pragma unroll
      for (int rr = 0; rr < kRowBatch; ++rr)
#pragma unroll
        for (int i = 0; i < kSlots / 32; ++i)
          hv[rr][i] = hot && r0 + rr < rows ? __ldg(hot + (b0 + r0 + rr) * ld_hot + hoff + lane + 32 * i) : 0.0f;
#pragma unroll
      for (int rr = 0; rr < kRowBatch; ++rr) {
        const int r = r0 + rr;
        if (r >= rows) break;
        const int64_t rb = b0 + r;
        const int64_t orow = (static_cast<int64_t>(p) * b + rb) * d_pad + static_cast<int64_t>(g) * kSlots;
        float v[kSlots / 32];
        float m = -INFINITY;
#pragma unroll
        for (int i = 0; i < kSlots / 32; ++i) {
          float* a = s_acc + r * kLdAcc + lane + 32 * i;
          float sc = *a;
          *a = 0.0f;  // ready for the next group
          if (hot) sc = __fadd_rn(sc, hv[rr][i]);
          v[i] = dm[i] >= 0 ? sc : -INFINITY;
          out[orow + lane + 32 * i] = v[i];
          m = fmaxf(m, v[i]);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
        int first = kSlots;
#pragma unroll
        for (int i = kSlots / 32 - 1; i >= 0; --i)
          if (v[i] == m) first = lane + 32 * i;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) first = min(first, __shfl_xor_sync(0xffffffffu, first, o));
        int32_t mine = dm[0];
#pragma unroll
        for (int i = 1; i < kSlots / 32; ++i)
          if ((first >> 5) == i) mine = dm[i];
        const int32_t row = __shfl_sync(0xffffffffu, mine, first & 31);
        if (lane == 0) {
          const int64_t o = (static_cast<int64_t>(p) * b + rb) * gc + g;
          gmax[o] = m;
          grow[o] = row;
        }
      }
    }
    __syncthreads();  // the accumulators are zero again
  }
}

}  // namespace

// qi / qw: (b, t_q) int32 / f32; term / tf: (n_c, l_c, d_pad) int32 / f32;
// hot: (b, ld_hot) f32 whose columns off .. off + n_c * d_pad - 1 are this
// class's slots, or null; dmap: (n_c, d_pad) int32 rows, -1 on padding;
// out: (n_c, b, d_pad) f32; gmax / grow: (n_c, b, d_pad / 128) f32 / int32;
// all contiguous on one device. Needs d_pad % 128 == 0 and t_q <= 4095 (the
// wrapper checks both). Returns cudaGetLastError() after the launch.
extern "C" int fs_flat_fused(const void* qi, const void* qw, const void* term, const void* tf,
                             const void* hot, long long ld_hot, long long off, const void* dmap,
                             void* out, void* gmax, void* grow, int n_c, int l_c, int d_pad,
                             int b, int t_q, void* stream) {
  if (n_c < 1 || l_c < 1 || b < 1 || t_q < 1 || d_pad < kSlots || d_pad % kSlots != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ldt = t_q | 1;  // odd stride: lanes on consecutive rows hit distinct banks
  if (ldt > kIdBudget) return static_cast<int>(cudaErrorInvalidValue);
  const int rows_per_block = std::min(kMaxRows, kIdBudget / ldt);
  const int row_tiles = (b + rows_per_block - 1) / rows_per_block;
  if (row_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(kBitWords) * sizeof(unsigned) +
                      static_cast<size_t>(rows_per_block) * kLdAcc * sizeof(float) +
                      static_cast<size_t>(rows_per_block) * ldt * (sizeof(int32_t) + sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(flat_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // one wave of resident blocks; each walks the class's groups grid-stride
  // (the occupancy query is kept per device and shared-memory size)
  static thread_local int cached_dev = -1, cached_blocks = 0;
  static thread_local size_t cached_smem = 0;
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if (dev != cached_dev || smem != cached_smem) {
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, flat_fused_kernel, kThreads,
                                                             smem)) != cudaSuccess)
      return static_cast<int>(err);
    cached_dev = dev;
    cached_smem = smem;
    cached_blocks = std::max(per_sm, 1) * sms;
  }
  const long long n_groups = static_cast<long long>(n_c) * (d_pad / kSlots);
  const long long per_row_tile = (static_cast<long long>(cached_blocks) + row_tiles - 1) / row_tiles;
  const unsigned gx = static_cast<unsigned>(n_groups < per_row_tile ? n_groups : per_row_tile);
  flat_fused_kernel<<<dim3(gx, static_cast<unsigned>(row_tiles)), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(qi), static_cast<const float*>(qw),
      static_cast<const int32_t*>(term), static_cast<const float*>(tf),
      static_cast<const float*>(hot), static_cast<const int32_t*>(dmap), static_cast<float*>(out),
      static_cast<float*>(gmax), static_cast<int32_t*>(grow), n_c, l_c, d_pad, b, t_q, ldt,
      rows_per_block, ld_hot, off);
  return static_cast<int>(cudaGetLastError());
}

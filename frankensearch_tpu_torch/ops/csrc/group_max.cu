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
// What bounds it on the H100: at the headline shape (1,007,616 x 256 bf16
// slab, B = 256) it reads 516 MB (0.158 ms at 3.35 TB/s) and does 132 G
// bf16 operations (0.134 ms at 989 TFLOP/s): it sits near the bf16 ridge,
// so the slab has to stream from HBM once while the tensor cores run near
// their full rate, which on this card only wgmma reaches. The first port
// (one block per group x 64 queries, mma.sync, synchronous staging) lost
// 5x to that bound: copy and compute never overlapped, and each group's
// rows and each query tile were restaged through L2 for every block.
//
// Design:
//   * a persistent grid, one block per SM; each block walks a contiguous
//     run of (query tile, group) items, query tile major;
//   * the query tile stays resident in shared memory (N queries x d, up to
//     128 KB; N is the smallest of 8 .. 256 that holds B, halved until the
//     tile fits), loaded by TMA once per block and query tile;
//   * one producer warp keeps a ring of 128-row x 64-dim slab stages (16
//     KB, 4 to 8 of them) in flight with 2-D TMA loads (128-byte swizzle,
//     the layout wgmma reads) and mbarriers;
//   * two consumer warpgroups run wgmma m64nNk16 (f32 accumulators, rows
//     0-63 and 64-127 of the group), k16 steps in ascending order, and
//     release each stage as its products retire;
//   * the epilogue adds the mask in f32, takes the max over the thread's
//     two rows, then a reduce-scatter over the 8 lanes that share columns
//     (each shuffle round halves the columns a lane holds), then across
//     the 8 warps through shared memory (bank-swizzled);
//   * each column's maxima are buffered for 8 consecutive groups and
//     written as one span per query, not as scattered 4-byte stores.
// A query's row does not depend on N or on its place in the tile: each
// output element is its own dot product, summed in the same k order.
//
// The tensor maps are encoded on the host for every call
// (cuTensorMapEncodeTiled, fetched through cudaGetDriverEntryPoint: the
// library links no libcuda) and passed as __grid_constant__ parameters.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

using namespace fs_hopper;

namespace {

constexpr int kGroup = 128;                     // rows per group
constexpr int kChunk = 64;                      // dims per stage (one 128-byte swizzle row)
constexpr int kStageBytes = kGroup * kChunk * 2;
constexpr int kConsumerWarps = 8;               // two warpgroups
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kThreads = kConsumers + 32;       // + the producer warp
constexpr int kMaxStages = 8;
constexpr int kFlush = 8;                       // groups buffered per column
constexpr int kObufLd = kFlush + 1;             // padded: no bank conflicts
constexpr int kQBudget = 128 * 1024;            // resident query tile, bytes
constexpr int kSmemMax = 232448;                // 227 KB a block may use
constexpr int kMaxN = 256;

// Column c's slot in a warp's row of the reduction buffer: an XOR within
// each 32-column block, so that the 32 lanes of a warp, which hold the
// same register of 8 column groups x 4 lane columns, hit 32 banks.
__device__ __forceinline__ int red_slot(int c) {
  const int g = (c >> 5) & 7;
  return c ^ ((g & 1) | ((g >> 1) << 3));
}

// Value i of the thread's column list: accumulator 4*(i/2) + i%2 (row
// pair already folded in by the epilogue), column 8*(i/2) + 2t + i%2.
__device__ __forceinline__ constexpr int pos(int i) { return 4 * (i / 2) + (i & 1); }

// One round of the reduce-scatter over lanes `m` apart: a list of kW >= 2
// values keeps half (the upper half on the lane whose bit m is set) and
// takes the partner's max for it; a single value takes the plain max.
template <int kW, int kR>
__device__ __forceinline__ void colmax_round(float (&acc)[kR], int lane, int m) {
  if constexpr (kW >= 2) {
    const bool up = (lane & m) != 0;
#pragma unroll
    for (int i = 0; i < kW / 2; ++i) {
      const float lo = acc[pos(i)], hi = acc[pos(kW / 2 + i)];
      acc[pos(i)] = fmaxf(up ? hi : lo, __shfl_xor_sync(0xffffffffu, up ? lo : hi, m));
    }
  } else {
    acc[pos(0)] = fmaxf(acc[pos(0)], __shfl_xor_sync(0xffffffffu, acc[pos(0)], m));
  }
}

template <bool kBf16, int kN>
__global__ void __launch_bounds__(kThreads, 1)
group_max_kernel(const __grid_constant__ CUtensorMap slab_map,  // (n, d), box 64 x 128
                 const __grid_constant__ CUtensorMap q_map,     // (b, d), box 64 x kN
                 const float* __restrict__ mask,                // (n,) additive
                 float* __restrict__ out,                       // (b, n_groups)
                 int b, int n_chunks, int n_groups, int n_items, int stages) {
  constexpr int kR = kN / 2;  // accumulators a thread
  constexpr int kV = kN / 4;  // columns a thread holds after folding its two rows
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* q_s = smem;                                        // n_chunks x [kN][64]
  uint8_t* ring = q_s + n_chunks * kN * 128;                  // stages x [128][64]
  float* red = reinterpret_cast<float*>(ring + stages * kStageBytes);  // [2][8][kN]
  float* obuf = red + 2 * kConsumerWarps * kN;                // [kN][kObufLd]
  uint64_t* full = reinterpret_cast<uint64_t*>(obuf + kN * kObufLd);
  uint64_t* empty = full + stages;
  uint64_t* q_full = empty + stages;
  uint64_t* q_empty = q_full + 1;

  const int item0 = static_cast<int>(static_cast<long long>(blockIdx.x) * n_items / gridDim.x);
  const int item1 = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * n_items / gridDim.x);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumerWarps);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // the producer
    if (lane != 0) return;
    int stage = 0, loads = 0, cur_nt = -1;
    uint32_t phase = 0;
    for (int it = item0; it < item1; ++it) {
      const int nt = it / n_groups, grp = it % n_groups;
      if (nt != cur_nt) {
        if (loads > 0) mbar_wait(q_empty, (loads - 1) & 1);  // the old tile's products retired
        mbar_arrive_expect_tx(q_full, n_chunks * kN * 128);
        for (int kc = 0; kc < n_chunks; ++kc) tma_load_2d(q_s + kc * kN * 128, &q_map, kc * kChunk, nt * kN, q_full);
        cur_nt = nt;
        ++loads;
      }
      for (int kc = 0; kc < n_chunks; ++kc) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_arrive_expect_tx(&full[stage], kStageBytes);
        tma_load_2d(ring + stage * kStageBytes, &slab_map, kc * kChunk, grp * kGroup, &full[stage]);
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg scores rows 64*wg .. 64*wg+63 of each group
  const int wg = warp >> 2;
  const int t = lane & 3;
  const int r_lo = wg * 64 + (warp & 3) * 16 + (lane >> 2);  // and r_lo + 8
  float acc[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) acc[i] = 0.0f;
  int stage = 0, loads = 0, cur_nt = -1, slot = 0, g_first = 0, buf = 0;
  uint32_t phase = 0;

  auto flush = [&](int nt) {
    const int c = threadIdx.x;
    const int qi = nt * kN + c;
    if (c < kN && qi < b) {
      float* dst = out + static_cast<int64_t>(qi) * n_groups + g_first;
      for (int s = 0; s < slot; ++s) dst[s] = obuf[c * kObufLd + s];
    }
    slot = 0;
  };

  for (int it = item0; it < item1; ++it) {
    const int nt = it / n_groups, grp = it % n_groups;
    if (nt != cur_nt) {
      if (cur_nt >= 0) {
        flush(cur_nt);
        if (lane == 0) mbar_arrive(q_empty);
      }
      mbar_wait(q_full, loads & 1);
      ++loads;
      cur_nt = nt;
    }
    if (slot == 0) g_first = grp;
    const float m_lo = __ldg(mask + static_cast<int64_t>(grp) * kGroup + r_lo);
    const float m_hi = __ldg(mask + static_cast<int64_t>(grp) * kGroup + r_lo + 8);

    int prev = -1;
    for (int kc = 0; kc < n_chunks; ++kc) {
      mbar_wait(&full[stage], phase);
      wgmma_fence();
      const uint64_t da = desc_sw128(ring + stage * kStageBytes + wg * 64 * 128);
      const uint64_t db = desc_sw128(q_s + kc * kN * 128);
#pragma unroll
      for (int k = 0; k < kChunk / 16; ++k) Wgmma<kN>::template fma<kBf16>(acc, da + 2 * k, db + 2 * k, (kc | k) != 0);
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

    // mask, then the max over the thread's two rows: value i at acc[pos(i)]
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        acc[4 * j + e] = fmaxf(acc[4 * j + e] + m_lo, acc[4 * j + 2 + e] + m_hi);
    // reduce-scatter over the 8 lanes of equal t (lane bits 4, 3, 2)
    constexpr int kW1 = kV >= 2 ? kV / 2 : 1;
    constexpr int kW2 = kW1 >= 2 ? kW1 / 2 : 1;
    constexpr int kW3 = kW2 >= 2 ? kW2 / 2 : 1;
    colmax_round<kV>(acc, lane, 16);
    colmax_round<kW1>(acc, lane, 8);
    colmax_round<kW2>(acc, lane, 4);
    const int base = (kV >= 2 && (lane & 16) ? kV / 2 : 0) + (kW1 >= 2 && (lane & 8) ? kW1 / 2 : 0) +
                     (kW2 >= 2 && (lane & 4) ? kW2 / 2 : 0);
    const bool writer = (kV >= 2 || !(lane & 16)) && (kW1 >= 2 || !(lane & 8)) && (kW2 >= 2 || !(lane & 4));
    float* red_w = red + (buf * kConsumerWarps + warp) * kN;
    if (writer) {
#pragma unroll
      for (int i = 0; i < kW3; ++i) {
        const int idx = base + i;
        red_w[red_slot(8 * (idx >> 1) + 2 * t + (idx & 1))] = acc[pos(i)];
      }
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
    if (threadIdx.x < kN) {
      const float* col = red + buf * kConsumerWarps * kN + red_slot(threadIdx.x);
      float m = col[0];
#pragma unroll
      for (int w = 1; w < kConsumerWarps; ++w) m = fmaxf(m, col[w * kN]);
      obuf[threadIdx.x * kObufLd + slot] = m;
    }
    buf ^= 1;  // the next group writes the other buffer: one barrier a group
    ++slot;
    if (slot == kFlush || it + 1 == item1 || (it + 1) % n_groups == 0) flush(nt);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2-D map of a row-major (rows, d) bf16/f16 matrix read in boxes of 64
// dims x box_rows rows, 128-byte swizzle; rows past the end read as zeros.
bool encode_map(CUtensorMap* map, const void* base, long long rows, int d, int box_rows, bool bf16) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * 2};
  const cuuint32_t box[2] = {kChunk, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16, 2,
             const_cast<void*>(base), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool kBf16, int kN>
int launch(const void* q, const void* slab, const float* mask, float* out, int b, int d, long long n,
           cudaStream_t s) {
  alignas(64) CUtensorMap slab_map, q_map;
  if (!encode_map(&slab_map, slab, n, d, kGroup, kBf16) || !encode_map(&q_map, q, b, d, kN, kBf16))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_chunks = d / kChunk;
  const int n_groups = static_cast<int>(n / kGroup);
  const long long n_items = static_cast<long long>((b + kN - 1) / kN) * n_groups;
  const size_t fixed = 1024 + static_cast<size_t>(n_chunks) * kN * 128 +
                       (2 * kConsumerWarps * kN + kN * kObufLd) * sizeof(float) + (2 * kMaxStages + 2) * 8;
  const int stages = static_cast<int>(std::min<size_t>(kMaxStages, (kSmemMax - fixed) / kStageBytes));
  if (n_items > 0x7fffffffLL || stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fixed + static_cast<size_t>(stages) * kStageBytes;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaError_t err = cudaFuncSetAttribute(group_max_kernel<kBf16, kN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = static_cast<int>(std::min<long long>(n_items, sms));
  group_max_kernel<kBf16, kN><<<grid, kThreads, smem, s>>>(slab_map, q_map, mask, out, b, n_chunks, n_groups,
                                                            static_cast<int>(n_items), stages);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBf16>
int dispatch(int tile, const void* q, const void* slab, const float* mask, float* out, int b, int d,
             long long n, cudaStream_t s) {
  switch (tile) {
    case 8: return launch<kBf16, 8>(q, slab, mask, out, b, d, n, s);
    case 16: return launch<kBf16, 16>(q, slab, mask, out, b, d, n, s);
    case 32: return launch<kBf16, 32>(q, slab, mask, out, b, d, n, s);
    case 64: return launch<kBf16, 64>(q, slab, mask, out, b, d, n, s);
    case 128: return launch<kBf16, 128>(q, slab, mask, out, b, d, n, s);
    default: return launch<kBf16, 256>(q, slab, mask, out, b, d, n, s);
  }
}

}  // namespace

// q: (b, d) bf16/f16, slab: (n, d) same dtype, mask: (n,) f32,
// out: (b, n / 128) f32. Needs n % 128 == 0, d % 64 == 0, d <= 8192, b >= 1
// and 16-byte aligned pointers (the Python wrapper checks all of these).
// Returns cudaGetLastError() after the launch.
extern "C" int fs_group_max(const void* q, const void* slab, const void* mask, void* out, int b, int d,
                            long long n, int is_bf16, void* stream) {
  if (b < 1 || d < kChunk || d % kChunk != 0 || n < kGroup || n % kGroup != 0 || n / kGroup > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  int tile = 8;  // the query tile: the smallest width that holds b, halved until it fits
  while (tile < kMaxN && tile < b) tile *= 2;
  while (tile > 8 && static_cast<long long>(tile) * d * 2 > kQBudget) tile /= 2;
  if (static_cast<long long>(tile) * d * 2 > kQBudget) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* mp = static_cast<const float*>(mask);
  auto* op = static_cast<float*>(out);
  return is_bf16 ? dispatch<true>(tile, q, slab, mp, op, b, d, n, s)
                 : dispatch<false>(tile, q, slab, mp, op, b, d, n, s);
}

// K1 and K4: masked per-group maxima of the slab scan scores, for sm_90a.
//
// Replaces two TPU kernels of frankensearch_tpu/ops/topk_scan.py:
// `_group_max_kernel` (K1, the pallas_call in `scan_topk_hierarchical`)
// and `_group_max_int8_kernel` (K4, the one in
// `scan_topk_hierarchical_int8`). For every 128-row group g of the slab and
// every query b they compute
//
//     K1:  out[b, g] = max_{r in g} ( dot(q[b], slab[r]) + mask[r] )
//     K4:  out[b, g] = max_{r in g} ( float(sum_d q_i8[b, d] * slab_i8[r, d]) + mask[r] )
//
// K1 takes bf16 (or f16) products accumulated in f32; the query arrives
// already rounded to the slab dtype, exactly like the TPU kernel's astype.
// K4's products and sums are int32 and exact, and the cast to f32 is exact
// while |sum| < 2^24 (127 * 127 * 1024 < 2^24, so for d <= 1024): its
// result is bitwise the twin's whatever the order of the sum. K6
// (group_candidates.cu) takes its group maxima from K1 as well.
//
// What bounds them on the H100: at the headline shape (1,007,616 x 256
// slab, B = 256) K1 reads 516 MB of bf16 (0.158 ms at 3.35 TB/s) and does
// 132 G bf16 operations (0.134 ms at 989 TFLOP/s); K4 reads a 258 MB int8
// slab (0.077 ms) and does 132 G int8 operations (0.067 ms at 1,979
// TOP/s). Both sit near their type's ridge, so the slab has to stream from
// HBM once while the tensor cores run near their full rate, which on this
// card only wgmma reaches. The first ports (one block per group x 64
// queries, mma.sync, synchronous staging) lost 5x (K1) and 6x (K4) to that
// bound: copy and compute never overlapped, and each group's rows and each
// query tile were restaged through L2 for every block.
//
// Design (one body, templated on the operand type; a 128-byte row of a
// stage holds 64 bf16/f16 dims or 128 int8 dims, so the stages, their
// swizzle and the descriptors are the same for both):
//   * a persistent grid, one block per SM; each block walks a contiguous
//     run of (query tile, group) items, query tile major;
//   * the query tile stays resident in shared memory (N queries x d
//     elements, up to 128 KB; N is the smallest of 8 .. 256 that holds B,
//     halved until the tile fits), loaded by TMA once per block and query
//     tile;
//   * one producer warp keeps a ring of 128-row x 128-byte slab stages (16
//     KB, 4 to 8 of them) in flight with 2-D TMA loads (128-byte swizzle,
//     the layout wgmma reads) and mbarriers;
//   * two consumer warpgroups run wgmma (m64nNk16 with f32 sums, or
//     m64nNk32 with s32 sums; rows 0-63 and 64-127 of the group), k steps
//     in ascending order, and release each stage as its products retire;
//   * the epilogue turns each sum into its f32 score (K4: __int2float_rn,
//     exact), adds the mask in f32, takes the max over the thread's two
//     rows, then a reduce-scatter over the 8 lanes that share columns (each
//     shuffle round halves the columns a lane holds), then across the 8
//     warps through shared memory (bank-swizzled);
//   * each column's maxima are buffered for 8 consecutive groups and
//     written as one span per query, not as scattered 4-byte stores.
// A query's row does not depend on N or on its place in the tile: each
// output element is its own dot product, summed in the same k order.
//
// The tensor maps are encoded on the host for every call
// (cuTensorMapEncodeTiled, fetched through cudaGetDriverEntryPoint: the
// library links no libcuda) and passed as __grid_constant__ parameters.
//
// K1 on an f32 slab (`fs_group_max` with kind 2) is a kernel of its own:
// the TPU kernel's dot_general on f32 operands is f32 products and sums,
// which wgmma cannot give (TF32 rounds the operands). It scores each
// (group, tile of up to 64 queries) with the FFMA body of scan_f32.cuh
// (K5's f32 form scores with the same fmaf chain, so K5's candidates are
// these scores' bits),
// adds the mask, takes the max over the thread's 4 rows, then over the 8
// lanes of equal t (shuffles) and the 4 warps (shared memory). A block is
// one (group, query tile), the query tile fastest, so a group's blocks run
// side by side and read it from L2 after the first. It is FFMA-bound (see
// scan_f32.cuh): 1.97 ms at 1,007,616 x 256, B = 256, against 0.31 ms of
// bytes.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"
#include "scan_f32.cuh"

using namespace fs_hopper;

namespace {

// The operands' element type (query and slab share it).
enum Kind : int { kBf16, kF16, kS8 };

__host__ __device__ constexpr int elem_bytes(int kind) { return kind == kS8 ? 1 : 2; }

// Sums of bf16/f16 products are f32, of int8 products s32.
template <int kKind>
using Acc = std::conditional_t<kKind == kS8, int, float>;

constexpr int kGroup = 128;                     // rows per group
constexpr int kRowBytes = 128;                  // bytes of a row per stage (one 128-byte swizzle row)
constexpr int kStageBytes = kGroup * kRowBytes;
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

// A sum as its f32 score: an f32 sum as it is, an s32 sum cast (exact
// below 2^24). Once scored, an accumulator register holds f32 bits.
__device__ __forceinline__ float score_of(float x) { return x; }
__device__ __forceinline__ float score_of(int x) { return __int2float_rn(x); }
__device__ __forceinline__ float f32_of(float x) { return x; }
__device__ __forceinline__ float f32_of(int x) { return __int_as_float(x); }
__device__ __forceinline__ void set_f32(float& r, float x) { r = x; }
__device__ __forceinline__ void set_f32(int& r, float x) { r = __float_as_int(x); }

// Value i of the thread's column list: accumulator 4*(i/2) + i%2 (row
// pair already folded in by the epilogue), column 8*(i/2) + 2t + i%2.
__device__ __forceinline__ constexpr int pos(int i) { return 4 * (i / 2) + (i & 1); }

// One round of the reduce-scatter over lanes `m` apart: a list of kW >= 2
// values keeps half (the upper half on the lane whose bit m is set) and
// takes the partner's max for it; a single value takes the plain max.
template <int kW, class T, int kR>
__device__ __forceinline__ void colmax_round(T (&acc)[kR], int lane, int m) {
  if constexpr (kW >= 2) {
    const bool up = (lane & m) != 0;
#pragma unroll
    for (int i = 0; i < kW / 2; ++i) {
      const float lo = f32_of(acc[pos(i)]), hi = f32_of(acc[pos(kW / 2 + i)]);
      set_f32(acc[pos(i)], fmaxf(up ? hi : lo, __shfl_xor_sync(0xffffffffu, up ? lo : hi, m)));
    }
  } else {
    const float v = f32_of(acc[pos(0)]);
    set_f32(acc[pos(0)], fmaxf(v, __shfl_xor_sync(0xffffffffu, v, m)));
  }
}

template <int kKind, int kN>
__global__ void __launch_bounds__(kThreads, 1)
group_max_kernel(const __grid_constant__ CUtensorMap slab_map,  // (n, d), box 128 bytes x 128 rows
                 const __grid_constant__ CUtensorMap q_map,     // (b, d), box 128 bytes x kN rows
                 const float* __restrict__ mask,                // (n,) additive
                 float* __restrict__ out,                       // (b, n_groups)
                 int b, int n_chunks, int n_groups, int n_items, int stages) {
  constexpr int kR = kN / 2;  // accumulators a thread
  constexpr int kV = kN / 4;  // columns a thread holds after folding its two rows
  constexpr int kChunk = kRowBytes / elem_bytes(kKind);  // dims per stage
  using T = Acc<kKind>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* q_s = smem;                                        // n_chunks x [kN][128 bytes]
  uint8_t* ring = q_s + n_chunks * kN * kRowBytes;            // stages x [128][128 bytes]
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
        mbar_arrive_expect_tx(q_full, n_chunks * kN * kRowBytes);
        for (int kc = 0; kc < n_chunks; ++kc)
          tma_load_2d(q_s + kc * kN * kRowBytes, &q_map, kc * kChunk, nt * kN, q_full);
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
  T acc[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) acc[i] = T(0);
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
      const uint64_t da = desc_sw128(ring + stage * kStageBytes + wg * 64 * kRowBytes);
      const uint64_t db = desc_sw128(q_s + kc * kN * kRowBytes);
#pragma unroll
      for (int k = 0; k < kRowBytes / 32; ++k) {  // 32-byte k steps: k16 (bf16/f16) or k32 (int8)
        if constexpr (kKind == kS8)
          Wgmma<kN>::fma_s8(acc, da + 2 * k, db + 2 * k, (kc | k) != 0);
        else
          Wgmma<kN>::template fma<kKind == kBf16>(acc, da + 2 * k, db + 2 * k, (kc | k) != 0);
      }
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

    // score, mask, then the max over the thread's two rows: value i (f32
    // bits) at acc[pos(i)]
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        set_f32(acc[4 * j + e], fmaxf(score_of(acc[4 * j + e]) + m_lo, score_of(acc[4 * j + 2 + e]) + m_hi));
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
        red_w[red_slot(8 * (idx >> 1) + 2 * t + (idx & 1))] = f32_of(acc[pos(i)]);
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

// A 2-D map of a row-major (rows, d) matrix of `kind` read in boxes of 128
// bytes x box_rows rows, 128-byte swizzle; rows past the end read as zeros.
// int8 rows are mapped as uint8: the copy moves bits.
bool encode_map(CUtensorMap* map, const void* base, long long rows, int d, int box_rows, int kind) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const int eb = elem_bytes(kind);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * eb};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kRowBytes / eb), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUtensorMapDataType type = kind == kBf16  ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                   : kind == kF16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                                  : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  return enc(map, type, 2,
             const_cast<void*>(base), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kKind, int kN>
int launch(const void* q, const void* slab, const float* mask, float* out, int b, int d, long long n,
           cudaStream_t s) {
  alignas(64) CUtensorMap slab_map, q_map;
  if (!encode_map(&slab_map, slab, n, d, kGroup, kKind) || !encode_map(&q_map, q, b, d, kN, kKind))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_chunks = d * elem_bytes(kKind) / kRowBytes;
  const int n_groups = static_cast<int>(n / kGroup);
  const long long n_items = static_cast<long long>((b + kN - 1) / kN) * n_groups;
  const size_t fixed = 1024 + static_cast<size_t>(n_chunks) * kN * kRowBytes +
                       (2 * kConsumerWarps * kN + kN * kObufLd) * sizeof(float) + (2 * kMaxStages + 2) * 8;
  const int stages = static_cast<int>(std::min<size_t>(kMaxStages, (kSmemMax - fixed) / kStageBytes));
  if (n_items > 0x7fffffffLL || stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fixed + static_cast<size_t>(stages) * kStageBytes;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaError_t err = cudaFuncSetAttribute(group_max_kernel<kKind, kN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = static_cast<int>(std::min<long long>(n_items, sms));
  group_max_kernel<kKind, kN><<<grid, kThreads, smem, s>>>(slab_map, q_map, mask, out, b, n_chunks, n_groups,
                                                            static_cast<int>(n_items), stages);
  return static_cast<int>(cudaGetLastError());
}

template <int kKind>
int dispatch(int tile, const void* q, const void* slab, const float* mask, float* out, int b, int d,
             long long n, cudaStream_t s) {
  switch (tile) {
    case 8: return launch<kKind, 8>(q, slab, mask, out, b, d, n, s);
    case 16: return launch<kKind, 16>(q, slab, mask, out, b, d, n, s);
    case 32: return launch<kKind, 32>(q, slab, mask, out, b, d, n, s);
    case 64: return launch<kKind, 64>(q, slab, mask, out, b, d, n, s);
    case 128: return launch<kKind, 128>(q, slab, mask, out, b, d, n, s);
    default: return launch<kKind, 256>(q, slab, mask, out, b, d, n, s);
  }
}

// K1's f32 form: one block per (group, tile of 8 * kNT queries).
template <int kNT>
__global__ void __launch_bounds__(fs_scan_f32::kThreads)
group_max_f32_kernel(const float* __restrict__ q,     // (b, d)
                     const float* __restrict__ slab,  // (n, d)
                     const float* __restrict__ mask,  // (n,) additive
                     float* __restrict__ out,         // (b, n_groups)
                     int b, int d, int n_groups, int n_qtiles) {
  constexpr int kQ = kNT * 8;
  constexpr int kWarpsF = fs_scan_f32::kWarps;
  __shared__ fs_scan_f32::GroupSmemF32 sm;
  __shared__ float red[kWarpsF][kQ];
  const int q0 = (blockIdx.x % n_qtiles) * kQ;
  const int grp = blockIdx.x / n_qtiles;
  fs_scan_f32::score_group_f32_with<kNT>(
      q, slab, mask, static_cast<int64_t>(grp) * kGroup, q0, b, d, sm, [&](auto& acc) {
        const int warp = threadIdx.x >> 5;
        const int lane = threadIdx.x & 31;
        const int g = lane >> 2;
        const int t = lane & 3;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float m = -INFINITY;
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int h = 0; h < 2; ++h)
                m = fmaxf(m, acc[mt][nt][2 * h + j] + sm.mask[warp * 32 + mt * 16 + g + 8 * h]);
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 4));
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 8));
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 16));
            if (g == 0) red[warp][nt * 8 + 2 * t + j] = m;
          }
        __syncthreads();
        const int c = threadIdx.x;
        if (c < kQ && q0 + c < b) {
          float m = red[0][c];
#pragma unroll
          for (int w = 1; w < kWarpsF; ++w) m = fmaxf(m, red[w][c]);
          out[static_cast<int64_t>(q0 + c) * n_groups + grp] = m;
        }
      });
}

template <int kNT>
int launch_f32(const void* q, const void* slab, const float* mask, float* out, int b, int d, long long n,
               cudaStream_t s) {
  const long long n_qtiles = (b + kNT * 8 - 1) / (kNT * 8);
  const long long blocks = n_qtiles * (n / kGroup);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  group_max_f32_kernel<kNT><<<static_cast<unsigned>(blocks), fs_scan_f32::kThreads, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(slab), mask, out, b, d, static_cast<int>(n / kGroup),
      static_cast<int>(n_qtiles));
  return static_cast<int>(cudaGetLastError());
}

// The f32 form's query tile: the smallest of 8, 16, 32, 64 that holds b.
int run_f32(const void* q, const void* slab, const void* mask, void* out, int b, int d, long long n, void* stream) {
  if (b < 1 || d < fs_scan_f32::kChunk || d % fs_scan_f32::kChunk != 0 || n < kGroup || n % kGroup != 0 ||
      n / kGroup > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* mp = static_cast<const float*>(mask);
  auto* op = static_cast<float*>(out);
  if (b <= 8) return launch_f32<1>(q, slab, mp, op, b, d, n, s);
  if (b <= 16) return launch_f32<2>(q, slab, mp, op, b, d, n, s);
  if (b <= 32) return launch_f32<4>(q, slab, mp, op, b, d, n, s);
  return launch_f32<8>(q, slab, mp, op, b, d, n, s);
}

// Checks the shapes, picks the query tile (the smallest width that holds b,
// halved until its rows fit kQBudget) and launches.
int run(int kind, const void* q, const void* slab, const void* mask, void* out, int b, int d, long long n,
        void* stream) {
  const long long row_bytes = static_cast<long long>(d) * elem_bytes(kind);
  if (b < 1 || d < 1 || row_bytes % kRowBytes != 0 || n < kGroup || n % kGroup != 0 ||
      n / kGroup > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  int tile = 8;
  while (tile < kMaxN && tile < b) tile *= 2;
  while (tile > 8 && tile * row_bytes > kQBudget) tile /= 2;
  if (tile * row_bytes > kQBudget) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* mp = static_cast<const float*>(mask);
  auto* op = static_cast<float*>(out);
  switch (kind) {
    case kBf16: return dispatch<kBf16>(tile, q, slab, mp, op, b, d, n, s);
    case kF16: return dispatch<kF16>(tile, q, slab, mp, op, b, d, n, s);
    default: return dispatch<kS8>(tile, q, slab, mp, op, b, d, n, s);
  }
}

}  // namespace

// K1. q: (b, d) of the slab's dtype, slab: (n, d) f16 (kind 0), bf16 (kind
// 1) or f32 (kind 2), mask: (n,) f32, out: (b, n / 128) f32. Needs n % 128
// == 0, d % 64 == 0, d <= 8192, b >= 1 and 16-byte aligned pointers (the
// Python wrapper checks all of these). Returns cudaGetLastError() after the
// launch.
extern "C" int fs_group_max(const void* q, const void* slab, const void* mask, void* out, int b, int d,
                            long long n, int kind, void* stream) {
  if (kind == 2) return run_f32(q, slab, mask, out, b, d, n, stream);
  return run(kind == 1 ? kBf16 : kF16, q, slab, mask, out, b, d, n, stream);
}

// K4. q: (b, d) int8 prepared queries, slab: (n, d) int8, mask: (n,) f32,
// out: (b, n / 128) f32. Needs n % 128 == 0, d % 128 == 0, d <= 1024 (the
// exact cast), b >= 1 and 16-byte aligned pointers (the Python wrapper
// checks all of these). Returns cudaGetLastError() after the launch.
extern "C" int fs_group_max_int8(const void* q, const void* slab, const void* mask, void* out, int b, int d,
                                 long long n, void* stream) {
  if (d > 1024) return static_cast<int>(cudaErrorInvalidValue);
  return run(kS8, q, slab, mask, out, b, d, n, stream);
}

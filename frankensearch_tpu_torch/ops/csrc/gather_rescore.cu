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
// What bounds it on the H100: it is a gather-bound GEMV. At B = 256 and
// kk = 30 groups it reads 256*30*128 rows of 512 B, ~0.5 GB: as much as the
// slab itself, with 2 FLOP per element read. Only bytes matter.
//
// Design: one block per (query, group) pair, 4 warps of 32 rows each. The
// block loads its own group id (the TPU kernel used scalar prefetch) and
// stages the query once in shared memory as f32. Each warp reads whole rows
// with coalesced 16-byte loads (one row = one 512 B transaction at d = 256),
// four rows in flight per lane, and reduces each row's dot with a fixed
// butterfly of shuffles. There is no VMEM gate and no batch-multiple rule:
// any b and kk launch.

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
constexpr int kUnroll = 4;  // rows in flight per lane

template <bool kBf16>
__device__ __forceinline__ float to_f32(uint16_t x) {
  if constexpr (kBf16) {
    return __uint_as_float(static_cast<uint32_t>(x) << 16);
  } else {
    return __half2float(__ushort_as_half(x));
  }
}

template <bool kBf16>
__device__ __forceinline__ float dot8(const uint4& v, const float* qv, float acc) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc = fmaf(to_f32<kBf16>(static_cast<uint16_t>(w[i] & 0xffffu)), qv[2 * i], acc);
    acc = fmaf(to_f32<kBf16>(static_cast<uint16_t>(w[i] >> 16)), qv[2 * i + 1], acc);
  }
  return acc;
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
gather_rescore_kernel(const uint16_t* __restrict__ q,       // (b, d) slab dtype
                      const uint16_t* __restrict__ slab,    // (n, d)
                      const int32_t* __restrict__ groups,   // (b, kk)
                      float* __restrict__ out,              // (b, kk*128)
                      int kk, int d, int n_groups) {
  extern __shared__ float s_q[];  // d floats
  const int64_t pair = blockIdx.x;  // = query * kk + j
  const int64_t bq = pair / kk;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* dst = out + pair * kGroup;

  const int gid = groups[pair];
  if (gid < 0 || gid >= n_groups) {  // never produced by the scan; poison
    for (int r = threadIdx.x; r < kGroup; r += kThreads) dst[r] = NAN;
    return;
  }
  for (int i = threadIdx.x; i < d; i += kThreads)
    s_q[i] = to_f32<kBf16>(q[bq * d + i]);
  __syncthreads();

  const int n_vec = d / 8;  // 16-byte vectors per row
  const uint16_t* rows =
      slab + (static_cast<int64_t>(gid) * kGroup + warp * kRowsPerWarp) * d;
  for (int r0 = 0; r0 < kRowsPerWarp; r0 += kUnroll) {
    float part[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) part[u] = 0.0f;
    for (int c = lane; c < n_vec; c += 32) {
      float qv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) qv[i] = s_q[c * 8 + i];
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        v[u] = __ldg(reinterpret_cast<const uint4*>(
            rows + static_cast<int64_t>(r0 + u) * d + c * 8));
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) part[u] = dot8<kBf16>(v[u], qv, part[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float s = part[u];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) dst[warp * kRowsPerWarp + r0 + u] = s;
    }
  }
}

}  // namespace

// q: (b, d) bf16/f16, slab: (n, d) same dtype, groups: (b, kk) int32 group
// ids, out: (b, kk * 128) f32. Needs n % 128 == 0, d % 8 == 0 and 16-byte
// aligned pointers (the Python wrapper checks all of these).
// Returns cudaGetLastError() after the launch.
extern "C" int fs_gather_rescore(const void* q, const void* slab, const void* groups,
                                 void* out, int b, int kk, int d, long long n,
                                 int is_bf16, void* stream) {
  if (b < 1 || kk < 1 || d < 8 || d % 8 != 0 || n < kGroup || n % kGroup != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(b) * kk;
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  if (blocks > 0x7fffffffLL || smem > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_groups = static_cast<int>(n / kGroup);
  const dim3 grid(static_cast<unsigned>(blocks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const uint16_t*>(q);
  const auto* sp = static_cast<const uint16_t*>(slab);
  const auto* gp = static_cast<const int32_t*>(groups);
  auto* op = static_cast<float*>(out);
  if (is_bf16)
    gather_rescore_kernel<true><<<grid, kThreads, smem, s>>>(qp, sp, gp, op, kk, d, n_groups);
  else
    gather_rescore_kernel<false><<<grid, kThreads, smem, s>>>(qp, sp, gp, op, kk, d, n_groups);
  return static_cast<int>(cudaGetLastError());
}

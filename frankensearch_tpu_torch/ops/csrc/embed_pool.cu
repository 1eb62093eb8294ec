// The Model2Vec pool: token rows gathered, mean-pooled and L2-normalized in
// one launch, for sm_90a.
//
// Replaces no TPU kernel: the reference pools with XLA
// (frankensearch_tpu/embed/model2vec.py `_gather_pool_normalize`). The
// port's plain form (embed/model2vec.py `gather_pool_normalize_plain`) adds
// token by token in elementwise PyTorch operations, one multiply and one add
// a token plus a 13-step normalize: 65 launches a call at the 16-token
// bucket, each a few microseconds of device work behind tens of microseconds
// of host enqueue. This kernel takes the same rounded steps in the same
// order, so the two agree bit for bit. For row b of (B, T) token ids and
// 0/1 mask, with m_t = float(mask[b, t]) and r_t = float(table[ids[b, t]]):
//
//   acc    = r_0 * m_0;  acc = acc + r_t * m_t   for t = 1 .. T-1
//   count  = m_0;        count = count + m_t     for t = 1 .. T-1
//   pooled = acc / max(count, 1)
//   s      = pooled * pooled over D, padded with +0.0f to W, the power of
//            two >= D; then s[i] = s[i] + s[i + h] for h = W/2, W/4, .., 1
//   norm   = sqrt(s[0])
//   out    = norm > 1e-12f ? pooled / norm : pooled
//
// Masked positions are gathered and added as the plain form adds them: a
// row times +0.0f is a zero that carries the row's sign, and that sign
// survives in a row with no token (-0.0f + -0.0f is -0.0f). Every product,
// sum, quotient and the root is one IEEE round-to-nearest step
// (`__fmul_rn`, `__fadd_rn`, `__fdiv_rn`, `__fsqrt_rn`): nvcc contracts a
// plain `a * b + c` into one fused multiply-add, which the plain form never
// takes. A row's steps read nothing of another row, so its bits depend
// neither on its batchmates nor on how far its bucket pads it. An id outside
// [0, V) is read as NaN (no load leaves the table), so its row comes out NaN.
//
// What bounds it on the H100: the launch. The gathered rows are B T D
// element bytes (8 KB at B = 1, T = 16, D = 256 in bf16: 2.4 ns at 3.35
// TB/s), and each row's arithmetic is T + log2(W) + 2 steps an element.
// One launch replaces the chain of 65.
//
// Design: one block a row; the block stages the row's ids and mask in
// shared memory, each thread walks the tokens for its elements of D (the
// token loop unrolled, so the gathers of several tokens are in flight
// together), keeps pooled in the output row, and writes its squares into
// the W-float tree in shared memory; the levels of the tree are separated by
// barriers; the threads then divide their own elements.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBf16 = 1, kF32 = 2;  // ops/topk_scan._KINDS
constexpr int kMaxThreads = 256;
constexpr int kMaxWidth = 32768;     // the tree's floats: 128 KB of shared memory
constexpr int kMaxSmem = 232448;     // a block's shared memory on sm_90
constexpr int kDefaultSmem = 49152;  // above it only after cudaFuncSetAttribute

template <int kKind>
__device__ __forceinline__ float table_elem(const void* __restrict__ table, long long at) {
  if constexpr (kKind == kF32) {
    return static_cast<const float*>(table)[at];
  } else {
    const unsigned short x = static_cast<const unsigned short*>(table)[at];
    return __uint_as_float(static_cast<unsigned>(x) << 16);  // bf16 -> f32 is exact
  }
}

// element c of token `id`'s row; NaN for an id outside the table
template <int kKind>
__device__ __forceinline__ float token_elem(const void* __restrict__ table, int32_t id, long long v, int d,
                                            int c) {
  if (id < 0 || id >= v) return __int_as_float(0x7fc00000);
  return table_elem<kKind>(table, static_cast<long long>(id) * d + c);
}

template <int kKind>
__global__ void __launch_bounds__(kMaxThreads)
embed_pool_kernel(const void* __restrict__ table, const int32_t* __restrict__ ids,
                  const int32_t* __restrict__ mask, float* __restrict__ out, long long v, int t, int d,
                  int width) {
  extern __shared__ float smem[];
  float* sq = smem;                                           // width
  int32_t* row_ids = reinterpret_cast<int32_t*>(sq + width);  // t
  float* row_m = reinterpret_cast<float*>(row_ids + t);       // t
  const long long row = blockIdx.x;
  for (int j = threadIdx.x; j < t; j += blockDim.x) {
    row_ids[j] = ids[row * t + j];
    row_m[j] = static_cast<float>(mask[row * t + j]);
  }
  __syncthreads();
  float count = row_m[0];
  for (int j = 1; j < t; ++j) count = __fadd_rn(count, row_m[j]);
  const float denom = fmaxf(count, 1.0f);
  float* o = out + row * d;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float acc = __fmul_rn(token_elem<kKind>(table, row_ids[0], v, d, c), row_m[0]);
#pragma unroll 8
    for (int j = 1; j < t; ++j)
      acc = __fadd_rn(acc, __fmul_rn(token_elem<kKind>(table, row_ids[j], v, d, c), row_m[j]));
    const float pooled = __fdiv_rn(acc, denom);
    o[c] = pooled;
    sq[c] = __fmul_rn(pooled, pooled);
  }
  for (int c = d + threadIdx.x; c < width; c += blockDim.x) sq[c] = 0.0f;
  __syncthreads();
  for (int h = width >> 1; h > 0; h >>= 1) {
    for (int i = threadIdx.x; i < h; i += blockDim.x) sq[i] = __fadd_rn(sq[i], sq[i + h]);
    __syncthreads();
  }
  const float norm = __fsqrt_rn(sq[0]);
  if (norm > 1e-12f) {
    for (int c = threadIdx.x; c < d; c += blockDim.x) o[c] = __fdiv_rn(o[c], norm);
  }
}

template <int kKind>
int launch(const void* table, const int32_t* ids, const int32_t* mask, float* out, long long v, int d, int b,
           int t, cudaStream_t stream) {
  if (d > kMaxWidth) return static_cast<int>(cudaErrorInvalidValue);
  int width = 1;
  while (width < d) width <<= 1;
  const size_t smem = static_cast<size_t>(width) * sizeof(float) + static_cast<size_t>(t) * 8;
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > static_cast<size_t>(kDefaultSmem)) {
    const cudaError_t err = cudaFuncSetAttribute(embed_pool_kernel<kKind>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = d >= kMaxThreads ? kMaxThreads : (d + 31) / 32 * 32;
  embed_pool_kernel<kKind><<<b, threads, smem, stream>>>(table, ids, mask, out, v, t, d, width);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (V, D) table of `kind` (1 bf16, 2 f32), (B, T) int32 ids and mask,
// (B, D) f32 out; all contiguous. Returns a CUDA error code (0 on success).
extern "C" int fs_embed_pool(const void* table, const void* ids, const void* mask, void* out, long long v,
                             int d, int b, int t, int kind, void* stream) {
  if (v < 1 || d < 1 || b < 1 || t < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto* ip = static_cast<const int32_t*>(ids);
  const auto* mp = static_cast<const int32_t*>(mask);
  auto* op = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (kind == kBf16) return launch<kBf16>(table, ip, mp, op, v, d, b, t, s);
  if (kind == kF32) return launch<kF32>(table, ip, mp, op, v, d, b, t, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

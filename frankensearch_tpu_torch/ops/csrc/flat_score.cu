// K3: flat tail scores of one length class of the split BM25 layout, for
// sm_90a.
//
// Replaces the TPU kernel frankensearch_tpu/lexical/device_bm25.py
// `_flat_score_kernel` (the pallas_call in `_flat_class_scores_pallas`,
// reached from `_graded_scan_flat`). For block p, query b and slot d
//
//     out[p, b, d] = sum_l sum_j qw[b, j] * tf[p, l, d] * (term[p, l, d] == qi[b, j])
//
// summed from +0.0f with l outer and j inner, one rounded product and one
// rounded add per hit: the TPU kernel's order, so the result equals the
// plain twin (`flat_class_scores_plain`) and the reference kernel's
// interpret mode bit for bit. `__fmul_rn`/`__fadd_rn` are never contracted
// into a fused multiply-add. A miss adds nothing instead of +0.0f, which
// changes no bit: every addend is a product of non-negative values, so the
// sum never reaches -0.0f.
//
// What bounds it on the H100: bytes. Each cell does L*T compares and
// writes one f32; the class's (L, d_pad) term/tf rows are 8 B per slot and
// are read once per block of queries, mostly from L2. At B = 64 the output,
// n_c * 64 * d_pad * 4 bytes, is most of the traffic.
//
// Design: one thread per (b, d) cell, d the fast axis so a warp reads 32
// consecutive term and tf values and writes 32 consecutive outputs. A
// block is 128 slots x 4 queries; the 4 query rows (ids and weights) are
// staged in shared memory, and the 4 rows of threads that share a slot
// read the same term/tf words. Any B, T and L launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDTile = 128;  // slots per block (threadIdx.x)
constexpr int kBTile = 4;    // query rows per block (threadIdx.y)

__global__ void __launch_bounds__(kDTile * kBTile)
flat_score_kernel(const int32_t* __restrict__ qi,    // (b, t_q)
                  const float* __restrict__ qw,      // (b, t_q)
                  const int32_t* __restrict__ term,  // (n_c, l_c, d_pad)
                  const float* __restrict__ tf,      // (n_c, l_c, d_pad)
                  float* __restrict__ out,           // (n_c, b, d_pad)
                  int l_c, int d_pad, int b, int t_q) {
  extern __shared__ unsigned char smem[];
  int32_t* s_ids = reinterpret_cast<int32_t*>(smem);  // kBTile * t_q
  float* s_w = reinterpret_cast<float*>(s_ids + kBTile * t_q);

  const int p = blockIdx.z;
  const int b0 = blockIdx.y * kBTile;
  const int tid = threadIdx.y * kDTile + threadIdx.x;
  for (int i = tid; i < kBTile * t_q; i += kDTile * kBTile) {
    const int row = b0 + i / t_q;
    const int64_t src = static_cast<int64_t>(row) * t_q + i % t_q;
    s_ids[i] = row < b ? qi[src] : -1;
    s_w[i] = row < b ? qw[src] : 0.0f;
  }
  __syncthreads();

  const int d = blockIdx.x * kDTile + threadIdx.x;
  const int bq = b0 + threadIdx.y;
  if (d >= d_pad || bq >= b) return;
  const int32_t* ids = s_ids + threadIdx.y * t_q;
  const float* w = s_w + threadIdx.y * t_q;
  const int64_t base = static_cast<int64_t>(p) * l_c * d_pad + d;
  float acc = 0.0f;
  for (int l = 0; l < l_c; ++l) {
    const int32_t t = term[base + static_cast<int64_t>(l) * d_pad];
    if (t < 0) continue;  // slot padding (tf 0): matches no query term
    const float f = tf[base + static_cast<int64_t>(l) * d_pad];
    for (int j = 0; j < t_q; ++j)
      if (t == ids[j]) acc = __fadd_rn(acc, __fmul_rn(w[j], f));
  }
  out[(static_cast<int64_t>(p) * b + bq) * d_pad + d] = acc;
}

}  // namespace

// qi: (b, t_q) int32, qw: (b, t_q) f32, term: (n_c, l_c, d_pad) int32,
// tf: (n_c, l_c, d_pad) f32, out: (n_c, b, d_pad) f32, all contiguous on
// one device. Needs d_pad % 128 == 0 (the wrapper checks it).
// Returns cudaGetLastError() after the launch.
extern "C" int fs_flat_score(const void* qi, const void* qw, const void* term,
                             const void* tf, void* out, int n_c, int l_c, int d_pad,
                             int b, int t_q, void* stream) {
  if (n_c < 1 || l_c < 1 || b < 1 || t_q < 1 || d_pad < kDTile || d_pad % kDTile != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(kBTile) * t_q * (sizeof(int32_t) + sizeof(float));
  const int b_tiles = (b + kBTile - 1) / kBTile;
  if (smem > 48 * 1024 || b_tiles > 65535 || n_c > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(d_pad / kDTile), static_cast<unsigned>(b_tiles),
                  static_cast<unsigned>(n_c));
  const dim3 block(kDTile, kBTile);
  flat_score_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(qi), static_cast<const float*>(qw),
      static_cast<const int32_t*>(term), static_cast<const float*>(tf),
      static_cast<float*>(out), l_c, d_pad, b, t_q);
  return static_cast<int>(cudaGetLastError());
}

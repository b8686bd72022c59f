// K1 fold_mean and K2 fold_rows: fused gather + masked fold of embedding
// rows, for Hopper (sm_90a).
//
// Replaces recommendsystem_tpu/embedding/packed.py::fold_mean (the Pallas
// kernel at packed.py:273, pallas_call at :307) and ::fold_rows (:327,
// pallas_call at :347).  On the TPU the table was first gathered as 128-lane
// physical rows by an XLA take (packed.py:589) and the kernel selected each
// id's D-lane group in VMEM.  Here the table stays (rows, D) float32 and
// contiguous, and the gather is fused into the fold: the (E, 128) wide
// stream never exists.
//
//   fold_mean: out[c*B + b, :] = sum_j mask[c, j, b] * table[ids[c, j, b], :]
//              ids/mask l-major: slot j of row b of column c at (c*L + j)*B + b
//   fold_rows: out[e, :]       = mask[e] * table[ids[e], :]
//
// Bound on the H100 (3.35 TB/s HBM, 67 TFLOP/s float32): bytes.  Per output
// row the fold reads L ids and L masks (4 B each) and up to L table rows
// (D*4 B: one 32-B sector at D=8) and writes D*4 B; L*D multiply-adds are
// far below the float32 rate.  Design: one thread per output element
// (row x, lane d), d fastest, so the D threads of a row read one contiguous
// table row and a warp reads 32/D whole rows; neighbouring rows read
// neighbouring ids and masks (l-major).  A slot with mask 0 (padding, id 0)
// skips its table read.  No shared memory: nothing is reused within a block.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void fold_mean_kernel(const float* __restrict__ table,
                                 const int* __restrict__ ids,
                                 const float* __restrict__ mask,
                                 float* __restrict__ out,
                                 long long c, int l, long long b, int d) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= c * b * d) return;
  const long long x = t / d;
  const int lane = static_cast<int>(t - x * d);
  const long long ci = x / b;
  const long long bi = x - ci * b;
  const long long base = ci * l * b + bi;
  float acc = 0.f;
  for (int j = 0; j < l; ++j) {
    const long long e = base + j * b;
    const float m = mask[e];
    if (m != 0.f) acc += m * table[static_cast<long long>(ids[e]) * d + lane];
  }
  out[t] = acc;
}

__global__ void fold_rows_kernel(const float* __restrict__ table,
                                 const int* __restrict__ ids,
                                 const float* __restrict__ mask,
                                 float* __restrict__ out,
                                 long long e, int d) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= e * d) return;
  const long long r = t / d;
  const int lane = static_cast<int>(t - r * d);
  const float m = mask[r];
  out[t] = (m != 0.f) ? m * table[static_cast<long long>(ids[r]) * d + lane] : 0.f;
}

unsigned int blocks_for(long long n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

}  // namespace

RS_EXPORT int fold_mean_f32(const float* table, const int* ids,
                            const float* mask, float* out, long long c, int l,
                            long long b, int d, cudaStream_t stream) {
  fold_mean_kernel<<<blocks_for(c * b * d), kThreads, 0, stream>>>(
      table, ids, mask, out, c, l, b, d);
  return static_cast<int>(cudaGetLastError());
}

RS_EXPORT int fold_rows_f32(const float* table, const int* ids,
                            const float* mask, float* out, long long e, int d,
                            cudaStream_t stream) {
  fold_rows_kernel<<<blocks_for(e * d), kThreads, 0, stream>>>(
      table, ids, mask, out, e, d);
  return static_cast<int>(cudaGetLastError());
}

// K3 unfold_mean and K4 unfold_rows, each fused with the scatter-add that
// consumes it, for Hopper (sm_90a).
//
// Replaces recommendsystem_tpu/embedding/packed.py::unfold_mean (the Pallas
// kernel at packed.py:365, pallas_call at :394) and ::unfold_rows (:416,
// pallas_call at :437), together with the XLA scatter that follows them in
// apply_gradients_packed (acc.at[phys].add(pay), packed.py:671).  On the TPU
// the unfold wrote a (E, 128) payload of [grad | count] lane groups because
// the scatter needed 128-lane rows.  Here the payload never exists: each
// live entry adds its column's gradient and a count of 1.0 straight into a
// per-storage (rows, D+1) float32 accumulator,
//
//   acc[id, 0:D] += g[row(x), :]    acc[id, D] += 1.0    for mask[x] > 0
//
// with row(x) = x mod B: unfold_mean's ids and mask are l-major (slot j of
// sample b at j*B + b) and broadcast the (B, D) gradient of the column's sums
// over its L slots; unfold_rows is the case L = 1 (one gradient row per
// entry).  Entries with mask 0 (padding, id 0) are skipped, so they never
// contend on row 0.
//
// Bound on the H100: atomics.  One column at B = 65536, L = 5, D = 8 reads
// 1.3 MB of ids, 1.3 MB of mask and 2.1 MB of gradient, and adds into at
// most 327,680 accumulator rows of 36 B; the 9.5 MB accumulator of a
// 265,104-row storage sits in the 50 MB L2, so the float atomics (9 per
// live slot: at most 2.9M, ~1.8M at the synthetic data's ragged lengths),
// resolved in L2, bound it rather than device memory (4 us of bytes; the
// kernel takes ~14 us alone, PERF.md).
// Design: one thread per (entry, lane), lane fastest, so the D+1 threads of
// an entry add into one contiguous accumulator row and neighbouring entries
// read neighbouring ids, masks and gradient rows.  atomicAdd with its result
// unused compiles to a fire-and-forget reduction (RED).  Sums of gradients
// take a different order on every run; the counts are sums of 1.0 and stay
// exact.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void unfold_scatter_kernel(float* __restrict__ acc,
                                      const float* __restrict__ g,
                                      const int* __restrict__ ids,
                                      const float* __restrict__ mask,
                                      long long e, long long b, int d) {
  const int width = d + 1;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= e * width) return;
  const long long x = t / width;
  const int lane = static_cast<int>(t - x * width);
  if (!(mask[x] > 0.f)) return;
  const float val = lane < d ? g[(x % b) * d + lane] : 1.f;
  atomicAdd(acc + static_cast<long long>(ids[x]) * width + lane, val);
}

int launch(float* acc, const float* g, const int* ids, const float* mask,
           long long e, long long b, int d, cudaStream_t stream) {
  const long long n = e * (d + 1);
  const unsigned int blocks = static_cast<unsigned int>((n + kThreads - 1) / kThreads);
  unfold_scatter_kernel<<<blocks, kThreads, 0, stream>>>(acc, g, ids, mask, e, b, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// g: (B, D) gradient of one mean column's sums; ids, mask: (L*B,) l-major.
RS_EXPORT int unfold_mean_scatter_f32(float* acc, const float* g, const int* ids,
                                      const float* mask, int l, long long b,
                                      int d, cudaStream_t stream) {
  return launch(acc, g, ids, mask, static_cast<long long>(l) * b, b, d, stream);
}

// g: (E, D) one gradient row per entry; ids, mask: (E,).
RS_EXPORT int unfold_rows_scatter_f32(float* acc, const float* g, const int* ids,
                                      const float* mask, long long e, int d,
                                      cudaStream_t stream) {
  return launch(acc, g, ids, mask, e, e, d, stream);
}

// K8 sparse_adam_update: the lazy per-row Adam pass over one storage, for
// Hopper (sm_90a).
//
// Replaces recommendsystem_tpu/embedding/packed.py::packed_adam_update
// (:1099; plain jnp in the JAX package, where it ran over the (rows/Ps, 128)
// packed-state layout) with the arithmetic of
// recommendsystem_tpu/embedding/optimizers.py::SparseAdam.update.  Here the
// state keeps the classic per-row layout: w, m, v (rows, D) and t, show
// (rows, 1) float32, all contiguous; acc is the (rows, D+1) [grad | count]
// accumulator that the unfold-scatter kernels filled.  For a row with
// count c = acc[r, D] > 0:
//
//   t += 1;  m = b1*m + (1-b1)*g;  v = b2*v + (1-b2)*g*g
//   w -= lr * (m / (1 - b1^max(t,1))) / (sqrt(v / (1 - b2^max(t,1))) + eps)
//   show += c;  acc[r, :] = 0
//
// A row with count 0 touches nothing but its count: w, m, v, t and show
// stay bit-identical, and its accumulator row is already zero.  Zeroing the
// live rows here means the next step needs no memset of the accumulator.
// Products and sums use the _rn intrinsics, so the compiler fuses none of
// them into an FMA and each rounds as the float32 reference does; powf
// differs from the host's pow by up to 2 ulp.
//
// Bound on the H100: bytes.  A live row moves 280 B (acc read and zeroed,
// 72 B; w, m, v read and written, 192 B; t and show, 16 B), a dead row the
// 4 B of its count: at most ~74 MB, ~22 us at 3.35 TB/s, for a storage of
// 265,104 rows of D = 8.  Design: each row gets min(D+1, 32) neighbouring
// threads of one warp (3 rows a warp at D = 8), thread j taking lanes j,
// j+32, ... of the row; lane D is the count.  Every thread of a row reads
// the count and t, then __syncwarp, then the thread of lane D clears the
// count and writes t, so no thread reads either after it changed.
// Neighbouring rows sit in neighbouring
// threads, so every load and store of a warp covers contiguous bytes.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
sparse_adam_kernel(float* __restrict__ w, float* __restrict__ m,
                   float* __restrict__ v, float* __restrict__ t,
                   float* __restrict__ show, float* __restrict__ acc,
                   long long rows, int d, float lr, float b1, float omb1,
                   float b2, float omb2, float eps) {
  const int width = d + 1;
  const int group = width < 32 ? width : 32;     // threads per row
  const int per_warp = 32 / group;               // rows per warp
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int wl = threadIdx.x & 31;
  const int seg = wl / group;
  const int sub = wl - seg * group;
  const long long r = warp * per_warp + seg;
  const bool ok = seg < per_warp && r < rows;
  const float cnt = ok ? acc[r * width + d] : 0.f;
  const bool live = cnt > 0.f;
  const float t_old = live ? t[r] : 0.f;
  __syncwarp();                                  // count and t read before any write
  if (!live) return;

  const float t_new = __fadd_rn(t_old, 1.f);
  const float ts = fmaxf(t_new, 1.f);
  const float bc1 = __fsub_rn(1.f, powf(b1, ts));
  const float bc2 = __fsub_rn(1.f, powf(b2, ts));
  for (int j = sub; j < width; j += group) {
    const long long ia = r * width + j;
    if (j < d) {
      const float g = acc[ia];
      acc[ia] = 0.f;
      const long long k = r * d + j;
      const float mm = __fadd_rn(__fmul_rn(b1, m[k]), __fmul_rn(omb1, g));
      const float vv = __fadd_rn(__fmul_rn(b2, v[k]),
                                 __fmul_rn(omb2, __fmul_rn(g, g)));
      m[k] = mm;
      v[k] = vv;
      const float m_hat = __fdiv_rn(mm, bc1);
      const float v_hat = __fdiv_rn(vv, bc2);
      const float step = __fdiv_rn(__fmul_rn(lr, m_hat),
                                   __fadd_rn(__fsqrt_rn(v_hat), eps));
      w[k] = __fsub_rn(w[k], step);
    } else {
      acc[ia] = 0.f;
      t[r] = t_new;
      show[r] = __fadd_rn(show[r], cnt);
    }
  }
}

}  // namespace

RS_EXPORT int sparse_adam_update_f32(float* w, float* m, float* v, float* t,
                                     float* show, float* acc, long long rows,
                                     int d, float lr, float b1, float omb1,
                                     float b2, float omb2, float eps,
                                     cudaStream_t stream) {
  const int group = d + 1 < 32 ? d + 1 : 32;
  const long long warps = (rows + 32 / group - 1) / (32 / group);
  const long long threads = warps * 32;
  const unsigned int blocks = static_cast<unsigned int>((threads + kThreads - 1) / kThreads);
  sparse_adam_kernel<<<blocks, kThreads, 0, stream>>>(
      w, m, v, t, show, acc, rows, d, lr, b1, omb1, b2, omb2, eps);
  return static_cast<int>(cudaGetLastError());
}

// K7 din_pool: DIN attention pooling of the staytime model, for Hopper
// (sm_90a).
//
// Replaces recommendsystem_tpu/kernels/din_pallas.py::din_pool (:72;
// _pallas_forward :44, pallas_call :51, the block math _din_block :25).  Per
// sample b with query q (H), facts f_t (T x H) and mask m_t:
//
//   x_t   = [q, f_t, q - f_t, q * f_t]                    (4H features)
//   s_t   = sigmoid(x_t . W1 + b1) . w2 + b2              (W1 (4H, 16))
//   s_t   = MASK_PAD where not m_t > 0                    (replaces the score)
//   p     = softmax over t of s
//   out_b = sum_t p_t f_t                                 (H)
//
// MASK_PAD is -(2^32) + 1, which float32 rounds to -2^32.  It replaces a
// score rather than adding -inf, so a sample whose mask is all 0 gets a
// uniform softmax and returns the mean of its T facts, as the reference does.
//
// Bound on the H100 (67 TFLOP/s float32, 3.35 TB/s): bytes.  In the folded
// form below the function needs H*16 + 16 + H multiply-adds per (sample, t)
// and 2*H*16 per sample: at B = 16384, T = 50, H = 16 that is 0.49 GFLOP
// (7.3 us), against 57.8 MB read and written once (17.3 us).  The TPU
// kernel's own count of the unfolded features (din_pallas.py:64-67), 1.73
// GFLOP, overstates the work.
//
// Design.  With W1 split by rows into the blocks Wa, Wb, Wc, Wd that meet
// q, f, q - f and q * f, the pre-activation of hidden unit j is
//
//   a_j + sum_k f_k M[k, j],   a_j = b1_j + sum_k q_k (Wa + Wc)[k, j],
//                              M[k, j] = (Wb - Wc)[k, j] + q_k Wd[k, j],
//
// so a and M are built once per sample and each t costs H*16 multiply-adds,
// a quarter of the features' product.  One warp per sample, 8 samples a
// block: the block folds W1 into Wa + Wc, Wb - Wc and Wd in shared memory;
// the warp builds its sample's a and M there; lane l scores t = l, l + 32,
// ... with the 16 pre-activations in registers, reading M as float4
// broadcasts.  The scores stay in shared memory, the masked max and the
// softmax sum are warp shuffles, and the pooling gives each fact row H
// lanes on neighbouring addresses.  The scorer's sigmoid uses the fast
// exponential and division (__expf, __fdividef): a few ulp on a value that
// only weights the softmax.
//
// The model passes strided views (the first 16 of 32 lanes of a row), so
// the kernel takes the row strides of q, facts and mask; the last dimension
// of each must be contiguous.  Output (B, H) contiguous.

#include <cmath>

#include "common.cuh"

namespace {

constexpr int H = 16;                          // the query and fact width
constexpr int kHidden = 16;
constexpr int kWarps = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kMaskPad = -4294967296.0f;   // -(2^32) + 1 in float32

__global__ void __launch_bounds__(kWarps * 32)
din_pool_kernel(const float* __restrict__ q, const float* __restrict__ facts,
                const float* __restrict__ mask, const float* __restrict__ w1,
                const float* __restrict__ b1, const float* __restrict__ w2,
                const float* __restrict__ b2, float* __restrict__ out,
                long long b, int t, long long qb, long long fb, long long ft,
                long long mb, long long mt) {
  constexpr int kW = H * kHidden;              // one (H, 16) block of W1
  __shared__ __align__(16) float s_wq[kW];     // Wa + Wc
  __shared__ __align__(16) float s_wf[kW];     // Wb - Wc
  __shared__ __align__(16) float s_wd[kW];     // Wd
  __shared__ __align__(16) float s_m[kWarps][kW];
  __shared__ __align__(16) float s_a[kWarps][kHidden];
  __shared__ float s_b1[kHidden];
  __shared__ float s_w2[kHidden];
  extern __shared__ float s_scores[];          // kWarps x t
  for (int i = threadIdx.x; i < kW; i += blockDim.x) {
    const float wc = w1[2 * kW + i];
    s_wq[i] = w1[i] + wc;
    s_wf[i] = w1[kW + i] - wc;
    s_wd[i] = w1[3 * kW + i];
  }
  if (threadIdx.x < kHidden) {
    s_b1[threadIdx.x] = b1[threadIdx.x];
    s_w2[threadIdx.x] = w2[threadIdx.x];
  }
  const float bias2 = b2[0];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long sample = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (sample >= b) return;                     // whole warps leave together
  const float* qs = q + sample * qb;
  const float* fs = facts + sample * fb;
  const float* ms = mask + sample * mb;
  float* m = s_m[warp];
  float* p = s_scores + warp * t;

  // this sample's a (16) and M (H x 16)
  for (int i = lane; i < kW; i += 32) m[i] = fmaf(qs[i / kHidden], s_wd[i], s_wf[i]);
  if (lane < kHidden) {
    float a = 0.f;
#pragma unroll
    for (int k = 0; k < H; ++k) a = fmaf(qs[k], s_wq[k * kHidden + lane], a);
    s_a[warp][lane] = s_b1[lane] + a;
  }
  __syncwarp();

  // scores, and the running max of this lane's scores
  float mx = -INFINITY;
  for (int ti = lane; ti < t; ti += 32) {
    // M and a are read from shared memory on every pass: hoisted out of the
    // loop, their H*16 + 16 values would take every register and spill
    asm volatile("" ::: "memory");
    const float* fr = fs + ti * ft;
    float fv[H];
#pragma unroll
    for (int k = 0; k < H; ++k) fv[k] = fr[k];
    float acc[kHidden];
#pragma unroll
    for (int j4 = 0; j4 < kHidden / 4; ++j4) {
      const float4 a4 = reinterpret_cast<const float4*>(s_a[warp])[j4];
      acc[4 * j4 + 0] = a4.x;
      acc[4 * j4 + 1] = a4.y;
      acc[4 * j4 + 2] = a4.z;
      acc[4 * j4 + 3] = a4.w;
    }
#pragma unroll
    for (int k = 0; k < H; ++k) {
      const float4* row = reinterpret_cast<const float4*>(m + k * kHidden);
#pragma unroll
      for (int j4 = 0; j4 < kHidden / 4; ++j4) {
        const float4 w = row[j4];
        acc[4 * j4 + 0] = fmaf(fv[k], w.x, acc[4 * j4 + 0]);
        acc[4 * j4 + 1] = fmaf(fv[k], w.y, acc[4 * j4 + 1]);
        acc[4 * j4 + 2] = fmaf(fv[k], w.z, acc[4 * j4 + 2]);
        acc[4 * j4 + 3] = fmaf(fv[k], w.w, acc[4 * j4 + 3]);
      }
    }
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kHidden; ++j) {
      s = fmaf(__fdividef(1.f, 1.f + __expf(-acc[j])), s_w2[j], s);
    }
    s += bias2;
    if (!(ms[ti * mt] > 0.f)) s = kMaskPad;
    p[ti] = s;
    mx = fmaxf(mx, s);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));

  // softmax: each lane exponentiates and normalises its own scores
  float sum = 0.f;
  for (int ti = lane; ti < t; ti += 32) {
    const float e = expf(p[ti] - mx);
    p[ti] = e;
    sum += e;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(kFull, sum, off);
  for (int ti = lane; ti < t; ti += 32) p[ti] = p[ti] / sum;
  __syncwarp();

  // pooling: H lanes per fact row, 32 / H rows at a time
  constexpr int kRows = 32 / H;
  const int h = lane % H;
  float o = 0.f;
  for (int ti = lane / H; ti < t; ti += kRows) o = fmaf(p[ti], fs[ti * ft + h], o);
#pragma unroll
  for (int off = H; off < 32; off <<= 1) o += __shfl_xor_sync(kFull, o, off);
  if (lane < H) out[sample * H + h] = o;
}

}  // namespace

// q (B, H) with row stride qb; facts (B, T, H) with strides (fb, ft, 1);
// mask (B, T) float {0, 1} with strides (mb, mt); w1 (4H, 16), b1 (16),
// w2 (16, 1), b2 (1) contiguous; out (B, H) contiguous; H = 16.  T * 8
// floats of dynamic shared memory (the wrapper caps T at 512).
RS_EXPORT int din_pool_f32(const float* q, const float* facts, const float* mask,
                           const float* w1, const float* b1, const float* w2,
                           const float* b2, float* out, long long b, int t,
                           long long qb, long long fb, long long ft,
                           long long mb, long long mt, cudaStream_t stream) {
  const unsigned int blocks = static_cast<unsigned int>((b + kWarps - 1) / kWarps);
  const size_t smem = sizeof(float) * kWarps * static_cast<size_t>(t);
  din_pool_kernel<<<blocks, kWarps * 32, smem, stream>>>(
      q, facts, mask, w1, b1, w2, b2, out, b, t, qb, fb, ft, mb, mt);
  return static_cast<int>(cudaGetLastError());
}

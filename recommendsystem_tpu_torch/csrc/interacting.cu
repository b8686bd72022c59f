// K6 interacting_attention: one fused InteractingLayer iteration, for
// Hopper (sm_90a).
//
// Replaces recommendsystem_tpu/kernels/interacting_pallas.py::
// interacting_attention (:107; _pallas_forward :74, pallas_call :90, the
// block math _attention_block :31).  Per sample, over its F fields, with x
// (F, D) and H heads of width DH = U / H cut head-major from U:
//
//   q = relu(x Wq + bq), k = relu(x Wk + bk), v = relu(x Wv + bv),
//   r = relu(x Wr + br)                                       (F, U) each
//   o_h = softmax(q_h k_h^T / sqrt(DH)) v_h                   per head
//   o = relu(o + r)
//   out = (o - mean(o)) * rsqrt(var(o) + eps) * gamma + beta  over U
//
// Bound on the H100 (3.35 TB/s HBM, 67 TFLOP/s float32): at F = 24 the
// bytes (x and out once, 64 B a field) and the operations (4 projections
// of 2*D*U and 2*H*F*DH*2 for the attention, per field) come out nearly
// equal (B = 65536: 100.7 MB, 30.05 us; 2.01 GFLOP, 30.05 us); at F = 180
// the attention's F^2 term makes it operations-bound.
//
// Design.  The TPU kernel cut the batch into tiles held as (8, 128)-padded
// VMEM intermediates; none of that is carried over.  A block holds S =
// max(1, 256 / F) samples, one thread per (sample, query field).  It stages
// the 4*D*U + 6*U parameters and its samples' x rows (contiguous, read as
// float4) in shared memory.  Each thread computes its field's q and r rows
// in registers and writes its k and v rows to shared memory; after one
// barrier it reads its sample's F key and value rows as float4 broadcasts.
// The softmax takes two passes over the keys, the maximum per head and then
// the exponentials, their sum and the weighted sum of v, as the plain
// version computes it; the scores are recomputed in the second pass (8
// multiply-adds a key), which costs less than the rescaling exponential of
// an online softmax.  One thread holds every head of its field, so the
// LayerNorm over U runs in registers and the output row leaves as two
// float4 stores.  expf and IEEE division, no fast math: the kernel holds
// to the plain version within 2e-5.  Shared memory: (S*F*D + 2*S*(F*U + 4))
// floats, 23 KB at F = 24 and 17 KB at F = 180; each sample's k and v rows
// are padded by 4 floats so that the two samples a warp may span read
// other banks.

#include <cmath>

#include "common.cuh"

namespace {

constexpr int D = 8;                 // input width
constexpr int U = 8;                 // units
constexpr int kMaxThreads = 256;

template <int H>
__global__ void __launch_bounds__(kMaxThreads)
interacting_kernel(const float* __restrict__ x, const float* __restrict__ wq,
                   const float* __restrict__ bq, const float* __restrict__ wk,
                   const float* __restrict__ bk, const float* __restrict__ wv,
                   const float* __restrict__ bv, const float* __restrict__ wr,
                   const float* __restrict__ br, const float* __restrict__ gamma,
                   const float* __restrict__ beta, float* __restrict__ out,
                   long long b, int f, int s, float scale, float eps) {
  constexpr int DH = U / H;
  __shared__ __align__(16) float s_w[4][D * U];      // Wq, Wk, Wv, Wr
  __shared__ float s_b[4][U];                        // bq, bk, bv, br
  __shared__ float s_gamma[U];
  __shared__ float s_beta[U];
  extern __shared__ __align__(16) float smem[];
  const int kv_stride = f * U + 4;
  float* s_x = smem;                                 // s * f * D
  float* s_k = s_x + s * f * D;                      // s * kv_stride
  float* s_v = s_k + s * kv_stride;                  // s * kv_stride

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  for (int i = tid; i < D * U; i += nthreads) {
    s_w[0][i] = wq[i];
    s_w[1][i] = wk[i];
    s_w[2][i] = wv[i];
    s_w[3][i] = wr[i];
  }
  for (int i = tid; i < U; i += nthreads) {
    s_b[0][i] = bq[i];
    s_b[1][i] = bk[i];
    s_b[2][i] = bv[i];
    s_b[3][i] = br[i];
    s_gamma[i] = gamma[i];
    s_beta[i] = beta[i];
  }
  const long long s0 = static_cast<long long>(blockIdx.x) * s;
  const int ns = static_cast<int>(min(static_cast<long long>(s), b - s0));
  const float4* xg = reinterpret_cast<const float4*>(x + s0 * f * D);
  float4* xs = reinterpret_cast<float4*>(s_x);
  for (int i = tid; i < ns * f * (D / 4); i += nthreads) xs[i] = xg[i];
  __syncthreads();

  const int sl = tid / f;                            // sample in the block
  const int fi = tid - sl * f;                       // query field
  const bool live = sl < ns;
  float q[U], r[U];
  if (live) {
    float xv[D];
    const float4* xr = reinterpret_cast<const float4*>(s_x + tid * D);
#pragma unroll
    for (int d4 = 0; d4 < D / 4; ++d4) {
      const float4 t = xr[d4];
      xv[4 * d4 + 0] = t.x;
      xv[4 * d4 + 1] = t.y;
      xv[4 * d4 + 2] = t.z;
      xv[4 * d4 + 3] = t.w;
    }
    float k[U], v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) q[u] = k[u] = v[u] = r[u] = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        q[u] = fmaf(xv[d], s_w[0][d * U + u], q[u]);
        k[u] = fmaf(xv[d], s_w[1][d * U + u], k[u]);
        v[u] = fmaf(xv[d], s_w[2][d * U + u], v[u]);
        r[u] = fmaf(xv[d], s_w[3][d * U + u], r[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      q[u] = fmaxf(q[u] + s_b[0][u], 0.f);
      k[u] = fmaxf(k[u] + s_b[1][u], 0.f);
      v[u] = fmaxf(v[u] + s_b[2][u], 0.f);
      r[u] = fmaxf(r[u] + s_b[3][u], 0.f);
    }
    float4* kd = reinterpret_cast<float4*>(s_k + sl * kv_stride + fi * U);
    float4* vd = reinterpret_cast<float4*>(s_v + sl * kv_stride + fi * U);
#pragma unroll
    for (int u4 = 0; u4 < U / 4; ++u4) {
      kd[u4] = make_float4(k[4 * u4], k[4 * u4 + 1], k[4 * u4 + 2], k[4 * u4 + 3]);
      vd[u4] = make_float4(v[4 * u4], v[4 * u4 + 1], v[4 * u4 + 2], v[4 * u4 + 3]);
    }
  }
  __syncthreads();
  if (!live) return;

  const float4* ks = reinterpret_cast<const float4*>(s_k + sl * kv_stride);
  const float4* vs = reinterpret_cast<const float4*>(s_v + sl * kv_stride);

  // pass 1: the maximum score of each head
  float mx[H];
#pragma unroll
  for (int h = 0; h < H; ++h) mx[h] = -INFINITY;
  for (int g = 0; g < f; ++g) {
    float kr[U];
#pragma unroll
    for (int u4 = 0; u4 < U / 4; ++u4) {
      const float4 t = ks[g * (U / 4) + u4];
      kr[4 * u4 + 0] = t.x;
      kr[4 * u4 + 1] = t.y;
      kr[4 * u4 + 2] = t.z;
      kr[4 * u4 + 3] = t.w;
    }
#pragma unroll
    for (int h = 0; h < H; ++h) {
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < DH; ++j) dot = fmaf(q[h * DH + j], kr[h * DH + j], dot);
      mx[h] = fmaxf(mx[h], dot / scale);
    }
  }

  // pass 2: exponentials, their sum and the weighted sum of v
  float sum[H], acc[U];
#pragma unroll
  for (int h = 0; h < H; ++h) sum[h] = 0.f;
#pragma unroll
  for (int u = 0; u < U; ++u) acc[u] = 0.f;
  for (int g = 0; g < f; ++g) {
    float kr[U], vr[U];
#pragma unroll
    for (int u4 = 0; u4 < U / 4; ++u4) {
      const float4 t = ks[g * (U / 4) + u4];
      kr[4 * u4 + 0] = t.x;
      kr[4 * u4 + 1] = t.y;
      kr[4 * u4 + 2] = t.z;
      kr[4 * u4 + 3] = t.w;
      const float4 w = vs[g * (U / 4) + u4];
      vr[4 * u4 + 0] = w.x;
      vr[4 * u4 + 1] = w.y;
      vr[4 * u4 + 2] = w.z;
      vr[4 * u4 + 3] = w.w;
    }
#pragma unroll
    for (int h = 0; h < H; ++h) {
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < DH; ++j) dot = fmaf(q[h * DH + j], kr[h * DH + j], dot);
      const float e = expf(dot / scale - mx[h]);
      sum[h] += e;
#pragma unroll
      for (int j = 0; j < DH; ++j) acc[h * DH + j] = fmaf(e, vr[h * DH + j], acc[h * DH + j]);
    }
  }

  // residual, relu and the LayerNorm over U
  float o[U];
  float mu = 0.f;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    o[u] = fmaxf(acc[u] / sum[u / DH] + r[u], 0.f);
    mu += o[u];
  }
  mu /= U;
  float var = 0.f;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const float c = o[u] - mu;
    var = fmaf(c, c, var);
  }
  var /= U;
  const float inv = rsqrtf(var + eps);
  float y[U];
#pragma unroll
  for (int u = 0; u < U; ++u) y[u] = (o[u] - mu) * inv * s_gamma[u] + s_beta[u];
  float4* dst = reinterpret_cast<float4*>(out + ((s0 + sl) * f + fi) * U);
#pragma unroll
  for (int u4 = 0; u4 < U / 4; ++u4) {
    dst[u4] = make_float4(y[4 * u4], y[4 * u4 + 1], y[4 * u4 + 2], y[4 * u4 + 3]);
  }
}

template <int H>
cudaError_t launch(const float* x, const float* wq, const float* bq,
                   const float* wk, const float* bk, const float* wv,
                   const float* bv, const float* wr, const float* br,
                   const float* gamma, const float* beta, float* out,
                   long long b, int f, float scale, float eps,
                   cudaStream_t stream) {
  const int s = f >= kMaxThreads ? 1 : kMaxThreads / f;
  const unsigned int blocks = static_cast<unsigned int>((b + s - 1) / s);
  const size_t smem = sizeof(float) * (static_cast<size_t>(s) * f * D
                                       + 2 * static_cast<size_t>(s) * (f * U + 4));
  interacting_kernel<H><<<blocks, s * f, smem, stream>>>(
      x, wq, bq, wk, bk, wv, bv, wr, br, gamma, beta, out, b, f, s, scale, eps);
  return cudaGetLastError();
}

}  // namespace

// x (B, F, 8) and out (B, F, 8) contiguous float32, 16-byte aligned; wq,
// wk, wv, wr (8, 8), bq, bk, bv, br, gamma, beta (8) contiguous; 1 <= F <=
// 256; h in {1, 2, 4, 8}; scale = sqrt(8 / h).  Other h: cudaErrorInvalidValue.
RS_EXPORT int interacting_attention_f32(
    const float* x, const float* wq, const float* bq, const float* wk,
    const float* bk, const float* wv, const float* bv, const float* wr,
    const float* br, const float* gamma, const float* beta, float* out,
    long long b, int f, int h, float scale, float eps, cudaStream_t stream) {
  switch (h) {
    case 1: return static_cast<int>(launch<1>(x, wq, bq, wk, bk, wv, bv, wr, br,
                                              gamma, beta, out, b, f, scale, eps, stream));
    case 2: return static_cast<int>(launch<2>(x, wq, bq, wk, bk, wv, bv, wr, br,
                                              gamma, beta, out, b, f, scale, eps, stream));
    case 4: return static_cast<int>(launch<4>(x, wq, bq, wk, bk, wv, bv, wr, br,
                                              gamma, beta, out, b, f, scale, eps, stream));
    case 8: return static_cast<int>(launch<8>(x, wq, bq, wk, bk, wv, bv, wr, br,
                                              gamma, beta, out, b, f, scale, eps, stream));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

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
// equal (B = 65536: 100.7 MB, 30.05 us; 2.01 GFLOP, 30.05 us); at F = 40
// (B = 32768, 35.06 us) and F = 180 (B = 8192, 138.04 us) the attention's
// F^2 term makes it operations-bound.
//
// Design.  The TPU kernel cut the batch into tiles held as (8, 128)-padded
// VMEM intermediates; none of that is carried over.  A thread takes QP
// query fields of one sample (QP = 2; 1 at H = 8, where its per-head state
// would not fit 64 registers), TPS = ceil(F / QP) threads a sample, and a
// block S = max(1, 256 / TPS) samples (21 at F = 24, 12 at F = 40, 2 at
// F = 180), so a warp may span samples but is full but for the block's
// last.  The 4*D*U + 6*U parameters sit in shared memory and every thread
// reads them as 16-byte broadcasts, one weight row serving its QP fields.
// Each thread reads its fields' x rows from device memory (32 B each),
// computes k, v and r, writes them to shared memory, and keeps q in
// registers, pre-scaled by log2(e) / sqrt(DH) after its ReLU so that scores
// come out in base 2 with no division.
//
// Softmax with no running max.  q and k come out of a ReLU, so every score
// of a head is at most M = sum_d q_d * kmax_d, with kmax_d the largest k_d
// over the sample's F fields (one pass over the keys in shared memory after
// the projections).  Each weight is then exp2(s - M) <= 1, in one pass over
// the keys with no max, no rescaling and no second pass: per (query, key,
// head) DH FMA for the score (its chain starts at -M), one ex2.approx, one
// add to the sum and DH FMA into the output, 2*DH + 2 instructions, 20 a
// (query, key) pair over H = 2 heads at DH = 4.  Each k and v row read from shared
// memory serves QP queries; the threads of a sample read the same row, so a
// warp's 16-byte read is one broadcast wavefront (each sample's rows are
// padded by 4 floats, so the samples a warp spans use other banks).  If M
// overshoots the true max so far that a head's sum falls below 2^-64 (only
// for scores spread by more than 64 in base 2), the thread recomputes that
// head exactly, max first: the result never depends on the bound.
// Residual, ReLU and the LayerNorm over U run in registers (one reciprocal a
// head, IEEE), and the output row leaves as two 16-byte stores.  The kernel
// holds to the plain version within 2e-5 (ex2.approx: 2 ulp).  Shared
// memory: (2*S*(F*U + 4) + S*F*U + S*U) floats, 48.5 KB at F = 24, 34 KB at
// F = 180; registers: the build log's -Xptxas -v (the launch bounds cap
// them at 64: 4 blocks of 256 threads an SM; at H <= 4 up to 24 bytes
// spill).  What holds it back now:
// instructions (20 a pair at F = 180, where the pairs are 97 % of the work)
// and, at F = 24, the projections (4 x 64 FMA and 32 broadcast loads a
// field) beside device memory.
//
// bf16 inputs (the bf16 compute policy).  x and the ten parameters may be
// bfloat16, x's type (TX) and the parameters' (TP) on their own: the first
// iteration takes bf16 x and bf16 parameters, a later one the float32
// output of the one before with bf16 parameters.  The JAX kernel takes
// every product with preferred_element_type=float32, so on bf16 operands
// its body is the float32 body on inputs widened exactly; here each value
// is widened as it is loaded (a bf16 x row is one 16-byte load, half the
// float32 row's bytes) and everything after is the float32 kernel.  The
// output stays float32.

#include <cmath>

#include "common.cuh"

namespace {

constexpr int D = 8;                 // input width
constexpr int U = 8;                 // units
constexpr int kMaxThreads = 256;
constexpr float kLog2e = 1.44269504f;
constexpr float kTiny = 5.42101086e-20f;   // 2^-64: a head's sum below it is recomputed

template <int H>
struct Tile {
  static constexpr int DH = U / H;
  static constexpr int QP = H == 8 ? 1 : 2;   // query fields a thread
};

// 2^x in one MUFU op; subnormal results flush to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// N consecutive floats of shared memory, in 16-, 8- or 4-byte loads
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float* r) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      r[i] = t.x; r[i + 1] = t.y; r[i + 2] = t.z; r[i + 3] = t.w;
    }
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    r[0] = t.x; r[1] = t.y;
  } else {
    r[0] = p[0];
  }
}

__device__ __forceinline__ void store_row(float* p, const float (&r)[U]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(r[0], r[1], r[2], r[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(r[4], r[5], r[6], r[7]);
}

// relu(x W + b) of the thread's QP fields, W and b matrix m of shared memory
template <int QP>
__device__ __forceinline__ void project(const float (&xv)[QP][D], const float* w,
                                        const float* bias, float (&res)[QP][U]) {
#pragma unroll
  for (int i = 0; i < QP; ++i) {
#pragma unroll
    for (int u = 0; u < U; ++u) res[i][u] = 0.f;
  }
#pragma unroll
  for (int d = 0; d < D; ++d) {
    float wr[U];
    load_vec<U>(w + d * U, wr);
#pragma unroll
    for (int i = 0; i < QP; ++i) {
#pragma unroll
      for (int u = 0; u < U; ++u) res[i][u] = fmaf(xv[i][d], wr[u], res[i][u]);
    }
  }
  float bv[U];
  load_vec<U>(bias, bv);
#pragma unroll
  for (int i = 0; i < QP; ++i) {
#pragma unroll
    for (int u = 0; u < U; ++u) res[i][u] = fmaxf(res[i][u] + bv[u], 0.f);
  }
}

template <int H, typename TX, typename TP>
__global__ void __launch_bounds__(kMaxThreads, 4)
interacting_kernel(const TX* __restrict__ x, const TP* __restrict__ wq,
                   const TP* __restrict__ bq, const TP* __restrict__ wk,
                   const TP* __restrict__ bk, const TP* __restrict__ wv,
                   const TP* __restrict__ bv, const TP* __restrict__ wr,
                   const TP* __restrict__ br, const TP* __restrict__ gamma,
                   const TP* __restrict__ beta, float* __restrict__ out,
                   long long b, int f, int s, int tps, float scale, float eps) {
  constexpr int DH = Tile<H>::DH;
  constexpr int QP = Tile<H>::QP;
  __shared__ __align__(16) float s_w[4][D * U];      // Wq, Wk, Wv, Wr
  __shared__ __align__(16) float s_b[4][U];          // bq, bk, bv, br
  __shared__ float s_gamma[U];
  __shared__ float s_beta[U];
  extern __shared__ __align__(16) float smem[];
  const int kv_stride = f * U + 4;
  float* s_k = smem;                                 // s * kv_stride
  float* s_v = s_k + s * kv_stride;                  // s * kv_stride
  float* s_r = s_v + s * kv_stride;                  // s * f * U: the residual rows
  float* s_kmax = s_r + s * f * U;                   // s * U

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  for (int i = tid; i < D * U; i += nthreads) {
    s_w[0][i] = to_float(wq[i]);
    s_w[1][i] = to_float(wk[i]);
    s_w[2][i] = to_float(wv[i]);
    s_w[3][i] = to_float(wr[i]);
  }
  for (int i = tid; i < U; i += nthreads) {
    s_b[0][i] = to_float(bq[i]);
    s_b[1][i] = to_float(bk[i]);
    s_b[2][i] = to_float(bv[i]);
    s_b[3][i] = to_float(br[i]);
    s_gamma[i] = to_float(gamma[i]);
    s_beta[i] = to_float(beta[i]);
  }
  const long long s0 = static_cast<long long>(blockIdx.x) * s;
  const int ns = static_cast<int>(min(static_cast<long long>(s), b - s0));
  const int sl = tid / tps;                          // sample in the block
  const int f0 = (tid - sl * tps) * QP;              // first query field
  const bool live = sl < ns;
  __syncthreads();

  // projections: k, v and r of the thread's fields to shared memory, q kept
  float qv[QP][U];
  if (live) {
    using Row = Lanes<TX, D>;
    float xv[QP][D];
#pragma unroll
    for (int i = 0; i < QP; ++i) {
      const bool ok = f0 + i < f;
      const typename Row::Raw* xr = reinterpret_cast<const typename Row::Raw*>(
          x + ((s0 + sl) * f + (ok ? f0 + i : 0)) * D);
      if (ok) {
        Row::widen(*xr, xv[i]);
      } else {
#pragma unroll
        for (int j = 0; j < D; ++j) xv[i][j] = 0.f;
      }
    }
    float* dst[3] = {s_k + sl * kv_stride, s_v + sl * kv_stride, s_r + sl * f * U};
#pragma unroll
    for (int m = 1; m < 4; ++m) {
      float res[QP][U];
      project<QP>(xv, s_w[m], s_b[m], res);
#pragma unroll
      for (int i = 0; i < QP; ++i) {
        if (f0 + i < f) store_row(dst[m - 1] + (f0 + i) * U, res[i]);
      }
    }
    project<QP>(xv, s_w[0], s_b[0], qv);
    const float qscale = kLog2e / scale;
#pragma unroll
    for (int i = 0; i < QP; ++i) {
#pragma unroll
      for (int u = 0; u < U; ++u) qv[i][u] *= qscale;
    }
  }
  __syncthreads();
  // the largest k of each sample and unit (k >= 0 after its ReLU)
  for (int t = tid; t < ns * U; t += nthreads) {
    const float* col = s_k + (t / U) * kv_stride + t % U;
    float m = 0.f;
#pragma unroll 8
    for (int g = 0; g < f; ++g) m = fmaxf(m, col[g * U]);   // 8 loads in flight
    s_kmax[t] = m;
  }
  __syncthreads();
  if (!live) return;

  const float* ks = s_k + sl * kv_stride;
  const float* vs = s_v + sl * kv_stride;
  float neg_bound[QP][H];   // -M of each query and head
  {
    float kmax[U];
    load_vec<U>(s_kmax + sl * U, kmax);
#pragma unroll
    for (int i = 0; i < QP; ++i) {
#pragma unroll
      for (int hh = 0; hh < H; ++hh) {
        float m = 0.f;
#pragma unroll
        for (int j = 0; j < DH; ++j) m = fmaf(qv[i][hh * DH + j], kmax[hh * DH + j], m);
        neg_bound[i][hh] = -m;
      }
    }
  }
  float acc[QP][U], sum[QP][H];
#pragma unroll
  for (int i = 0; i < QP; ++i) {
#pragma unroll
    for (int u = 0; u < U; ++u) acc[i][u] = 0.f;
#pragma unroll
    for (int hh = 0; hh < H; ++hh) sum[i][hh] = 0.f;
  }
  for (int g = 0; g < f; ++g) {
#pragma unroll
    for (int hh = 0; hh < H; ++hh) {
      float kr[DH], vr[DH], p[QP];
      load_vec<DH>(ks + g * U + hh * DH, kr);
#pragma unroll
      for (int i = 0; i < QP; ++i) {
        float sc = neg_bound[i][hh];
#pragma unroll
        for (int j = 0; j < DH; ++j) sc = fmaf(qv[i][hh * DH + j], kr[j], sc);
        p[i] = ex2(sc);
        sum[i][hh] += p[i];
      }
      load_vec<DH>(vs + g * U + hh * DH, vr);
#pragma unroll
      for (int i = 0; i < QP; ++i) {
#pragma unroll
        for (int j = 0; j < DH; ++j) acc[i][hh * DH + j] = fmaf(p[i], vr[j], acc[i][hh * DH + j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < QP; ++i) {
    const int fi = f0 + i;
    if (fi >= f) continue;
    // a head whose bound overshot: recompute it exactly, max first
#pragma unroll
    for (int hh = 0; hh < H; ++hh) {
      if (sum[i][hh] < kTiny) {
        float mx = -INFINITY;
        for (int g = 0; g < f; ++g) {
          float kr[DH];
          load_vec<DH>(ks + g * U + hh * DH, kr);
          float sc = 0.f;
#pragma unroll
          for (int j = 0; j < DH; ++j) sc = fmaf(qv[i][hh * DH + j], kr[j], sc);
          mx = fmaxf(mx, sc);
        }
        float l = 0.f, a[DH];
#pragma unroll
        for (int j = 0; j < DH; ++j) a[j] = 0.f;
        for (int g = 0; g < f; ++g) {
          float kr[DH], vr[DH];
          load_vec<DH>(ks + g * U + hh * DH, kr);
          load_vec<DH>(vs + g * U + hh * DH, vr);
          float sc = -mx;
#pragma unroll
          for (int j = 0; j < DH; ++j) sc = fmaf(qv[i][hh * DH + j], kr[j], sc);
          const float e = ex2(sc);
          l += e;
#pragma unroll
          for (int j = 0; j < DH; ++j) a[j] = fmaf(e, vr[j], a[j]);
        }
        sum[i][hh] = l;
#pragma unroll
        for (int j = 0; j < DH; ++j) acc[i][hh * DH + j] = a[j];
      }
    }

    // residual, relu and the LayerNorm over U
    float r[U], o[U];
    load_vec<U>(s_r + (sl * f + fi) * U, r);
    float mu = 0.f;
#pragma unroll
    for (int hh = 0; hh < H; ++hh) {
      const float inv = 1.f / sum[i][hh];
#pragma unroll
      for (int j = 0; j < DH; ++j) {
        const int u = hh * DH + j;
        o[u] = fmaxf(acc[i][u] * inv + r[u], 0.f);
        mu += o[u];
      }
    }
    mu /= U;
    float var = 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float c = o[u] - mu;
      var = fmaf(c, c, var);
    }
    var /= U;
    const float rs = rsqrtf(var + eps);
    float yv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) yv[u] = (o[u] - mu) * rs * s_gamma[u] + s_beta[u];
    store_row(out + ((s0 + sl) * f + fi) * U, yv);
  }
}

template <int H, typename TX, typename TP>
cudaError_t launch(const void* xp, const void* const* pp, float* out, long long b, int f,
                   float scale, float eps, cudaStream_t stream) {
  const TX* x = static_cast<const TX*>(xp);
  const TP* wq = static_cast<const TP*>(pp[0]);
  const TP* bq = static_cast<const TP*>(pp[1]);
  const TP* wk = static_cast<const TP*>(pp[2]);
  const TP* bk = static_cast<const TP*>(pp[3]);
  const TP* wv = static_cast<const TP*>(pp[4]);
  const TP* bv = static_cast<const TP*>(pp[5]);
  const TP* wr = static_cast<const TP*>(pp[6]);
  const TP* br = static_cast<const TP*>(pp[7]);
  const TP* gamma = static_cast<const TP*>(pp[8]);
  const TP* beta = static_cast<const TP*>(pp[9]);
  constexpr int QP = Tile<H>::QP;
  const int tps = (f + QP - 1) / QP;
  const int s = tps >= kMaxThreads ? 1 : kMaxThreads / tps;
  const unsigned int blocks = static_cast<unsigned int>((b + s - 1) / s);
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(s) * (f * U + 4)
                                       + static_cast<size_t>(s) * f * U
                                       + static_cast<size_t>(s) * U);
  const cudaError_t set = cudaFuncSetAttribute(
      interacting_kernel<H, TX, TP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (set != cudaSuccess) return set;
  interacting_kernel<H, TX, TP><<<blocks, s * tps, smem, stream>>>(
      x, wq, bq, wk, bk, wv, bv, wr, br, gamma, beta, out, b, f, s, tps, scale, eps);
  return cudaGetLastError();
}

template <typename TX, typename TP>
int launch_h(const void* x, const void* const* p, float* out, long long b, int f, int h,
             float scale, float eps, cudaStream_t stream) {
  switch (h) {
    case 1: return static_cast<int>(launch<1, TX, TP>(x, p, out, b, f, scale, eps, stream));
    case 2: return static_cast<int>(launch<2, TX, TP>(x, p, out, b, f, scale, eps, stream));
    case 4: return static_cast<int>(launch<4, TX, TP>(x, p, out, b, f, scale, eps, stream));
    case 8: return static_cast<int>(launch<8, TX, TP>(x, p, out, b, f, scale, eps, stream));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x (B, F, 8) contiguous, float32 (x_bf16 = 0) or bfloat16 (1), 16-byte
// aligned; wq, wk, wv, wr (8, 8), bq, bk, bv, br, gamma, beta (8)
// contiguous, all float32 (p_bf16 = 0) or all bfloat16 (1); out (B, F, 8)
// float32 contiguous, 16-byte aligned; 1 <= F <= 256; h in {1, 2, 4, 8};
// scale = sqrt(8 / h).  Other h: cudaErrorInvalidValue.
RS_EXPORT int interacting_attention(
    const void* x, const void* wq, const void* bq, const void* wk,
    const void* bk, const void* wv, const void* bv, const void* wr,
    const void* br, const void* gamma, const void* beta, float* out,
    long long b, int f, int h, float scale, float eps, int x_bf16, int p_bf16,
    cudaStream_t stream) {
  const void* const p[10] = {wq, bq, wk, bk, wv, bv, wr, br, gamma, beta};
  if (x_bf16) {
    return p_bf16 ? launch_h<bf16, bf16>(x, p, out, b, f, h, scale, eps, stream)
                  : launch_h<bf16, float>(x, p, out, b, f, h, scale, eps, stream);
  }
  return p_bf16 ? launch_h<float, bf16>(x, p, out, b, f, h, scale, eps, stream)
                : launch_h<float, float>(x, p, out, b, f, h, scale, eps, stream);
}

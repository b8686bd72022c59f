// K5: field attention, softmax over keys of q.k / sqrt(dh) across the F
// fields of each sample, times v, with optional dropout on the attention
// weights; forward (K5f) and backward (K5b).  For Hopper (sm_90a).
//
// Replaces recommendsystem_tpu/kernels/field_attention_pallas.py::
// field_attention (:175; pallas_call in _call :209, bodies _fwd_kernel :98
// and _bwd_kernel :111).  Layout as there, batch-minor: q/k/v/o/do and the
// gradients are (head, dh, F, B) float32, contiguous; lse and the row dots
// of the backward are (head, F, B).
//
// Dropout.  The TPU kernel seeded its hardware generator per grid cell.
// Here every weight (head, query fq, key fk, sample b) draws its own bits
// from Philox4x32-10 with key (k0, k1) = (step seed, iteration) and counter
// (b, fq, head, fk / 4), taking word fk % 4: each index has a word of its
// own, so no two weights share bits, and the backward regenerates the
// forward's mask from the same key.  A weight is kept when its draw is
// >= thresh = rate * 2^32 and then scaled by 1 / (1 - rate), as
// field_attention_pallas.py:71-77 does.  The plain PyTorch version
// (kernels/field_attention.py) computes the same bits with integer ops.
//
// Bound on the H100 (3.35 TB/s HBM, 67 TFLOP/s float32).  The forward reads
// q, k, v once and writes o once (16*h*dh*F*B bytes) against 4*h*dh*F*F*B
// flops, h*F*F*B exponentials and, with dropout, h*F*F*B/4 Philox draws;
// at dh = 4 that is F/4 flops per byte against the card's 20, so autoint's
// F = 24 is bound by bytes and the production ctr's F = 175 by operations.
// The backward reads q, k, v, o, do, lse and writes dq, dk, dv.
//
// Forward design: one thread per (head, query field, sample); a block is 32
// samples (threadIdx.x, B fastest, so every load and store coalesces) by kFq
// query fields (threadIdx.y).  The block walks the keys in tiles of KT
// fields: it stages the tile's k and v for its 32 samples in shared memory
// once, and all kFq query fields of the block read them there.  Softmax is
// online across tiles (running max and sum, one rescale per tile); the
// dropout mask multiplies the weight after the softmax, so the running sum
// takes the unmasked weights.  With an lse pointer it also writes
// lse = max + log(sum) for the backward.  Ragged B and F edges are masked
// by predicates; the TPU's F padding and -1e9 key bias are not needed.
//
// Backward design: the TPU kernel summed dk and dv over query tiles across
// sequential grid steps; blocks here run in no order, so no block may share
// a dk or dv element with another.  One thread owns one (head, field f,
// sample b) and computes everything of its field: dq[f] as the query
// (a loop over all keys) and dk[f], dv[f] as the key (a loop over all
// queries), recomputing p = exp(s - lse) for each pair on both sides.  So
// every sum stays in one thread's registers, with no atomics and no order
// between blocks, at the price of computing each score twice.  A first
// kernel writes D = rowsum(do * o), which stands in for sum_k dp*p also
// under dropout (sum_k m_k p_k (do.v_k) = do.o).  The other fields' rows
// come from device memory through L1: the kFq threads of a block that read
// one row read it at once.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kLanes = 32;   // samples per block
constexpr int kFq = 8;       // query fields per block

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t lo0 = kPhiloxM0 * c.x;
    const uint32_t hi0 = __umulhi(kPhiloxM0, c.x);
    const uint32_t lo1 = kPhiloxM1 * c.z;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += kPhiloxW0;
    k1 += kPhiloxW1;
  }
  return c;
}

__device__ __forceinline__ uint32_t word(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}

struct Dropout {
  uint32_t k0, k1, thresh;
  float keep_scale;
  // the four keys 4*kg .. 4*kg+3 of query fq, head h, sample b
  __device__ __forceinline__ uint4 bits(long long b, int fq, int h, int kg) const {
    return philox4x32_10(make_uint4(static_cast<uint32_t>(b), static_cast<uint32_t>(fq),
                                    static_cast<uint32_t>(h), static_cast<uint32_t>(kg)),
                         k0, k1);
  }
  __device__ __forceinline__ float scale(uint32_t r) const {
    return r >= thresh ? keep_scale : 0.f;
  }
};

template <int DH, int KT, bool kDrop>
__global__ void __launch_bounds__(kLanes * kFq)
field_attention_fwd_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ o,
                           float* __restrict__ lse,
                           int f, long long b, float scale, Dropout drop) {
  __shared__ float ks[DH][KT][kLanes];
  __shared__ float vs[DH][KT][kLanes];

  const int lane = threadIdx.x;
  const int fq = blockIdx.y * kFq + threadIdx.y;
  const long long b0 = static_cast<long long>(blockIdx.x) * kLanes;
  const long long bi = b0 + lane;
  const bool live = fq < f && bi < b;
  const long long fb = static_cast<long long>(f) * b;
  const long long head = static_cast<long long>(blockIdx.z) * DH * fb;
  const float* qh = q + head;
  const float* kh = k + head;
  const float* vh = v + head;

  float qr[DH];
  float acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    qr[d] = live ? qh[d * fb + static_cast<long long>(fq) * b + bi] : 0.f;
    acc[d] = 0.f;
  }
  float run_max = -INFINITY;
  float run_sum = 0.f;

  const int tid = threadIdx.y * kLanes + lane;
  for (int k0 = 0; k0 < f; k0 += KT) {
    const int nk = min(KT, f - k0);
    for (int i = tid; i < DH * KT * kLanes; i += kLanes * kFq) {
      const int il = i % kLanes;
      const int j = (i / kLanes) % KT;
      const int d = i / (kLanes * KT);
      const bool ok = j < nk && b0 + il < b;
      const long long off = d * fb + static_cast<long long>(k0 + j) * b + b0 + il;
      ks[d][j][il] = ok ? kh[off] : 0.f;
      vs[d][j][il] = ok ? vh[off] : 0.f;
    }
    __syncthreads();
    if (live) {
      float s[KT];
      float tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        if (j < nk) {
          float dot = 0.f;
#pragma unroll
          for (int d = 0; d < DH; ++d) dot += qr[d] * ks[d][j][lane];
          s[j] = dot * scale;
          tile_max = fmaxf(tile_max, s[j]);
        }
      }
      const float new_max = fmaxf(run_max, tile_max);
      const float corr = expf(run_max - new_max);   // 0 on the first tile
      run_sum *= corr;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] *= corr;
      uint4 bits = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        if (j < nk) {
          // KT is a multiple of 4, so (k0 + j) % 4 == j % 4
          if (kDrop && (j & 3) == 0) bits = drop.bits(bi, fq, blockIdx.z, (k0 + j) >> 2);
          const float p = expf(s[j] - new_max);
          run_sum += p;
          const float pd = kDrop ? p * drop.scale(word(bits, j & 3)) : p;
#pragma unroll
          for (int d = 0; d < DH; ++d) acc[d] += pd * vs[d][j][lane];
        }
      }
      run_max = new_max;
    }
    __syncthreads();
  }
  if (live) {
    const float inv = 1.f / run_sum;
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      o[head + d * fb + static_cast<long long>(fq) * b + bi] = acc[d] * inv;
    }
    if (lse != nullptr) {
      lse[static_cast<long long>(blockIdx.z) * fb + static_cast<long long>(fq) * b + bi] =
          run_max + logf(run_sum);
    }
  }
}

// rowdot[h, f, b] = sum_d do[h, d, f, b] * o[h, d, f, b]
__global__ void row_dot_kernel(const float* __restrict__ dout,
                               const float* __restrict__ o,
                               float* __restrict__ rowdot,
                               long long h, int dh, long long fb) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= h * fb) return;
  const long long hi = t / fb;
  const long long x = t - hi * fb;
  const float* dp = dout + hi * dh * fb + x;
  const float* op = o + hi * dh * fb + x;
  float s = 0.f;
  for (int d = 0; d < dh; ++d) s += dp[d * fb] * op[d * fb];
  rowdot[t] = s;
}

template <int DH, bool kDrop>
__global__ void __launch_bounds__(kLanes * kFq)
field_attention_bwd_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ rowdot,
                           float* __restrict__ dq,
                           float* __restrict__ dk,
                           float* __restrict__ dv,
                           int f, long long b, float scale, Dropout drop) {
  const int fi = blockIdx.y * kFq + threadIdx.y;
  const long long bi = static_cast<long long>(blockIdx.x) * kLanes + threadIdx.x;
  if (fi >= f || bi >= b) return;
  const int h = blockIdx.z;
  const long long fb = static_cast<long long>(f) * b;
  const long long head = static_cast<long long>(h) * DH * fb;
  const float* qh = q + head + bi;
  const float* kh = k + head + bi;
  const float* vh = v + head + bi;
  const float* doh = dout + head + bi;
  const float* lseh = lse + static_cast<long long>(h) * fb + bi;
  const float* rdh = rowdot + static_cast<long long>(h) * fb + bi;
  const long long own = static_cast<long long>(fi) * b;

  float qf[DH], kf[DH], vf[DH], dof[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    qf[d] = qh[d * fb + own];
    kf[d] = kh[d * fb + own];
    vf[d] = vh[d * fb + own];
    dof[d] = doh[d * fb + own];
  }

  // field fi as the query: dq = scale * sum_g ds[fi, g] k[g]
  {
    const float lse_f = lseh[own];
    const float rd_f = rdh[own];
    float acc[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] = 0.f;
    uint4 bits = make_uint4(0u, 0u, 0u, 0u);
    for (int g = 0; g < f; ++g) {
      const long long og = static_cast<long long>(g) * b;
      float kg[DH];
      float s = 0.f, dpv = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        kg[d] = kh[d * fb + og];
        s += qf[d] * kg[d];
        dpv += dof[d] * vh[d * fb + og];
      }
      const float p = expf(s * scale - lse_f);
      if (kDrop) {
        if ((g & 3) == 0) bits = drop.bits(bi, fi, h, g >> 2);
        dpv *= drop.scale(word(bits, g & 3));
      }
      const float ds = p * (dpv - rd_f);
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] += ds * kg[d];
    }
#pragma unroll
    for (int d = 0; d < DH; ++d) dq[head + d * fb + own + bi] = acc[d] * scale;
  }

  // field fi as the key: dv = sum_g p[g, fi] m[g, fi] do[g],
  //                      dk = scale * sum_g ds[g, fi] q[g]
  {
    float acc_k[DH], acc_v[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) acc_k[d] = acc_v[d] = 0.f;
    for (int g = 0; g < f; ++g) {
      const long long og = static_cast<long long>(g) * b;
      float qg[DH], dog[DH];
      float s = 0.f, dpv = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        qg[d] = qh[d * fb + og];
        dog[d] = doh[d * fb + og];
        s += qg[d] * kf[d];
        dpv += dog[d] * vf[d];
      }
      const float p = expf(s * scale - lseh[og]);
      float pd = p;
      if (kDrop) {
        const float m = drop.scale(word(drop.bits(bi, g, h, fi >> 2), fi & 3));
        pd = p * m;
        dpv *= m;
      }
      const float ds = p * (dpv - rdh[og]);
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        acc_v[d] += pd * dog[d];
        acc_k[d] += ds * qg[d];
      }
    }
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      dk[head + d * fb + own + bi] = acc_k[d] * scale;
      dv[head + d * fb + own + bi] = acc_v[d];
    }
  }
}

dim3 grid_for(int h, int f, long long b) {
  return dim3(static_cast<unsigned int>((b + kLanes - 1) / kLanes),
              static_cast<unsigned int>((f + kFq - 1) / kFq),
              static_cast<unsigned int>(h));
}

template <int DH>
void launch_fwd(const float* q, const float* k, const float* v, float* o,
                float* lse, int h, int f, long long b, float scale,
                const Dropout& drop, bool dropout, cudaStream_t stream) {
  constexpr int KT = 128 / DH;   // k and v tiles: 2 * 128 * 32 * 4 B = 32 KB
  const dim3 block(kLanes, kFq);
  if (dropout) {
    field_attention_fwd_kernel<DH, KT, true><<<grid_for(h, f, b), block, 0, stream>>>(
        q, k, v, o, lse, f, b, scale, drop);
  } else {
    field_attention_fwd_kernel<DH, KT, false><<<grid_for(h, f, b), block, 0, stream>>>(
        q, k, v, o, lse, f, b, scale, drop);
  }
}

template <int DH>
void launch_bwd(const float* q, const float* k, const float* v,
                const float* dout, const float* lse, const float* rowdot,
                float* dq, float* dk, float* dv, int h, int f, long long b,
                float scale, const Dropout& drop, bool dropout,
                cudaStream_t stream) {
  const dim3 block(kLanes, kFq);
  if (dropout) {
    field_attention_bwd_kernel<DH, true><<<grid_for(h, f, b), block, 0, stream>>>(
        q, k, v, dout, lse, rowdot, dq, dk, dv, f, b, scale, drop);
  } else {
    field_attention_bwd_kernel<DH, false><<<grid_for(h, f, b), block, 0, stream>>>(
        q, k, v, dout, lse, rowdot, dq, dk, dv, f, b, scale, drop);
  }
}

Dropout make_dropout(unsigned int k0, unsigned int k1, unsigned int thresh,
                     float keep_scale) {
  Dropout drop;
  drop.k0 = k0;
  drop.k1 = k1;
  drop.thresh = thresh;
  drop.keep_scale = keep_scale;
  return drop;
}

}  // namespace

// lse may be null (no backward to follow).  dropout != 0 applies the mask
// of key (k0, k1) with threshold thresh and scale keep_scale.
RS_EXPORT int field_attention_fwd_f32(const float* q, const float* k,
                                      const float* v, float* o, float* lse,
                                      int h, int dh, int f, long long b,
                                      float scale, int dropout,
                                      unsigned int k0, unsigned int k1,
                                      unsigned int thresh, float keep_scale,
                                      cudaStream_t stream) {
  const Dropout drop = make_dropout(k0, k1, thresh, keep_scale);
  const bool on = dropout != 0;
  switch (dh) {
    case 1: launch_fwd<1>(q, k, v, o, lse, h, f, b, scale, drop, on, stream); break;
    case 2: launch_fwd<2>(q, k, v, o, lse, h, f, b, scale, drop, on, stream); break;
    case 4: launch_fwd<4>(q, k, v, o, lse, h, f, b, scale, drop, on, stream); break;
    case 8: launch_fwd<8>(q, k, v, o, lse, h, f, b, scale, drop, on, stream); break;
    case 16: launch_fwd<16>(q, k, v, o, lse, h, f, b, scale, drop, on, stream); break;
    case 32: launch_fwd<32>(q, k, v, o, lse, h, f, b, scale, drop, on, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// rowdot is (h, F, B) scratch that the first kernel fills.
RS_EXPORT int field_attention_bwd_f32(const float* q, const float* k,
                                      const float* v, const float* o,
                                      const float* lse, const float* dout,
                                      float* rowdot, float* dq, float* dk,
                                      float* dv, int h, int dh, int f,
                                      long long b, float scale, int dropout,
                                      unsigned int k0, unsigned int k1,
                                      unsigned int thresh, float keep_scale,
                                      cudaStream_t stream) {
  const long long fb = static_cast<long long>(f) * b;
  const long long n = static_cast<long long>(h) * fb;
  row_dot_kernel<<<static_cast<unsigned int>((n + 255) / 256), 256, 0, stream>>>(
      dout, o, rowdot, h, dh, fb);
  const int code = static_cast<int>(cudaGetLastError());
  if (code != 0) return code;
  const Dropout drop = make_dropout(k0, k1, thresh, keep_scale);
  const bool on = dropout != 0;
  switch (dh) {
    case 1: launch_bwd<1>(q, k, v, dout, lse, rowdot, dq, dk, dv, h, f, b, scale, drop, on, stream); break;
    case 2: launch_bwd<2>(q, k, v, dout, lse, rowdot, dq, dk, dv, h, f, b, scale, drop, on, stream); break;
    case 4: launch_bwd<4>(q, k, v, dout, lse, rowdot, dq, dk, dv, h, f, b, scale, drop, on, stream); break;
    case 8: launch_bwd<8>(q, k, v, dout, lse, rowdot, dq, dk, dv, h, f, b, scale, drop, on, stream); break;
    case 16: launch_bwd<16>(q, k, v, dout, lse, rowdot, dq, dk, dv, h, f, b, scale, drop, on, stream); break;
    case 32: launch_bwd<32>(q, k, v, dout, lse, rowdot, dq, dk, dv, h, f, b, scale, drop, on, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

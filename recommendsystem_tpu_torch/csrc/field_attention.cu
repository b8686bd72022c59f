// K5: field attention, softmax over keys of q.k / sqrt(dh) across the F
// fields of each sample, times v, with optional dropout on the attention
// weights; forward (K5f) and backward (K5b).  For Hopper (sm_90a).
//
// Replaces recommendsystem_tpu/kernels/field_attention_pallas.py::
// field_attention (:175; pallas_call in _call :209, bodies _fwd_kernel :98
// and _bwd_kernel :111).  Layout as there, batch-minor: q/k/v/o/do and the
// gradients are (head, dh, F, B) float32, contiguous; lse is (head, F, B).
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
// The backward reads q, k, v, o, do, lse and writes dq, dk, dv
// (32*h*dh*F*B + 4*h*F*B bytes) against (10*dh + 5)*h*F*F*B operations: at
// autoint's dh = 4 and F = 24 its bytes bound it, at F = 175 its operations.
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
// a dq, dk or dv element with another.  A block owns one head and kLanes = 32
// samples (threadIdx.x) for all F fields, so every sum stays inside it, and
// each (query, key, sample) score, its exponential, its dropout draw and its
// ds are computed once:
//  - keys go in chunks of KC = min(32, 128 / dh) fields, whose k and v rows
//    the block stages in shared memory;
//  - within a chunk, queries go in tiles of kBY = 8 (threadIdx.y).  In the
//    query phase the thread of (query, sample) loads its q, do and o rows,
//    forms rowdot = do.o (which stands in for sum_k dp*p also under dropout:
//    sum_k m_k p_k (do.v_k) = do.o) and walks the chunk's keys, 4 at a
//    time: scores, p = exp2((s*scale - lse) log2 e), one Philox call with
//    the forward's counter (b, fq, head, fk/4), ds = p (m do.v - rowdot);
//    it sums ds*k
//    into its dq and writes ds and p*m, with its q and do rows, to shared
//    memory;
//  - in the key phase the thread of (key, sample) sums ds*q into dk and
//    p*m*do into dv, over the tile's queries in order, in registers that
//    live across the chunk's query tiles;
//  - dq of a query is summed over the chunks in order, in place in dq (its
//    one owner reads back what it wrote), and scaled after the last chunk.
// Every sum runs in a fixed order, with no atomics, so two launches give the
// same bits.  Shared memory depends on dh alone (74-104 KB), so any F fits.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kLanes = 32;   // samples per block (forward and backward)
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

constexpr int kBY = 8;    // backward: queries per tile (threadIdx.y)
constexpr float kLog2e = 1.44269504f;   // exp(x) = exp2(x * log2 e): one ex2.approx

// a sample's dh floats, contiguous in shared memory: one 16-byte access
// per 4 floats
template <int DH>
__device__ __forceinline__ void load_row(const float* p, float (&r)[DH]) {
  if constexpr (DH % 4 == 0) {
#pragma unroll
    for (int d = 0; d < DH; d += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + d);
      r[d] = t.x; r[d + 1] = t.y; r[d + 2] = t.z; r[d + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int d = 0; d < DH; ++d) r[d] = p[d];
  }
}

template <int DH>
__device__ __forceinline__ void store_row(float* p, const float (&r)[DH]) {
  if constexpr (DH % 4 == 0) {
#pragma unroll
    for (int d = 0; d < DH; d += 4) {
      *reinterpret_cast<float4*>(p + d) = make_float4(r[d], r[d + 1], r[d + 2], r[d + 3]);
    }
  } else {
#pragma unroll
    for (int d = 0; d < DH; ++d) p[d] = r[d];
  }
}

template <int DH>
struct BwdTile {
  static constexpr int KC = 128 / DH < 32 ? 128 / DH : 32;   // keys per chunk
  static constexpr int KPT = (KC + kBY - 1) / kBY;             // keys per thread
  static constexpr int kFloats =
      2 * DH * KC * kLanes + 2 * kBY * DH * kLanes + 2 * kBY * KC * kLanes;
};

template <int DH, bool kDrop>
__global__ void __launch_bounds__(kLanes * kBY)
field_attention_bwd_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ o,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           float* __restrict__ dq,
                           float* __restrict__ dk,
                           float* __restrict__ dv,
                           int f, long long b, float scale, Dropout drop) {
  using T = BwdTile<DH>;
  constexpr int KC = T::KC;
  extern __shared__ float smem[];
  // a sample's dh floats are contiguous, so a thread reads a row in dh / 4
  // 16-byte accesses
  float* ks = smem;                     // [KC][kLanes][DH] the chunk's keys
  float* vs = ks + DH * KC * kLanes;    // [KC][kLanes][DH]
  float* qs = vs + DH * KC * kLanes;    // [kBY][kLanes][DH] the tile's queries
  float* dos = qs + kBY * DH * kLanes;  // [kBY][kLanes][DH]
  // [kBY][KC][kLanes] (ds, p * m) of the tile's pairs
  float2* dsp = reinterpret_cast<float2*>(dos + kBY * DH * kLanes);

  const int x = threadIdx.x;
  const int y = threadIdx.y;
  const int tid = y * kLanes + x;
  const int h = blockIdx.y;
  const long long b0 = static_cast<long long>(blockIdx.x) * kLanes;
  const long long bi = b0 + x;
  const bool lane_ok = bi < b;
  const long long fb = static_cast<long long>(f) * b;
  const long long head = static_cast<long long>(h) * DH * fb;

  for (int kc0 = 0; kc0 < f; kc0 += KC) {
    const int nk = min(KC, f - kc0);
    const bool last_chunk = kc0 + KC >= f;
    for (int i = tid; i < DH * KC * kLanes; i += kLanes * kBY) {
      const int il = i % kLanes;
      const int j = (i / kLanes) % KC;
      const int d = i / (kLanes * KC);
      const bool ok = j < nk && b0 + il < b;
      const long long off = head + d * fb + static_cast<long long>(kc0 + j) * b + b0 + il;
      ks[(j * kLanes + il) * DH + d] = ok ? k[off] : 0.f;
      vs[(j * kLanes + il) * DH + d] = ok ? v[off] : 0.f;
    }
    float ak[T::KPT][DH], av[T::KPT][DH];
#pragma unroll
    for (int i = 0; i < T::KPT; ++i) {
#pragma unroll
      for (int d = 0; d < DH; ++d) ak[i][d] = av[i][d] = 0.f;
    }
    __syncthreads();

    for (int fq0 = 0; fq0 < f; fq0 += kBY) {
      // query phase: the thread of (query fq, sample bi)
      const int fq = fq0 + y;
      const bool q_ok = lane_ok && fq < f;
      const long long own = head + static_cast<long long>(fq) * b + bi;
      float qf[DH], dof[DH], acc[DH];
      float rd = 0.f, lse_q = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        qf[d] = q_ok ? q[own + d * fb] : 0.f;
        dof[d] = q_ok ? dout[own + d * fb] : 0.f;
        rd += q_ok ? dof[d] * o[own + d * fb] : 0.f;
        acc[d] = 0.f;
      }
      store_row<DH>(qs + (y * kLanes + x) * DH, qf);
      store_row<DH>(dos + (y * kLanes + x) * DH, dof);
      if (q_ok) lse_q = lse[static_cast<long long>(h) * fb + static_cast<long long>(fq) * b + bi];
      // keys in groups of 4, one Philox call a group (KC is a multiple of
      // 4, so kc0 + j4 is too)
      for (int j4 = 0; j4 < nk; j4 += 4) {
        uint4 bits = make_uint4(0u, 0u, 0u, 0u);
        if (kDrop && q_ok) bits = drop.bits(bi, fq, h, (kc0 + j4) >> 2);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = j4 + jj;
          if (j < nk) {
            float kr[DH], vr[DH];
            load_row<DH>(ks + (j * kLanes + x) * DH, kr);
            load_row<DH>(vs + (j * kLanes + x) * DH, vr);
            float s = 0.f, dpv = 0.f;
#pragma unroll
            for (int d = 0; d < DH; ++d) {
              s += qf[d] * kr[d];
              dpv += dof[d] * vr[d];
            }
            const float p = q_ok ? exp2f((s * scale - lse_q) * kLog2e) : 0.f;
            float pm = p;
            if (kDrop) {
              const float mk = drop.scale(word(bits, jj));
              pm = p * mk;
              dpv *= mk;
            }
            const float ds = p * (dpv - rd);
#pragma unroll
            for (int d = 0; d < DH; ++d) acc[d] += ds * kr[d];
            dsp[(y * KC + j) * kLanes + x] = make_float2(ds, pm);
          }
        }
      }
      if (q_ok) {
#pragma unroll
        for (int d = 0; d < DH; ++d) {
          float val = acc[d];
          if (kc0 > 0) val += dq[own + d * fb];
          dq[own + d * fb] = last_chunk ? val * scale : val;
        }
      }
      __syncthreads();

      // key phase: the thread of (key kc0 + y + kBY*i, sample bi), over the
      // tile's queries in order
      const int nq = min(kBY, f - fq0);
      for (int r = 0; r < nq; ++r) {
        float qr[DH], dr[DH];
        load_row<DH>(qs + (r * kLanes + x) * DH, qr);
        load_row<DH>(dos + (r * kLanes + x) * DH, dr);
#pragma unroll
        for (int i = 0; i < T::KPT; ++i) {
          const int j = y + kBY * i;
          if (j < nk) {
            const float2 dp = dsp[(r * KC + j) * kLanes + x];
            const float ds = dp.x;
            const float pm = dp.y;
#pragma unroll
            for (int d = 0; d < DH; ++d) {
              ak[i][d] += ds * qr[d];
              av[i][d] += pm * dr[d];
            }
          }
        }
      }
      __syncthreads();
    }

    if (lane_ok) {
#pragma unroll
      for (int i = 0; i < T::KPT; ++i) {
        const int j = y + kBY * i;
        if (j < nk) {
          const long long key = head + static_cast<long long>(kc0 + j) * b + bi;
#pragma unroll
          for (int d = 0; d < DH; ++d) {
            dk[key + d * fb] = ak[i][d] * scale;
            dv[key + d * fb] = av[i][d];
          }
        }
      }
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
int launch_bwd(const float* q, const float* k, const float* v, const float* o,
               const float* dout, const float* lse, float* dq, float* dk,
               float* dv, int h, int f, long long b, float scale,
               const Dropout& drop, bool dropout, cudaStream_t stream) {
  const int bytes = BwdTile<DH>::kFloats * static_cast<int>(sizeof(float));
  auto kernel = dropout ? field_attention_bwd_kernel<DH, true>
                        : field_attention_bwd_kernel<DH, false>;
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid(static_cast<unsigned int>((b + kLanes - 1) / kLanes),
                  static_cast<unsigned int>(h));
  kernel<<<grid, dim3(kLanes, kBY), bytes, stream>>>(q, k, v, o, dout, lse, dq, dk,
                                                  dv, f, b, scale, drop);
  return static_cast<int>(cudaGetLastError());
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

// o is the forward's output, lse its (h, F, B) log-sum-exp; dropout as in
// the forward, from the same key.
RS_EXPORT int field_attention_bwd_f32(const float* q, const float* k,
                                      const float* v, const float* o,
                                      const float* lse, const float* dout,
                                      float* dq, float* dk, float* dv, int h,
                                      int dh, int f, long long b, float scale,
                                      int dropout, unsigned int k0,
                                      unsigned int k1, unsigned int thresh,
                                      float keep_scale, cudaStream_t stream) {
  const Dropout drop = make_dropout(k0, k1, thresh, keep_scale);
  const bool on = dropout != 0;
  switch (dh) {
    case 1: return launch_bwd<1>(q, k, v, o, dout, lse, dq, dk, dv, h, f, b, scale, drop, on, stream);
    case 2: return launch_bwd<2>(q, k, v, o, dout, lse, dq, dk, dv, h, f, b, scale, drop, on, stream);
    case 4: return launch_bwd<4>(q, k, v, o, dout, lse, dq, dk, dv, h, f, b, scale, drop, on, stream);
    case 8: return launch_bwd<8>(q, k, v, o, dout, lse, dq, dk, dv, h, f, b, scale, drop, on, stream);
    case 16: return launch_bwd<16>(q, k, v, o, dout, lse, dq, dk, dv, h, f, b, scale, drop, on, stream);
    case 32: return launch_bwd<32>(q, k, v, o, dout, lse, dq, dk, dv, h, f, b, scale, drop, on, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

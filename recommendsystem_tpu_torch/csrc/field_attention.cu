// K5 forward: field attention, softmax over keys of q.k / sqrt(dh) across
// the F fields of each sample, times v.  For Hopper (sm_90a), rate 0 only.
//
// Replaces the forward of recommendsystem_tpu/kernels/
// field_attention_pallas.py::field_attention (:175; pallas_call in _call
// :209, body _fwd_kernel :98).  Layout as there, batch-minor:
// q/k/v/o are (head, dh, F, B) float32, contiguous.
//
// Bound on the H100 (3.35 TB/s HBM, 67 TFLOP/s float32): it reads q, k, v
// once and writes o once (16*h*dh*F*B bytes) against 4*h*dh*F*F*B flops
// and h*F*F*B exponentials; at dh = 4 that is F/4 flops per byte against
// the card's 20, so autoint's F = 24 is bound by bytes (6 flops per byte)
// and the production ctr's F = 175 by operations (44 flops per byte).
//
// Design: one thread per (head, query field, sample); a block is 32
// samples (threadIdx.x, B fastest, so every load and store coalesces) by
// kFq query fields (threadIdx.y).  The block walks the keys in tiles of KT
// fields: it stages the tile's k and v for its 32 samples in shared memory
// once, and all kFq query fields of the block read them there, so k and v
// come from device memory once per kFq query fields, not once per field.
// Softmax is online across tiles (running max and sum, one rescale per
// tile); the F <= KT case is a single tile, i.e. the exact softmax.  Ragged
// B and F edges are masked by predicates; the TPU's F padding and -1e9 key
// bias are not needed.  Dropout (rate > 0) and the backward pass are not
// here yet.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kLanes = 32;   // samples per block
constexpr int kFq = 8;       // query fields per block

template <int DH, int KT>
__global__ void __launch_bounds__(kLanes * kFq)
field_attention_fwd_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ o,
                           int f, long long b, float scale) {
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
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        if (j < nk) {
          const float p = expf(s[j] - new_max);
          run_sum += p;
#pragma unroll
          for (int d = 0; d < DH; ++d) acc[d] += p * vs[d][j][lane];
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
  }
}

template <int DH>
void launch(const float* q, const float* k, const float* v, float* o, int h,
            int f, long long b, float scale, cudaStream_t stream) {
  constexpr int KT = 128 / DH;   // k and v tiles: 2 * 128 * 32 * 4 B = 32 KB
  const dim3 block(kLanes, kFq);
  const dim3 grid(static_cast<unsigned int>((b + kLanes - 1) / kLanes),
                  static_cast<unsigned int>((f + kFq - 1) / kFq),
                  static_cast<unsigned int>(h));
  field_attention_fwd_kernel<DH, KT><<<grid, block, 0, stream>>>(
      q, k, v, o, f, b, scale);
}

}  // namespace

RS_EXPORT int field_attention_fwd_f32(const float* q, const float* k,
                                      const float* v, float* o, int h, int dh,
                                      int f, long long b, float scale,
                                      cudaStream_t stream) {
  switch (dh) {
    case 1: launch<1>(q, k, v, o, h, f, b, scale, stream); break;
    case 2: launch<2>(q, k, v, o, h, f, b, scale, stream); break;
    case 4: launch<4>(q, k, v, o, h, f, b, scale, stream); break;
    case 8: launch<8>(q, k, v, o, h, f, b, scale, stream); break;
    case 16: launch<16>(q, k, v, o, h, f, b, scale, stream); break;
    case 32: launch<32>(q, k, v, o, h, f, b, scale, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

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
// forward's mask from the same key.  The key is not a launch parameter: it
// is one 64-bit word in device memory, k0 << 32 | k1, which every thread
// reads as the kernel starts, so a launch captured in a CUDA graph draws
// the key that its replay finds there.  A weight is kept when its draw is
// >= thresh = rate * 2^32 and then scaled by 1 / (1 - rate), as
// field_attention_pallas.py:71-77 does.  The plain PyTorch version
// (kernels/field_attention.py) computes the same bits with integer ops.
//
// Bound on the H100 (3.35 TB/s HBM, 67 TFLOP/s float32).  The forward reads
// q, k, v once and writes o once, and lse when asked (16*h*dh*F*B +
// 4*h*F*B bytes), against 4*h*dh*F*F*B flops, h*F*F*B exponentials and,
// with dropout, h*F*F*B/4 Philox draws; at dh = 4 that is F/4 flops per
// byte against the card's 20, so autoint's F = 24 is bound by bytes (63.85
// us at h = 2, B = 65536, with lse) and the production ctr's F = 175 by
// operations.  The backward reads q, k, v, o, do, lse and writes dq, dk, dv
// (32*h*dh*F*B + 4*h*F*B bytes) against (10*dh + 5)*h*F*F*B operations: at
// autoint's dh = 4 and F = 24 its bytes bound it, at F = 175 its operations.
//
// Forward design (K5f).  A block owns one head and kLanes = 32 samples
// (threadIdx.x, B fastest, so every global load and store coalesces) for
// all F query fields; its kQy = 8 warps (threadIdx.y) each take QPT query
// fields of every sample (3 at dh <= 4, 2 at dh = 8, 1 above), so a query
// tile is 8*QPT fields and F = 24 is one tile.  Where the grid of (32
// samples, head) blocks would leave SMs idle (B <= 2048 at h = 2), a
// thread takes one query and the tiles spread over grid z instead.  Keys go
// in chunks of KC = max(4, 64 / dh) fields, whose k and v rows (a sample's
// dh floats contiguous) the block copies into shared memory with 4-byte
// cp.async (zero-filled past the ragged B and F edges; B-minor rows of a
// ragged B are not 16-byte aligned), into one of two buffers while the
// other is computed: the next chunk's copy is in flight while this one's
// math runs (cp.async groups, then a block barrier).  Shared memory depends
// on dh alone (34-37 KB; 74 KB at dh = 32), so any F fits.  At F = 24 (two
// chunks, one tile) every k and v element is read from device memory once;
// where F spans several chunks and several tiles (F > 24 at dh = 4) each
// tile copies the chunks again, from L2.
//
// Softmax with no running max.  Every score of a query is at most M =
// sum_d max(q_d kmax_d, q_d kmin_d), with kmax_d and kmin_d the largest and
// smallest k_d over the sample's F keys: one pass over k in device memory
// at the start (while the first chunk is in flight) finds them.  A thread
// holds its queries pre-scaled by scale * log2(e), so scores come out in
// base 2, and each weight is exp2(s - M) <= 1: one ex2.approx, no max, no
// rescaling.  If M overshoots the largest score so far that a row's sum
// falls below 2^-64, the thread does that row again exactly (max first,
// from device memory): the result never depends on the bound.  Per (query,
// key, sample) pair at dh = 4: 4 FMA (the score, its chain starting at -M),
// 1 ex2, 1 add (sum), 1 select (dropout), 4 FMA (output): 11 instructions
// (an online softmax needs ~20), plus a quarter of a Philox call under
// dropout: the round keys are formed from the key's two words as the rounds
// go, so a round is 2 wide multiplies, 2 three-way XORs and 2 adds, ~60
// instructions a call, ~15 a pair.  Each k and v row read from shared
// memory serves QPT queries: 2 * 16 B / QPT = 10.7 B a pair.  The dropout
// mask multiplies the weight after the softmax, so the sum takes the
// unmasked weights; the keep scale 1 / (1 - rate) is applied once, to the
// output.  lse is written in natural units, (M + log2(sum)) * ln 2, as K5b
// reads it.  Registers (the build log's -Xptxas -v, as the launch bounds
// allow): 64 for dh <= 8, so 4 blocks of 256 threads an SM; 72-80 with
// dropout (3 blocks; at three queries a thread a few bytes spill); 107-128
// for dh = 16 and 32 (2 blocks).  What holds it back now: instructions (~21
// a pair with dropout at dh = 4, half of them Philox), and at F > 24 the
// chunks copied again for every query tile.
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
//
// bf16 inputs (the bf16 compute policy).  q, k and v may be bfloat16 (all
// three of one type T, a template parameter of both kernels), as the first
// InteractingLayer iteration gives them from its bf16 projections.  The JAX
// kernel refuses them (its float32 scratch takes no bf16 store); the port
// keeps the float32 math: each value is widened as it is loaded (the
// forward stages a bf16 chunk with plain loads, cp.async moving 4 bytes at
// the least), o and lse stay float32, and the backward reads float32 o, lse
// and do, computes in float32 and rounds dq, dk and dv once, to bf16, as
// they are stored: the cotangents a custom VJP gives bf16 primals.  dq's
// partial sums over key chunks stay in a float32 scratch (dq_acc), so that
// only the final sum is rounded.  Dropout is unchanged.

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kLanes = 32;   // samples per block (forward and backward)
constexpr int kQy = 8;       // forward: warps per block (threadIdx.y)
constexpr float kLog2e = 1.44269504f;   // exp(x) = exp2(x * log2 e): one ex2.approx
constexpr float kLn2 = 0.693147181f;
constexpr float kTiny = 5.42101086e-20f;   // 2^-64: a row's sum below it is done again

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

__device__ __forceinline__ uint32_t word(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}

// The launch's dropout: the key's address (null without dropout), the
// threshold and keep scale, and the global index of the call's first
// sample
struct DropoutArgs {
  const unsigned long long* key;   // k0 << 32 | k1
  uint32_t thresh;
  float keep_scale;
  uint32_t sample0;
};

// Philox4x32-10 (Salmon et al., SC'11) under the key (k0, k1) that a thread
// reads from device memory as the kernel starts; the round keys (k0 + i*W0,
// k1 + i*W1), i = 0..9, are formed as the rounds go
struct Dropout {
  uint32_t k0, k1;
  uint32_t thresh;
  float keep_scale;
  uint32_t sample0;   // the global index of the call's first sample
  template <bool kDrop>
  __device__ __forceinline__ static Dropout load(const DropoutArgs& a) {
    Dropout d;
    const unsigned long long w = kDrop ? __ldg(a.key) : 0ull;
    d.k0 = static_cast<uint32_t>(w >> 32);
    d.k1 = static_cast<uint32_t>(w);
    d.thresh = a.thresh;
    d.keep_scale = a.keep_scale;
    d.sample0 = a.sample0;
    return d;
  }
  // the four keys 4*kg .. 4*kg+3 of query fq, head h, sample b of the call
  __device__ __forceinline__ uint4 bits(long long b, int fq, int h, int kg) const {
    uint4 c = make_uint4(static_cast<uint32_t>(b) + sample0, static_cast<uint32_t>(fq),
                         static_cast<uint32_t>(h), static_cast<uint32_t>(kg));
#pragma unroll
    for (int i = 0; i < 10; ++i) {
      const uint32_t lo0 = kPhiloxM0 * c.x;
      const uint32_t hi0 = __umulhi(kPhiloxM0, c.x);
      const uint32_t lo1 = kPhiloxM1 * c.z;
      const uint32_t hi1 = __umulhi(kPhiloxM1, c.z);
      c = make_uint4(hi1 ^ c.y ^ (k0 + static_cast<uint32_t>(i) * kPhiloxW0), lo1,
                     hi0 ^ c.w ^ (k1 + static_cast<uint32_t>(i) * kPhiloxW1), lo0);
    }
    return c;
  }
  __device__ __forceinline__ float scale(uint32_t r) const {
    return r >= thresh ? keep_scale : 0.f;
  }
  // bit i set where word i of r keeps its weight
  __device__ __forceinline__ uint32_t keep_bits(const uint4& r) const {
    return static_cast<uint32_t>(r.x >= thresh) | static_cast<uint32_t>(r.y >= thresh) << 1 |
           static_cast<uint32_t>(r.z >= thresh) << 2 | static_cast<uint32_t>(r.w >= thresh) << 3;
  }
};

// 2^x in one MUFU op; subnormal results flush to 0 (a weight below 2^-126
// of the row's largest)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

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

// 4 bytes global -> shared, asynchronously; zero-filled where !ok
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(s), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int DH>
struct FwdTile {
  static constexpr int KC = 64 / DH < 4 ? 4 : 64 / DH;          // keys per chunk
  static constexpr int QPT = DH <= 4 ? 3 : DH == 8 ? 2 : 1;     // queries per thread
  static constexpr int kChunkFloats = 2 * KC * kLanes * DH;     // one buffer: k and v
  static constexpr int kParts = DH < kQy ? kQy / DH : 1;        // key slices of the bound pass
  static constexpr int kBoundFloats = 2 * kParts * DH * kLanes; // their largest and smallest k
};

// the chunk of keys kc0 .. kc0+KC-1 of the block's samples into buf
// ([k|v][KC][kLanes][DH]), one cp.async per float32 element (bf16 ones
// with a plain load, widened: cp.async moves 4 bytes at the least); a
// thread keeps its sample (lane) and walks rows of (d, key), so its
// addresses step by B
template <int DH, typename T>
__device__ __forceinline__ void stage_chunk(float* buf, const T* kh, const T* vh,
                                            int kc0, int f, long long b, long long b0,
                                            long long fb, int tid) {
  using Tile = FwdTile<DH>;
  constexpr int kElems = DH * Tile::KC * kLanes;
  constexpr int kRounds = kElems / (kLanes * kQy);
  static_assert(kElems % (kLanes * kQy) == 0, "a chunk is whole rounds of the block");
  const int il = tid % kLanes;
  const bool lane_in = b0 + il < b;
  const T* kb = kh + b0 + il;
  const T* vb = vh + b0 + il;
  float* vs = buf + kElems;
#pragma unroll 1
  for (int n = 0; n < kRounds; ++n) {
    const int row = tid / kLanes + n * kQy;   // d * KC + j
    const int j = row % Tile::KC;
    const int d = row / Tile::KC;
    const bool ok = lane_in && kc0 + j < f;
    const long long off = d * fb + static_cast<long long>(kc0 + j) * b;
    const int dst = (j * kLanes + il) * DH + d;
    if constexpr (std::is_same<T, float>::value) {
      cp_async_f32(buf + dst, ok ? kb + off : kh, ok);
      cp_async_f32(vs + dst, ok ? vb + off : vh, ok);
    } else {
      buf[dst] = ok ? to_float(kb[off]) : 0.f;
      vs[dst] = ok ? to_float(vb[off]) : 0.f;
    }
  }
}

// query qf (pre-scaled, base 2) of sample bi done again exactly, from device
// memory: the largest score first, then the weights; acc and sum are
// replaced and neg_max is minus that largest score
template <int DH, bool kDrop, typename T>
__device__ __forceinline__ void exact_row(const float (&qf)[DH], float (&acc)[DH], float& sum,
                                          float& neg_max, const T* kh, const T* vh,
                                          int f, long long b, long long bi, long long fb,
                                          int fq, int h, const Dropout& drop) {
  float mx = -INFINITY;
  for (int g = 0; g < f; ++g) {
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      s = fmaf(qf[d], to_float(kh[d * fb + static_cast<long long>(g) * b + bi]), s);
    }
    mx = fmaxf(mx, s);
  }
  sum = 0.f;
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;
  uint32_t keep = 0xFu;
  for (int g = 0; g < f; ++g) {
    if (kDrop && (g & 3) == 0) keep = drop.keep_bits(drop.bits(bi, fq, h, g >> 2));
    const long long at = static_cast<long long>(g) * b + bi;
    float s = -mx;
#pragma unroll
    for (int d = 0; d < DH; ++d) s = fmaf(qf[d], to_float(kh[d * fb + at]), s);
    const float p = ex2(s);
    sum += p;
    const float pd = (keep >> (g & 3)) & 1u ? p : 0.f;
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] = fmaf(pd, to_float(vh[d * fb + at]), acc[d]);
  }
  neg_max = -mx;
}

// blocks an SM the registers must allow: 64 registers a thread (80 with
// dropout, whose Philox state spills at 64) for dh <= 8, 128 above
template <int DH, bool kDrop>
constexpr int fwd_min_blocks() { return DH > 8 ? 2 : kDrop ? 3 : 4; }

template <int DH, int QPT, bool kDrop, typename T>
__global__ void __launch_bounds__(kLanes * kQy, fwd_min_blocks<DH, kDrop>())
field_attention_fwd_kernel(const T* __restrict__ q,
                           const T* __restrict__ k,
                           const T* __restrict__ v,
                           float* __restrict__ o,
                           float* __restrict__ lse,
                           int f, long long b, float scale, DropoutArgs dargs) {
  const Dropout drop = Dropout::load<kDrop>(dargs);
  using Tile = FwdTile<DH>;
  constexpr int KC = Tile::KC;
  constexpr int QT = kQy * QPT;            // queries per tile
  constexpr int P = Tile::kParts;
  extern __shared__ __align__(16) float smem[];   // [2][kChunkFloats], [2][P][DH][kLanes]
  float* s_bound = smem + 2 * Tile::kChunkFloats;

  const int lane = threadIdx.x;
  const int y = threadIdx.y;
  const int tid = y * kLanes + lane;
  const int h = blockIdx.y;
  const long long b0 = static_cast<long long>(blockIdx.x) * kLanes;
  const long long bi = b0 + lane;
  const bool lane_ok = bi < b;
  const long long fb = static_cast<long long>(f) * b;
  const long long head = static_cast<long long>(h) * DH * fb;
  const T* kh = k + head;
  const T* vh = v + head;
  const float qscale = scale * kLog2e;
  const int nchunks = (f + KC - 1) / KC;
  // query tiles blockIdx.z, blockIdx.z + gridDim.z, ... (gridDim.z > 1 only
  // where the grid would not fill the card)
  const int ntiles = (f + QT - 1) / QT;
  const int nmine = (ntiles - static_cast<int>(blockIdx.z) + static_cast<int>(gridDim.z) - 1) /
                    static_cast<int>(gridDim.z);
  const int nloads = nchunks == 1 ? 1 : nchunks * nmine;

  // the first two chunks in flight before anything else
  stage_chunk<DH, T>(smem, kh, vh, 0, f, b, b0, fb, tid);
  cp_async_commit();
  if (nloads > 1) {
    stage_chunk<DH, T>(smem + Tile::kChunkFloats, kh, vh, (1 % nchunks) * KC, f, b, b0, fb,
                       tid);
    cp_async_commit();
  }

  for (int t = 0; t < nmine; ++t) {
    // this thread's queries fq = fq0 + kQy*i: each is one warp's for every
    // i, so a dead query (fq >= F) is dead for the whole warp
    const int fq0 = (static_cast<int>(blockIdx.z) + t * static_cast<int>(gridDim.z)) * QT + y;
    float qr[QPT][DH], acc[QPT][DH], nb[QPT], sm[QPT];
#pragma unroll
    for (int i = 0; i < QPT; ++i) {
      const int fq = fq0 + kQy * i;
      const bool ok = lane_ok && fq < f;
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        qr[i][d] = ok ? to_float(q[head + d * fb + static_cast<long long>(fq) * b + bi]) * qscale
                      : 0.f;
        acc[i][d] = 0.f;
      }
      nb[i] = 0.f;
      sm[i] = 0.f;
    }
    if (t == 0) {
      // the bound pass, with the chunks and the queries in flight: the
      // largest and the smallest k of each unit over the sample's keys, in
      // P slices of keys
      for (int idx = y; idx < DH * P; idx += kQy) {
        const int d = idx % DH;
        const int part = idx / DH;
        float hi = lane_ok ? -INFINITY : 0.f;
        float lo = lane_ok ? INFINITY : 0.f;
        if (lane_ok) {
#pragma unroll 8
          for (int g = part; g < f; g += P) {   // 8 loads in flight
            const float x = to_float(kh[d * fb + static_cast<long long>(g) * b + bi]);
            hi = fmaxf(hi, x);
            lo = fminf(lo, x);
          }
        }
        s_bound[(part * DH + d) * kLanes + lane] = hi;
        s_bound[((P + part) * DH + d) * kLanes + lane] = lo;
      }
      __syncthreads();
    }
    // every score of query i is at most sum_d max(q_d * kmax_d, q_d * kmin_d)
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      float hi = -INFINITY, lo = INFINITY;
#pragma unroll
      for (int part = 0; part < P; ++part) {
        hi = fmaxf(hi, s_bound[(part * DH + d) * kLanes + lane]);
        lo = fminf(lo, s_bound[((P + part) * DH + d) * kLanes + lane]);
      }
#pragma unroll
      for (int i = 0; i < QPT; ++i) nb[i] -= qr[i][d] * (qr[i][d] >= 0.f ? hi : lo);
    }

    for (int c = 0; c < nchunks; ++c) {
      // chunk it is in buffer it & 1; chunk it + 1, where there is one, is
      // in flight in the other
      const int it = t * nchunks + c;
      const float* buf = smem + (nchunks > 1 ? it & 1 : 0) * Tile::kChunkFloats;
      if (nchunks > 1 || t == 0) {
        if (it + 1 < nloads) {
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
      }
      if (fq0 < f) {
        const int kc0 = c * KC;
        const int nk = min(KC, f - kc0);
        const float* ks = buf;
        const float* vs = buf + DH * KC * kLanes;
        // keys in groups of 4, one Philox call per (query, group) (KC is a
        // multiple of 4, so kc0 + j4 is too)
        for (int j4 = 0; j4 < nk; j4 += 4) {
          uint32_t keep = 0xFFFFFFFFu;    // bit 4*i + jj: query i keeps key j4 + jj
          if (kDrop) {
            keep = 0u;
#pragma unroll
            for (int i = 0; i < QPT; ++i) {
              const int fq = fq0 + kQy * i;
              if (fq < f) {
                keep |= drop.keep_bits(drop.bits(bi, fq, h, (kc0 + j4) >> 2)) << (4 * i);
              }
            }
          }
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int j = j4 + jj;
            if (j < nk) {
              float kr[DH], vr[DH], pd[QPT];
              load_row<DH>(ks + (j * kLanes + lane) * DH, kr);
#pragma unroll
              for (int i = 0; i < QPT; ++i) {
                float s = nb[i];
#pragma unroll
                for (int d = 0; d < DH; ++d) s = fmaf(qr[i][d], kr[d], s);
                const float p = ex2(s);       // s <= 0 up to rounding
                sm[i] += p;
                pd[i] = (keep >> (4 * i + jj)) & 1u ? p : 0.f;
              }
              load_row<DH>(vs + (j * kLanes + lane) * DH, vr);
#pragma unroll
              for (int i = 0; i < QPT; ++i) {
#pragma unroll
                for (int d = 0; d < DH; ++d) acc[i][d] = fmaf(pd[i], vr[d], acc[i][d]);
              }
            }
          }
        }
      }
      if (nchunks > 1) {
        __syncthreads();   // every warp is done with buffer it & 1
        if (it + 2 < nloads) {
          stage_chunk<DH, T>(smem + (it & 1) * Tile::kChunkFloats, kh, vh,
                             ((it + 2) % nchunks) * KC, f, b, b0, fb, tid);
          cp_async_commit();
        }
      }
    }
    if (lane_ok) {
#pragma unroll
      for (int i = 0; i < QPT; ++i) {
        const int fq = fq0 + kQy * i;
        if (fq < f) {
          // the bound overshot the largest score by more than 64 (base 2):
          // this row again, exactly
          if (sm[i] < kTiny) exact_row<DH, kDrop, T>(qr[i], acc[i], sm[i], nb[i], kh, vh, f,
                                                     b, bi, fb, fq, h, drop);
          const long long own = static_cast<long long>(fq) * b + bi;
          const float w = (kDrop ? drop.keep_scale : 1.f) / sm[i];
#pragma unroll
          for (int d = 0; d < DH; ++d) o[head + d * fb + own] = acc[i][d] * w;
          if (lse != nullptr) {
            lse[static_cast<long long>(h) * fb + own] = (log2f(sm[i]) - nb[i]) * kLn2;
          }
        }
      }
    }
  }
}

constexpr int kBY = 8;    // backward: queries per tile (threadIdx.y)

template <int DH>
struct BwdTile {
  static constexpr int KC = 128 / DH < 32 ? 128 / DH : 32;   // keys per chunk
  static constexpr int KPT = (KC + kBY - 1) / kBY;             // keys per thread
  static constexpr int kFloats =
      2 * DH * KC * kLanes + 2 * kBY * DH * kLanes + 2 * kBY * KC * kLanes;
};

// dq_acc holds dq's partial sums over the key chunks before the last (it is
// dq itself for float32; the two may alias, so neither is __restrict__)
template <int DH, bool kDrop, typename T>
__global__ void __launch_bounds__(kLanes * kBY)
field_attention_bwd_kernel(const T* __restrict__ q,
                           const T* __restrict__ k,
                           const T* __restrict__ v,
                           const float* __restrict__ o,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           T* dq,
                           float* dq_acc,
                           T* __restrict__ dk,
                           T* __restrict__ dv,
                           int f, long long b, float scale, DropoutArgs dargs) {
  const Dropout drop = Dropout::load<kDrop>(dargs);
  using Tile = BwdTile<DH>;
  constexpr int KC = Tile::KC;
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
      ks[(j * kLanes + il) * DH + d] = ok ? to_float(k[off]) : 0.f;
      vs[(j * kLanes + il) * DH + d] = ok ? to_float(v[off]) : 0.f;
    }
    float ak[Tile::KPT][DH], av[Tile::KPT][DH];
#pragma unroll
    for (int i = 0; i < Tile::KPT; ++i) {
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
        qf[d] = q_ok ? to_float(q[own + d * fb]) : 0.f;
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
          if (kc0 > 0) val += dq_acc[own + d * fb];
          if (last_chunk) {
            dq[own + d * fb] = from_float<T>(val * scale);
          } else {
            dq_acc[own + d * fb] = val;
          }
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
        for (int i = 0; i < Tile::KPT; ++i) {
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
      for (int i = 0; i < Tile::KPT; ++i) {
        const int j = y + kBY * i;
        if (j < nk) {
          const long long key = head + static_cast<long long>(kc0 + j) * b + bi;
#pragma unroll
          for (int d = 0; d < DH; ++d) {
            dk[key + d * fb] = from_float<T>(ak[i][d] * scale);
            dv[key + d * fb] = from_float<T>(av[i][d]);
          }
        }
      }
    }
  }
}

template <int DH, int QPT, typename T>
int launch_fwd_q(const T* q, const T* k, const T* v, float* o, float* lse, int h, int f,
                 long long b, float scale, const DropoutArgs& drop, bool dropout,
                 unsigned int zsplit, cudaStream_t stream) {
  using Tile = FwdTile<DH>;
  const int bytes = (2 * Tile::kChunkFloats + Tile::kBoundFloats) * static_cast<int>(sizeof(float));
  auto kernel = dropout ? field_attention_fwd_kernel<DH, QPT, true, T>
                        : field_attention_fwd_kernel<DH, QPT, false, T>;
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (set != cudaSuccess) return static_cast<int>(set);
  const unsigned int z = zsplit ? static_cast<unsigned int>((f + kQy * QPT - 1) / (kQy * QPT)) : 1u;
  const dim3 grid(static_cast<unsigned int>((b + kLanes - 1) / kLanes),
                  static_cast<unsigned int>(h), z);
  kernel<<<grid, dim3(kLanes, kQy), bytes, stream>>>(q, k, v, o, lse, f, b, scale, drop);
  return static_cast<int>(cudaGetLastError());
}

// Where the (sample block, head) grid would leave SMs idle (small B), one
// query per thread and the query tiles spread over grid z; else QPT
// queries per thread and every tile in its block.
template <int DH, typename T>
int launch_fwd(const void* q, const void* k, const void* v, float* o, float* lse, int h,
               int f, long long b, float scale, const DropoutArgs& drop, bool dropout,
               cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((b + kLanes - 1) / kLanes * h < sms) {
    return launch_fwd_q<DH, 1, T>(qt, kt, vt, o, lse, h, f, b, scale, drop, dropout, 1u, stream);
  }
  return launch_fwd_q<DH, FwdTile<DH>::QPT, T>(qt, kt, vt, o, lse, h, f, b, scale, drop, dropout,
                                               0u, stream);
}

template <int DH, typename T>
int launch_bwd(const void* q, const void* k, const void* v, const float* o,
               const float* dout, const float* lse, void* dq, float* dq_acc, void* dk,
               void* dv, int h, int f, long long b, float scale, const DropoutArgs& drop,
               bool dropout, cudaStream_t stream) {
  const int bytes = BwdTile<DH>::kFloats * static_cast<int>(sizeof(float));
  auto kernel = dropout ? field_attention_bwd_kernel<DH, true, T>
                        : field_attention_bwd_kernel<DH, false, T>;
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid(static_cast<unsigned int>((b + kLanes - 1) / kLanes),
                  static_cast<unsigned int>(h));
  kernel<<<grid, dim3(kLanes, kBY), bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), o, dout,
      lse, static_cast<T*>(dq), dq_acc, static_cast<T*>(dk), static_cast<T*>(dv), f, b, scale,
      drop);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int fwd_dh(const void* q, const void* k, const void* v, float* o, float* lse, int h, int dh,
           int f, long long b, float scale, const DropoutArgs& drop, bool on, cudaStream_t stream) {
  switch (dh) {
    case 1: return launch_fwd<1, T>(q, k, v, o, lse, h, f, b, scale, drop, on, stream);
    case 2: return launch_fwd<2, T>(q, k, v, o, lse, h, f, b, scale, drop, on, stream);
    case 4: return launch_fwd<4, T>(q, k, v, o, lse, h, f, b, scale, drop, on, stream);
    case 8: return launch_fwd<8, T>(q, k, v, o, lse, h, f, b, scale, drop, on, stream);
    case 16: return launch_fwd<16, T>(q, k, v, o, lse, h, f, b, scale, drop, on, stream);
    case 32: return launch_fwd<32, T>(q, k, v, o, lse, h, f, b, scale, drop, on, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int bwd_dh(const void* q, const void* k, const void* v, const float* o, const float* lse,
           const float* dout, void* dq, float* dq_acc, void* dk, void* dv, int h, int dh,
           int f, long long b, float scale, const DropoutArgs& drop, bool on, cudaStream_t stream) {
  switch (dh) {
    case 1: return launch_bwd<1, T>(q, k, v, o, dout, lse, dq, dq_acc, dk, dv, h, f, b, scale,
                                    drop, on, stream);
    case 2: return launch_bwd<2, T>(q, k, v, o, dout, lse, dq, dq_acc, dk, dv, h, f, b, scale,
                                    drop, on, stream);
    case 4: return launch_bwd<4, T>(q, k, v, o, dout, lse, dq, dq_acc, dk, dv, h, f, b, scale,
                                    drop, on, stream);
    case 8: return launch_bwd<8, T>(q, k, v, o, dout, lse, dq, dq_acc, dk, dv, h, f, b, scale,
                                    drop, on, stream);
    case 16: return launch_bwd<16, T>(q, k, v, o, dout, lse, dq, dq_acc, dk, dv, h, f, b, scale,
                                      drop, on, stream);
    case 32: return launch_bwd<32, T>(q, k, v, o, dout, lse, dq, dq_acc, dk, dv, h, f, b, scale,
                                      drop, on, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

DropoutArgs make_dropout(const unsigned long long* key, unsigned int thresh,
                         float keep_scale, unsigned int sample0) {
  DropoutArgs drop;
  drop.key = key;
  drop.thresh = thresh;
  drop.keep_scale = keep_scale;
  drop.sample0 = sample0;
  return drop;
}

}  // namespace

// q, k, v (h, dh, F, B) contiguous, float32 (bf16 = 0) or bfloat16 (1);
// o (h, dh, F, B) and lse (h, F, B) float32; lse may be null (no backward to
// follow).  dropout != 0 applies the mask of the key at key (one 64-bit
// word in device memory, k0 << 32 | k1) with threshold thresh and scale
// keep_scale, numbering the samples from sample0 in the
// Philox counter (a rank's rows of a batch start at their global index).
RS_EXPORT int field_attention_fwd(const void* q, const void* k, const void* v, float* o,
                                  float* lse, int h, int dh, int f, long long b, float scale,
                                  int dropout, const unsigned long long* key,
                                  unsigned int thresh, float keep_scale, unsigned int sample0,
                                  int bf16_in, cudaStream_t stream) {
  const DropoutArgs drop = make_dropout(key, thresh, keep_scale, sample0);
  const bool on = dropout != 0;
  return bf16_in ? fwd_dh<bf16>(q, k, v, o, lse, h, dh, f, b, scale, drop, on, stream)
                 : fwd_dh<float>(q, k, v, o, lse, h, dh, f, b, scale, drop, on, stream);
}

// o is the forward's output, lse its (h, F, B) log-sum-exp, dout the
// output gradient, all float32; q, k, v and dq, dk, dv of one type, float32
// (bf16 = 0) or bfloat16 (1); dq_acc a float32 (h, dh, F, B) scratch for
// dq's partial sums (dq itself for float32; read and written only where F
// spans more than one key chunk); dropout as in the forward, from the same
// key.
RS_EXPORT int field_attention_bwd(const void* q, const void* k, const void* v, const float* o,
                                  const float* lse, const float* dout, void* dq, float* dq_acc,
                                  void* dk, void* dv, int h, int dh, int f, long long b,
                                  float scale, int dropout, const unsigned long long* key,
                                  unsigned int thresh, float keep_scale, unsigned int sample0,
                                  int bf16_in, cudaStream_t stream) {
  const DropoutArgs drop = make_dropout(key, thresh, keep_scale, sample0);
  const bool on = dropout != 0;
  return bf16_in ? bwd_dh<bf16>(q, k, v, o, lse, dout, dq, dq_acc, dk, dv, h, dh, f, b, scale,
                                drop, on, stream)
                 : bwd_dh<float>(q, k, v, o, lse, dout, dq, dq_acc, dk, dv, h, dh, f, b, scale,
                                 drop, on, stream);
}

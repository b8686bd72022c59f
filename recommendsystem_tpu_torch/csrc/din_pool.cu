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
// Two entries share the scorer:
//  - din_pool_f32 takes the facts as a (B, T, H) tensor (strided views);
//  - din_pool_gather_f32 and din_pool_gather_bf16 gather them themselves
//    from the embedding table (float32 or bfloat16 rows): fact t of sample
//    b is m * table[ids[b, t], lane0 : lane0 + H], with m the mask, and 0
//    where m is 0 (no table read there), which is what the fold K2
//    (fold.cu) writes and the staytime model then slices.  On the serving
//    path this removes K2's (B*T, D) rows from device memory: K2 wrote them
//    (105 MB a sequence at B = 16384, D = 32) and the pool read half of
//    each back.  A bf16 lane becomes float32 as it is loaded (exactly), so
//    the tile, the scores and the pooling stay float32.
//
// Bound on the H100 (67 TFLOP/s float32, 3.35 TB/s): bytes.  In the folded
// form below the function needs H*16 + 16 + H multiply-adds per (sample, t)
// and 2*H*16 per sample: at B = 16384, T = 50, H = 16 that is 0.49 GFLOP
// (7.3 us).  Facts given: 57.8 MB read and written once (17.3 us).
// Gathered: ids and mask 6.6 MB, the live 64-byte half-rows at most 52.4
// MB (32-byte windows, 26.2 MB, from a bf16 table), query and output 2.1 MB
// (about 18 us; 10 from bf16).  The TPU kernel's own count of
// the unfolded features (din_pallas.py:64-67), 1.73 GFLOP, overstates the
// work.
//
// Design.  With W1 split by rows into the blocks Wa, Wb, Wc, Wd that meet
// q, f, q - f and q * f, the pre-activation of hidden unit j is
//
//   a_j + sum_k f_k M[k, j],   a_j = b1_j + sum_k q_k (Wa + Wc)[k, j],
//                              M[k, j] = (Wb - Wc)[k, j] + q_k Wd[k, j],
//
// so a and M are built once per sample and each t costs H*16 multiply-adds,
// a quarter of the features' product.  One warp per sample, up to 8 samples
// a block: the block folds W1 into Wa + Wc, Wb - Wc and Wd in shared
// memory; the warp builds its sample's a and M there; lane l scores t = l,
// l + 32, ... with the 16 pre-activations in registers, reading M as float4
// broadcasts.  The scores stay in shared memory, the masked max and the
// softmax sum are warp shuffles.  The scorer's sigmoid uses the fast
// exponential and division (__expf, __fdividef): a few ulp on a value that
// only weights the softmax.
//
// Facts given, lane l reads its row t straight from the facts tensor for
// the score, and the pooling pass reads the facts again, H lanes per row.
//
// Gathered, the warp first copies its sample's T half-rows into a tile in
// shared memory, 4 lanes a half-row, each lane one chunk of 4 lanes (16
// bytes of a float32 row, 8 of a bf16 one), so one load instruction moves 8
// half-rows (8 rows, 2 sectors each; 1 from bf16) and each lane has up to 8
// loads in flight before it stores any; the tile holds m * row in
// float32.  The scoring pass and the pooling pass then both read the tile,
// so the table is read once per (sample, t).  The scoring pass skips the
// masked positions (their score is MASK_PAD whatever the scorer says): a
// warp whose live positions all lie below t = 32 makes one pass, not two.
// The chunks of row t sit at chunk c ^ ((t >> 1) & 3), which keeps the
// tile's stores and the scoring pass's reads (a row a lane) free of bank
// conflicts.  The tile and the scores take (H + 1) * T floats a warp of
// dynamic shared memory; above 48 KB a block takes fewer warps.
//
// The query is a strided view (the first 16 of 32 lanes of a mean row): the
// kernels take its row stride; its last dimension must be contiguous.
// Output (B, H) contiguous.
//
// bf16 inputs (the bf16 compute policy).  The query, the facts and the
// scorer's w1, b1, w2, b2 may be bfloat16, all of one compute type C (a
// template parameter); the gathering entry reads a float32 or a bf16 table
// (T) whatever C is.  The JAX kernel's body on bf16 inputs
// (din_pallas.py:25-36) forms q - f and q * f in bf16, each rounded, before
// the scorer's product, which accumulates in float32; the sigmoid, the
// softmax and the weighted sum are float32, and the output is float32.
// Those two roundings break the fold above (it multiplies q into W1 before
// f is known), so for C = bf16 the scorer takes the features as they are:
// a_j = b1_j + sum_k q_k Wa[k, j] once per sample, then per t
// sum_k f_k Wb + bf16(q_k - f_k) Wc + bf16(q_k * f_k) Wd, 3*H*16
// multiply-adds in place of H*16.  Every value is widened as it is loaded;
// a gathered fact from a float32 table is rounded to bf16 as the tile takes
// it (the JAX predict step casts its folded facts to bf16), which is the
// identity for a bf16 table.  The mask stays float32.

#include <cmath>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int H = 16;                          // the query and fact width
constexpr int kHidden = 16;
constexpr int kWarps = 8;
constexpr int kW = H * kHidden;                // one (H, 16) block of W1
constexpr unsigned kFull = 0xffffffffu;
constexpr float kMaskPad = -4294967296.0f;   // -(2^32) + 1 in float32
constexpr int kChunks = H / 4;                 // 16-byte chunks of a fact row
constexpr int kLoadRows = 32 / kChunks;        // fact rows a warp loads at once
constexpr int kInFlight = 8;                   // loads a lane issues before storing
// dynamic shared memory a block may take: below the 227 KB a block can
// have, with room for the static scorer
constexpr size_t kMaxDynamic = 200 * 1024;

// The block's scorer and each warp's fold of its sample's query.  Compute
// type float32: wq = Wa + Wc, wf = Wb - Wc, wd = Wd and m[warp] the query's
// M.  bf16 (rounded features): wq = Wc, wf = Wb, wd = Wd and m[warp] holds
// the query itself.
struct Scorer {
  float wq[kW];
  float wf[kW];
  float wd[kW];
  float m[kWarps][kW];
  float a[kWarps][kHidden];
  float b1[kHidden];
  float w2[kHidden];
};

// compute type bf16: the features q - f and q * f are rounded
template <typename C>
constexpr bool kRounds = std::is_same<C, bf16>::value;

// the block folds W1 (4H, 16) (for bf16 it copies its Wb, Wc and Wd
// blocks), widened; the caller synchronises
template <typename C>
__device__ __forceinline__ void fold_weights(Scorer& sc, const C* __restrict__ w1,
                                             const C* __restrict__ b1,
                                             const C* __restrict__ w2) {
  for (int i = threadIdx.x; i < kW; i += blockDim.x) {
    const float wc = to_float(w1[2 * kW + i]);
    const float wb = to_float(w1[kW + i]);
    if constexpr (kRounds<C>) {
      sc.wq[i] = wc;
      sc.wf[i] = wb;
    } else {
      sc.wq[i] = to_float(w1[i]) + wc;
      sc.wf[i] = wb - wc;
    }
    sc.wd[i] = to_float(w1[3 * kW + i]);
  }
  if (threadIdx.x < kHidden) {
    sc.b1[threadIdx.x] = to_float(b1[threadIdx.x]);
    sc.w2[threadIdx.x] = to_float(w2[threadIdx.x]);
  }
}

// the warp builds its sample's a (16) and M (H x 16); for bf16, a from W1's
// Wa block and the query into m[warp]
template <typename C>
__device__ __forceinline__ void fold_query(Scorer& sc, int warp, int lane,
                                           const C* __restrict__ qs,
                                           const C* __restrict__ w1) {
  float* m = sc.m[warp];
  if constexpr (kRounds<C>) {
    if (lane < H) m[lane] = to_float(qs[lane]);
  } else {
    for (int i = lane; i < kW; i += 32) {
      m[i] = fmaf(to_float(qs[i / kHidden]), sc.wd[i], sc.wf[i]);
    }
  }
  if (lane < kHidden) {
    float a = 0.f;
#pragma unroll
    for (int k = 0; k < H; ++k) {
      const float wa = kRounds<C> ? to_float(w1[k * kHidden + lane]) : sc.wq[k * kHidden + lane];
      a = fmaf(to_float(qs[k]), wa, a);
    }
    sc.a[warp][lane] = sc.b1[lane] + a;
  }
  __syncwarp();
}

// the score of one fact row under the warp's fold
template <typename C>
__device__ __forceinline__ float score(const Scorer& sc, int warp, const float (&fv)[H],
                                       float bias2) {
  // M and a are read from shared memory on every call: hoisted out of the
  // caller's loop, their H*16 + 16 values would take every register and spill
  asm volatile("" ::: "memory");
  const float* m = sc.m[warp];
  float acc[kHidden];
#pragma unroll
  for (int j4 = 0; j4 < kHidden / 4; ++j4) {
    const float4 a4 = reinterpret_cast<const float4*>(sc.a[warp])[j4];
    acc[4 * j4 + 0] = a4.x;
    acc[4 * j4 + 1] = a4.y;
    acc[4 * j4 + 2] = a4.z;
    acc[4 * j4 + 3] = a4.w;
  }
  if constexpr (kRounds<C>) {
    // [f, bf16(q - f), bf16(q * f)] against Wb, Wc and Wd
#pragma unroll
    for (int k = 0; k < H; ++k) {
      const float x[3] = {fv[k], round_bf16(m[k] - fv[k]), round_bf16(m[k] * fv[k])};
      const float* blocks[3] = {sc.wf, sc.wq, sc.wd};
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        const float4* row = reinterpret_cast<const float4*>(blocks[e] + k * kHidden);
#pragma unroll
        for (int j4 = 0; j4 < kHidden / 4; ++j4) {
          const float4 w = row[j4];
          acc[4 * j4 + 0] = fmaf(x[e], w.x, acc[4 * j4 + 0]);
          acc[4 * j4 + 1] = fmaf(x[e], w.y, acc[4 * j4 + 1]);
          acc[4 * j4 + 2] = fmaf(x[e], w.z, acc[4 * j4 + 2]);
          acc[4 * j4 + 3] = fmaf(x[e], w.w, acc[4 * j4 + 3]);
        }
      }
    }
  } else {
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
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kHidden; ++j) {
    s = fmaf(__fdividef(1.f, 1.f + __expf(-acc[j])), sc.w2[j], s);
  }
  return s + bias2;
}

// p[0, t) from scores to softmax weights, in place; mx is this lane's max
// of the scores it wrote (t = lane, lane + 32, ...)
__device__ __forceinline__ void softmax(float* p, int t, int lane, float mx) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
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
}

template <typename C>
__global__ void __launch_bounds__(kWarps * 32)
din_pool_kernel(const C* __restrict__ q, const C* __restrict__ facts,
                const float* __restrict__ mask, const C* __restrict__ w1,
                const C* __restrict__ b1, const C* __restrict__ w2,
                const C* __restrict__ b2, float* __restrict__ out,
                long long b, int t, long long qb, long long fb, long long ft,
                long long mb, long long mt) {
  __shared__ __align__(16) Scorer sc;
  extern __shared__ float s_scores[];          // kWarps x t
  fold_weights(sc, w1, b1, w2);
  const float bias2 = to_float(b2[0]);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long sample = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (sample >= b) return;                     // whole warps leave together
  const C* fs = facts + sample * fb;
  const float* ms = mask + sample * mb;
  float* p = s_scores + warp * t;
  fold_query(sc, warp, lane, q + sample * qb, w1);

  // scores, and the running max of this lane's scores
  float mx = -INFINITY;
  for (int ti = lane; ti < t; ti += 32) {
    const C* fr = fs + ti * ft;
    float fv[H];
#pragma unroll
    for (int k = 0; k < H; ++k) fv[k] = to_float(fr[k]);
    float s = score<C>(sc, warp, fv, bias2);
    if (!(ms[ti * mt] > 0.f)) s = kMaskPad;
    p[ti] = s;
    mx = fmaxf(mx, s);
  }
  softmax(p, t, lane, mx);

  // pooling: H lanes per fact row, 32 / H rows at a time
  constexpr int kRows = 32 / H;
  const int h = lane % H;
  float o = 0.f;
  for (int ti = lane / H; ti < t; ti += kRows) o = fmaf(p[ti], to_float(fs[ti * ft + h]), o);
#pragma unroll
  for (int off = H; off < 32; off <<= 1) o += __shfl_xor_sync(kFull, o, off);
  if (lane < H) out[sample * H + h] = o;
}

// where chunk c of tile row t sits
__device__ __forceinline__ int swizzle(int t, int c) { return c ^ ((t >> 1) & 3); }

__device__ __forceinline__ float4 scale(float m, const float4& v) {
  return make_float4(m * v.x, m * v.y, m * v.z, m * v.w);
}

template <typename T, typename C>
__global__ void __launch_bounds__(kWarps * 32)
din_pool_gather_kernel(const C* __restrict__ q, const T* __restrict__ table,
                       const int* __restrict__ ids, const float* __restrict__ mask,
                       const C* __restrict__ w1, const C* __restrict__ b1,
                       const C* __restrict__ w2, const C* __restrict__ b2,
                       float* __restrict__ out, long long b, int t, long long qb,
                       int d, int lane0) {
  __shared__ __align__(16) Scorer sc;
  // per warp: its (t, H) fact tile, then (after every warp's tile) its t
  // scores
  extern __shared__ __align__(16) float s_dyn[];
  fold_weights(sc, w1, b1, w2);
  const float bias2 = to_float(b2[0]);
  __syncthreads();

  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long sample = static_cast<long long>(blockIdx.x) * warps + warp;
  if (sample >= b) return;                     // whole warps leave together
  float4* tile = reinterpret_cast<float4*>(s_dyn) + static_cast<size_t>(warp) * t * kChunks;
  float* p = s_dyn + static_cast<size_t>(warps) * t * H + static_cast<size_t>(warp) * t;
  const int* is = ids + sample * t;
  const float* ms = mask + sample * t;
  fold_query(sc, warp, lane, q + sample * qb, w1);

  // the facts: lane 4r + c copies chunk c of rows r, r + 8, ...; each
  // tile row is m * row, and p[t] holds m until its score replaces it
  const int r = lane / kChunks;
  const int c = lane % kChunks;
  using Raw = typename Lanes<T, 4>::Raw;
  const Raw* chunks = reinterpret_cast<const Raw*>(table + lane0) + c;
  const size_t row4 = static_cast<size_t>(d / 4);
  for (int t0 = 0; t0 < t; t0 += kLoadRows * kInFlight) {
    float m[kInFlight];
    int id[kInFlight];
#pragma unroll
    for (int i = 0; i < kInFlight; ++i) {
      const int ti = t0 + i * kLoadRows + r;
      m[i] = ti < t ? ms[ti] : 0.f;
      id[i] = ti < t ? is[ti] : 0;
    }
    Raw v[kInFlight];
#pragma unroll
    for (int i = 0; i < kInFlight; ++i) {
      v[i] = m[i] != 0.f ? __ldg(chunks + static_cast<size_t>(id[i]) * row4) : Raw{};
    }
#pragma unroll
    for (int i = 0; i < kInFlight; ++i) {
      const int ti = t0 + i * kLoadRows + r;
      if (ti < t) {
        float f[4];
        Lanes<T, 4>::widen(v[i], f);
        if constexpr (kRounds<C>) {
#pragma unroll
          for (int j = 0; j < 4; ++j) f[j] = round_bf16(f[j]);
        }
        tile[ti * kChunks + swizzle(ti, c)] = scale(m[i], make_float4(f[0], f[1], f[2], f[3]));
        if (c == 0) p[ti] = m[i];
      }
    }
  }
  __syncwarp();

  // scores from the tile, and the running max of this lane's scores; a
  // masked position is not scored, MASK_PAD replaces its score
  float mx = -INFINITY;
  for (int ti = lane; ti < t; ti += 32) {
    float s = kMaskPad;
    if (p[ti] > 0.f) {
      const float4* row = tile + ti * kChunks;
      float fv[H];
#pragma unroll
      for (int k = 0; k < kChunks; ++k) {
        const float4 x = row[swizzle(ti, k)];
        fv[4 * k + 0] = x.x;
        fv[4 * k + 1] = x.y;
        fv[4 * k + 2] = x.z;
        fv[4 * k + 3] = x.w;
      }
      s = score<C>(sc, warp, fv, bias2);
    }
    p[ti] = s;
    mx = fmaxf(mx, s);
  }
  softmax(p, t, lane, mx);

  // pooling from the tile: lane 4r + c sums chunk c over rows r, r + 8, ...
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int ti = r; ti < t; ti += kLoadRows) {
    const float w = p[ti];
    const float4 x = tile[ti * kChunks + swizzle(ti, c)];
    o.x = fmaf(w, x.x, o.x);
    o.y = fmaf(w, x.y, o.y);
    o.z = fmaf(w, x.z, o.z);
    o.w = fmaf(w, x.w, o.w);
  }
#pragma unroll
  for (int off = kChunks; off < 32; off <<= 1) {
    o.x += __shfl_xor_sync(kFull, o.x, off);
    o.y += __shfl_xor_sync(kFull, o.y, off);
    o.z += __shfl_xor_sync(kFull, o.z, off);
    o.w += __shfl_xor_sync(kFull, o.w, off);
  }
  if (lane < kChunks) reinterpret_cast<float4*>(out + sample * H)[c] = o;
}

template <typename C>
int launch_pool(const void* q, const void* facts, const float* mask, const void* w1,
                const void* b1, const void* w2, const void* b2, float* out, long long b, int t,
                long long qb, long long fb, long long ft, long long mb, long long mt,
                cudaStream_t stream) {
  const unsigned int blocks = static_cast<unsigned int>((b + kWarps - 1) / kWarps);
  const size_t smem = sizeof(float) * kWarps * static_cast<size_t>(t);
  din_pool_kernel<C><<<blocks, kWarps * 32, smem, stream>>>(
      static_cast<const C*>(q), static_cast<const C*>(facts), mask, static_cast<const C*>(w1),
      static_cast<const C*>(b1), static_cast<const C*>(w2), static_cast<const C*>(b2), out, b, t,
      qb, fb, ft, mb, mt);
  return static_cast<int>(cudaGetLastError());
}

// the gathering launch over a table of T: see din_pool_gather
template <typename T, typename C>
int launch_gather(const void* q, const void* table, const int* ids, const float* mask,
                  const void* w1, const void* b1, const void* w2, const void* b2, float* out,
                  long long b, int t, long long qb, int d, int lane0, cudaStream_t stream) {
  const size_t per_warp = sizeof(float) * (H + 1) * static_cast<size_t>(t);
  if (t < 1 || d % 4 || lane0 % 4 || lane0 + H > d || !aligned16(table) ||
      !aligned16(out) || per_warp > kMaxDynamic) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int warps = kWarps;
  while (warps > 1 && warps * per_warp > kMaxDynamic) --warps;
  const size_t smem = warps * per_warp;
  // the static scorer and the dynamic tiles together pass the default 48
  // KB from T = 66 on: opt in once to kMaxDynamic
  static const cudaError_t raised = cudaFuncSetAttribute(
      din_pool_gather_kernel<T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMaxDynamic));
  if (raised != cudaSuccess) return static_cast<int>(raised);
  const unsigned int blocks = static_cast<unsigned int>((b + warps - 1) / warps);
  din_pool_gather_kernel<T, C><<<blocks, warps * 32, smem, stream>>>(
      static_cast<const C*>(q), static_cast<const T*>(table), ids, mask,
      static_cast<const C*>(w1), static_cast<const C*>(b1), static_cast<const C*>(w2),
      static_cast<const C*>(b2), out, b, t, qb, d, lane0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, H) with row stride qb; facts (B, T, H) with strides (fb, ft, 1);
// mask (B, T) float32 {0, 1} with strides (mb, mt); w1 (4H, 16), b1 (16),
// w2 (16, 1), b2 (1) contiguous; q, facts and the weights all float32
// (bf16 = 0) or all bfloat16 (1); out (B, H) float32 contiguous; H = 16.
// T * 8 floats of dynamic shared memory (the wrapper caps T at 512).
RS_EXPORT int din_pool(const void* q, const void* facts, const float* mask, const void* w1,
                       const void* b1, const void* w2, const void* b2, float* out,
                       long long b, int t, long long qb, long long fb, long long ft,
                       long long mb, long long mt, int bf16_in, cudaStream_t stream) {
  return bf16_in ? launch_pool<bf16>(q, facts, mask, w1, b1, w2, b2, out, b, t, qb, fb, ft, mb,
                                     mt, stream)
                 : launch_pool<float>(q, facts, mask, w1, b1, w2, b2, out, b, t, qb, fb, ft, mb,
                                      mt, stream);
}

// q (B, H) with row stride qb; table (rows, D) contiguous, float32
// (table_bf16 = 0) or bfloat16 (1), 16-byte aligned, D % 4 == 0; ids (B, T)
// int32 and mask (B, T) float32 contiguous; facts are the lanes [lane0,
// lane0 + H) of each row, lane0 % 4 == 0; q and the weights float32 (bf16 =
// 0) or bfloat16 (1: the facts rounded to bf16); out as din_pool.  T >= 1
// (the wrapper caps T at 512).
RS_EXPORT int din_pool_gather(const void* q, const void* table, const int* ids,
                              const float* mask, const void* w1, const void* b1,
                              const void* w2, const void* b2, float* out, long long b, int t,
                              long long qb, int d, int lane0, int table_bf16, int bf16_in,
                              cudaStream_t stream) {
  if (table_bf16) {
    return bf16_in ? launch_gather<bf16, bf16>(q, table, ids, mask, w1, b1, w2, b2, out, b, t,
                                               qb, d, lane0, stream)
                   : launch_gather<bf16, float>(q, table, ids, mask, w1, b1, w2, b2, out, b, t,
                                                qb, d, lane0, stream);
  }
  return bf16_in ? launch_gather<float, bf16>(q, table, ids, mask, w1, b1, w2, b2, out, b, t,
                                              qb, d, lane0, stream)
                 : launch_gather<float, float>(q, table, ids, mask, w1, b1, w2, b2, out, b, t,
                                               qb, d, lane0, stream);
}

// K1 fold_mean and K2 fold_rows: fused gather + masked fold of embedding
// rows, for Hopper (sm_90a).
//
// Replaces recommendsystem_tpu/embedding/packed.py::fold_mean (the Pallas
// kernel at packed.py:273, pallas_call at :307) and ::fold_rows (:327,
// pallas_call at :347).  On the TPU the table was first gathered as 128-lane
// physical rows by an XLA take (packed.py:589) and the kernel selected each
// id's D-lane group in VMEM.  Here the table stays (rows, D) float32 and
// contiguous, and the gather is fused into the fold: the (E, 128) wide
// stream never exists.
//
//   fold_mean: out[c*B + b, :] = sum_j mask[c, j, b] * table[ids[c, j, b], :]
//              ids/mask l-major: slot j of row b of column c at (c*L + j)*B + b
//   fold_rows: out[e, :]       = mask[e] * table[ids[e], :]
//
// Bound on the H100 (3.35 TB/s HBM, 67 TFLOP/s float32): bytes.  Per output
// row the fold reads L ids and L masks (4 B each) and up to L table rows
// (D*4 B: one 32-B sector at D=8) and writes D*4 B; L*D multiply-adds are
// far below the float32 rate.
//
// fold_mean is one grouped launch over every mean segment of a call (a
// predict or train step has 24-46 of them, each a few microseconds of
// work): the segments' pointers and sizes travel by value in the kernel's
// parameter struct (read from the constant bank through __grid_constant__),
// with a prefix table of block starts by which a block finds its segment;
// blocks are numbered segment by segment.  Within a segment:
//  - a row is D/4 threads of 16-byte table loads when D % 4 == 0 and the
//    table is 16-byte aligned, else D threads of one float each;
//  - a thread first loads the ids and masks of up to kChunk slots of its
//    row (l-major, so neighbouring rows read neighbouring words), then
//    issues those slots' table loads, each predicated on mask != 0, before
//    it sums any of them: kChunk loads in flight, not one;
//  - the sum runs in slot order j = 0..L-1 as `acc += m * row` for each
//    slot with m != 0; L > kChunk takes several chunks;
//  - indices within a segment are 32-bit (the wrapper checks the sizes).
// fold_rows keeps one thread per output element (row, lane).  No shared
// memory: nothing is reused within a block.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSegments = 64;      // segments a launch takes
constexpr int kChunk = 8;             // slots whose table loads fly together

struct Segment {
  const float* table;
  const int* ids;
  const float* mask;
  float* out;
  int rows;     // C*B output rows
  int b;
  int l;
  int d;
  int vec;      // 4: float4 lanes; 1: one float a lane
};

using Group = Grouped<Segment, kMaxSegments>;
// kept within the 4 KB of kernel parameters every CUDA 12 driver accepts
static_assert(sizeof(Group) <= 4096, "Group exceeds 4 KB of kernel parameters");

__device__ __forceinline__ void zero(float& x) { x = 0.f; }
__device__ __forceinline__ void zero(float4& x) { x = make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ void add_scaled(float& acc, float m, float v) { acc += m * v; }
__device__ __forceinline__ void add_scaled(float4& acc, float m, const float4& v) {
  acc.x += m * v.x;
  acc.y += m * v.y;
  acc.z += m * v.z;
  acc.w += m * v.w;
}

// thread t of the segment: row t / (D/V), lanes V * (t % (D/V)) onward
template <int V>
__device__ __forceinline__ void fold_segment(const Segment& s, int t) {
  using Vec = typename VecOf<V>::type;
  const int per_row = s.d / V;
  const int x = t / per_row;
  if (x >= s.rows) return;
  const int lane = t - x * per_row;
  const int ci = x / s.b;
  const int bi = x - ci * s.b;
  const int* ids = s.ids + ci * s.l * s.b + bi;
  const float* mask = s.mask + ci * s.l * s.b + bi;
  const Vec* table = reinterpret_cast<const Vec*>(s.table) + lane;
  Vec acc;
  zero(acc);
  for (int j0 = 0; j0 < s.l; j0 += kChunk) {
    int id[kChunk];
    float m[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int j = j0 + k;
      m[k] = j < s.l ? mask[j * s.b] : 0.f;
      id[k] = j < s.l ? ids[j * s.b] : 0;
    }
    Vec v[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (m[k] != 0.f) {
        v[k] = table[static_cast<size_t>(id[k]) * per_row];
      } else {
        zero(v[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (m[k] != 0.f) add_scaled(acc, m[k], v[k]);
    }
  }
  reinterpret_cast<Vec*>(s.out)[x * per_row + lane] = acc;
}

__global__ void __launch_bounds__(kThreads)
fold_mean_group_kernel(const __grid_constant__ Group g) {
  const int blk = blockIdx.x;
  const int member = g.member_of(blk);
  const Segment& s = g.s[member];
  const int t = (blk - g.block_start[member]) * kThreads + static_cast<int>(threadIdx.x);
  if (s.vec == 4) {
    fold_segment<4>(s, t);
  } else {
    fold_segment<1>(s, t);
  }
}

__global__ void fold_rows_kernel(const float* __restrict__ table,
                                 const int* __restrict__ ids,
                                 const float* __restrict__ mask,
                                 float* __restrict__ out,
                                 long long e, int d) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= e * d) return;
  const long long r = t / d;
  const int lane = static_cast<int>(t - r * d);
  const float m = mask[r];
  out[t] = (m != 0.f) ? m * table[static_cast<long long>(ids[r]) * d + lane] : 0.f;
}

}  // namespace

// Segments a launch takes: the wrapper cuts larger groups.
RS_EXPORT int fold_mean_max_segments() { return kMaxSegments; }

// n segments (1 <= n <= kMaxSegments), each 8 host words: table, ids, mask,
// out (device pointers), then C, L, B, D.  Each segment needs C, L, B, D
// >= 1 and C*L*B and C*B*D below 2^31 (the wrapper checks; refused here
// with cudaErrorInvalidValue).
RS_EXPORT int fold_mean_group_f32(const long long* desc, int n, cudaStream_t stream) {
  if (n < 1 || n > kMaxSegments) return static_cast<int>(cudaErrorInvalidValue);
  Group g;
  long long blocks = 0;
  for (int i = 0; i < n; ++i) {
    const long long* w = desc + 8 * i;
    const long long c = w[4], l = w[5], b = w[6], d = w[7];
    if (c < 1 || l < 1 || b < 1 || d < 1 || c * l * b > 0x7fffffffLL ||
        c * b * d > 0x7fffffffLL) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const float* table = reinterpret_cast<const float*>(w[0]);
    float* out = reinterpret_cast<float*>(w[3]);
    const int vec = (d % 4 == 0 && aligned16(table) && aligned16(out)) ? 4 : 1;
    const Segment s{table, reinterpret_cast<const int*>(w[1]),
                    reinterpret_cast<const float*>(w[2]), out, static_cast<int>(c * b),
                    static_cast<int>(b), static_cast<int>(l), static_cast<int>(d), vec};
    if (!g.add(i, s, (c * b * (d / vec) + kThreads - 1) / kThreads, blocks)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  g.close(n, blocks);
  fold_mean_group_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

RS_EXPORT int fold_rows_f32(const float* table, const int* ids,
                            const float* mask, float* out, long long e, int d,
                            cudaStream_t stream) {
  const unsigned int blocks = static_cast<unsigned int>((e * d + kThreads - 1) / kThreads);
  fold_rows_kernel<<<blocks, kThreads, 0, stream>>>(table, ids, mask, out, e, d);
  return static_cast<int>(cudaGetLastError());
}

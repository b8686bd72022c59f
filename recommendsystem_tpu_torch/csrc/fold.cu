// K1 fold_mean and K2 fold_rows: fused gather + masked fold of embedding
// rows, for Hopper (sm_90a).
//
// Replaces recommendsystem_tpu/embedding/packed.py::fold_mean (the Pallas
// kernel at packed.py:273, pallas_call at :307) and ::fold_rows (:327,
// pallas_call at :347).  On the TPU the table was first gathered as 128-lane
// physical rows by an XLA take (packed.py:589) and the kernel selected each
// id's D-lane group in VMEM.  Here the table stays (rows, D), float32 or
// bfloat16, contiguous, and the gather is fused into the fold: the (E, 128)
// wide stream never exists.  A bf16 lane becomes float32 as it is loaded
// (exactly: its bits are the float's high half); the sums and the output
// are float32, as the JAX kernels convert lanes at use (packed.py:130).
//
//   fold_mean: out[c*B + b, :] = sum_j mask[c, j, b] * table[ids[c, j, b], :]
//              ids/mask l-major: slot j of row b of column c at (c*L + j)*B + b
//   fold_rows: out[e, :]       = mask[e] * table[ids[e], :]
//
// Bound on the H100 (3.35 TB/s HBM, 67 TFLOP/s float32): bytes.  Per output
// row the fold reads L ids and L masks (4 B each) and up to L table rows
// (D*4 B: one 32-B sector at D=8; D*2 B for a bf16 table) and writes D*4 B;
// L*D multiply-adds are far below the float32 rate.
//
// Each is one grouped launch over the segments of a call (a predict or
// train step has 24-49 of them, each a few microseconds of work): the
// members' pointers and sizes travel by value in the kernel's parameter
// struct (read from the constant bank through __grid_constant__), with a
// prefix table of block starts by which a block finds its member; blocks
// are numbered member by member.  Within a member:
//  - a row is D/V threads of 16-byte table loads when the table and the
//    output are 16-byte aligned and V divides D (V = 4 float32 lanes, or 8
//    bf16 lanes: D 8, 16, 32, 48, 56), else D threads of one lane each; the
//    table's type rides in each member's descriptor, so one launch may hold
//    float32 and bf16 members;
//  - fold_mean: a thread first loads the ids and masks of up to kChunk
//    slots of its row (l-major, so neighbouring rows read neighbouring
//    words), then issues those slots' table loads, each predicated on
//    mask != 0, before it sums any of them: kChunk loads in flight, not
//    one; the sum runs in slot order j = 0..L-1 as `acc += m * row` for
//    each slot with m != 0; L > kChunk takes several chunks;
//  - fold_rows: a thread takes kRowsPerThread units (a unit is one thread's
//    share of a row), kThreads apart so that neighbouring threads move
//    neighbouring words; it loads their ids and masks, then issues their
//    table loads, each predicated on mask != 0 (a masked entry reads no
//    table sector), then stores m * row or 0;
//  - indices within a member are 32-bit (the wrapper checks the sizes).
// No shared memory: nothing is reused within a block.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxMembers = 64;       // members a launch takes
constexpr int kChunk = 8;             // fold_mean: slots whose table loads fly together
constexpr int kRowsPerThread = 4;     // fold_rows: units whose table loads fly together

struct Segment {
  const void* table;
  const int* ids;
  const float* mask;
  float* out;
  int rows;     // C*B output rows
  int b;
  int l;
  int d;
  int vec;      // lanes a thread moves: 4 (float32) or 8 (bf16) in 16 bytes, or 1
  int bf16;     // 1: the table's rows are bfloat16
};

struct Rows {
  const void* table;
  const int* ids;
  const float* mask;
  float* out;
  int e;        // entries (output rows)
  int d;
  int vec;      // lanes a thread moves: 4 (float32) or 8 (bf16) in 16 bytes, or 1
  int bf16;     // 1: the table's rows are bfloat16
};

using Group = Grouped<Segment, kMaxMembers>;
using RowsGroup = Grouped<Rows, kMaxMembers>;
// kept within the 4 KB of kernel parameters every CUDA 12 driver accepts
static_assert(sizeof(Group) <= 4096, "Group exceeds 4 KB of kernel parameters");
static_assert(sizeof(RowsGroup) <= 4096, "RowsGroup exceeds 4 KB of kernel parameters");

// thread t of the segment: row t / (D/V), lanes V * (t % (D/V)) onward; the
// table's lanes are of type T, the sums and the output float32
template <typename T, int V>
__device__ __forceinline__ void fold_segment(const Segment& s, int t) {
  using Raw = typename Lanes<T, V>::Raw;
  const int per_row = s.d / V;
  const int x = t / per_row;
  if (x >= s.rows) return;
  const int lane = t - x * per_row;
  const int ci = x / s.b;
  const int bi = x - ci * s.b;
  const int* ids = s.ids + ci * s.l * s.b + bi;
  const float* mask = s.mask + ci * s.l * s.b + bi;
  const Raw* table = reinterpret_cast<const Raw*>(s.table) + lane;
  float acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = 0.f;
  for (int j0 = 0; j0 < s.l; j0 += kChunk) {
    int id[kChunk];
    float m[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int j = j0 + k;
      m[k] = j < s.l ? mask[j * s.b] : 0.f;
      id[k] = j < s.l ? ids[j * s.b] : 0;
    }
    Raw v[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (m[k] != 0.f) {
        v[k] = table[static_cast<size_t>(id[k]) * per_row];
      } else {
        v[k] = Raw{};
      }
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (m[k] != 0.f) {
        float f[V];
        Lanes<T, V>::widen(v[k], f);
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] += m[k] * f[i];
      }
    }
  }
  reinterpret_cast<typename Lanes<float, V>::Raw*>(s.out)[x * per_row + lane] =
      Lanes<float, V>::narrow(acc);
}

__global__ void __launch_bounds__(kThreads)
fold_mean_group_kernel(const __grid_constant__ Group g) {
  const int blk = blockIdx.x;
  const int member = g.member_of(blk);
  const Segment& s = g.s[member];
  const int t = (blk - g.block_start[member]) * kThreads + static_cast<int>(threadIdx.x);
  if (s.bf16) {
    if (s.vec == 8) {
      fold_segment<bf16, 8>(s, t);
    } else {
      fold_segment<bf16, 1>(s, t);
    }
  } else if (s.vec == 4) {
    fold_segment<float, 4>(s, t);
  } else {
    fold_segment<float, 1>(s, t);
  }
}

// block blk of the member: units (blk * kRowsPerThread + k) * kThreads +
// threadIdx.x, k < kRowsPerThread; unit u is row u / (D/V), lanes V * (u %
// (D/V)) onward
template <typename T, int V>
__device__ __forceinline__ void fold_rows_member(const Rows& s, int blk) {
  using Raw = typename Lanes<T, V>::Raw;
  // unsigned: a unit past the member's end (units < 2^31) stays below 2^32
  const unsigned per_row = static_cast<unsigned>(s.d / V);
  const unsigned units = static_cast<unsigned>(s.e) * per_row;
  const Raw* table = reinterpret_cast<const Raw*>(s.table);
  unsigned u[kRowsPerThread];
  int id[kRowsPerThread];
  float m[kRowsPerThread];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    u[k] = (static_cast<unsigned>(blk) * kRowsPerThread + k) * kThreads + threadIdx.x;
    const unsigned x = u[k] / per_row;
    m[k] = u[k] < units ? s.mask[x] : 0.f;
    id[k] = u[k] < units ? s.ids[x] : 0;
  }
  Raw v[kRowsPerThread];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    if (m[k] != 0.f) {
      const unsigned lane = u[k] % per_row;
      v[k] = table[static_cast<size_t>(id[k]) * per_row + lane];
    } else {
      v[k] = Raw{};
    }
  }
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    if (u[k] < units) {
      float o[V];
#pragma unroll
      for (int i = 0; i < V; ++i) o[i] = 0.f;
      if (m[k] != 0.f) {
        float f[V];
        Lanes<T, V>::widen(v[k], f);
#pragma unroll
        for (int i = 0; i < V; ++i) o[i] += m[k] * f[i];
      }
      reinterpret_cast<typename Lanes<float, V>::Raw*>(s.out)[u[k]] = Lanes<float, V>::narrow(o);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
fold_rows_group_kernel(const __grid_constant__ RowsGroup g) {
  const int blk = blockIdx.x;
  const int member = g.member_of(blk);
  const Rows& s = g.s[member];
  const int b = blk - g.block_start[member];
  if (s.bf16) {
    if (s.vec == 8) {
      fold_rows_member<bf16, 8>(s, b);
    } else {
      fold_rows_member<bf16, 1>(s, b);
    }
  } else if (s.vec == 4) {
    fold_rows_member<float, 4>(s, b);
  } else {
    fold_rows_member<float, 1>(s, b);
  }
}

// lanes a thread moves for a table of D lanes (bf16 or not) into out: 16
// bytes of the table where V divides D and both are 16-byte aligned
int vec_of(long long d, bool is_bf16, const void* table, const void* out) {
  const int v = is_bf16 ? 8 : 4;
  return (d % v == 0 && aligned16(table) && aligned16(out)) ? v : 1;
}

}  // namespace

// Members a launch takes, of either group: the wrapper cuts larger groups.
RS_EXPORT int fold_max_members() { return kMaxMembers; }

// n segments (1 <= n <= kMaxMembers), each 9 host words: table, ids, mask,
// out (device pointers), then C, L, B, D and the table's type (0 float32, 1
// bfloat16).  Each segment needs C, L, B, D >= 1 and C*L*B and C*B*D below
// 2^31 (the wrapper checks; refused here with cudaErrorInvalidValue).
RS_EXPORT int fold_mean_group(const long long* desc, int n, cudaStream_t stream) {
  if (n < 1 || n > kMaxMembers) return static_cast<int>(cudaErrorInvalidValue);
  Group g;
  long long blocks = 0;
  for (int i = 0; i < n; ++i) {
    const long long* w = desc + 9 * i;
    const long long c = w[4], l = w[5], b = w[6], d = w[7], type = w[8];
    if (c < 1 || l < 1 || b < 1 || d < 1 || c * l * b > 0x7fffffffLL ||
        c * b * d > 0x7fffffffLL || (type != 0 && type != 1)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const void* table = reinterpret_cast<const void*>(w[0]);
    float* out = reinterpret_cast<float*>(w[3]);
    const int vec = vec_of(d, type == 1, table, out);
    const Segment s{table, reinterpret_cast<const int*>(w[1]),
                    reinterpret_cast<const float*>(w[2]), out, static_cast<int>(c * b),
                    static_cast<int>(b), static_cast<int>(l), static_cast<int>(d), vec,
                    static_cast<int>(type)};
    if (!g.add(i, s, (c * b * (d / vec) + kThreads - 1) / kThreads, blocks)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  g.close(n, blocks);
  fold_mean_group_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

// n members (1 <= n <= kMaxMembers), each 7 host words: table, ids, mask,
// out (device pointers), then E, D and the table's type (0 float32, 1
// bfloat16).  Each member needs E, D >= 1 and E*D below 2^31 (the wrapper
// checks; refused here with cudaErrorInvalidValue).
RS_EXPORT int fold_rows_group(const long long* desc, int n, cudaStream_t stream) {
  if (n < 1 || n > kMaxMembers) return static_cast<int>(cudaErrorInvalidValue);
  RowsGroup g;
  long long blocks = 0;
  for (int i = 0; i < n; ++i) {
    const long long* w = desc + 7 * i;
    const long long e = w[4], d = w[5], type = w[6];
    if (e < 1 || d < 1 || e * d > 0x7fffffffLL || (type != 0 && type != 1)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const void* table = reinterpret_cast<const void*>(w[0]);
    float* out = reinterpret_cast<float*>(w[3]);
    const int vec = vec_of(d, type == 1, table, out);
    const Rows s{table, reinterpret_cast<const int*>(w[1]),
                 reinterpret_cast<const float*>(w[2]), out, static_cast<int>(e),
                 static_cast<int>(d), vec, static_cast<int>(type)};
    const long long per_block = static_cast<long long>(kThreads) * kRowsPerThread;
    if (!g.add(i, s, (e * (d / vec) + per_block - 1) / per_block, blocks)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  g.close(n, blocks);
  fold_rows_group_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

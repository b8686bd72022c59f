// K3 unfold_mean and K4 unfold_rows, each fused with the scatter-add that
// consumes it, for Hopper (sm_90a).
//
// Replaces recommendsystem_tpu/embedding/packed.py::unfold_mean (the Pallas
// kernel at packed.py:365, pallas_call at :394) and ::unfold_rows (:416,
// pallas_call at :437), together with the XLA scatter that follows them in
// apply_gradients_packed (acc.at[phys].add(pay), packed.py:671).  On the TPU
// the unfold wrote a (E, 128) payload of [grad | count] lane groups because
// the scatter needed 128-lane rows.  Here the payload never exists: each
// live entry adds its column's gradient and a count of 1.0 straight into a
// storage's float32 accumulator: a (rows, D) block of gradient sums G and a
// (rows,) block of counts N (one allocation of rows*(D+1) floats, G then N;
// the kernel takes the two pointers):
//
//   G[id, :] += g[b, :]    N[id] += 1.0    for mask[j*B + b] > 0
//
// unfold_mean's ids and mask are l-major (slot j of sample b at j*B + b) and
// broadcast the (B, D) gradient of the column's sums over its L slots;
// unfold_rows is the case L = 1 (one gradient row per entry).  Entries with
// mask 0 (padding, id 0) are skipped, so they never contend on row 0.
//
// Bound on the H100: bytes by the formula (one column at B = 65536, L = 5,
// D = 8 reads 1.3 MB of ids, 1.3 MB of mask and 2.1 MB of gradient, and
// reads and writes the rows it touches: ~4 us), in practice the reductions
// resolved in L2: with interleaved [grad | count] rows of 36 B (D = 8) no
// vector reduction is aligned, and a live slot takes 9 scalar ones.  Design:
//  - unfold_mean is one grouped launch over every mean column of a train
//    step, and unfold_rows one grouped launch over every single-id and
//    sequence column: the columns' pointers and sizes travel by value in
//    the kernel's parameter struct (__grid_constant__), with a prefix table
//    of block starts; blocks are numbered column by column, so that only a
//    few columns' accumulators are live in the 50 MB L2 at a time;
//  - both take up to 512 members a launch (the 212-feature ctr step has
//    180 single-id columns, staytime's 91 mean columns: one launch each
//    where 64 a launch took three and two).  Their table rides in a
//    parameter struct of ~30 KB, which Hopper accepts under CUDA >= 12.1
//    (up to 32,764 bytes), rather than in a member table in device memory:
//    that table would have to be copied to the card with the step's other
//    inputs, in stream order, where the parameter struct travels with the
//    launch itself and needs no allocation and no host sync;
//  - within a column the blocks walk (slot j, sample b) in l-major order
//    with 32-bit indices: the gradient row is b = e - (e / B) * B;
//  - with G's rows 16-byte aligned (D % 4 == 0), an entry is D/4 threads,
//    each loading its id and mask once and a float4 of the gradient row and
//    issuing one 16-byte vector reduction into G (atomicAdd on a float4,
//    sm_90); the first of them adds the count.  At D = 8 that is 3
//    reductions a live slot instead of 9.  Other D take one float a thread.
// Sums of gradients take a different order on every run; the counts are
// sums of 1.0 and stay exact.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxMembers = 512;      // columns a launch takes

struct Column {
  float* grads;     // G: (rows, D)
  float* counts;    // N: (rows,)
  const float* g;
  const int* ids;
  const float* mask;
  int l;
  int b;
  int d;
  int vec;          // 4: float4 lanes; 1: one float a lane
};

using Group = Grouped<Column, kMaxMembers>;
// kernel parameters past 4 KB: CUDA >= 12.1 on Volta and later, 32,764 bytes
#if !defined(CUDART_VERSION) || CUDART_VERSION < 12010
#error "unfold_scatter.cu needs CUDA 12.1 or later (kernel parameters past 4 KB)"
#endif
static_assert(sizeof(Group) <= 32764, "Group exceeds 32,764 bytes of kernel parameters");

__device__ __forceinline__ void add_into(float* p, float v) { atomicAdd(p, v); }
__device__ __forceinline__ void add_into(float4* p, float4 v) { atomicAdd(p, v); }

// thread t of the column: entry t / (D/V), lanes V * (t % (D/V)) onward
template <int V>
__device__ __forceinline__ void unfold_column(const Column& c, int t) {
  using Vec = typename VecOf<V>::type;
  const int per_entry = c.d / V;
  const int e = t / per_entry;
  if (e >= c.l * c.b) return;
  if (!(c.mask[e] > 0.f)) return;
  const int lane = t - e * per_entry;
  const int bi = e - (e / c.b) * c.b;
  const size_t row = static_cast<size_t>(c.ids[e]);
  const Vec val = reinterpret_cast<const Vec*>(c.g)[bi * per_entry + lane];
  add_into(reinterpret_cast<Vec*>(c.grads) + row * per_entry + lane, val);
  if (lane == 0) atomicAdd(c.counts + row, 1.f);
}

__global__ void __launch_bounds__(kThreads)
unfold_group_kernel(const __grid_constant__ Group g) {
  const int blk = blockIdx.x;
  const int member = g.member_of(blk);
  const Column& c = g.s[member];
  const int t = (blk - g.block_start[member]) * kThreads + static_cast<int>(threadIdx.x);
  if (c.vec == 4) {
    unfold_column<4>(c, t);
  } else {
    unfold_column<1>(c, t);
  }
}

// desc: n columns of 8 host words: grads, counts, g, ids, mask, L, B, D
int launch_group(const long long* desc, int n, cudaStream_t stream) {
  if (n < 1 || n > kMaxMembers) return static_cast<int>(cudaErrorInvalidValue);
  Group g;
  long long blocks = 0;
  for (int i = 0; i < n; ++i) {
    const long long* w = desc + 8 * i;
    const long long l = w[5], b = w[6], d = w[7];
    if (l < 1 || b < 1 || d < 1 || l * b * d > 0x7fffffffLL) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    float* grads = reinterpret_cast<float*>(w[0]);
    const float* grad = reinterpret_cast<const float*>(w[2]);
    const int vec = (d % 4 == 0 && aligned16(grads) && aligned16(grad)) ? 4 : 1;
    const Column c{grads, reinterpret_cast<float*>(w[1]), grad,
                   reinterpret_cast<const int*>(w[3]), reinterpret_cast<const float*>(w[4]),
                   static_cast<int>(l), static_cast<int>(b), static_cast<int>(d), vec};
    if (!g.add(i, c, (l * b * (d / vec) + kThreads - 1) / kThreads, blocks)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  g.close(n, blocks);
  unfold_group_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Members a launch takes: the wrappers cut larger groups.
RS_EXPORT int unfold_max_members() { return kMaxMembers; }

// n columns (1 <= n <= kMaxMembers), each 8 host words: grads (rows, D),
// counts (rows,), g, ids, mask (device pointers), then L, B, D; g is (B, D),
// ids and mask (L*B,) l-major.  Each column needs L, B, D >= 1 and L*B*D
// below 2^31 (the wrapper checks; refused here with cudaErrorInvalidValue).
RS_EXPORT int unfold_mean_group_f32(const long long* desc, int n, cudaStream_t stream) {
  return launch_group(desc, n, stream);
}

// n members (1 <= n <= kMaxMembers), each 8 host words as above with L = 1
// and B the member's entries E: g (E, D) one gradient row per entry, ids and
// mask (E,).
RS_EXPORT int unfold_rows_group_f32(const long long* desc, int n, cudaStream_t stream) {
  return launch_group(desc, n, stream);
}

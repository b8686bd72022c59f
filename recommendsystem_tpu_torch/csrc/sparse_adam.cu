// K8 sparse_adam_update: one lazy per-row Adam pass over every storage of a
// train step, in one launch, for Hopper (sm_90a).
//
// Replaces recommendsystem_tpu/embedding/packed.py::packed_adam_update
// (:1099; plain jnp in the JAX package, where it ran over the (rows/Ps, 128)
// packed-state layout, once per storage) with the arithmetic of
// recommendsystem_tpu/embedding/optimizers.py::SparseAdam.update.  Here each
// storage keeps the classic per-row layout: w, m, v (rows, D) and t, show
// (rows, 1) float32, all contiguous; acc is the accumulator that the
// unfold-scatter kernels filled, rows*(D+1) floats laid out as a (rows, D)
// block of gradient sums G followed by a (rows,) block of counts N.  For a
// row with count c = N[r] > 0:
//
//   t += 1;  m = b1*m + (1-b1)*g;  v = b2*v + (1-b2)*g*g
//   w -= lr * (m / (1 - b1^max(t,1))) / (sqrt(v / (1 - b2^max(t,1))) + eps)
//   show += c;  G[r, :] = 0;  N[r] = 0
//
// A row with count 0 writes nothing: w, m, v, t and show stay bit-identical,
// and its accumulator row is already zero.  Zeroing the live rows here means
// the next step needs no memset of the accumulator.  Products and sums use
// the _rn intrinsics, so the compiler fuses none of them into an FMA and
// each rounds as the float32 reference does; powf differs from the host's
// pow by up to 2 ulp.
//
// Bound on the H100: bytes.  A live row moves 4 * (2 (D+1) + 6 D + 4) B
// (G and N read and zeroed; w, m, v read and written; t and show), a dead row
// its count.  Design:
//  - one launch for a group of up to kMaxStorages storages: their pointers,
//    rows and D travel by value in the kernel's parameter struct (read from
//    the constant bank through __grid_constant__), with a prefix table of
//    block starts by which a block finds its storage.  No copy to the card,
//    no cache of pointers.
//  - a block takes a tile of kTileRows rows of one storage, a thread a row:
//    its count, t and show in one trip of coalesced 4-byte reads (a dead
//    row's gradients are never read: the counts have a block of their own);
//  - the live rows are compacted (a ballot and a prefix sum), and one
//    thread per live row updates t and show, clears the count and computes
//    the two bias corrections once for the row;
//  - then w, m, v and G of the live rows move as 16-byte vectors (D % 4 ==
//    0 and aligned; else one float a thread) in one trip, each thread
//    issuing the loads of kUnroll vectors before it uses any; G's words are
//    stored back as zeros.  A live row waits on device memory twice.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxStorages = 64;      // storages a launch takes
constexpr int kTileRows = kThreads;   // rows a block: one thread a row
// widest row: a tile's offsets, up to kTileRows * D, stay in 32 bits
constexpr int kMaxD = 0x7fffffff / kTileRows;
constexpr int kUnroll = 1;            // vectors in flight per thread (measured best)
constexpr int kMinBlocks = 4;         // blocks an SM: at most 64 registers a thread

struct Storage {
  float* w;
  float* m;
  float* v;
  float* t;
  float* show;
  float* acc;
  int rows;
  int d;
};

struct Group : Grouped<Storage, kMaxStorages> {
  float lr, b1, omb1, b2, omb2, eps;
};
// kept within the 4 KB of kernel parameters every CUDA 12 driver accepts
static_assert(sizeof(Group) <= 4096, "Group exceeds 4 KB of kernel parameters");

// w, m, v and G of the tile's live rows (live_s, n_live of them, in row
// order), V floats a thread at a time; G is stored back as zeros
template <int V>
__device__ __forceinline__ void adam_rows(const Storage& st, const Group& g,
                                          long long r0, int n_live,
                                          const int* live_s, const float* bc1_s,
                                          const float* bc2_s) {
  using Vec = typename VecOf<V>::type;
  const int d = st.d;
  const int per_row = d / V;
  const int units = n_live * per_row;
  Vec* w = reinterpret_cast<Vec*>(st.w + r0 * d);
  Vec* m = reinterpret_cast<Vec*>(st.m + r0 * d);
  Vec* v = reinterpret_cast<Vec*>(st.v + r0 * d);
  Vec* gsum = reinterpret_cast<Vec*>(st.acc + r0 * d);
  for (int base = threadIdx.x; base < units; base += kUnroll * kThreads) {
    Vec wv[kUnroll], mv[kUnroll], vv[kUnroll], gv[kUnroll];
    int at[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const int u = base + i * kThreads;
      if (u < units) {
        const int li = u / per_row;
        at[i] = live_s[li] * per_row + (u - li * per_row);
        wv[i] = w[at[i]];
        mv[i] = m[at[i]];
        vv[i] = v[at[i]];
        gv[i] = gsum[at[i]];
      }
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const int u = base + i * kThreads;
      if (u >= units) continue;
      const int li = u / per_row;
      const float bc1 = bc1_s[li];
      const float bc2 = bc2_s[li];
      float* wf = reinterpret_cast<float*>(&wv[i]);
      float* mf = reinterpret_cast<float*>(&mv[i]);
      float* vf = reinterpret_cast<float*>(&vv[i]);
      float* gf = reinterpret_cast<float*>(&gv[i]);
#pragma unroll
      for (int l = 0; l < V; ++l) {
        const float gr = gf[l];
        const float mm = __fadd_rn(__fmul_rn(g.b1, mf[l]), __fmul_rn(g.omb1, gr));
        const float vn = __fadd_rn(__fmul_rn(g.b2, vf[l]),
                                   __fmul_rn(g.omb2, __fmul_rn(gr, gr)));
        mf[l] = mm;
        vf[l] = vn;
        const float m_hat = __fdiv_rn(mm, bc1);
        const float v_hat = __fdiv_rn(vn, bc2);
        const float step = __fdiv_rn(__fmul_rn(g.lr, m_hat),
                                     __fadd_rn(__fsqrt_rn(v_hat), g.eps));
        wf[l] = __fsub_rn(wf[l], step);
        gf[l] = 0.f;
      }
      w[at[i]] = wv[i];
      m[at[i]] = mv[i];
      v[at[i]] = vv[i];
      gsum[at[i]] = gv[i];
    }
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
sparse_adam_group_kernel(const __grid_constant__ Group g) {
  __shared__ float bc1_s[kTileRows];         // by live index
  __shared__ float bc2_s[kTileRows];
  __shared__ int live_s[kTileRows];          // the tile's live rows, in order
  __shared__ int warp_live[kThreads / 32];

  const int blk = blockIdx.x;
  const int member = g.member_of(blk);
  const Storage& st = g.s[member];
  const int d = st.d;
  const long long r0 = static_cast<long long>(blk - g.block_start[member]) * kTileRows;
  const int nr = static_cast<int>(min(static_cast<long long>(kTileRows), st.rows - r0));
  float* counts = st.acc + static_cast<long long>(st.rows) * d;

  // 1. thread r looks at row r: its count, t and show in one trip
  const int r = threadIdx.x;
  float cnt = 0.f, t_old = 0.f, show_old = 0.f;
  if (r < nr) {
    cnt = counts[r0 + r];
    t_old = st.t[r0 + r];
    show_old = st.show[r0 + r];
  }
  const bool is_live = cnt > 0.f;

  // 2. the live rows, compacted in row order
  const unsigned int ballot = __ballot_sync(0xffffffffu, is_live);
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  if (lane == 0) warp_live[wid] = __popc(ballot);
  __syncthreads();
  int before = 0, n_live = 0;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) {
    before += i < wid ? warp_live[i] : 0;
    n_live += warp_live[i];
  }
  if (n_live == 0) return;

  // 3. each live row: t and show, its count cleared, the bias corrections
  if (is_live) {
    const int li = before + __popc(ballot & ((1u << lane) - 1u));
    live_s[li] = r;
    const float t_new = __fadd_rn(t_old, 1.f);
    const float ts = fmaxf(t_new, 1.f);
    bc1_s[li] = __fsub_rn(1.f, powf(g.b1, ts));
    bc2_s[li] = __fsub_rn(1.f, powf(g.b2, ts));
    st.t[r0 + r] = t_new;
    st.show[r0 + r] = __fadd_rn(show_old, cnt);
    counts[r0 + r] = 0.f;
  }
  __syncthreads();

  // 4. w, m, v and G of the live rows
  if ((d & 3) == 0 && aligned16(st.w + r0 * d) && aligned16(st.m + r0 * d) &&
      aligned16(st.v + r0 * d) && aligned16(st.acc + r0 * d)) {
    adam_rows<4>(st, g, r0, n_live, live_s, bc1_s, bc2_s);
  } else {
    adam_rows<1>(st, g, r0, n_live, live_s, bc1_s, bc2_s);
  }
}

}  // namespace

// Storages a launch takes, and the largest D: the wrapper chunks and checks.
RS_EXPORT int sparse_adam_max_storages() { return kMaxStorages; }
RS_EXPORT int sparse_adam_max_d() { return kMaxD; }

// n storages (1 <= n <= kMaxStorages): ptrs holds n x 6 device pointers
// (w, m, v, t, show, acc), rows and d one entry each, all in host memory.
RS_EXPORT int sparse_adam_group_f32(const unsigned long long* ptrs,
                                    const long long* rows, const int* d, int n,
                                    float lr, float b1, float omb1, float b2,
                                    float omb2, float eps, cudaStream_t stream) {
  if (n < 1 || n > kMaxStorages) return static_cast<int>(cudaErrorInvalidValue);
  Group g;
  long long blocks = 0;
  for (int s = 0; s < n; ++s) {
    if (d[s] < 1 || d[s] > kMaxD || rows[s] < 0 || rows[s] > 0x7fffffffLL) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const unsigned long long* p = ptrs + 6 * s;
    const Storage st{reinterpret_cast<float*>(p[0]), reinterpret_cast<float*>(p[1]),
                     reinterpret_cast<float*>(p[2]), reinterpret_cast<float*>(p[3]),
                     reinterpret_cast<float*>(p[4]), reinterpret_cast<float*>(p[5]),
                     static_cast<int>(rows[s]), d[s]};
    if (!g.add(s, st, (rows[s] + kTileRows - 1) / kTileRows, blocks)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  g.close(n, blocks);
  g.lr = lr;
  g.b1 = b1;
  g.omb1 = omb1;
  g.b2 = b2;
  g.omb2 = omb2;
  g.eps = eps;
  if (blocks == 0) return 0;
  sparse_adam_group_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

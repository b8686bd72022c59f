// K8 sparse_adam_update: one lazy per-row Adam pass over every storage of a
// train step, in one launch, for Hopper (sm_90a).
//
// Replaces recommendsystem_tpu/embedding/packed.py::packed_adam_update
// (:1099; plain jnp in the JAX package, where it ran over the (rows/Ps, 128)
// packed-state layout, once per storage) with the arithmetic of
// recommendsystem_tpu/embedding/optimizers.py::SparseAdam.update.  Here each
// storage keeps the classic per-row layout: w, m, v (rows, D) and t, show
// (rows, 1), all contiguous; t and show are float32, w float32 or bfloat16,
// m and v (one type for both) float32 or bfloat16; acc is the accumulator that the
// unfold-scatter kernels filled, rows*(D+1) floats laid out as a (rows, D)
// block of gradient sums G followed by a (rows,) block of counts N.  For a
// row with count c = N[r] > 0:
//
//   t += 1;  m = b1*m + (1-b1)*g;  v = b2*v + (1-b2)*g*g
//   w -= lr * (m / (1 - b1^max(t,1))) / (sqrt(v / (1 - b2^max(t,1))) + eps)
//   show += c;  G[r, :] = 0;  N[r] = 0
//
// The arithmetic is float32: a bf16 w, m or v is widened as it is loaded
// (exactly), and only what is stored is rounded, to nearest even
// (__float2bfloat16_rn, as torch's .to(torch.bfloat16) and XLA's convert
// round).  The step is computed from the unrounded m and v, as the JAX
// optimizer computes it before it casts its moments to their storage type.
// A row with count 0 writes nothing: w, m, v, t and show stay bit-identical,
// and its accumulator row is already zero.  Zeroing the live rows here means
// the next step needs no memset of the accumulator.  Products and sums use
// the _rn intrinsics, so the compiler fuses none of them into an FMA and
// each rounds as the float32 reference does; powf differs from the host's
// pow by up to 2 ulp.
//
// Bound on the H100: bytes.  A live row moves 4 * (2 (D+1) + 4) B of G, N, t
// and show and 2 D (sw + 2 smv) B of w, m and v read and written (sw, smv:
// their types' sizes), a dead row its count.  Design:
//  - one launch for a group of up to kMaxStorages storages: their pointers,
//    rows, D and types travel by value in the kernel's parameter struct (read
//    from the constant bank through __grid_constant__), with a prefix table
//    of block starts by which a block finds its storage.  No copy to the
//    card, no cache of pointers.
//  - a block takes a tile of kTileRows rows of one storage, a thread a row:
//    its count, t and show in one trip of coalesced 4-byte reads (a dead
//    row's gradients are never read: the counts have a block of their own);
//  - the live rows are compacted (a ballot and a prefix sum), and one
//    thread per live row updates t and show, clears the count and computes
//    the two bias corrections once for the row;
//  - then w, m, v and G of the live rows move 4 lanes a thread (D % 4 == 0
//    and aligned: 16 bytes of a float32 array, 8 of a bf16 one; else one
//    lane a thread) in one trip, each thread
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

// the types of a storage's arrays (Group::kind): bits of kWBf16 and kMvBf16
constexpr int kWBf16 = 1;             // w is bfloat16
constexpr int kMvBf16 = 2;            // m and v are bfloat16

struct Storage {
  void* w;
  void* m;
  void* v;
  float* t;
  float* show;
  float* acc;
  int rows;
  int d;
};

struct Group : Grouped<Storage, kMaxStorages> {
  float lr, b1, omb1, b2, omb2, eps;
  unsigned char kind[kMaxStorages];   // each storage's types
};
// kept within the 4 KB of kernel parameters every CUDA 12 driver accepts
static_assert(sizeof(Group) <= 4096, "Group exceeds 4 KB of kernel parameters");

// w, m, v and G of the tile's live rows (live_s, n_live of them, in row
// order), V lanes a thread at a time, w of type TW, m and v of type TM; G is
// stored back as zeros
template <int V, typename TW, typename TM>
__device__ __forceinline__ void adam_rows(const Storage& st, const Group& g,
                                          long long r0, int n_live,
                                          const int* live_s, const float* bc1_s,
                                          const float* bc2_s) {
  using W = Lanes<TW, V>;
  using M = Lanes<TM, V>;
  using G = Lanes<float, V>;
  const int d = st.d;
  const int per_row = d / V;
  const int units = n_live * per_row;
  auto* w = reinterpret_cast<typename W::Raw*>(static_cast<TW*>(st.w) + r0 * d);
  auto* m = reinterpret_cast<typename M::Raw*>(static_cast<TM*>(st.m) + r0 * d);
  auto* v = reinterpret_cast<typename M::Raw*>(static_cast<TM*>(st.v) + r0 * d);
  auto* gsum = reinterpret_cast<typename G::Raw*>(st.acc + r0 * d);
  for (int base = threadIdx.x; base < units; base += kUnroll * kThreads) {
    typename W::Raw wv[kUnroll];
    typename M::Raw mv[kUnroll], vv[kUnroll];
    typename G::Raw gv[kUnroll];
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
      float wf[V], mf[V], vf[V], gf[V];
      W::widen(wv[i], wf);
      M::widen(mv[i], mf);
      M::widen(vv[i], vf);
      G::widen(gv[i], gf);
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
      w[at[i]] = W::narrow(wf);
      m[at[i]] = M::narrow(mf);
      v[at[i]] = M::narrow(vf);
      gsum[at[i]] = G::narrow(gf);
    }
  }
}

// adam_rows 4 lanes a thread where D % 4 == 0 and the tile's rows of every
// array are aligned to 4 lanes of its type, else one lane a thread
template <typename TW, typename TM>
__device__ __forceinline__ void rows_of(const Storage& st, const Group& g, long long r0,
                                        int n_live, const int* live_s, const float* bc1_s,
                                        const float* bc2_s) {
  const int d = st.d;
  if ((d & 3) == 0 && aligned_to(static_cast<TW*>(st.w) + r0 * d, 4 * sizeof(TW)) &&
      aligned_to(static_cast<TM*>(st.m) + r0 * d, 4 * sizeof(TM)) &&
      aligned_to(static_cast<TM*>(st.v) + r0 * d, 4 * sizeof(TM)) &&
      aligned16(st.acc + r0 * d)) {
    adam_rows<4, TW, TM>(st, g, r0, n_live, live_s, bc1_s, bc2_s);
  } else {
    adam_rows<1, TW, TM>(st, g, r0, n_live, live_s, bc1_s, bc2_s);
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
  const int kind = g.kind[member];
  if (kind == 0) {
    rows_of<float, float>(st, g, r0, n_live, live_s, bc1_s, bc2_s);
  } else if (kind == kWBf16) {
    rows_of<bf16, float>(st, g, r0, n_live, live_s, bc1_s, bc2_s);
  } else if (kind == kMvBf16) {
    rows_of<float, bf16>(st, g, r0, n_live, live_s, bc1_s, bc2_s);
  } else {
    rows_of<bf16, bf16>(st, g, r0, n_live, live_s, bc1_s, bc2_s);
  }
}

}  // namespace

// Storages a launch takes, and the largest D: the wrapper chunks and checks.
RS_EXPORT int sparse_adam_max_storages() { return kMaxStorages; }
RS_EXPORT int sparse_adam_max_d() { return kMaxD; }

// n storages (1 <= n <= kMaxStorages): ptrs holds n x 6 device pointers
// (w, m, v, t, show, acc), rows, d and kind one entry each (kind: kWBf16 |
// kMvBf16 bits, 0 for all float32), all in host memory.
RS_EXPORT int sparse_adam_group(const unsigned long long* ptrs, const long long* rows,
                                const int* d, const int* kind, int n, float lr, float b1,
                                float omb1, float b2, float omb2, float eps,
                                cudaStream_t stream) {
  if (n < 1 || n > kMaxStorages) return static_cast<int>(cudaErrorInvalidValue);
  Group g;
  long long blocks = 0;
  for (int s = 0; s < n; ++s) {
    if (d[s] < 1 || d[s] > kMaxD || rows[s] < 0 || rows[s] > 0x7fffffffLL ||
        kind[s] < 0 || kind[s] > (kWBf16 | kMvBf16)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const unsigned long long* p = ptrs + 6 * s;
    const Storage st{reinterpret_cast<void*>(p[0]), reinterpret_cast<void*>(p[1]),
                     reinterpret_cast<void*>(p[2]), reinterpret_cast<float*>(p[3]),
                     reinterpret_cast<float*>(p[4]), reinterpret_cast<float*>(p[5]),
                     static_cast<int>(rows[s]), d[s]};
    g.kind[s] = static_cast<unsigned char>(kind[s]);
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

// K8 sparse_adam_update: one lazy per-row Adam pass over every storage of a
// train step, in one launch, for Hopper (sm_90a).
//
// Replaces recommendsystem_tpu/embedding/packed.py::packed_adam_update
// (:1099; plain jnp in the JAX package, where it ran over the (rows/Ps, 128)
// packed-state layout, once per storage) with the arithmetic of
// recommendsystem_tpu/embedding/optimizers.py::SparseAdam.update.  Here each
// storage keeps the classic per-row layout: w, m, v (rows, D) and t, show
// (rows, 1) float32, all contiguous; acc is the (rows, D+1) [grad | count]
// accumulator that the unfold-scatter kernels filled.  For a row with count
// c = acc[r, D] > 0:
//
//   t += 1;  m = b1*m + (1-b1)*g;  v = b2*v + (1-b2)*g*g
//   w -= lr * (m / (1 - b1^max(t,1))) / (sqrt(v / (1 - b2^max(t,1))) + eps)
//   show += c;  acc[r, :] = 0
//
// A row with count 0 writes nothing: w, m, v, t and show stay bit-identical,
// and its accumulator row is already zero.  Zeroing the live rows here means
// the next step needs no memset of the accumulator.  Products and sums use
// the _rn intrinsics, so the compiler fuses none of them into an FMA and
// each rounds as the float32 reference does; powf differs from the host's
// pow by up to 2 ulp.
//
// Bound on the H100: bytes.  A live row moves 4 * (2 (D+1) + 6 D + 4) B
// (acc read and zeroed; w, m, v read and written; t and show), a dead row its
// count.  Design:
//  - one launch for a group of up to kMaxStorages storages: their pointers,
//    rows and D travel by value in the kernel's parameter struct (read from
//    the constant bank through __grid_constant__), with a prefix table of
//    block starts by which a block finds its storage.  No copy to the card,
//    no cache of pointers.
//  - a block takes a tile of rows of one storage.  It first reads the tile's
//    whole accumulator, (D+1) floats a row, contiguous, as 16-byte vectors,
//    into shared memory: the counts and the gradients in one coalesced trip
//    (a count is 4 B of a 36 B row at D = 8, so reading counts alone would
//    touch the same sectors).
//    The same trip reads t and show of every row of the tile (8 B a dead
//    row), so that a live row waits on device memory twice, not three
//    times.
//  - the live rows are compacted (a ballot and a prefix sum), so that
//    neither the rows' nor the lanes' work below waits on dead rows: one
//    thread per live row updates t and show and computes the two bias
//    corrections once for the row;
//  - then w, m, v of the live rows move as 16-byte vectors (D % 4 == 0
//    and aligned; else one float a thread), each thread issuing the loads
//    of kUnroll vectors before it uses any; dead rows load nothing.
//  - last, the 16-byte words of the accumulator that hold a live row are
//    stored as zeros.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxStorages = 64;      // storages a launch takes
constexpr int kTileFloats = 8192;     // accumulator tile: 32 KB of shared memory
constexpr int kMaxTileRows = 256;
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

struct Group {
  Storage s[kMaxStorages];
  int block_start[kMaxStorages + 1];  // prefix of blocks per storage
  int n;
  float lr, b1, omb1, b2, omb2, eps;
};
// kept within the 4 KB of kernel parameters every CUDA 12 driver accepts
static_assert(sizeof(Group) <= 4096, "Group exceeds 4 KB of kernel parameters");
static_assert(kMaxTileRows <= kThreads, "one thread a row of the tile");

// rows per block: the tile's accumulator fits kTileFloats; a multiple of 4
// rows keeps every tile 16-byte aligned where the accumulator is
__host__ __device__ __forceinline__ int tile_rows(int d) {
  int r = kTileFloats / (d + 1);
  r = r < kMaxTileRows ? r : kMaxTileRows;
  return r >= 4 ? (r & ~3) : r;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int V>
struct VecOf {
  using type = float;
};
template <>
struct VecOf<4> {
  using type = float4;
};

// w, m, v of the tile's live rows (live_s, n_live of them, in row order),
// V floats a thread at a time
template <int V>
__device__ __forceinline__ void adam_rows(const Storage& st, const Group& g,
                                          long long r0, int n_live,
                                          const int* live_s, const float* acc_s,
                                          const float* bc1_s,
                                          const float* bc2_s) {
  using Vec = typename VecOf<V>::type;
  const int d = st.d;
  const int width = d + 1;
  const int per_row = d / V;
  const int units = n_live * per_row;
  Vec* w = reinterpret_cast<Vec*>(st.w + r0 * d);
  Vec* m = reinterpret_cast<Vec*>(st.m + r0 * d);
  Vec* v = reinterpret_cast<Vec*>(st.v + r0 * d);
  for (int base = threadIdx.x; base < units; base += kUnroll * kThreads) {
    Vec wv[kUnroll], mv[kUnroll], vv[kUnroll];
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
      }
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const int u = base + i * kThreads;
      if (u >= units) continue;
      const int li = u / per_row;
      const float* gs = acc_s + live_s[li] * width + (u - li * per_row) * V;
      const float bc1 = bc1_s[li];
      const float bc2 = bc2_s[li];
      float* wf = reinterpret_cast<float*>(&wv[i]);
      float* mf = reinterpret_cast<float*>(&mv[i]);
      float* vf = reinterpret_cast<float*>(&vv[i]);
#pragma unroll
      for (int l = 0; l < V; ++l) {
        const float gr = gs[l];
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
      }
      w[at[i]] = wv[i];
      m[at[i]] = mv[i];
      v[at[i]] = vv[i];
    }
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
sparse_adam_group_kernel(const __grid_constant__ Group g) {
  __shared__ float4 acc_s4[kTileFloats / 4];
  __shared__ float t_s[kMaxTileRows];
  __shared__ float show_s[kMaxTileRows];
  __shared__ float bc1_s[kMaxTileRows];      // by live index
  __shared__ float bc2_s[kMaxTileRows];
  __shared__ int live_s[kMaxTileRows];       // the tile's live rows, in order
  __shared__ int warp_live[kThreads / 32];
  float* acc_s = reinterpret_cast<float*>(acc_s4);

  // the storage of this block: the last one whose first block is <= it
  const int blk = blockIdx.x;
  int lo = 0, hi = g.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (g.block_start[mid] <= blk) lo = mid; else hi = mid - 1;
  }
  const Storage& st = g.s[lo];
  const int d = st.d;
  const int width = d + 1;
  const int tr = tile_rows(d);
  const long long r0 = static_cast<long long>(blk - g.block_start[lo]) * tr;
  const int nr = static_cast<int>(min(static_cast<long long>(tr), st.rows - r0));
  float* acc_g = st.acc + r0 * width;
  const int nf = nr * width;
  const bool acc_vec = aligned16(acc_g);

  // 1. the tile's accumulator, counts and gradients, and its rows' t and
  //    show, in one trip of coalesced reads
  if (static_cast<int>(threadIdx.x) < nr) {
    t_s[threadIdx.x] = st.t[r0 + threadIdx.x];
    show_s[threadIdx.x] = st.show[r0 + threadIdx.x];
  }
  if (acc_vec) {
    const float4* src = reinterpret_cast<const float4*>(acc_g);
    for (int i = threadIdx.x; i < nf / 4; i += kThreads) acc_s4[i] = src[i];
    for (int i = (nf & ~3) + threadIdx.x; i < nf; i += kThreads) acc_s[i] = acc_g[i];
  } else {
    for (int i = threadIdx.x; i < nf; i += kThreads) acc_s[i] = acc_g[i];
  }
  __syncthreads();

  // 2. the live rows, compacted in row order (thread r looks at row r)
  const bool is_live = static_cast<int>(threadIdx.x) < nr &&
                       acc_s[threadIdx.x * width + d] > 0.f;
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
  if (is_live) live_s[before + __popc(ballot & ((1u << lane) - 1u))] = threadIdx.x;
  __syncthreads();

  // 3. one thread a live row: t, show and the bias corrections, once per row
  if (static_cast<int>(threadIdx.x) < n_live) {
    const int r = live_s[threadIdx.x];
    const float t_new = __fadd_rn(t_s[r], 1.f);
    const float ts = fmaxf(t_new, 1.f);
    bc1_s[threadIdx.x] = __fsub_rn(1.f, powf(g.b1, ts));
    bc2_s[threadIdx.x] = __fsub_rn(1.f, powf(g.b2, ts));
    st.t[r0 + r] = t_new;
    st.show[r0 + r] = __fadd_rn(show_s[r], acc_s[r * width + d]);
  }
  __syncthreads();

  // 4. w, m, v of the live rows
  if ((d & 3) == 0 && aligned16(st.w + r0 * d) && aligned16(st.m + r0 * d) &&
      aligned16(st.v + r0 * d)) {
    adam_rows<4>(st, g, r0, n_live, live_s, acc_s, bc1_s, bc2_s);
  } else {
    adam_rows<1>(st, g, r0, n_live, live_s, acc_s, bc1_s, bc2_s);
  }

  // 5. the live rows' accumulator back to zero (a 16-byte word spans at
  //    most two rows; a dead row's words are zero already)
  if (acc_vec) {
    float4* dst = reinterpret_cast<float4*>(acc_g);
    for (int i = threadIdx.x; i < nf / 4; i += kThreads) {
      const int ra = (4 * i) / width;
      const int rb = (4 * i + 3) / width;
      if (acc_s[ra * width + d] > 0.f || acc_s[rb * width + d] > 0.f) {
        dst[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    for (int i = (nf & ~3) + threadIdx.x; i < nf; i += kThreads) {
      if (acc_s[(i / width) * width + d] > 0.f) acc_g[i] = 0.f;
    }
  } else {
    for (int i = threadIdx.x; i < nf; i += kThreads) {
      if (acc_s[(i / width) * width + d] > 0.f) acc_g[i] = 0.f;
    }
  }
}

}  // namespace

// Storages a launch takes, and the largest D: the wrapper chunks and checks.
RS_EXPORT int sparse_adam_max_storages() { return kMaxStorages; }
RS_EXPORT int sparse_adam_max_d() { return kTileFloats - 1; }

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
    const int tr = d[s] >= 1 ? tile_rows(d[s]) : 0;
    if (tr < 1 || rows[s] < 0 || rows[s] > 0x7fffffffLL) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const unsigned long long* p = ptrs + 6 * s;
    g.s[s] = Storage{reinterpret_cast<float*>(p[0]), reinterpret_cast<float*>(p[1]),
                     reinterpret_cast<float*>(p[2]), reinterpret_cast<float*>(p[3]),
                     reinterpret_cast<float*>(p[4]), reinterpret_cast<float*>(p[5]),
                     static_cast<int>(rows[s]), d[s]};
    g.block_start[s] = static_cast<int>(blocks);
    blocks += (rows[s] + tr - 1) / tr;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  }
  g.block_start[n] = static_cast<int>(blocks);
  g.n = n;
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

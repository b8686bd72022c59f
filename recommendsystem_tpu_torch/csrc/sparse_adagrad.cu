// K9 sparse_adagrad_update: one lazy per-row AdaGrad pass over every storage
// of a train step, in one launch, for Hopper (sm_90a).
//
// The JAX package runs this update as XLA over whole tables: the classic-
// state branch of recommendsystem_tpu/embedding/packed.py::
// apply_gradients_packed (:714-731) applies
// recommendsystem_tpu/embedding/optimizers.py::SparseAdaGrad.update (:99) to
// each storage and adds the counts to show.  Here each storage keeps the
// classic per-row layout: w (rows, D) float32 or bfloat16, g2sum and show
// (rows, 1) float32, all contiguous; acc is the accumulator that the
// unfold-scatter kernels filled, rows*(D+1) floats laid out as a (rows, D)
// block of gradient sums G
// followed by a (rows,) block of counts N.  For a row with count
// c = N[r] > 0:
//
//   g2sum += (sum_l G[r, l]^2) / D
//   w[r, l] -= lr * G[r, l] / sqrt(g2sum)
//   show += c;  G[r, :] = 0;  N[r] = 0
//
// The arithmetic is float32: a bf16 w is widened as it is loaded (exactly)
// and rounded to nearest even as it is stored (__float2bfloat16_rn, as
// torch's .to(torch.bfloat16) and XLA's convert round).
// A row with count 0 reads its count and nothing else, and writes nothing:
// w, g2sum and show stay bit-identical, and its accumulator row is already
// zero.  Zeroing the live rows here means the next step needs no memset of
// the accumulator, which the engine reuses every step.  The squares are
// summed over l = 0 .. D-1 in that order, and products, sums, quotients and
// the square root use the _rn intrinsics, so the compiler fuses none of
// them into an FMA and each rounds as float32 does; the sum's order differs
// from the host's vectorised mean, by a rounding of g2sum at most.
//
// Bound on the H100: bytes.  A live row moves 4 * (2 D + 6) B (G and its
// count read and zeroed; g2sum and show read and written) and 2 D sw B of w
// read and written (sw: 4 float32, 2 bf16), a dead row its count.
// Design, as K8 (csrc/sparse_adam.cu):
//  - one launch for a group of up to kMaxStorages storages: their pointers,
//    rows and D travel by value in the kernel's parameter struct (read from
//    the constant bank through __grid_constant__), with a prefix table of
//    block starts by which a block finds its storage;
//  - a block takes a tile of kTileRows rows of one storage, a thread a row:
//    its count, one coalesced 4-byte read (the counts have a block of their
//    own, so a dead row's gradients are never read);
//  - the live rows are compacted (a ballot and a prefix sum); the thread of
//    a live row reads its G row as 16-byte vectors (D % 4 == 0 and aligned;
//    else one float at a time), sums the squares in lane order, updates
//    g2sum and show, clears the count and leaves the row's sqrt(g2sum) in
//    shared memory;
//  - then w and G of the live rows move 4 lanes a thread (16 bytes of G,
//    16 or 8 of w) in one trip: w steps, G is stored back as zeros.  The
//    storage's type of w rides in the parameter struct.  G's second
//    read finds the lines the first one brought into L1.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxStorages = 64;      // storages a launch takes
constexpr int kTileRows = kThreads;   // rows a block: one thread a row
// widest row: a tile's offsets, up to kTileRows * D, stay in 32 bits
constexpr int kMaxD = 0x7fffffff / kTileRows;

struct Storage {
  void* w;
  float* g2sum;
  float* show;
  float* acc;
  int rows;
  int d;
};

struct Group : Grouped<Storage, kMaxStorages> {
  float lr;
  unsigned char w_bf16[kMaxStorages];  // 1: the storage's w is bfloat16
};
// kept within the 4 KB of kernel parameters every CUDA 12 driver accepts
static_assert(sizeof(Group) <= 4096, "Group exceeds 4 KB of kernel parameters");

// the sum of the squares of one G row, lanes in order
template <int V>
__device__ __forceinline__ float sum_squares(const float* grow, int d) {
  using Vec = typename VecOf<V>::type;
  const Vec* g = reinterpret_cast<const Vec*>(grow);
  float s = 0.f;
  for (int u = 0; u < d / V; ++u) {
    Vec gv = g[u];
    const float* gf = reinterpret_cast<const float*>(&gv);
#pragma unroll
    for (int l = 0; l < V; ++l) s = __fadd_rn(s, __fmul_rn(gf[l], gf[l]));
  }
  return s;
}

// w and G of the tile's live rows (live_s, n_live of them, in row order),
// V lanes a thread at a time, w of type TW; G is stored back as zeros
template <int V, typename TW>
__device__ __forceinline__ void adagrad_rows(const Storage& st, float lr, long long r0,
                                             int n_live, const int* live_s,
                                             const float* root_s) {
  using W = Lanes<TW, V>;
  using G = Lanes<float, V>;
  const int per_row = st.d / V;
  const int units = n_live * per_row;
  auto* w = reinterpret_cast<typename W::Raw*>(static_cast<TW*>(st.w) + r0 * st.d);
  auto* gsum = reinterpret_cast<typename G::Raw*>(st.acc + r0 * st.d);
  for (int u = threadIdx.x; u < units; u += kThreads) {
    const int li = u / per_row;
    const int at = live_s[li] * per_row + (u - li * per_row);
    const typename W::Raw wv = w[at];
    const typename G::Raw gv = gsum[at];
    const float root = root_s[li];
    float wf[V], gf[V];
    W::widen(wv, wf);
    G::widen(gv, gf);
#pragma unroll
    for (int l = 0; l < V; ++l) {
      wf[l] = __fsub_rn(wf[l], __fdiv_rn(__fmul_rn(lr, gf[l]), root));
      gf[l] = 0.f;
    }
    w[at] = W::narrow(wf);
    gsum[at] = G::narrow(gf);
  }
}

// adagrad_rows 4 lanes a thread where vec (D % 4 == 0, G's tile rows
// 16-byte aligned) holds and w's are aligned to 4 lanes of its type, else
// one lane a thread
template <typename TW>
__device__ __forceinline__ void rows_of(const Storage& st, float lr, long long r0, int n_live,
                                        const int* live_s, const float* root_s, bool vec) {
  if (vec && aligned_to(static_cast<TW*>(st.w) + r0 * st.d, 4 * sizeof(TW))) {
    adagrad_rows<4, TW>(st, lr, r0, n_live, live_s, root_s);
  } else {
    adagrad_rows<1, TW>(st, lr, r0, n_live, live_s, root_s);
  }
}

__global__ void __launch_bounds__(kThreads)
sparse_adagrad_group_kernel(const __grid_constant__ Group g) {
  __shared__ float root_s[kTileRows];        // sqrt(g2sum) by live index
  __shared__ int live_s[kTileRows];          // the tile's live rows, in order
  __shared__ int warp_live[kThreads / 32];

  const int blk = blockIdx.x;
  const int member = g.member_of(blk);
  const Storage& st = g.s[member];
  const int d = st.d;
  const long long r0 = static_cast<long long>(blk - g.block_start[member]) * kTileRows;
  const int nr = static_cast<int>(min(static_cast<long long>(kTileRows), st.rows - r0));
  float* counts = st.acc + static_cast<long long>(st.rows) * d;
  const bool vec = (d & 3) == 0 && aligned16(st.acc + r0 * d);

  // 1. thread r looks at row r's count
  const int r = threadIdx.x;
  const float cnt = r < nr ? counts[r0 + r] : 0.f;
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

  // 3. each live row: the mean of its squared gradients into g2sum, show,
  // its count cleared, sqrt(g2sum) for the step
  if (is_live) {
    const int li = before + __popc(ballot & ((1u << lane) - 1u));
    live_s[li] = r;
    const long long row = r0 + r;
    const float* grow = st.acc + row * d;
    const float sq = vec ? sum_squares<4>(grow, d) : sum_squares<1>(grow, d);
    const float g2sum = __fadd_rn(st.g2sum[row], __fdiv_rn(sq, static_cast<float>(d)));
    st.g2sum[row] = g2sum;
    root_s[li] = __fsqrt_rn(g2sum);
    st.show[row] = __fadd_rn(st.show[row], cnt);
    counts[row] = 0.f;
  }
  __syncthreads();

  // 4. w and G of the live rows
  if (g.w_bf16[member]) {
    rows_of<bf16>(st, g.lr, r0, n_live, live_s, root_s, vec);
  } else {
    rows_of<float>(st, g.lr, r0, n_live, live_s, root_s, vec);
  }
}

}  // namespace

// Storages a launch takes, and the largest D: the wrapper chunks and checks.
RS_EXPORT int sparse_adagrad_max_storages() { return kMaxStorages; }
RS_EXPORT int sparse_adagrad_max_d() { return kMaxD; }

// n storages (1 <= n <= kMaxStorages): ptrs holds n x 4 device pointers
// (w, g2sum, show, acc), rows, d and kind one entry each (kind 1: w is
// bfloat16, 0: float32), all in host memory.
RS_EXPORT int sparse_adagrad_group(const unsigned long long* ptrs, const long long* rows,
                                   const int* d, const int* kind, int n, float lr,
                                   cudaStream_t stream) {
  if (n < 1 || n > kMaxStorages) return static_cast<int>(cudaErrorInvalidValue);
  Group g;
  long long blocks = 0;
  for (int s = 0; s < n; ++s) {
    if (d[s] < 1 || d[s] > kMaxD || rows[s] < 0 || rows[s] > 0x7fffffffLL || kind[s] < 0 ||
        kind[s] > 1) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const unsigned long long* p = ptrs + 4 * s;
    g.w_bf16[s] = static_cast<unsigned char>(kind[s]);
    const Storage st{reinterpret_cast<void*>(p[0]), reinterpret_cast<float*>(p[1]),
                     reinterpret_cast<float*>(p[2]), reinterpret_cast<float*>(p[3]),
                     static_cast<int>(rows[s]), d[s]};
    if (!g.add(s, st, (rows[s] + kTileRows - 1) / kTileRows, blocks)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  g.close(n, blocks);
  g.lr = lr;
  if (blocks == 0) return 0;
  sparse_adagrad_group_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

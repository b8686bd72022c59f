// K10 dcn_cross_bwd: the elementwise part of the backward of one low-rank
// cross layer (DCN-V2, Wang et al., arXiv:2008.13535), for Hopper (sm_90a).
//
// The layer (nn/dcn.py::LowRankCrossNet) computes, over rows of F floats,
//
//   u = W (V x_l) + b            (two GEMMs, cuBLAS)
//   x_{l+1} = x_0 * u + x_l      (elementwise)
//
// and its backward, given g = dL/dx_{l+1}, needs
//
//   du = g * x_0                 the cotangent of u, into the two GEMMs
//   dx_0 += g * u                the layer's share of x_0's gradient
//   db = sum over rows of du
//
// which eager ATen takes as three or four passes over B x F floats.  This
// kernel reads g, x_0 and u once, writes du, accumulates dx_0 in place and
// leaves each tile's partial sums of db (the caller sums the few tiles):
//
//   du[r, :]  = g * x0
//   dx0[r, :] = (accumulate ? dx0 : 0) + g * u (+ g where residual)
//   partial[tile, :] = sum over the tile's rows of du, in row order
//
// ``residual`` adds g itself: the first layer, whose x_l is x_0, passes the
// layer's residual gradient to x_0 there.  The products and sums use the
// _rn intrinsics, so that nothing fuses into an FMA and each rounds as
// float32 does: du and dx0 equal the plain version's bit for bit, and db
// differs by the order of its sum.
//
// Bound on the H100: bytes.  A layer moves 5 x B x F x 4 bytes that it must
// (g, x_0, u read; du, dx_0 written), plus dx_0's read where it accumulates
// and the partials (B / kTileRows x F floats, under 3 % of the rest).
// Design: a block is kThreads threads over one tile of kTileRows rows; a
// thread owns V neighbouring lanes of a row (V = 4: 16-byte loads and
// stores where F % 4 == 0 and every pointer is 16-byte aligned; else 1),
// walks the tile's rows and keeps its lanes' sums of du in registers.  The
// grid is (lane blocks, tiles).  Neighbouring threads move neighbouring
// 16-byte words of a row: each warp's loads are whole 128-byte lines.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 32;         // rows a block walks, one partial row of db (TILE_ROWS)
constexpr long long kMaxTiles = 65535;  // the grid's y extent

template <int V>
__global__ void __launch_bounds__(kThreads)
dcn_cross_bwd_kernel(const float* __restrict__ g, const float* __restrict__ x0,
                     const float* __restrict__ u, float* __restrict__ du,
                     float* __restrict__ dx0, float* __restrict__ partial, int rows, int f,
                     int accumulate, int residual) {
  using Vec = typename VecOf<V>::type;
  const int lanes = f / V;
  const int lane = blockIdx.x * kThreads + static_cast<int>(threadIdx.x);
  if (lane >= lanes) return;
  const int tile = blockIdx.y;
  const int r0 = tile * kTileRows;
  const int r1 = min(rows, r0 + kTileRows);
  const Vec* gv = reinterpret_cast<const Vec*>(g);
  const Vec* xv = reinterpret_cast<const Vec*>(x0);
  const Vec* uv = reinterpret_cast<const Vec*>(u);
  Vec* duv = reinterpret_cast<Vec*>(du);
  Vec* dxv = reinterpret_cast<Vec*>(dx0);
  float acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = 0.f;
#pragma unroll 4
  for (int r = r0; r < r1; ++r) {
    const size_t at = static_cast<size_t>(r) * lanes + lane;
    Vec a = gv[at], b = xv[at], c = uv[at];
    Vec d;
    if (accumulate) {
      d = dxv[at];
    }
    const float* gf = reinterpret_cast<const float*>(&a);
    const float* xf = reinterpret_cast<const float*>(&b);
    const float* uf = reinterpret_cast<const float*>(&c);
    float* df = reinterpret_cast<float*>(&d);
    Vec o;
    float* of = reinterpret_cast<float*>(&o);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      of[k] = __fmul_rn(gf[k], xf[k]);
      const float gu = __fmul_rn(gf[k], uf[k]);
      float dx = accumulate ? __fadd_rn(df[k], gu) : gu;
      if (residual) dx = __fadd_rn(dx, gf[k]);
      df[k] = dx;
      acc[k] = __fadd_rn(acc[k], of[k]);
    }
    duv[at] = o;
    dxv[at] = d;
  }
  float* p = partial + static_cast<size_t>(tile) * f + static_cast<size_t>(lane) * V;
#pragma unroll
  for (int k = 0; k < V; ++k) p[k] = acc[k];
}

}  // namespace

// g, x0, u, du, dx0: (rows, f) float32 device arrays, row-major; partial:
// (ceil(rows / tile rows), f).  accumulate 1 adds into dx0, 0 overwrites
// it; residual 1 adds g too.  Needs rows, f >= 1 and at most 65,535 tiles
// (refused with cudaErrorInvalidValue; the wrapper checks).
RS_EXPORT int dcn_cross_bwd(const float* g, const float* x0, const float* u, float* du,
                            float* dx0, float* partial, long long rows, long long f,
                            int accumulate, int residual, cudaStream_t stream) {
  const long long tiles = (rows + kTileRows - 1) / kTileRows;
  if (rows < 1 || f < 1 || f > 0x7fffffffLL || tiles > kMaxTiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = f % 4 == 0 && aligned16(g) && aligned16(x0) && aligned16(u) &&
                   aligned16(du) && aligned16(dx0) && aligned16(partial);
  const long long lanes = vec ? f / 4 : f;
  const dim3 grid(static_cast<unsigned int>((lanes + kThreads - 1) / kThreads),
                  static_cast<unsigned int>(tiles));
  if (vec) {
    dcn_cross_bwd_kernel<4><<<grid, kThreads, 0, stream>>>(
        g, x0, u, du, dx0, partial, static_cast<int>(rows), static_cast<int>(f), accumulate,
        residual);
  } else {
    dcn_cross_bwd_kernel<1><<<grid, kThreads, 0, stream>>>(
        g, x0, u, du, dx0, partial, static_cast<int>(rows), static_cast<int>(f), accumulate,
        residual);
  }
  return static_cast<int>(cudaGetLastError());
}

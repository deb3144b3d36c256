// Layer norm backward for Hopper (sm_90a): dx, dscale and dbias from dy and
// the forward's x, mean and rstd.  The layout, the bound and the dispatch
// are in layer_norm.cuh.
//
// xhat is recomputed from x, mean and rstd; g = dy * scale; dx = rstd *
// (g - mean(g) - xhat * mean(g * xhat)) in x's dtype.  Each lane sums dy *
// xhat and dy over the rows its warp walks for its own columns; at the end
// the block's warps add theirs in a fixed order through shared memory and
// the block writes one f32 partial row of each.  A second kernel sums the
// partial rows in a fixed order.  No float atomics: two runs on the same
// inputs give bit-identical gradients.  The grid is sized from the row
// count, so a decode step's few rows make a few partial rows.
//
// The RMS mode (RMS = true): xhat = x * rstd, dx = rstd * (g - xhat *
// mean(g * xhat)), dscale alone (one partial row a block).
//
// Measured on an H100 80GB HBM3 at 700 W (PERF.md): 80% of the byte bound
// at (131,072, 1,024) bf16.

#include "layer_norm.cuh"

namespace bjx_ln {
namespace {

constexpr int kSumGroups = 8;  // row groups of a partials block

template <typename T, int V, int CB, bool RMS>
__global__ void __launch_bounds__(kThreads)
layer_norm_bwd_kernel(const void* dyv, const void* xv, const float* __restrict__ mean,
                      const float* __restrict__ rstd, const float* __restrict__ scale,
                      void* dxv, float* __restrict__ partial, long long rows, int chunks) {
  __shared__ float red[kMaxD];
  const T* __restrict__ dy = static_cast<const T*>(dyv);
  const T* __restrict__ x = static_cast<const T*>(xv);
  T* __restrict__ dx = static_cast<T*>(dxv);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int d = chunks * V * 32;
  const long long first = static_cast<long long>(blockIdx.x) * kWarps + warp;
  const long long step = static_cast<long long>(gridDim.x) * kWarps;
  float g[CB][V], ds[CB][V], db[CB][V];
  load_f32<V, CB>(scale, lane, chunks, g);
#pragma unroll
  for (int c = 0; c < CB; ++c)
#pragma unroll
    for (int v = 0; v < V; ++v) ds[c][v] = db[c][v] = 0.f;
  for (long long row = first; row < rows; row += step) {
    Vec<T, V> xr[CB], dyr[CB];
    load_row<T, V, CB>(x + row * d, lane, chunks, xr);
    load_row<T, V, CB>(dy + row * d, lane, chunks, dyr);
    const float mu = RMS ? 0.f : mean[row], rs = rstd[row];
    float sg = 0.f, sgx = 0.f;
#pragma unroll
    for (int c = 0; c < CB; ++c) {
      if (c >= chunks) continue;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float xh = (to_f32(xr[c].v[v]) - mu) * rs;
        const float dyf = to_f32(dyr[c].v[v]);
        const float gv = dyf * g[c][v];
        if constexpr (!RMS) sg += gv;
        sgx += gv * xh;
        ds[c][v] += dyf * xh;
        if constexpr (!RMS) db[c][v] += dyf;
      }
    }
    const float mg = RMS ? 0.f : warp_sum(sg) / d, mgx = warp_sum(sgx) / d;
    T* out = dx + row * d;
#pragma unroll
    for (int c = 0; c < CB; ++c) {
      if (c >= chunks) continue;
      Vec<T, V> o;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float xh = (to_f32(xr[c].v[v]) - mu) * rs;
        const float gv = to_f32(dyr[c].v[v]) * g[c][v];
        o.v[v] = from_f32<T>(rs * (gv - mg - xh * mgx));
      }
      *reinterpret_cast<Vec<T, V>*>(out + (c * 32 + lane) * V) = o;
    }
  }
  // the block's column sums, warp 0's plus warp 1's plus ... in that order;
  // the last warp writes the block's partial rows (dscale, then dbias)
  constexpr int kParts = RMS ? 1 : 2;
  float* part = partial + static_cast<long long>(blockIdx.x) * kParts * d;
#pragma unroll
  for (int which = 0; which < kParts; ++which) {
    for (int w = 0; w < kWarps; ++w) {
      if (warp == w) {
#pragma unroll
        for (int c = 0; c < CB; ++c) {
          if (c >= chunks) continue;
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const int col = (c * 32 + lane) * V + v;
            const float mine = which == 0 ? ds[c][v] : db[c][v];
            const float sum = w == 0 ? mine : red[col] + mine;
            if (w == kWarps - 1) part[which * d + col] = sum;
            else red[col] = sum;
          }
        }
      }
      __syncthreads();
    }
  }
}

// dscale[j] and dbias[j]: the blocks' partial rows summed in a fixed order.
// A block owns 32 of the P * d columns of the (blocks, P, d) partials (P 2,
// or 1 in the RMS mode, which has no dbias); row group r of it sums the
// partial rows r, r + kSumGroups, ... and group 0 then adds the groups in
// order.
template <int P>
__global__ void __launch_bounds__(32 * kSumGroups)
layer_norm_partials_kernel(const float* __restrict__ partial, float* __restrict__ dscale,
                           float* __restrict__ dbias, int blocks, int d) {
  __shared__ float acc[kSumGroups][32];
  const int lane = threadIdx.x & 31;
  const int grp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  float s = 0.f;
#pragma unroll 4
  for (int p = grp; p < blocks; p += kSumGroups)
    s += partial[static_cast<long long>(p) * P * d + col];
  acc[grp][lane] = s;
  __syncthreads();
  if (grp != 0) return;
  float t = acc[0][lane];
#pragma unroll
  for (int r = 1; r < kSumGroups; ++r) t += acc[r][lane];
  if (col < d) dscale[col] = t;
  else dbias[col - d] = t;
}

template <typename T, int V, int CB>
struct Bwd {
  using Fn = void (*)(const void*, const void*, const float*, const float*, const float*,
                      void*, float*, long long, int);
  static Fn kernel() { return &layer_norm_bwd_kernel<T, V, CB, false>; }
};

template <typename T, int V, int CB>
struct RmsBwd {
  using Fn = typename Bwd<T, V, CB>::Fn;
  static Fn kernel() { return &layer_norm_bwd_kernel<T, V, CB, true>; }
};

template <template <typename, int, int> class K, int P>
int launch_bwd(const void* dy, const void* x, const void* mean, const void* rstd,
               const void* scale, void* dx, void* partial, void* dscale, void* dbias,
               long long rows, int d, int kind, int blocks, void* stream) {
  int chunks = 0;
  const auto fn = pick<K>(kind, d, &chunks);
  if (fn == nullptr || blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto* part = static_cast<float*>(partial);
  fn<<<blocks, kThreads, 0, s>>>(dy, x, static_cast<const float*>(mean),
                                 static_cast<const float*>(rstd),
                                 static_cast<const float*>(scale), dx, part, rows, chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  layer_norm_partials_kernel<P><<<P * d / 32, 32 * kSumGroups, 0, s>>>(
      part, static_cast<float*>(dscale), static_cast<float*>(dbias), blocks, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace bjx_ln

// The backward's blocks for `rows` rows of width d and dtype kind (0 f32,
// 1 bf16), into *blocks: the partial rows bjx_layer_norm_bwd writes.
// Returns a cudaError_t.
extern "C" int bjx_layer_norm_bwd_blocks(int kind, int d, long long rows, int* blocks) {
  using namespace bjx_ln;
  int chunks = 0;
  const auto fn = pick<Bwd>(kind, d, &chunks);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(grid_for(reinterpret_cast<const void*>(fn), rows, blocks));
}

// The same for the RMS mode's backward.
extern "C" int bjx_rms_norm_bwd_blocks(int kind, int d, long long rows, int* blocks) {
  using namespace bjx_ln;
  int chunks = 0;
  const auto fn = pick<RmsBwd>(kind, d, &chunks);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(grid_for(reinterpret_cast<const void*>(fn), rows, blocks));
}

// dx from dy and the forward's x, mean and rstd, on `blocks` blocks (from
// bjx_layer_norm_bwd_blocks), then dscale and dbias from the blocks'
// partial rows (`partial`: blocks x 2 x d f32 scratch).
extern "C" int bjx_layer_norm_bwd(const void* dy, const void* x, const void* mean,
                                  const void* rstd, const void* scale, void* dx, void* partial,
                                  void* dscale, void* dbias, long long rows, int d, int kind,
                                  int blocks, void* stream) {
  return bjx_ln::launch_bwd<bjx_ln::Bwd, 2>(dy, x, mean, rstd, scale, dx, partial, dscale,
                                            dbias, rows, d, kind, blocks, stream);
}

// The RMS mode: dx from dy and the forward's x and rstd, on `blocks` blocks
// (from bjx_rms_norm_bwd_blocks), then dscale from the blocks' partial rows
// (`partial`: blocks x d f32 scratch).
extern "C" int bjx_rms_norm_bwd(const void* dy, const void* x, const void* rstd,
                                const void* scale, void* dx, void* partial, void* dscale,
                                long long rows, int d, int kind, int blocks, void* stream) {
  return bjx_ln::launch_bwd<bjx_ln::RmsBwd, 1>(dy, x, nullptr, rstd, scale, dx, partial, dscale,
                                               nullptr, rows, d, kind, blocks, stream);
}

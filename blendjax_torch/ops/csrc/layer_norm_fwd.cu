// Layer norm forward for Hopper (sm_90a): y, and the per-row f32 mean and
// rstd the backward reuses.  The layout, the bound and the dispatch are in
// layer_norm.cuh.
//
// The row's sum and then the sum of squared deviations from its mean, each
// by warp shuffles (two passes over the registers, not E[x^2] - mean^2);
// rstd = rsqrt(var + eps); the affine step multiplies and adds without
// contraction into an FMA, as the separate tensor ops round.  The next
// row's loads are issued before the current row's reductions.
//
// The RMS mode (RMS = true; RMSNorm, Zhang and Sennrich 2019, as
// DeepSeek-V2/V3 and Moonlight use it): no mean and no bias, rstd =
// rsqrt(mean(x^2) + eps), y = x * rstd * scale; the mean is not written.
//
// Measured on an H100 80GB HBM3 at 700 W (PERF.md): 82% of the byte bound
// at (131,072, 1,024) bf16, 168 registers a thread, 3 blocks an SM.

#include "layer_norm.cuh"

namespace bjx_ln {
namespace {

template <typename T, int V, int CB, bool RMS>
__global__ void __launch_bounds__(kThreads)
layer_norm_fwd_kernel(const void* xv, const float* __restrict__ scale,
                      const float* __restrict__ bias, void* yv, float* __restrict__ mean,
                      float* __restrict__ rstd, long long rows, int chunks, float eps) {
  const T* __restrict__ x = static_cast<const T*>(xv);
  T* __restrict__ y = static_cast<T*>(yv);
  const int lane = threadIdx.x & 31;
  const int d = chunks * V * 32;
  const long long first = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const long long step = static_cast<long long>(gridDim.x) * kWarps;
  if (first >= rows) return;
  float g[CB][V], b[CB][V];
  load_f32<V, CB>(scale, lane, chunks, g);
  if constexpr (!RMS) load_f32<V, CB>(bias, lane, chunks, b);
  Vec<T, V> cur[CB];
  load_row<T, V, CB>(x + first * d, lane, chunks, cur);
  for (long long row = first; row < rows; row += step) {
    Vec<T, V> nxt[CB];
    if (row + step < rows) load_row<T, V, CB>(x + (row + step) * d, lane, chunks, nxt);
    float f[CB][V];
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < CB; ++c)
#pragma unroll
      for (int v = 0; v < V; ++v) {
        f[c][v] = c < chunks ? to_f32(cur[c].v[v]) : 0.f;
        s += f[c][v];
      }
    const float mu = RMS ? 0.f : warp_sum(s) / d;
    float q = 0.f;
#pragma unroll
    for (int c = 0; c < CB; ++c)
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float t = c < chunks ? f[c][v] - mu : 0.f;
        q += t * t;
      }
    const float rs = rsqrtf(warp_sum(q) / d + eps);
    T* out = y + row * d;
#pragma unroll
    for (int c = 0; c < CB; ++c) {
      if (c >= chunks) continue;
      Vec<T, V> o;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if constexpr (RMS) {
          o.v[v] = from_f32<T>(__fmul_rn(__fmul_rn(f[c][v], rs), g[c][v]));
        } else {
          const float t = __fmul_rn(__fsub_rn(f[c][v], mu), rs);
          o.v[v] = from_f32<T>(__fadd_rn(__fmul_rn(t, g[c][v]), b[c][v]));
        }
      }
      *reinterpret_cast<Vec<T, V>*>(out + (c * 32 + lane) * V) = o;
    }
    if (lane == 0) {
      if constexpr (!RMS) mean[row] = mu;
      rstd[row] = rs;
    }
#pragma unroll
    for (int c = 0; c < CB; ++c) cur[c] = nxt[c];
  }
}

template <typename T, int V, int CB>
struct Fwd {
  using Fn = void (*)(const void*, const float*, const float*, void*, float*, float*,
                      long long, int, float);
  static Fn kernel() { return &layer_norm_fwd_kernel<T, V, CB, false>; }
};

template <typename T, int V, int CB>
struct RmsFwd {
  using Fn = typename Fwd<T, V, CB>::Fn;
  static Fn kernel() { return &layer_norm_fwd_kernel<T, V, CB, true>; }
};

template <template <typename, int, int> class K>
int launch_fwd(const void* x, const void* scale, const void* bias, void* y, void* mean,
               void* rstd, long long rows, int d, float eps, int kind, void* stream) {
  int chunks = 0, blocks = 0;
  const auto fn = pick<K>(kind, d, &chunks);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 0) return 0;
  const cudaError_t err = grid_for(reinterpret_cast<const void*>(fn), rows, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  fn<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<const float*>(scale), static_cast<const float*>(bias), y,
      static_cast<float*>(mean), static_cast<float*>(rstd), rows, chunks, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace bjx_ln

// y, mean, rstd from x (rows, d) of dtype kind (0 f32, 1 bf16).  Returns a
// cudaError_t.
extern "C" int bjx_layer_norm_fwd(const void* x, const void* scale, const void* bias, void* y,
                                  void* mean, void* rstd, long long rows, int d, float eps,
                                  int kind, void* stream) {
  return bjx_ln::launch_fwd<bjx_ln::Fwd>(x, scale, bias, y, mean, rstd, rows, d, eps, kind,
                                         stream);
}

// The RMS mode: y and rstd from x (rows, d) and scale; no bias, no mean.
extern "C" int bjx_rms_norm_fwd(const void* x, const void* scale, void* y, void* rstd,
                                long long rows, int d, float eps, int kind, void* stream) {
  return bjx_ln::launch_fwd<bjx_ln::RmsFwd>(x, scale, nullptr, y, nullptr, rstd, rows, d, eps,
                                            kind, stream);
}

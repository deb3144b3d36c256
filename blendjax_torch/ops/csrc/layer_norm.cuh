// Layer norm for Hopper (sm_90a), forward (layer_norm_fwd.cu) and backward
// (layer_norm_bwd.cu): the SeqFormer's y = (x - mean) * rsqrt(var + eps) *
// scale + bias over the last axis, in f32, with the population variance,
// rounded once to x's dtype.
//
// Replaces no Pallas kernel: the JAX package leaves its layer norm
// (blendjax/models/seqformer.py::_ln_apply) to XLA, which fuses it.  The
// port composed it from separate float32 tensor ops, each a full pass over
// device memory forward and backward (about 34 kernels a norm); these
// kernels take their place (blendjax_torch/ops/layer_norm.py).
//
// Bound: bytes.  A norm does a few flops per element; at the main path's
// (131,072 rows, 1,024) bf16 the forward moves 538 MB (read x, write y,
// write the per-row mean and rstd: 0.16 ms at 3.35 TB/s) and the backward
// about 806 MB (read x and dy, write dx, read the statistics: 0.24 ms).
// The design moves each of those bytes once per pass.
//
// Layout: x, y, dy and dx are contiguous (rows, d) in f32 or bf16; scale,
// bias, mean, rstd and the gradients of scale and bias are f32.  One warp
// owns one row at a time and holds it in registers: lane l keeps the
// `chunks` vectors of V consecutive elements that start at columns
// (c * 32 + l) * V, c < chunks, so each load and store of the warp covers
// 32 neighbouring vectors.  V is 16 bytes where d allows it (d a multiple
// of 256 in bf16, of 128 in f32) and one element otherwise.  The kernels
// are instantiated for powers of two of chunks (CB) and mask the chunks
// beyond the row's, so one kernel serves every d that is a multiple of 32
// up to 4,096 (kMaxPerLane elements a lane; past 1,024 they spill).  Each
// warp walks rows first, first + step, ... of a grid sized from the row
// count and the occupancy (grid_for), so scale and bias are read from
// device memory once per warp.  Nothing is allocated
// here; every launch goes on the caller's stream.

#pragma once

#include <algorithm>
#include <cstdint>
#include <mutex>
#include <type_traits>
#include <vector>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace bjx_ln {

constexpr int kWarps = 4;  // warps a block, forward and backward
constexpr int kThreads = kWarps * 32;
constexpr int kMaxPerLane = 128;  // elements a lane: d up to 4,096
constexpr int kMaxD = kMaxPerLane * 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// V consecutive elements, aligned to their size, so that one access moves them
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// the row's chunks this lane holds (chunks beyond the row's are left alone)
template <typename T, int V, int CB>
__device__ __forceinline__ void load_row(const T* row, int lane, int chunks, Vec<T, V> (&r)[CB]) {
#pragma unroll
  for (int c = 0; c < CB; ++c)
    if (c < chunks) r[c] = *reinterpret_cast<const Vec<T, V>*>(row + (c * 32 + lane) * V);
}

template <int V, int CB>
__device__ __forceinline__ void load_f32(const float* p, int lane, int chunks, float (&r)[CB][V]) {
#pragma unroll
  for (int c = 0; c < CB; ++c)
#pragma unroll
    for (int v = 0; v < V; ++v) r[c][v] = c < chunks ? p[(c * 32 + lane) * V + v] : 0.f;
}

template <typename T>
struct Tag {
  using type = T;
};

// Calls f(Tag<T>) for kind 0 = float32, 1 = bfloat16; nullptr for another.
template <typename F>
auto with_type(int kind, F&& f) -> decltype(f(Tag<float>{})) {
  if (kind == 0) return f(Tag<float>{});
  if (kind == 1) return f(Tag<__nv_bfloat16>{});
  return nullptr;
}

inline bool width_ok(int d) { return d >= 32 && d <= kMaxD && d % 32 == 0; }

// V: 16 bytes where every lane's share of the row splits into them, else 1
template <typename T>
constexpr int vec16() { return 16 / static_cast<int>(sizeof(T)); }

template <typename T>
int vec_for(int d) { return (d / 32) % vec16<T>() == 0 ? vec16<T>() : 1; }

// The blocks of `kernel` the current device holds at once, from its SM
// count and the kernel's occupancy, asked once per (kernel, device): a
// decode step launches a few rows at a time, and the queries would cost
// more host time than the launch.
inline cudaError_t resident_blocks(const void* kernel, long long* cap) {
  struct Seen {
    const void* kernel;
    int dev;
    long long cap;
  };
  static std::mutex mu;
  static std::vector<Seen> seen;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  {
    std::lock_guard<std::mutex> lock(mu);
    for (const Seen& s : seen)
      if (s.kernel == kernel && s.dev == dev) {
        *cap = s.cap;
        return cudaSuccess;
      }
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  *cap = static_cast<long long>(std::max(per_sm, 1)) * sms;
  std::lock_guard<std::mutex> lock(mu);
  seen.push_back({kernel, dev, *cap});
  return cudaSuccess;
}

// Blocks of `kernel` for `rows` rows, one warp a row: one per kWarps rows,
// and no more than the current device holds at once.
inline cudaError_t grid_for(const void* kernel, long long rows, int* blocks) {
  long long cap = 0;
  const cudaError_t err = resident_blocks(kernel, &cap);
  if (err != cudaSuccess) return err;
  *blocks = static_cast<int>(std::max(1LL, std::min((rows + kWarps - 1) / kWarps, cap)));
  return cudaSuccess;
}

// The instance with the fewest chunk slots CB >= chunks, by
// Pick<K, T, V, 1>::get(chunks): K<T, V, CB>::kernel() gives the kernel of
// that instance, as a K<...>::Fn (a __global__ function cannot be a
// member).
template <template <typename, int, int> class K, typename T, int V, int CB>
struct Pick {
  static typename K<float, 1, 1>::Fn get(int chunks) {
    if constexpr (CB * V > kMaxPerLane) {
      return nullptr;
    } else {
      if (chunks <= CB) return K<T, V, CB>::kernel();
      return Pick<K, T, V, CB * 2>::get(chunks);
    }
  }
};

// K's kernel for rows of dtype `kind` and width d, its chunk count in
// *chunks; nullptr where no instance takes them.
template <template <typename, int, int> class K>
typename K<float, 1, 1>::Fn pick(int kind, int d, int* chunks) {
  using Fn = typename K<float, 1, 1>::Fn;
  if (!width_ok(d)) return nullptr;
  return with_type(kind, [&](auto tag) -> Fn {
    using T = typename decltype(tag)::type;
    const int v = vec_for<T>(d);
    *chunks = d / 32 / v;
    return v == 1 ? Pick<K, T, 1, 1>::get(*chunks) : Pick<K, T, vec16<T>(), 1>::get(*chunks);
  });
}

}  // namespace bjx_ln

// Shared pieces of the flash-attention kernels for Hopper (sm_90a):
// flash_fwd.cu (forward) and flash_bwd.cu (dQ and dK/dV) on the CUDA
// cores, flash_fwd_tc.cu and flash_bwd_tc.cu on the tensor cores (bf16
// inputs).
//
// Layout: every tensor is flat (batch*heads, T, D), row-major, D
// contiguous, as blendjax/ops/flash_attention.py's _flat gives it; lse
// and delta are (batch*heads, T) f32.  Grouped-query attention goes
// through kv_head(), the flat map of _kv_head_map.
//
// The CUDA-core kernels work on 64 x 64 tiles with 256 threads laid out as a
// 16 x 16 grid (ty = tid / 16, tx = tid % 16).  A thread owns the 4 x 4
// entries (ty*4 + i, tx + 16*j) of a tile's score matrix and the D/16
// output columns tx + 16*jj of its 4 rows.  The 16 threads of one row
// group sit in one half-warp, so row maxima and sums are 16-lane
// shuffles.  Tiles are staged in shared memory as f32; rows whose
// leading dimension is D + 1 are read down a column by 16 threads at
// once and the pad keeps those reads on 16 different banks.
//
// Their arithmetic is f32 FMAs on the CUDA cores: f32 inputs must not go
// through TF32, and bf16 inputs are widened on load, so P and dS stay
// f32 as in the reference.  The tensor-core kernels keep their own layout
// (one warpgroup of 128 threads per block, flash_tc_common.cuh) and share
// the problem, the masks and the dispatch below.

#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace bjx_flash {

constexpr int kThreads = 256;
constexpr int kBQ = 64;  // q rows per tile
constexpr int kBK = 64;  // kv rows (score columns) per tile
constexpr float kNeg = -1e30f;  // the reference's mask value, applied after the scale

struct Problem {
  int h_q, h_kv;  // heads of q and of k/v (h_q % h_kv == 0)
  int tq, tk;     // sequence lengths of q and of k/v
  float scale;
  int causal;
  int window;     // 0: no sliding window
  int q_offset;   // global position of q row 0 minus that of kv row 0
};

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

// Flat kv head serving flat q head bh: (bh // h_q) * h_kv + (bh % h_q) // g.
__device__ __forceinline__ int kv_head(int bh, const Problem& p) {
  return (bh / p.h_q) * p.h_kv + (bh % p.h_q) / (p.h_q / p.h_kv);
}

// Whether q row r (local) sees kv row c (local): bounds, then the causal
// bound and the window on global positions, as _mask does.
__device__ __forceinline__ bool visible(const Problem& p, int r, int c) {
  if (r >= p.tq || c >= p.tk) return false;
  if (!p.causal) return true;
  const int row = r + p.q_offset;
  return c <= row && (p.window == 0 || c > row - p.window);
}

// kv rows [lo, hi] that q rows [r0, r1] can see (empty when lo > hi): the
// causal bound and, under a window, the shrunk start of _kv_base.
__device__ __forceinline__ void kv_span(const Problem& p, int r0, int r1, int& lo, int& hi) {
  lo = 0;
  hi = p.tk - 1;
  if (p.causal) {
    hi = min(hi, r1 + p.q_offset);
    if (p.window) lo = max(0, r0 + p.q_offset - p.window + 1);
  }
}

// q rows [lo, hi] that can see kv rows [c0, c1]: _q_base and the window's
// end, with the q-length guard.
__device__ __forceinline__ void q_span(const Problem& p, int c0, int c1, int& lo, int& hi) {
  lo = 0;
  hi = p.tq - 1;
  if (p.causal) {
    lo = max(0, c0 - p.q_offset);
    if (p.window) hi = min(hi, c1 + p.window - 1 - p.q_offset);
  }
}

// rows x D tile of src (rows r0.. of an n-row matrix) -> f32 smem with
// leading dimension ld; rows past n are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* __restrict__ src,
                                          int r0, int n, int rows) {
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx % D;
    dst[r * ld + d] = (r0 + r < n) ? to_f32(src[static_cast<int64_t>(r0 + r) * D + d]) : 0.f;
  }
}

__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Raises a kernel's dynamic shared memory limit, then launches it with
// Threads threads per block.
template <int Threads = kThreads, typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, Threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <typename T>
struct Tag {
  using type = T;
};

template <int D, typename F>
cudaError_t with_io(int in_kind, int out_kind, F&& f) {
  using D_ = std::integral_constant<int, D>;
  if (in_kind == 0 && out_kind == 0) return f(Tag<float>{}, Tag<float>{}, D_{});
  if (in_kind == 0 && out_kind == 1) return f(Tag<float>{}, Tag<__nv_bfloat16>{}, D_{});
  if (in_kind == 1 && out_kind == 0) return f(Tag<__nv_bfloat16>{}, Tag<float>{}, D_{});
  if (in_kind == 1 && out_kind == 1) return f(Tag<__nv_bfloat16>{}, Tag<__nv_bfloat16>{}, D_{});
  return cudaErrorInvalidValue;
}

// Calls f(Tag<TIn>, Tag<TOut>, integral_constant<D>) for the instance that
// matches; kinds: 0 = float32, 1 = bfloat16.  Head dims 16, 32, 64, 128.
template <typename F>
cudaError_t dispatch(int d, int in_kind, int out_kind, F&& f) {
  switch (d) {
    case 16: return with_io<16>(in_kind, out_kind, f);
    case 32: return with_io<32>(in_kind, out_kind, f);
    case 64: return with_io<64>(in_kind, out_kind, f);
    case 128: return with_io<128>(in_kind, out_kind, f);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace bjx_flash

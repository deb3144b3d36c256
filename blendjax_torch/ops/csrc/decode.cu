// uint8 frame decode for Hopper (sm_90a): out = x * (1/255) in f32,
// optionally sRGB -> linear, stored as f32 or bf16.
//
// Replaces the Pallas TPU kernel blendjax/ops/image.py::_decode_kernel
// (reached through decode_frames_pallas).  The TPU kernel views the frames
// as a zero-padded (rows, 128) grid and widens uint8 through int32; both
// are Mosaic workarounds, so this kernel works on the flat contiguous
// buffer instead.
//
// Bound: bytes.  Each element is read once (1 byte) and written once (2 or
// 4 bytes) with a few flops between, far below the card's
// flops-per-byte balance.  Design for that: every thread moves 16 input
// bytes with one 16-byte load and writes its 16 outputs with 16-byte
// stores (four float4 for f32, two uint4 for bf16); a grid-stride loop
// covers any size; a scalar loop takes the tail, and the whole buffer when
// either base pointer is not 16-byte aligned.
//
// Arithmetic matches the reference bit for bit where IEEE allows: the
// multiply, add and divide use the _rn intrinsics so nvcc cannot contract
// them into an FMA, and bf16 rounding is round-to-nearest-even
// (__float2bfloat16_rn), as XLA converts.  powf is CUDA's (within 2 ulp,
// not correctly rounded), which the linearize tolerance covers.  Build
// without --use_fast_math: it would replace powf and the division.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 16;  // input bytes per vector step
constexpr int kMaxBlocks = 65535;

template <bool kLinearize>
__device__ __forceinline__ float decode_one(uint32_t v) {
  float x = __fmul_rn(static_cast<float>(v), 1.0f / 255.0f);
  if (kLinearize) {
    x = x <= 0.04045f ? __fdiv_rn(x, 12.92f)
                      : powf(__fdiv_rn(__fadd_rn(x, 0.055f), 1.055f), 2.4f);
  }
  return x;
}

__device__ __forceinline__ void store16(float* out, const float (&v)[kVec]) {
  float4* o = reinterpret_cast<float4*>(out);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    o[j] = make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
  }
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

__device__ __forceinline__ void store16(__nv_bfloat16* out, const float (&v)[kVec]) {
  uint4* o = reinterpret_cast<uint4*>(out);
  o[0] = make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                    pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
  o[1] = make_uint4(pack_bf16x2(v[8], v[9]), pack_bf16x2(v[10], v[11]),
                    pack_bf16x2(v[12], v[13]), pack_bf16x2(v[14], v[15]));
}

__device__ __forceinline__ void store1(float* out, float v) { *out = v; }

__device__ __forceinline__ void store1(__nv_bfloat16* out, float v) {
  *out = __float2bfloat16_rn(v);
}

// n_vec: number of 16-byte input chunks taken by the vector loop (0 when a
// base pointer is misaligned); elements [n_vec * 16, n) go scalar.
template <typename OutT, bool kLinearize>
__global__ void __launch_bounds__(kThreads)
decode_u8_kernel(const uint8_t* __restrict__ in, OutT* __restrict__ out,
                 int64_t n, int64_t n_vec) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const uint4* in16 = reinterpret_cast<const uint4*>(in);
  for (int64_t c = tid; c < n_vec; c += stride) {
    const uint4 raw = __ldg(in16 + c);
    const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
    float v[kVec];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        v[4 * w + b] = decode_one<kLinearize>((words[w] >> (8 * b)) & 0xffu);
      }
    }
    store16(out + c * kVec, v);
  }
  for (int64_t i = n_vec * kVec + tid; i < n; i += stride) {
    store1(out + i, decode_one<kLinearize>(in[i]));
  }
}

template <typename OutT, bool kLinearize>
cudaError_t launch(const uint8_t* in, OutT* out, int64_t n, cudaStream_t stream) {
  const bool aligned = (reinterpret_cast<uintptr_t>(in) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const int64_t n_vec = aligned ? n / kVec : 0;
  const int64_t work = n_vec > 0 ? n_vec : n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  decode_u8_kernel<OutT, kLinearize>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(in, out, n, n_vec);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes.  out_kind: 0 = float32,
// 1 = bfloat16.  Launches on `stream` without synchronising and returns the
// launch's cudaError_t (0 on success).
extern "C" int bjx_decode_u8(const void* in, void* out, long long n, int out_kind,
                             int linearize, void* stream) {
  if (n <= 0) return 0;
  const auto* src = static_cast<const uint8_t*>(in);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (out_kind == 0) {
    auto* dst = static_cast<float*>(out);
    err = linearize ? launch<float, true>(src, dst, n, s)
                    : launch<float, false>(src, dst, n, s);
  } else if (out_kind == 1) {
    auto* dst = static_cast<__nv_bfloat16*>(out);
    err = linearize ? launch<__nv_bfloat16, true>(src, dst, n, s)
                    : launch<__nv_bfloat16, false>(src, dst, n, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// A register-only form of the uint8 decode kernel, kept to be compared with
// blendjax_torch/ops/csrc/decode.cu by flash_bwd_probe.py decode_ab=.  The
// same persistent grid and launch plan (ops/image.py::decode_plan: each
// block one contiguous run of chunks, the unaligned head and tail scalar)
// and the same lane mapping (lane i reads the input bytes of one 16-byte
// output unit and writes that unit), but through registers: each of 1,024
// threads issues kU = 8 independent loads before its first store.  An
// input base that leaves the units unaligned takes byte loads.
// Arithmetic as in decode.cu, bit for bit.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kU = 8;  // units in flight per thread

struct Plan {
  long long lo, hi, chunk, chunks, grid, stages, shift, smem;
};

template <bool kLinearize>
__device__ __forceinline__ float scale(float b) {
  float x = __fmul_rn(b, 1.0f / 255.0f);
  if (kLinearize) {
    x = x <= 0.04045f ? __fdiv_rn(x, 12.92f)
                      : powf(__fdiv_rn(__fadd_rn(x, 0.055f), 1.055f), 2.4f);
  }
  return x;
}

template <int K>
__device__ __forceinline__ float byte_as_float(uint32_t w) {
  return __fsub_rn(__uint_as_float(__byte_perm(w, 0x4Bu, 0x4550u | K)), 8388608.0f);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return static_cast<uint32_t>(__bfloat16_as_ushort(v.x)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(v.y)) << 16);
}

template <bool kLinearize>
__device__ __forceinline__ uint4 encode(const uint32_t (&w)[2], __nv_bfloat16*) {
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    o[2 * i] = pack_bf16x2(scale<kLinearize>(byte_as_float<0>(w[i])),
                           scale<kLinearize>(byte_as_float<1>(w[i])));
    o[2 * i + 1] = pack_bf16x2(scale<kLinearize>(byte_as_float<2>(w[i])),
                               scale<kLinearize>(byte_as_float<3>(w[i])));
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

template <bool kLinearize>
__device__ __forceinline__ uint4 encode(const uint32_t (&w)[1], float*) {
  return make_uint4(__float_as_uint(scale<kLinearize>(byte_as_float<0>(w[0]))),
                    __float_as_uint(scale<kLinearize>(byte_as_float<1>(w[0]))),
                    __float_as_uint(scale<kLinearize>(byte_as_float<2>(w[0]))),
                    __float_as_uint(scale<kLinearize>(byte_as_float<3>(w[0]))));
}

__device__ __forceinline__ void store1(float* out, float v) { *out = v; }

__device__ __forceinline__ void store1(__nv_bfloat16* out, float v) {
  *out = __float2bfloat16_rn(v);
}

template <typename OutT, bool kLinearize>
__device__ __forceinline__ void decode_scalar(const uint8_t* in, OutT* out, long long a,
                                              long long b) {
  for (long long i = a + threadIdx.x; i < b; i += kThreads) {
    store1(out + i, scale<kLinearize>(static_cast<float>(in[i])));
  }
}

template <int NW, bool kAligned>
__device__ __forceinline__ void load_unit(const uint8_t* src, uint32_t (&w)[NW]) {
  if constexpr (kAligned && NW == 2) {
    const uint2 v = __ldcs(reinterpret_cast<const uint2*>(src));
    w[0] = v.x;
    w[NW - 1] = v.y;
  } else if constexpr (kAligned) {
    w[0] = __ldcs(reinterpret_cast<const unsigned int*>(src));
  } else {
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      w[i] = static_cast<uint32_t>(__ldg(src + 4 * i)) |
             (static_cast<uint32_t>(__ldg(src + 4 * i + 1)) << 8) |
             (static_cast<uint32_t>(__ldg(src + 4 * i + 2)) << 16) |
             (static_cast<uint32_t>(__ldg(src + 4 * i + 3)) << 24);
    }
  }
}

template <typename OutT, bool kLinearize, bool kAligned>
__global__ void __launch_bounds__(kThreads, 1)
decode_regs_kernel(const uint8_t* __restrict__ in, OutT* __restrict__ out, long long n,
                   Plan p) {
  constexpr int kUnit = 16 / sizeof(OutT);
  constexpr int NW = kUnit / 4;
  const long long b = blockIdx.x;
  if (b == 0) decode_scalar<OutT, kLinearize>(in, out, 0, p.lo);
  if (b == gridDim.x - 1) decode_scalar<OutT, kLinearize>(in, out, p.hi, n);
  const long long q = p.chunks / gridDim.x, r = p.chunks % gridDim.x;
  const long long first = b * q + (b < r ? b : r);
  const long long count = q + (b < r);
  const long long s0 = p.lo + first * p.chunk;
  const long long s1 = min(p.lo + (first + count) * p.chunk, p.hi);
  const long long units = (s1 - s0) / kUnit;
  const uint8_t* src = in + s0;
  uint4* dst = reinterpret_cast<uint4*>(out + s0);
  for (long long base = threadIdx.x; base < units; base += static_cast<long long>(kU) * kThreads) {
    uint32_t w[kU][NW];
#pragma unroll
    for (int k = 0; k < kU; ++k) {
      const long long u = base + static_cast<long long>(k) * kThreads;
      if (u < units) load_unit<NW, kAligned>(src + u * kUnit, w[k]);
    }
#pragma unroll
    for (int k = 0; k < kU; ++k) {
      const long long u = base + static_cast<long long>(k) * kThreads;
      if (u < units) __stcs(dst + u, encode<kLinearize>(w[k], static_cast<OutT*>(nullptr)));
    }
  }
}

template <typename OutT, bool kLinearize>
cudaError_t launch(const uint8_t* in, OutT* out, long long n, const Plan& p,
                   cudaStream_t stream) {
  const bool aligned = p.shift % (16 / sizeof(OutT)) == 0;
  if (aligned) {
    decode_regs_kernel<OutT, kLinearize, true>
        <<<static_cast<unsigned>(p.grid), kThreads, 0, stream>>>(in, out, n, p);
  } else {
    decode_regs_kernel<OutT, kLinearize, false>
        <<<static_cast<unsigned>(p.grid), kThreads, 0, stream>>>(in, out, n, p);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int bjx_decode_u8(const void* in, void* out, long long n, int out_kind,
                             int linearize, const void* plan, void* stream) {
  if (n <= 0) return 0;
  const Plan& p = *static_cast<const Plan*>(plan);
  if (p.grid < 1 || p.lo < 0 || p.hi > n || p.lo > p.hi) return cudaErrorInvalidValue;
  const auto* src = static_cast<const uint8_t*>(in);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (out_kind == 0) {
    auto* dst = static_cast<float*>(out);
    err = linearize ? launch<float, true>(src, dst, n, p, s)
                    : launch<float, false>(src, dst, n, p, s);
  } else if (out_kind == 1) {
    auto* dst = static_cast<__nv_bfloat16*>(out);
    err = linearize ? launch<__nv_bfloat16, true>(src, dst, n, p, s)
                    : launch<__nv_bfloat16, false>(src, dst, n, p, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

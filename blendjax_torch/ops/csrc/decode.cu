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
// 4 bytes) with a few flops between, far below the card's flops-per-byte
// balance: (8, 480, 640, 3) -> bf16 moves 22.1 MB, 6.60 us at 3.35 TB/s.
// What costs time is keeping enough bytes in flight, in whole sectors.
//
// Design: a persistent grid, one block per SM, moves the bytes with
// Hopper's bulk copies and keeps them out of registers.  Each block owns
// one contiguous run of chunks (ops/image.py::decode_plan computes the
// whole launch in Python).  One thread asks for the block's first `stages`
// chunks at once, each a 1-D cp.async.bulk into its own stage of a ring in
// shared memory, completed on that stage's mbarrier; at the main shape in
// bf16 the ring holds the block's whole share (7 chunks of 8,192), so every
// byte is requested in the kernel's first microsecond.  The block converts
// shared memory to shared memory (lane i reads the input bytes of one
// 16-byte output unit and writes that unit: neighbouring lanes on
// neighbouring addresses on both sides), fences the writes over to the
// async proxy, and the same thread stores the chunk with one bulk store and
// refills the stage with the chunk `stages` ahead.  A stage's output
// buffer is written again only after its last store has read it
// (cp.async.bulk.wait_group.read).
//
// Alignment: a bulk copy needs 16-byte addresses and sizes.  Output chunks
// start on 16-byte output addresses; input chunks are loaded from the
// 16-byte granule at or before their first byte, `shift` bytes ahead, and
// the convert reads them that far in (funnel shifts of aligned words when
// shift != 0).  The few elements before the first aligned chunk and after
// the last go through plain loads and stores.
//
// What the measurements chose (an NVIDIA H100 80GB HBM3 at 700 W,
// PERF.md): every stage starts on 128 bytes of shared memory, since
// stages 16 bytes off it made the kernel 30-55% slower; a few large chunks
// per block, since each chunk costs a block barrier and a proxy fence in
// series (28 chunks a block took twice as long as 7).  Against the same
// bytes moved by a plain device copy (6.7-6.8 us) this kernel takes
// 7.5-7.7 us at the main shape in bf16; the first form (one 16-byte load
// per thread, 1.7 waves of blocks) and a register-only form on this
// persistent grid (8 loads per thread in flight before any store) took
// 8.9-9.2 us.
//
// Arithmetic matches the reference bit for bit where IEEE allows: a byte
// becomes an exact float as 2^23 + b less 2^23, the multiply, add and
// divide use the _rn intrinsics so nvcc cannot contract them into an FMA,
// and bf16 rounding is round-to-nearest-even, as XLA converts.  powf is
// CUDA's (within 2 ulp, not correctly rounded), which the linearize
// tolerance covers.  Build without --use_fast_math: it would replace powf
// and the division.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

using bjx::mbar_expect_tx;
using bjx::mbar_init;
using bjx::mbar_wait;
using bjx::smem_u32;

constexpr int kThreads = 256;

// The launch plan of ops/image.py::decode_plan; the field order is that of
// its ctypes mirror, DecodePlan.
struct Plan {
  long long lo, hi;  // chunks cover elements [lo, hi); [0, lo) and [hi, n) go scalar
  long long chunk;   // elements per chunk, a multiple of 128; the last chunk is short
  long long chunks;  // chunks in [lo, hi)
  long long grid;    // blocks: block b takes chunks [b q + min(b, r), + q + (b < r))
  long long stages;  // ring depth
  long long shift;   // (in + lo) % 16: the chunk's first byte in its aligned load
  long long smem;    // dynamic shared memory: stages * (chunk + 128 + chunk * out size + 8)
};

// -- bulk copies ----------------------------------------------------------------

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(reinterpret_cast<uint64_t>(dst)), "r"(smem_u32(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Waits until at most min(pending, 7) bulk stores still read shared memory
// (wait_group takes an immediate; waiting for more is always safe).
__device__ __forceinline__ void bulk_wait_read(int pending) {
  switch (pending < 0 ? 0 : pending) {
    case 0: asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory"); break;
    case 1: asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory"); break;
    case 2: asm volatile("cp.async.bulk.wait_group.read 2;" ::: "memory"); break;
    case 3: asm volatile("cp.async.bulk.wait_group.read 3;" ::: "memory"); break;
    case 4: asm volatile("cp.async.bulk.wait_group.read 4;" ::: "memory"); break;
    case 5: asm volatile("cp.async.bulk.wait_group.read 5;" ::: "memory"); break;
    case 6: asm volatile("cp.async.bulk.wait_group.read 6;" ::: "memory"); break;
    default: asm volatile("cp.async.bulk.wait_group.read 7;" ::: "memory"); break;
  }
}

// -- arithmetic -----------------------------------------------------------------

template <bool kLinearize>
__device__ __forceinline__ float scale(float b) {
  float x = __fmul_rn(b, 1.0f / 255.0f);
  if (kLinearize) {
    x = x <= 0.04045f ? __fdiv_rn(x, 12.92f)
                      : powf(__fdiv_rn(__fadd_rn(x, 0.055f), 1.055f), 2.4f);
  }
  return x;
}

// Byte K of w as an exact float: the bits 0x4B0000bb are 2^23 + b.
template <int K>
__device__ __forceinline__ float byte_as_float(uint32_t w) {
  return __fsub_rn(__uint_as_float(__byte_perm(w, 0x4Bu, 0x4550u | K)), 8388608.0f);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return static_cast<uint32_t>(__bfloat16_as_ushort(v.x)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(v.y)) << 16);
}

// One 16-byte output unit from its input words: 8 bytes -> 8 bf16, or
// 4 bytes -> 4 f32.
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

// Elements [a, b) through plain loads and stores (the head and tail).
template <typename OutT, bool kLinearize>
__device__ __forceinline__ void decode_scalar(const uint8_t* in, OutT* out, long long a,
                                              long long b) {
  for (long long i = a + threadIdx.x; i < b; i += kThreads) {
    store1(out + i, scale<kLinearize>(static_cast<float>(in[i])));
  }
}

// The NW input words of the unit whose first byte is at buf + o; with
// kShift, o need not be aligned and the words are funnel-shifted out of
// aligned ones (reading at most 3 bytes past the unit, inside the stage).
template <int NW, bool kShift>
__device__ __forceinline__ void read_unit(const uint8_t* buf, int o, uint32_t (&w)[NW]) {
  if constexpr (!kShift) {
    if constexpr (NW == 2) {
      const uint2 v = *reinterpret_cast<const uint2*>(buf + o);
      w[0] = v.x;
      w[NW - 1] = v.y;
    } else {
      w[0] = *reinterpret_cast<const uint32_t*>(buf + o);
    }
    return;
  }
  const uint32_t* p = reinterpret_cast<const uint32_t*>(buf + (o & ~3));
  const uint32_t r = 8u * (o & 3);
  uint32_t prev = p[0];
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint32_t next = p[i + 1];
    w[i] = __funnelshift_r(prev, next, r);
    prev = next;
  }
}

template <typename OutT, bool kLinearize, bool kShift>
__global__ void __launch_bounds__(kThreads, 1)
decode_u8_kernel(const uint8_t* __restrict__ in, OutT* __restrict__ out, long long n, Plan p) {
  constexpr int kOut = sizeof(OutT);
  constexpr int kUnit = 16 / kOut;  // elements (input bytes) per 16-byte output unit
  extern __shared__ __align__(128) uint8_t smem[];
  const int stages = static_cast<int>(p.stages);
  const int chunk = static_cast<int>(p.chunk);
  const int shift = static_cast<int>(p.shift);
  // every stage's buffers start on 128 bytes; an input stage holds up to
  // chunk + 16 bytes
  const int in_stride = chunk + 128;
  uint8_t* in_s = smem;                                  // stages x (chunk + 128) bytes
  uint8_t* out_s = smem + stages * in_stride;            // stages x chunk outputs
  auto* bars = reinterpret_cast<uint64_t*>(out_s + stages * chunk * kOut);
  const int tid = threadIdx.x;
  const long long b = blockIdx.x;

  if (b == 0) decode_scalar<OutT, kLinearize>(in, out, 0, p.lo);
  if (b == gridDim.x - 1) decode_scalar<OutT, kLinearize>(in, out, p.hi, n);
  const long long q = p.chunks / gridDim.x, r = p.chunks % gridDim.x;
  const long long first = b * q + (b < r ? b : r);
  const int count = static_cast<int>(q + (b < r));
  if (count == 0) return;

  // chunk j of this block: elements [start(j), start(j) + len(j))
  auto start = [&](int j) { return p.lo + (first + j) * chunk; };
  auto len = [&](int j) {
    return static_cast<int>(min(static_cast<long long>(chunk), p.hi - start(j)));
  };
  auto load = [&](int j) {
    const int st = j % stages;
    const uint32_t bytes = (len(j) + shift + 15) & ~15;
    mbar_expect_tx(&bars[st], bytes);
    bulk_load(in_s + st * in_stride, in + start(j) - shift, bytes, &bars[st]);
  };

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&bars[s]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int j = 0; j < count && j < stages; ++j) load(j);
  }
  __syncthreads();

  for (int j = 0; j < count; ++j) {
    const int st = j % stages;
    const uint8_t* src = in_s + st * in_stride;
    uint8_t* dst = out_s + st * chunk * kOut;
    const int units = len(j) / kUnit;
    mbar_wait(&bars[st], (j / stages) & 1);
    for (int u = tid; u < units; u += kThreads) {
      uint32_t w[kUnit / 4];
      read_unit<kUnit / 4, kShift>(src, shift + kUnit * u, w);
      reinterpret_cast<uint4*>(dst)[u] = encode<kLinearize>(w, static_cast<OutT*>(nullptr));
    }
    // the writes above, seen by the bulk store's (async) proxy
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    // the store that last read the next stage's output buffer (chunk
    // j + 1 - stages) has finished reading before anyone writes it again
    if (tid == 0) bulk_wait_read(stages - 2);
    __syncthreads();
    if (tid == 0) {
      bulk_store(out + start(j), dst, static_cast<uint32_t>(len(j) * kOut));
      if (j + stages < count) load(j + stages);
    }
  }
  // the stores have landed before the block's shared memory is released
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

template <typename OutT, bool kLinearize, bool kShift>
cudaError_t launch(const uint8_t* in, OutT* out, long long n, const Plan& p,
                   cudaStream_t stream) {
  auto kernel = decode_u8_kernel<OutT, kLinearize, kShift>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(p.smem));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(p.grid), kThreads, static_cast<size_t>(p.smem), stream>>>(
      in, out, n, p);
  return cudaGetLastError();
}

template <typename OutT, bool kLinearize>
cudaError_t launch(const uint8_t* in, OutT* out, long long n, const Plan& p,
                   cudaStream_t stream) {
  return p.shift ? launch<OutT, kLinearize, true>(in, out, n, p, stream)
                 : launch<OutT, kLinearize, false>(in, out, n, p, stream);
}

// The plan fits these pointers and this card's limits (a mismatch would
// fault or read out of bounds, so it is refused before the launch).
bool plan_ok(const void* in, const void* out, long long n, int out_size, const Plan& p) {
  if (p.grid < 1 || p.chunk < 128 || p.chunk % 128 || p.lo < 0 || p.hi > n) return false;
  if (p.chunks == 0) return p.lo == 0 && p.hi == 0 && p.grid == 1 && p.stages == 0 && p.smem == 0;
  const long long per_block = (p.chunks + p.grid - 1) / p.grid;
  const long long in0 = static_cast<long long>(reinterpret_cast<uintptr_t>(in));
  const long long in_at = in0 + p.lo - p.shift;  // the first chunk's load
  const long long in_end = (in0 + p.hi + 15) / 16 * 16;  // the end of the last one
  const long long out_at = static_cast<long long>(reinterpret_cast<uintptr_t>(out)) +
                           p.lo * out_size;
  return p.grid <= p.chunks && p.lo < p.hi && (p.hi - p.lo) % (16 / out_size) == 0 &&
         (p.hi - p.lo + p.chunk - 1) / p.chunk == p.chunks && p.stages >= 1 &&
         (p.stages >= 2 || per_block == 1) && p.stages <= per_block &&
         p.smem == p.stages * (p.chunk + 128 + p.chunk * out_size + 8) && p.smem <= 232448 &&
         p.shift >= 0 && p.shift < 16 && in_at % 16 == 0 && in_at >= in0 &&
         in_end <= in0 + n && out_at % 16 == 0;
}

}  // namespace

// Plain C entry point, loaded with ctypes.  out_kind: 0 = float32,
// 1 = bfloat16; plan: the Plan above, from ops/image.py::decode_plan for
// these pointers.  Launches on `stream` without synchronising and returns
// the cudaError_t of the shared-memory setting or the launch (0 on
// success; cudaErrorInvalidValue for a plan that does not fit).
extern "C" int bjx_decode_u8(const void* in, void* out, long long n, int out_kind,
                             int linearize, const void* plan, void* stream) {
  if (n <= 0) return 0;
  const Plan& p = *static_cast<const Plan*>(plan);
  const auto* src = static_cast<const uint8_t*>(in);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (out_kind == 0 && plan_ok(in, out, n, 4, p)) {
    auto* dst = static_cast<float*>(out);
    err = linearize ? launch<float, true>(src, dst, n, p, s)
                    : launch<float, false>(src, dst, n, p, s);
  } else if (out_kind == 1 && plan_ok(in, out, n, 2, p)) {
    auto* dst = static_cast<__nv_bfloat16*>(out);
    err = linearize ? launch<__nv_bfloat16, true>(src, dst, n, p, s)
                    : launch<__nv_bfloat16, false>(src, dst, n, p, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

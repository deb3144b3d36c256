// The tensor-core machinery of the bf16 flash-attention kernels for Hopper
// (sm_90a), shared by flash_fwd_tc.cu (forward) and flash_bwd_tc.cu (dQ,
// dK/dV): one warpgroup of 128 threads per block, 64-row tiles kept bf16
// in shared memory as 64 x 64 chunks with the 128-byte swizzle, filled by
// TMA over 3-D (BH, T, D) maps and completed on mbarriers, and wgmma
// products into f32 registers.  Register fragments follow the m64nNk16
// accumulator layout: thread (warp w, group g = lane / 4, t = lane % 4)
// holds entry 4j + e at row 16w + g + 8(e / 2), column 8j + 2t + e % 2.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include "async_copy.cuh"
#include "flash_common.cuh"

namespace bjx_flash {

using bf16 = __nv_bfloat16;
using bjx::mbar_expect_tx;
using bjx::mbar_init;
using bjx::mbar_wait;
using bjx::smem_u32;

constexpr int kWG = 128;          // threads: one warpgroup
constexpr int kRows = 64;         // rows of every tile
constexpr int kChunk = kRows * 64;  // bf16 elements of one 64 x 64 swizzled chunk (8 KB)

// -- TMA ------------------------------------------------------------------------

// One 64 x 64 box of a (BH, T, D) bf16 map at (col, row, head) -> smem.
__device__ __forceinline__ void tma_load(bf16* dst, const CUtensorMap* map, uint64_t* bar,
                                         int col, int row, int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(head), "r"(smem_u32(bar))
      : "memory");
}

// A 64-row tile of all NC column chunks; the barrier expects its bytes.
template <int NC>
__device__ __forceinline__ void tma_tile(bf16* dst, const CUtensorMap* map, uint64_t* bar,
                                         int row, int head) {
#pragma unroll
  for (int c = 0; c < NC; ++c) tma_load(dst + c * kChunk, map, bar, c * 64, row, head);
}

// -- wgmma ---------------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle.  K-major operands:
// 8-row groups 1024 B apart (SBO), LBO unused.  MN-major operands: 8-row
// groups of K 1024 B apart (SBO), and the next 64 columns (the next
// swizzle atom in MN, one chunk on) 8 KB apart (LBO).
__device__ __forceinline__ uint64_t desc_kmajor(const bf16* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint64_t desc_mnmajor(const bf16* p) {
  constexpr uint64_t kChunkBytes = kChunk * sizeof(bf16);
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | ((kChunkBytes >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Waits until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving register reads or writes across a wgmma
// boundary: the hardware reads and writes these registers asynchronously.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define BJX_ACC32(d)                                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),          \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),  \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),            \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),            \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

#define BJX_REGS32                                                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

#define BJX_REGS64                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "   \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "    \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "    \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x 64, f32) (+)= A (64 x 16, smem, K-major) * B (16 x 64, smem, K-major).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " BJX_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n\t}"
      : BJX_ACC32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16, registers) * B (16 x 64, smem, MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %37, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " BJX_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n\t}"
      : BJX_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// [d0 d1] (64 x 128, f32, two 64-column halves) += A (64 x 16, registers) *
// B (16 x 128, smem, MN-major, two swizzle atoms).
__device__ __forceinline__ void wgmma_rs128(float (&d0)[32], float (&d1)[32], const uint32_t* a,
                                            uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %69, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " BJX_REGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n\t}"
      : BJX_ACC32(d0), BJX_ACC32(d1)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef BJX_ACC32
#undef BJX_REGS32
#undef BJX_REGS64

// d (+)= A B^T over DP columns of two K-major tiles (64 rows each).
template <int DP>
__device__ __forceinline__ void gemm_nt(float (&d)[32], const bf16* a, const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int off = (kk / 4) * kChunk + (kk % 4) * 16;
    wgmma_ss(d, desc_kmajor(a + off), desc_kmajor(b + off), kk > 0);
  }
}

// d[c] += A B for the register fragments A (64 x 64, split into hi and lo)
// and B, a 64-row tile read MN-major; d[c] is B's column chunk c.  A head
// dim of 128 takes one n128 product per k step, narrower ones one n64.
template <int NC>
__device__ __forceinline__ void gemm_rn(float (&d)[NC][32], const uint32_t (&hi)[16],
                                        const uint32_t (&lo)[16], const bf16* b) {
  static_assert(NC == 1 || NC == 2, "head dims up to 128");
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = desc_mnmajor(b + kk * 16 * 64);
    if constexpr (NC == 2) {
      wgmma_rs128(d[0], d[1], hi + 4 * kk, db);
      wgmma_rs128(d[0], d[1], lo + 4 * kk, db);
    } else {
      wgmma_rs(d[0], hi + 4 * kk, db);
      wgmma_rs(d[0], lo + 4 * kk, db);
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The 64 x 64 f32 accumulator x -> register-A fragments of x = hi + lo.
// Accumulator entry 4j + e sits at (row g + 8 (e / 2), column 8j + 2t +
// e % 2); A fragment k-step kk takes column blocks 2kk and 2kk + 1.
__device__ __forceinline__ void split_hi_lo(const float (&x)[32], uint32_t (&hi)[16],
                                            uint32_t (&lo)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    const float2 hf = __bfloat1622float2(h);
    hi[i] = *reinterpret_cast<const uint32_t*>(&h);
    lo[i] = pack_bf16(x[2 * i] - hf.x, x[2 * i + 1] - hf.y);
  }
}

// visible() without branches: the select keeps an unrolled tile loop one
// basic block, so its 32 exponentials overlap instead of running in turn.
__device__ __forceinline__ bool seen(const Problem& p, int r, int c) {
  const int row = r + p.q_offset;
  const bool in_band = (c <= row) & ((p.window == 0) | (c > row - p.window));
  return (r < p.tq) & (c < p.tk) & ((p.causal == 0) | in_band);
}

// Whether every entry of the 64 x 64 tile (q rows r0.., kv rows c0..) is
// visible, so that the tile needs no mask.
__device__ __forceinline__ bool tile_full(const Problem& p, int r0, int c0) {
  if (r0 + kRows > p.tq || c0 + kRows > p.tk) return false;
  if (!p.causal) return true;
  const int last = r0 + kRows - 1 + p.q_offset;
  return c0 + kRows - 1 <= r0 + p.q_offset && (p.window == 0 || c0 > last - p.window);
}

template <typename T>
__device__ __forceinline__ void store2(T* dst, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<bf16>(bf16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

// Rows row0 + (0..63) of the (64 x 64 NC) accumulator acc into out
// (n rows of D columns, row-major); rows past n and columns past D skipped.
template <typename TOut, int D, int NC>
__device__ __forceinline__ void store_tile(TOut* out, const float (&acc)[NC][32], int row0,
                                           int n, int w, int g, int t) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c * 64 + 8 * j + 2 * t;
      if (col >= D) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + 16 * w + g + 8 * h;
        if (r < n) {
          store2<TOut>(out + static_cast<int64_t>(r) * D + col, acc[c][4 * j + 2 * h],
                       acc[c][4 * j + 2 * h + 1]);
        }
      }
    }
}

template <int D>
__host__ __device__ constexpr int padded() {
  return D < 64 ? 64 : D;
}

// The dynamic shared memory from its first 1024-byte aligned shared address.
__device__ __forceinline__ bf16* aligned_base(unsigned char* raw) {
  return reinterpret_cast<bf16*>(raw + ((1024 - (smem_u32(raw) & 1023)) & 1023));
}

__device__ __forceinline__ void init_barriers(uint64_t* bars, int n) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < n; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();
}

// -- host ----------------------------------------------------------------------

using EncodeTiled = PFN_cuTensorMapEncodeTiled_v12000;

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so
// the library needs no -lcuda.
inline EncodeTiled encode_fn() {
  static EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault,
                                     &status);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status);
#endif
    return status == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(ptr) : nullptr;
  }();
  return fn;
}

// 3-D map over a contiguous (heads, t, d) bf16 tensor, 64 x 64 boxes with
// the 128-byte swizzle; boxes past t (or past d < 64) are zero-filled.
inline cudaError_t make_map(CUtensorMap* map, const void* ptr, int heads, int t, int d) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(t),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * sizeof(bf16),
                                 static_cast<cuuint64_t>(t) * d * sizeof(bf16)};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(kRows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

struct Maps {
  CUtensorMap q, k, v, dout;
};

// The maps of q, k, v and, unless it is null (the forward), dout.
inline cudaError_t make_maps(Maps& m, const void* q, const void* k, const void* v,
                             const void* dout, int bh, const Problem& p, int d) {
  const int bkv = bh / p.h_q * p.h_kv;
  cudaError_t err;
  if ((err = make_map(&m.q, q, bh, p.tq, d)) != cudaSuccess) return err;
  if ((err = make_map(&m.k, k, bkv, p.tk, d)) != cudaSuccess) return err;
  if ((err = make_map(&m.v, v, bkv, p.tk, d)) != cudaSuccess) return err;
  return dout == nullptr ? cudaSuccess : make_map(&m.dout, dout, bh, p.tq, d);
}

// Calls f(Tag<TOut>, integral_constant<D>) for the bf16-input instance that
// matches; out_kind 0 = float32, 1 = bfloat16.
template <typename F>
cudaError_t dispatch_tc(int d, int out_kind, F&& f) {
  return dispatch(d, 1, out_kind, [&](auto, auto to, auto dc) { return f(to, dc); });
}

}  // namespace bjx_flash

// Flash-attention backward for Hopper (sm_90a) on the tensor cores: the dQ
// pass and the dK/dV pass for bf16 inputs, recomputing the probabilities
// from the forward's saved logsumexp (the FlashAttention-2 recurrence):
//
//   P = exp(S * scale - lse),  dP = dO V^T,  dS = P * (dP - delta) * scale,
//   dQ = dS K,  dK = dS^T Q,  dV = P^T dO.
//
// Replaces the Pallas TPU kernels blendjax/ops/flash_attention.py::
// _dq_kernel (through _dq_pass) and ::_dkv_kernel (through _dkv_pass) for
// bf16 inputs; f32 inputs keep the exact-f32 CUDA-core kernels of
// flash_bwd.cu (no TF32).
//
// Bound: at the main path's shape (8, 512, 8, 128) bf16 causal the dQ pass
// moves 42.2 MB (12.6 us at 3.35 TB/s) and the dK/dV pass 50.6 MB
// (15.1 us); with the split below their tensor work is 8.6 and 12.9 GFLOP
// (8.7 and 13.0 us at 989.4 TFLOP/s), so both stay bytes-bound.
//
// Design:
// - One warpgroup (128 threads) per block owns 64 rows: q rows in
//   flash_dq_tc_kernel, kv rows in flash_dkv_tc_kernel.  Every product is
//   a wgmma.mma_async, bf16 x bf16 -> f32 in registers, m64n64k16 for the
//   64 x 64 score tiles.
//   dq:  S = Q K^T and dP = dO V^T with both operands K-major in shared
//        memory; dQ += dS K with dS from registers and the K tile read
//        MN-major (the transpose flag).
//   dkv: S^T = K Q^T and dP^T = V dO^T, so that P^T and dS^T land in the
//        accumulator layout, which is the register-A fragment of the next
//        wgmma; dV += P^T dO and dK += dS^T Q read dO and Q MN-major.
//   At a head dim of 128 the dQ, dK and dV products are m64n128k16, one
//   per k step across both 64-column chunks.
// - Tiles stay bf16 in shared memory, in 64 x 64 chunks of 8 KB with the
//   128-byte swizzle that TMA writes and wgmma's descriptors read.  Head
//   dims 16 and 32 are padded to one 64-column chunk by TMA's zero fill.
// - TMA (cp.async.bulk.tensor over a 3-D map of (BH, T, D)) fills them;
//   a ragged T is zero-filled at its edge, never read from the next head.
//   The block's own 64 rows (Q, dO or K, V) stay resident; the other side
//   runs through a two-stage ring, so the next tile loads while this one
//   computes.  2 x 16 KB resident + 2 x 32 KB ring = 96 KB at D = 128:
//   two blocks per SM.
// - P and dS enter their products as two bf16 terms, x = hi + lo with
//   hi = bf16_rn(x) and lo = bf16_rn(x - hi), both into one f32
//   accumulator.  Each operand then keeps about 16 significant bits
//   (relative error <= 2^-17 against 2^-9 for one rounding); the bf16
//   products are exact in f32, so the results differ from the f32 plain
//   passes by the order of the sums and that residue only.
// - P = exp2((S * scale - lse) * log2 e), one FFMA and one FMUL ahead of
//   exp2f: the scaled argument adds a relative error near 2^-24 |arg|, far
//   inside the f32 limits the kernels are held to.
// - Masked entries get P = 0 exactly (per element on global positions
//   through seen(), a branch-free visible()); only tiles that cross the
//   causal diagonal, the window's edge or a ragged end pay for the test.
//   A row that sees no column gets zero gradients.
// - S and dP (S^T and dP^T) are separate commit groups, so the
//   exponentials run while the second product is on the tensor cores; in
//   dkv the dV product runs while dS is formed.
// - Under causal, dq launches its heaviest q tiles first and dkv its
//   heaviest kv tiles (the lowest) first: the tile index is blockIdx.y,
//   the slow axis of the launch order.

#include <cuda.h>
#include <cudaTypedefs.h>

#include "flash_common.cuh"

namespace bjx_flash {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kWG = 128;          // threads: one warpgroup
constexpr int kRows = 64;         // rows of every tile
constexpr int kChunk = kRows * 64;  // bf16 elements of one 64 x 64 swizzled chunk (8 KB)

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// -- mbarrier and TMA ----------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Spins until the barrier's phase differs from `parity`; a copy that never
// lands (about a second of spinning) traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins == (1u << 26)) __trap();
    asm volatile(
        "{\n\t.reg .pred P;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 P, [%1], %2;\n\t"
        "selp.b32 %0, 1, 0, P;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

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

// exp(s * scale - lse), as exp2 of the argument scaled by log2(e).
__device__ __forceinline__ float prob(float s, float scale, float lse) {
  constexpr float kLog2e = 1.4426950408889634f;
  return exp2f(fmaf(s, scale, -lse) * kLog2e);
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

template <int D>
constexpr size_t tc_smem() {
  // two resident tiles and a two-stage ring of two tiles, plus 1 KB to
  // align the swizzled chunks to 1024 B
  return 6 * sizeof(bf16) * kRows * padded<D>() + 1024;
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

// -- dQ ------------------------------------------------------------------------

template <typename TOut, int D>
__global__ void __launch_bounds__(kWG, 1)
flash_dq_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   const __grid_constant__ CUtensorMap do_map, const float* __restrict__ lse,
                   const float* __restrict__ delta, TOut* __restrict__ dq, Problem p) {
  constexpr int DP = padded<D>();
  constexpr int NC = DP / 64;
  constexpr int TILE = kRows * DP;
  constexpr uint32_t kPair = 2 * TILE * sizeof(bf16);  // bytes of two tiles
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t bars[3];  // resident Q/dO, ring stages 0 and 1
  bf16* sQ = aligned_base(smem_raw);
  bf16* sdO = sQ + TILE;
  bf16* sK = sdO + TILE;  // stage s: sK + 2 s TILE, sV = that + TILE

  const int bh = blockIdx.x;
  const int num_q = (p.tq + kRows - 1) / kRows;
  const int r0 = (p.causal ? num_q - 1 - blockIdx.y : blockIdx.y) * kRows;
  const int bkv = kv_head(bh, p);
  const int tid = threadIdx.x, w = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  int lo, hi;
  kv_span(p, r0, min(r0 + kRows, p.tq) - 1, lo, hi);
  const int first = lo / kRows;
  const int n = lo <= hi ? hi / kRows - first + 1 : 0;

  init_barriers(bars, 3);
  if (tid == 0) {
    mbar_expect_tx(&bars[0], kPair);
    tma_tile<NC>(sQ, &q_map, &bars[0], r0, bh);
    tma_tile<NC>(sdO, &do_map, &bars[0], r0, bh);
    for (int s = 0; s < 2 && s < n; ++s) {
      bf16* st = sK + 2 * s * TILE;
      mbar_expect_tx(&bars[1 + s], kPair);
      tma_tile<NC>(st, &k_map, &bars[1 + s], (first + s) * kRows, bkv);
      tma_tile<NC>(st + TILE, &v_map, &bars[1 + s], (first + s) * kRows, bkv);
    }
  }

  // this thread's two rows: r0 + 16w + g and 8 below
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 16 * w + g + 8 * h;
    const int64_t at = static_cast<int64_t>(bh) * p.tq + r;
    row_lse[h] = r < p.tq ? lse[at] : 0.f;
    row_delta[h] = r < p.tq ? delta[at] : 0.f;
  }
  float acc[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;

  mbar_wait(&bars[0], 0);
  for (int i = 0; i < n; ++i) {
    const int s = i & 1;
    const int c0 = (first + i) * kRows;
    const bf16* tK = sK + 2 * s * TILE;
    const bf16* tV = tK + TILE;
    mbar_wait(&bars[1 + s], (i >> 1) & 1);

    float sc[32] = {}, dp[32] = {};
    wg_fence();
    gemm_nt<DP>(sc, sQ, tK);
    wg_commit();
    gemm_nt<DP>(dp, sdO, tV);
    wg_commit();
    wg_wait<1>();  // S has landed; dP is still on the tensor cores
    fence_regs(sc);

    // entry x = 4j + e: q row r0 + 16w + g + 8(e / 2), kv row c0 + 8j + 2t + e % 2
    if (tile_full(p, r0, c0)) {
#pragma unroll
      for (int x = 0; x < 32; ++x) sc[x] = prob(sc[x], p.scale, row_lse[(x % 4) / 2]);
    } else {
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const float pe = prob(sc[x], p.scale, row_lse[(x % 4) / 2]);
        const int r = r0 + 16 * w + g + 8 * ((x % 4) / 2), c = c0 + 8 * (x / 4) + 2 * t + x % 2;
        sc[x] = seen(p, r, c) ? pe : 0.f;
      }
    }
    wg_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int x = 0; x < 32; ++x) dp[x] = sc[x] * (dp[x] - row_delta[(x % 4) / 2]) * p.scale;
    uint32_t ds_hi[16], ds_lo[16];
    split_hi_lo(dp, ds_hi, ds_lo);

    wg_fence();
    gemm_rn<NC>(acc, ds_hi, ds_lo, tK);
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int c = 0; c < NC; ++c) fence_regs(acc[c]);
    fence_regs(ds_hi);
    fence_regs(ds_lo);

    __syncthreads();  // every thread is done with stage s
    if (tid == 0 && i + 2 < n) {
      bf16* st = sK + 2 * s * TILE;
      mbar_expect_tx(&bars[1 + s], kPair);
      tma_tile<NC>(st, &k_map, &bars[1 + s], (first + i + 2) * kRows, bkv);
      tma_tile<NC>(st + TILE, &v_map, &bars[1 + s], (first + i + 2) * kRows, bkv);
    }
  }

  store_tile<TOut, D, NC>(dq + static_cast<int64_t>(bh) * p.tq * D, acc, r0, p.tq, w, g, t);
}

// -- dK / dV -------------------------------------------------------------------

template <typename TOut, int D>
__global__ void __launch_bounds__(kWG, 1)
flash_dkv_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap do_map, const float* __restrict__ lse,
                    const float* __restrict__ delta, TOut* __restrict__ dk,
                    TOut* __restrict__ dv, Problem p) {
  constexpr int DP = padded<D>();
  constexpr int NC = DP / 64;
  constexpr int TILE = kRows * DP;
  constexpr uint32_t kPair = 2 * TILE * sizeof(bf16);
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t bars[3];  // resident K/V, ring stages 0 and 1
  bf16* sK = aligned_base(smem_raw);
  bf16* sV = sK + TILE;
  bf16* sQ = sV + TILE;  // stage s: sQ + 2 s TILE, sdO = that + TILE

  const int bh = blockIdx.x;  // q head: the partial sums stay per q head
  const int c0 = blockIdx.y * kRows;  // tile 0 sees the most q rows
  const int bkv = kv_head(bh, p);
  const int tid = threadIdx.x, w = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  int lo, hi;
  q_span(p, c0, min(c0 + kRows, p.tk) - 1, lo, hi);
  const int first = lo / kRows;
  const int n = lo <= hi ? hi / kRows - first + 1 : 0;

  init_barriers(bars, 3);
  if (tid == 0) {
    mbar_expect_tx(&bars[0], kPair);
    tma_tile<NC>(sK, &k_map, &bars[0], c0, bkv);
    tma_tile<NC>(sV, &v_map, &bars[0], c0, bkv);
    for (int s = 0; s < 2 && s < n; ++s) {
      bf16* st = sQ + 2 * s * TILE;
      mbar_expect_tx(&bars[1 + s], kPair);
      tma_tile<NC>(st, &q_map, &bars[1 + s], (first + s) * kRows, bh);
      tma_tile<NC>(st + TILE, &do_map, &bars[1 + s], (first + s) * kRows, bh);
    }
  }

  float acc_k[NC][32], acc_v[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc_k[c][i] = acc_v[c][i] = 0.f;

  const float* lse_h = lse + static_cast<int64_t>(bh) * p.tq;
  const float* delta_h = delta + static_cast<int64_t>(bh) * p.tq;
  mbar_wait(&bars[0], 0);
  for (int i = 0; i < n; ++i) {
    const int s = i & 1;
    const int r0 = (first + i) * kRows;
    const bf16* tQ = sQ + 2 * s * TILE;
    const bf16* tdO = tQ + TILE;

    // the statistics of this thread's 16 q columns: r0 + 8j + 2t (+1)
    float col_lse[16], col_delta[16];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int r = r0 + 8 * j + 2 * t + b;
        col_lse[2 * j + b] = r < p.tq ? lse_h[r] : 0.f;
        col_delta[2 * j + b] = r < p.tq ? delta_h[r] : 0.f;
      }
    mbar_wait(&bars[1 + s], (i >> 1) & 1);

    float st[32] = {}, dpt[32] = {};  // S^T, dP^T: kv rows x q columns
    wg_fence();
    gemm_nt<DP>(st, sK, tQ);
    wg_commit();
    gemm_nt<DP>(dpt, sV, tdO);
    wg_commit();
    wg_wait<1>();  // S^T has landed; dP^T is still on the tensor cores
    fence_regs(st);

    // entry x = 4j + e: kv row c0 + 16w + g + 8(e / 2), q row r0 + 8j + 2t + e % 2
    if (tile_full(p, r0, c0)) {
#pragma unroll
      for (int x = 0; x < 32; ++x) st[x] = prob(st[x], p.scale, col_lse[2 * (x / 4) + x % 2]);
    } else {
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const float pe = prob(st[x], p.scale, col_lse[2 * (x / 4) + x % 2]);
        const int r = r0 + 8 * (x / 4) + 2 * t + x % 2, c = c0 + 16 * w + g + 8 * ((x % 4) / 2);
        st[x] = seen(p, r, c) ? pe : 0.f;
      }
    }
    uint32_t p_hi[16], p_lo[16], ds_hi[16], ds_lo[16];
    split_hi_lo(st, p_hi, p_lo);
    wg_fence();
    gemm_rn<NC>(acc_v, p_hi, p_lo, tdO);  // dV += P^T dO while dS is formed
    wg_commit();

    wg_wait<1>();  // dP^T has landed
    fence_regs(dpt);
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      dpt[x] = st[x] * (dpt[x] - col_delta[2 * (x / 4) + x % 2]) * p.scale;
    }
    split_hi_lo(dpt, ds_hi, ds_lo);
    wg_fence();
    gemm_rn<NC>(acc_k, ds_hi, ds_lo, tQ);
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      fence_regs(acc_v[c]);
      fence_regs(acc_k[c]);
    }
    fence_regs(p_hi);
    fence_regs(p_lo);
    fence_regs(ds_hi);
    fence_regs(ds_lo);

    __syncthreads();  // every thread is done with stage s
    if (tid == 0 && i + 2 < n) {
      bf16* sq = sQ + 2 * s * TILE;
      mbar_expect_tx(&bars[1 + s], kPair);
      tma_tile<NC>(sq, &q_map, &bars[1 + s], (first + i + 2) * kRows, bh);
      tma_tile<NC>(sq + TILE, &do_map, &bars[1 + s], (first + i + 2) * kRows, bh);
    }
  }

  const int64_t koff = static_cast<int64_t>(bh) * p.tk * D;
  store_tile<TOut, D, NC>(dk + koff, acc_k, c0, p.tk, w, g, t);
  store_tile<TOut, D, NC>(dv + koff, acc_v, c0, p.tk, w, g, t);
}

// -- host ----------------------------------------------------------------------

using EncodeTiled = PFN_cuTensorMapEncodeTiled_v12000;

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so
// the library needs no -lcuda.
EncodeTiled encode_fn() {
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
cudaError_t make_map(CUtensorMap* map, const void* ptr, int heads, int t, int d) {
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

cudaError_t make_maps(Maps& m, const void* q, const void* k, const void* v, const void* dout,
                      int bh, const Problem& p, int d) {
  const int bkv = bh / p.h_q * p.h_kv;
  cudaError_t err;
  if ((err = make_map(&m.q, q, bh, p.tq, d)) != cudaSuccess) return err;
  if ((err = make_map(&m.k, k, bkv, p.tk, d)) != cudaSuccess) return err;
  if ((err = make_map(&m.v, v, bkv, p.tk, d)) != cudaSuccess) return err;
  return make_map(&m.dout, dout, bh, p.tq, d);
}

// Calls f(Tag<TOut>, integral_constant<D>) for the bf16-input instance that
// matches; out_kind 0 = float32, 1 = bfloat16.
template <typename F>
cudaError_t dispatch_tc(int d, int out_kind, F&& f) {
  return dispatch(d, 1, out_kind, [&](auto, auto to, auto dc) { return f(to, dc); });
}

}  // namespace
}  // namespace bjx_flash

// Plain C entry points, loaded with ctypes, with the arguments of
// bjx_flash_dq / bjx_flash_dkv (flash_bwd.cu); in_kind must be 1 (bf16).
// q, k, v and dout must be contiguous with 16-byte aligned bases (TMA).
// Each launches on `stream` without synchronising and returns a
// cudaError_t (0 on success).
extern "C" int bjx_flash_dq_tc(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, void* dq, int bh, int h_q,
                               int h_kv, int tq, int tk, int d, float scale, int causal,
                               int window, int q_offset, int in_kind, int out_kind,
                               void* stream) {
  using namespace bjx_flash;
  if (in_kind != 1) return cudaErrorInvalidValue;
  if (bh <= 0 || tq <= 0) return 0;
  const Problem p{h_q, h_kv, tq, tk, scale, causal, window, q_offset};
  Maps m;
  cudaError_t err = make_maps(m, q, k, v, dout, bh, p, d);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (tq + kRows - 1) / kRows);
  auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch_tc(d, out_kind, [&](auto to, auto dc) {
    using TOut = typename decltype(to)::type;
    constexpr int D = decltype(dc)::value;
    return launch<kWG>(flash_dq_tc_kernel<TOut, D>, grid, tc_smem<D>(), s, m.q, m.k, m.v, m.dout,
                     static_cast<const float*>(lse), static_cast<const float*>(delta),
                     static_cast<TOut*>(dq), p);
  }));
}

extern "C" int bjx_flash_dkv_tc(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dk, void* dv, int bh,
                                int h_q, int h_kv, int tq, int tk, int d, float scale,
                                int causal, int window, int q_offset, int in_kind, int out_kind,
                                void* stream) {
  using namespace bjx_flash;
  if (in_kind != 1) return cudaErrorInvalidValue;
  if (bh <= 0 || tk <= 0) return 0;
  const Problem p{h_q, h_kv, tq, tk, scale, causal, window, q_offset};
  Maps m;
  cudaError_t err = make_maps(m, q, k, v, dout, bh, p, d);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (tk + kRows - 1) / kRows);
  auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch_tc(d, out_kind, [&](auto to, auto dc) {
    using TOut = typename decltype(to)::type;
    constexpr int D = decltype(dc)::value;
    return launch<kWG>(flash_dkv_tc_kernel<TOut, D>, grid, tc_smem<D>(), s, m.q, m.k, m.v,
                     m.dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
                     static_cast<TOut*>(dk), static_cast<TOut*>(dv), p);
  }));
}

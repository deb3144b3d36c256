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

#include "flash_tc_common.cuh"

namespace bjx_flash {
namespace {

// exp(s * scale - lse), as exp2 of the argument scaled by log2(e).
__device__ __forceinline__ float prob(float s, float scale, float lse) {
  constexpr float kLog2e = 1.4426950408889634f;
  return exp2f(fmaf(s, scale, -lse) * kLog2e);
}

template <int D>
constexpr size_t tc_smem() {
  // two resident tiles and a two-stage ring of two tiles, plus 1 KB to
  // align the swizzled chunks to 1024 B
  return 6 * sizeof(bf16) * kRows * padded<D>() + 1024;
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

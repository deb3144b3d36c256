// Flash-attention forward for Hopper (sm_90a) on the tensor cores, for
// bf16 inputs: O = softmax(Q K^T * scale) V and the per-row logsumexp,
// without the (T, T) score matrix in memory.
//
// Replaces the Pallas TPU kernel blendjax/ops/flash_attention.py::_kernel
// (reached through _flash_fwd_impl) for bf16 inputs; f32 inputs keep the
// exact-f32 CUDA-core kernel of flash_fwd.cu (no TF32).  The semantics are
// that kernel's: scores in f32 times the scale, masked entries set to
// -1e30 after the scale, a running max that starts at -1e30, l the sum of
// the f32 probabilities, l == 0 (a row that sees no column) giving O = 0
// and lse = -1e30 + log(1), lse = m + log(l), and a masked entry
// contributing exactly 0.
//
// Bound: at the main path's shape (8, 512, 8, 128) bf16 causal the work is
// 4.3 GFLOP over 33.7 MB (10.1 us at 3.35 TB/s); with the split below the
// tensor work is 6.5 GFLOP (6.5 us at 989.4 TFLOP/s), so it stays
// bytes-bound.
//
// Design (the machinery of flash_tc_common.cuh, shared with the backward):
// - One warpgroup (128 threads) per block owns one (bh, 64-row q tile) and
//   loops over the live kv tiles only (kv_span: up to the causal bound, and
//   from the window's first visible row under a window).  Under causal the
//   heaviest q tiles launch first: the tile index is blockIdx.y, the slow
//   axis of the launch order.  GQA reads k and v through kv_head().
// - Q stays resident in shared memory; K and V run through a two-stage TMA
//   ring over the 3-D (BH, T, D) maps, 128-byte swizzle, so the next kv
//   tile loads while this one computes.  Ragged T and head dims 16 and 32
//   are zero-filled by TMA.  16 KB + 2 x 32 KB + 1 KB = 81 KB at D = 128:
//   two blocks per SM.
// - S = Q K^T is wgmma m64n64k16 with both operands K-major in shared
//   memory (gemm_nt).
// - Online softmax in registers: each thread holds 2 rows x 16 columns of
//   S, a row lives on the 4 threads of a quad, so the row max is two
//   shuffles.  P = exp2((s - m) log2 e) and alpha = exp2((m_old - m_new)
//   log2 e); the O accumulator is rescaled by alpha and l sums the f32 P
//   (per thread, the quad's partial sums added once at the end).
// - Masks: only tiles that cross the causal diagonal, the window's edge or
//   a ragged end test entries, with the branch-free seen() select (a
//   per-element branch splits the unrolled loop and serialises the
//   exponentials); masked entries get s = -1e30 and P = 0 exactly.
// - O += P V: P's accumulator becomes the register-A fragment as bf16
//   hi + lo (split_hi_lo), both into one f32 accumulator with V read
//   MN-major (gemm_rn, m64n128k16 at D = 128).  P keeps about 16
//   significant bits, so the kernel differs from the f32 plain pass by the
//   order of its sums and that residue; the reference's P V runs in f32.
// - No overlap inside the block: S, softmax and P V run in turn, and the
//   two blocks on each SM overlap one another's exponentials with their
//   products.  Issuing the next tile's S with this tile's P V and running
//   its softmax while P V drains was measured slower on the H100 (more
//   registers, and the P V issue then waits behind S; see PERF.md).

#include "flash_tc_common.cuh"

namespace bjx_flash {
namespace {

constexpr float kLog2e = 1.4426950408889634f;

template <int D>
constexpr size_t fwd_tc_smem() {
  // the resident Q tile and a two-stage ring of K and V tiles, plus 1 KB
  // to align the swizzled chunks to 1024 B
  return 5 * sizeof(bf16) * kRows * padded<D>() + 1024;
}

// The max over each of this thread's two rows across its quad.
__device__ __forceinline__ void quad_max(float (&x)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    x[h] = fmaxf(x[h], __shfl_xor_sync(0xffffffffu, x[h], 1));
    x[h] = fmaxf(x[h], __shfl_xor_sync(0xffffffffu, x[h], 2));
  }
}

template <typename TOut, int D>
__global__ void __launch_bounds__(kWG, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map, TOut* __restrict__ o,
                    float* __restrict__ lse, Problem p) {
  constexpr int DP = padded<D>();
  constexpr int NC = DP / 64;
  constexpr int TILE = kRows * DP;
  constexpr uint32_t kTile = TILE * sizeof(bf16);
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t bars[3];  // resident Q, ring stages 0 and 1
  bf16* sQ = aligned_base(smem_raw);
  bf16* sK = sQ + TILE;  // stage s: sK + 2 s TILE, sV = that + TILE

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
    mbar_expect_tx(&bars[0], kTile);
    tma_tile<NC>(sQ, &q_map, &bars[0], r0, bh);
    for (int s = 0; s < 2 && s < n; ++s) {
      bf16* st = sK + 2 * s * TILE;
      mbar_expect_tx(&bars[1 + s], 2 * kTile);
      tma_tile<NC>(st, &k_map, &bars[1 + s], (first + s) * kRows, bkv);
      tma_tile<NC>(st + TILE, &v_map, &bars[1 + s], (first + s) * kRows, bkv);
    }
  }

  // the running max and this thread's part of the running sum of its two
  // rows, r0 + 16w + g and 8 below
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
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

    float sc[32] = {};
    wg_fence();
    gemm_nt<DP>(sc, sQ, tK);
    wg_commit();
    wg_wait<0>();
    fence_regs(sc);

    // entry x = 4j + e: q row r0 + 16w + g + 8(e / 2), kv row c0 + 8j + 2t + e % 2
    float mx[2] = {m[0], m[1]};
    if (tile_full(p, r0, c0)) {
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        sc[x] *= p.scale;
        mx[(x % 4) / 2] = fmaxf(mx[(x % 4) / 2], sc[x]);
      }
      quad_max(mx);
#pragma unroll
      for (int x = 0; x < 32; ++x) sc[x] = exp2f((sc[x] - mx[(x % 4) / 2]) * kLog2e);
    } else {
      uint32_t keep = 0;
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int r = r0 + 16 * w + g + 8 * ((x % 4) / 2), c = c0 + 8 * (x / 4) + 2 * t + x % 2;
        const bool k = seen(p, r, c);
        keep |= static_cast<uint32_t>(k) << x;
        sc[x] = k ? sc[x] * p.scale : kNeg;
        mx[(x % 4) / 2] = fmaxf(mx[(x % 4) / 2], sc[x]);
      }
      quad_max(mx);
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const float pe = exp2f((sc[x] - mx[(x % 4) / 2]) * kLog2e);
        sc[x] = (keep >> x) & 1u ? pe : 0.f;
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      alpha[h] = exp2f((m[h] - mx[h]) * kLog2e);
      m[h] = mx[h];
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int x = 0; x < 32; ++x) l[(x % 4) / 2] += sc[x];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int x = 0; x < 32; ++x) acc[c][x] *= alpha[(x % 4) / 2];
    uint32_t p_hi[16], p_lo[16];
    split_hi_lo(sc, p_hi, p_lo);

    wg_fence();
    gemm_rn<NC>(acc, p_hi, p_lo, tV);
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int c = 0; c < NC; ++c) fence_regs(acc[c]);
    fence_regs(p_hi);
    fence_regs(p_lo);

    __syncthreads();  // every thread is done with stage s
    if (tid == 0 && i + 2 < n) {
      bf16* st = sK + 2 * s * TILE;
      mbar_expect_tx(&bars[1 + s], 2 * kTile);
      tma_tile<NC>(st, &k_map, &bars[1 + s], (first + i + 2) * kRows, bkv);
      tma_tile<NC>(st + TILE, &v_map, &bars[1 + s], (first + i + 2) * kRows, bkv);
    }
  }

  float safe[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    safe[h] = l[h] == 0.f ? 1.f : l[h];
  }
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int x = 0; x < 32; ++x) acc[c][x] /= safe[(x % 4) / 2];
  store_tile<TOut, D, NC>(o + static_cast<int64_t>(bh) * p.tq * D, acc, r0, p.tq, w, g, t);
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 16 * w + g + 8 * h;
      if (r < p.tq) lse[static_cast<int64_t>(bh) * p.tq + r] = m[h] + logf(safe[h]);
    }
  }
}

}  // namespace
}  // namespace bjx_flash

// Plain C entry point, loaded with ctypes, with the arguments of
// bjx_flash_fwd (flash_fwd.cu); in_kind must be 1 (bf16).  q, k and v must
// be contiguous with 16-byte aligned bases (TMA).  Launches on `stream`
// without synchronising and returns a cudaError_t (0 on success).
extern "C" int bjx_flash_fwd_tc(const void* q, const void* k, const void* v, void* o, void* lse,
                                int bh, int h_q, int h_kv, int tq, int tk, int d, float scale,
                                int causal, int window, int q_offset, int in_kind, int out_kind,
                                void* stream) {
  using namespace bjx_flash;
  if (in_kind != 1) return cudaErrorInvalidValue;
  if (bh <= 0 || tq <= 0) return 0;
  const Problem p{h_q, h_kv, tq, tk, scale, causal, window, q_offset};
  Maps m;
  cudaError_t err = make_maps(m, q, k, v, nullptr, bh, p, d);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (tq + kRows - 1) / kRows);
  auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch_tc(d, out_kind, [&](auto to, auto dc) {
    using TOut = typename decltype(to)::type;
    constexpr int D = decltype(dc)::value;
    return launch<kWG>(flash_fwd_tc_kernel<TOut, D>, grid, fwd_tc_smem<D>(), s, m.q, m.k, m.v,
                       static_cast<TOut*>(o), static_cast<float*>(lse), p);
  }));
}

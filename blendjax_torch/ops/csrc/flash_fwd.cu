// Flash-attention forward for Hopper (sm_90a): O = softmax(Q K^T * scale) V
// and the per-row logsumexp, without the (T, T) score matrix in memory.
//
// Replaces the Pallas TPU kernel blendjax/ops/flash_attention.py::_kernel
// (reached through _flash_fwd_impl).  The TPU kernel walks a sequential
// grid (bh, q block, kv block) and carries the running max, sum and
// accumulator in VMEM scratch from one kv step to the next.  Hopper's
// blocks run in parallel and in no order, so here one block owns one
// (bh, 64-row q tile) and loops over the kv tiles itself, keeping the
// running statistics in registers.  The loop visits only the live kv
// tiles: up to the causal bound and, under a sliding window, from the
// window's first visible row on (the reference's shrunk grid and its
// num_kv_total guard), so dead tiles are never loaded.
//
// Semantics kept from the reference: the scores are computed in f32 and
// multiplied by the scale, masked entries are set to -1e30 after the
// scale, the running max starts at -1e30, l == 0 (a row that sees no
// column) gives O = 0 and lse = -1e30 + log(1), and lse = m + log(l).
// A masked entry contributes exactly 0 to the sums (the reference gets
// exp(-1e30 - m) = 0 for every row that sees anything).
//
// Bound: at the main path's shape (8, 512, 8, 128) bf16 causal the work
// is 4.3 GFLOP over 34 MB, bytes-bound on the card's bf16 tensor-core
// rate.  This first version computes in f32 FMAs on the CUDA cores (no
// tensor cores), so it is bound by those FMAs and by shared-memory reads
// instead; each thread keeps a 4 x 4 register tile of scores, so every
// shared-memory load feeds two FMAs.  wgmma and TMA are later work.

#include "flash_common.cuh"

namespace bjx_flash {
namespace {

template <int D>
constexpr size_t fwd_smem() {
  // sQ, sK: kBQ/kBK x (D + 1); sV: kBK x D; sP: kBQ x (kBK + 1)
  return sizeof(float) * (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1));
}

template <typename TIn, typename TOut, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const TIn* __restrict__ q, const TIn* __restrict__ k,
                 const TIn* __restrict__ v, TOut* __restrict__ o,
                 float* __restrict__ lse, Problem p) {
  constexpr int LD = D + 1;
  constexpr int LP = kBK + 1;
  constexpr int CPT = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBQ * LD;
  float* sV = sK + kBK * LD;
  float* sP = sV + kBK * D;

  const int bh = blockIdx.y;
  const int r0 = blockIdx.x * kBQ;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int bkv = kv_head(bh, p);
  const TIn* kb = k + static_cast<int64_t>(bkv) * p.tk * D;
  const TIn* vb = v + static_cast<int64_t>(bkv) * p.tk * D;

  load_tile<TIn, D>(sQ, LD, q + static_cast<int64_t>(bh) * p.tq * D, r0, p.tq, kBQ);

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < CPT; ++jj) acc[i][jj] = 0.f;
  }

  int lo, hi;
  kv_span(p, r0, min(r0 + kBQ, p.tq) - 1, lo, hi);
  for (int c0 = (lo / kBK) * kBK; lo <= hi && c0 <= hi; c0 += kBK) {
    __syncthreads();  // the previous tile's sK/sV/sP are consumed
    load_tile<TIn, D>(sK, LD, kb, c0, p.tk, kBK);
    load_tile<TIn, D>(sV, D, vb, c0, p.tk, kBK);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sQ[(ty * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sK[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + ty * 4 + i;
      bool keep[4];
      float row_max = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        keep[j] = visible(p, r, c0 + tx + 16 * j);
        s[i][j] = keep[j] ? s[i][j] * p.scale : kNeg;
        row_max = fmaxf(row_max, s[i][j]);
      }
      const float m_new = fmaxf(m[i], max16(row_max));
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pij = keep[j] ? expf(s[i][j] - m_new) : 0.f;
        sP[(ty * 4 + i) * LP + tx + 16 * j] = pij;
        row_sum += pij;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + sum16(row_sum);
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < CPT; ++jj) acc[i][jj] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = sP[(ty * 4 + i) * LP + c];
#pragma unroll
      for (int jj = 0; jj < CPT; ++jj) {
        const float vv = sV[c * D + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(pr[i], vv, acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= p.tq) continue;
    const float safe = l[i] == 0.f ? 1.f : l[i];
    const int64_t row = static_cast<int64_t>(bh) * p.tq + r;
#pragma unroll
    for (int jj = 0; jj < CPT; ++jj) o[row * D + tx + 16 * jj] = from_f32<TOut>(acc[i][jj] / safe);
    if (tx == 0) lse[row] = m[i] + logf(safe);
  }
}

}  // namespace
}  // namespace bjx_flash

// Plain C entry point, loaded with ctypes.  q: (bh, tq, d), k/v: (bh / h_q *
// h_kv, tk, d), o: (bh, tq, d), lse: (bh, tq) f32; in_kind/out_kind 0 =
// float32, 1 = bfloat16; window 0 = none.  Launches on `stream` without
// synchronising and returns the launch's cudaError_t (0 on success).
extern "C" int bjx_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                             int bh, int h_q, int h_kv, int tq, int tk, int d, float scale,
                             int causal, int window, int q_offset, int in_kind, int out_kind,
                             void* stream) {
  using namespace bjx_flash;
  if (bh <= 0 || tq <= 0) return 0;
  const Problem p{h_q, h_kv, tq, tk, scale, causal, window, q_offset};
  const dim3 grid((tq + kBQ - 1) / kBQ, bh);
  auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(d, in_kind, out_kind, [&](auto ti, auto to, auto dc) {
    using TIn = typename decltype(ti)::type;
    using TOut = typename decltype(to)::type;
    constexpr int D = decltype(dc)::value;
    return launch(flash_fwd_kernel<TIn, TOut, D>, grid, fwd_smem<D>(), s,
                  static_cast<const TIn*>(q), static_cast<const TIn*>(k),
                  static_cast<const TIn*>(v), static_cast<TOut*>(o), static_cast<float*>(lse), p);
  }));
}

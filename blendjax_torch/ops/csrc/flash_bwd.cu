// Flash-attention backward for Hopper (sm_90a): the dQ pass and the dK/dV
// pass, each recomputing the probabilities from the forward's saved
// logsumexp (the FlashAttention-2 recurrence):
//
//   P = exp(S - lse),  dP = dO V^T,  dS = P * (dP - delta) * scale,
//   dQ = dS K,  dK = dS^T Q,  dV = P^T dO,
//
// with delta = rowsum(dO * O) computed by the caller.
//
// Replaces the Pallas TPU kernels blendjax/ops/flash_attention.py::
// _dq_kernel (through _dq_pass) and ::_dkv_kernel (through _dkv_pass).
// As in the forward, the sequential grid axis that carried the TPU's
// accumulator becomes a loop inside one block:
//
// - flash_dq_kernel: one block per (bh, 64-row q tile), looping over the
//   live kv tiles (causal bound, window start) and accumulating dQ in f32
//   registers.
// - flash_dkv_kernel: one block per (q head bh, 64-row kv tile), looping
//   over the live q tiles (from _q_base to the window's end, guarded by
//   the q length) and accumulating dK and dV in f32 registers.  Under
//   grouped-query attention it reads k/v from the shared kv head and
//   writes the partial sums of its own q head; the caller folds them onto
//   the kv head.  No atomics: every sum is taken in one block in a fixed
//   order.
//
// Masked entries get P = 0 exactly, so dS = 0 there.
//
// Bound: at the main path's shape (8, 512, 8, 128) bf16 causal the dQ pass
// is 6.4 GFLOP over 42 MB and the dK/dV pass 8.6 GFLOP over 51 MB, both
// bytes-bound on the card's bf16 tensor-core rate.  Like the forward, this
// first version computes in f32 FMAs on the CUDA cores from shared
// memory, with 4 x 4 register tiles of S and dP per thread; the tensor
// cores are later work.

#include "flash_common.cuh"

namespace bjx_flash {
namespace {

template <int D>
constexpr size_t dq_smem() {
  // sQ, sdO, sK, sV: 64 x (D + 1); sdS: kBQ x (kBK + 1)
  return sizeof(float) * (2 * kBQ * (D + 1) + 2 * kBK * (D + 1) + kBQ * (kBK + 1));
}

template <int D>
constexpr size_t dkv_smem() {
  // sK, sV, sQ, sdO: 64 x (D + 1); sPt, sdSt: kBK x (kBQ + 1); lse, delta
  return sizeof(float) *
         (2 * kBK * (D + 1) + 2 * kBQ * (D + 1) + 2 * kBK * (kBQ + 1) + 2 * kBQ);
}

template <typename TIn, typename TOut, int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const TIn* __restrict__ q, const TIn* __restrict__ k,
                const TIn* __restrict__ v, const TIn* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                TOut* __restrict__ dq, Problem p) {
  constexpr int LD = D + 1;
  constexpr int LS = kBK + 1;
  constexpr int CPT = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + kBQ * LD;
  float* sK = sdO + kBQ * LD;
  float* sV = sK + kBK * LD;
  float* sdS = sV + kBK * LD;

  const int bh = blockIdx.y;
  const int r0 = blockIdx.x * kBQ;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int bkv = kv_head(bh, p);
  const int64_t qoff = static_cast<int64_t>(bh) * p.tq;
  const TIn* kb = k + static_cast<int64_t>(bkv) * p.tk * D;
  const TIn* vb = v + static_cast<int64_t>(bkv) * p.tk * D;

  load_tile<TIn, D>(sQ, LD, q + qoff * D, r0, p.tq, kBQ);
  load_tile<TIn, D>(sdO, LD, dout + qoff * D, r0, p.tq, kBQ);
  float row_lse[4], row_delta[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    row_lse[i] = r < p.tq ? lse[qoff + r] : 0.f;
    row_delta[i] = r < p.tq ? delta[qoff + r] : 0.f;
#pragma unroll
    for (int jj = 0; jj < CPT; ++jj) acc[i][jj] = 0.f;
  }

  int lo, hi;
  kv_span(p, r0, min(r0 + kBQ, p.tq) - 1, lo, hi);
  for (int c0 = (lo / kBK) * kBK; lo <= hi && c0 <= hi; c0 += kBK) {
    __syncthreads();
    load_tile<TIn, D>(sK, LD, kb, c0, p.tk, kBK);
    load_tile<TIn, D>(sV, LD, vb, c0, p.tk, kBK);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], g[4], b[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = sQ[(ty * 4 + i) * LD + d];
        g[i] = sdO[(ty * 4 + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = sK[(tx + 16 * j) * LD + d];
        w[j] = sV[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(g[i], w[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float pij =
            visible(p, r0 + ty * 4 + i, c0 + c) ? expf(s[i][j] * p.scale - row_lse[i]) : 0.f;
        sdS[(ty * 4 + i) * LS + c] = pij * (dp[i][j] - row_delta[i]) * p.scale;
      }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = sdS[(ty * 4 + i) * LS + c];
#pragma unroll
      for (int jj = 0; jj < CPT; ++jj) {
        const float kk = sK[c * LD + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(ds[i], kk, acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= p.tq) continue;
#pragma unroll
    for (int jj = 0; jj < CPT; ++jj) {
      dq[(qoff + r) * D + tx + 16 * jj] = from_f32<TOut>(acc[i][jj]);
    }
  }
}

template <typename TIn, typename TOut, int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const TIn* __restrict__ q, const TIn* __restrict__ k,
                 const TIn* __restrict__ v, const TIn* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 TOut* __restrict__ dk, TOut* __restrict__ dv, Problem p) {
  constexpr int LD = D + 1;
  constexpr int LT = kBQ + 1;
  constexpr int CPT = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kBK * LD;
  float* sQ = sV + kBK * LD;
  float* sdO = sQ + kBQ * LD;
  float* sPt = sdO + kBQ * LD;  // P^T: kv row x q row
  float* sdSt = sPt + kBK * LT;
  float* sLse = sdSt + kBK * LT;
  float* sDelta = sLse + kBQ;

  const int bh = blockIdx.y;  // q head: the partial sums stay per q head
  const int c0 = blockIdx.x * kBK;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int bkv = kv_head(bh, p);
  const int64_t qoff = static_cast<int64_t>(bh) * p.tq;

  load_tile<TIn, D>(sK, LD, k + static_cast<int64_t>(bkv) * p.tk * D, c0, p.tk, kBK);
  load_tile<TIn, D>(sV, LD, v + static_cast<int64_t>(bkv) * p.tk * D, c0, p.tk, kBK);
  float dk_acc[4][CPT], dv_acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < CPT; ++jj) dk_acc[i][jj] = dv_acc[i][jj] = 0.f;

  int lo, hi;
  q_span(p, c0, min(c0 + kBK, p.tk) - 1, lo, hi);
  for (int r0 = (lo / kBQ) * kBQ; lo <= hi && r0 <= hi; r0 += kBQ) {
    __syncthreads();
    load_tile<TIn, D>(sQ, LD, q + qoff * D, r0, p.tq, kBQ);
    load_tile<TIn, D>(sdO, LD, dout + qoff * D, r0, p.tq, kBQ);
    for (int r = threadIdx.x; r < kBQ; r += kThreads) {
      sLse[r] = r0 + r < p.tq ? lse[qoff + r0 + r] : 0.f;
      sDelta[r] = r0 + r < p.tq ? delta[qoff + r0 + r] : 0.f;
    }
    __syncthreads();

    // S^T and dP^T: rows are this block's kv rows, columns the tile's q rows
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], w[4], b[4], g[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = sK[(ty * 4 + i) * LD + d];
        w[i] = sV[(ty * 4 + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = sQ[(tx + 16 * j) * LD + d];
        g[j] = sdO[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(b[j], a[i], s[i][j]);
          dp[i][j] = fmaf(g[j], w[i], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j;
        const float pij =
            visible(p, r0 + r, c0 + ty * 4 + i) ? expf(s[i][j] * p.scale - sLse[r]) : 0.f;
        sPt[(ty * 4 + i) * LT + r] = pij;
        sdSt[(ty * 4 + i) * LT + r] = pij * (dp[i][j] - sDelta[r]) * p.scale;
      }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < kBQ; ++r) {
      float pt[4], dst[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pt[i] = sPt[(ty * 4 + i) * LT + r];
        dst[i] = sdSt[(ty * 4 + i) * LT + r];
      }
#pragma unroll
      for (int jj = 0; jj < CPT; ++jj) {
        const float g = sdO[r * LD + tx + 16 * jj];
        const float qq = sQ[r * LD + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv_acc[i][jj] = fmaf(pt[i], g, dv_acc[i][jj]);
          dk_acc[i][jj] = fmaf(dst[i], qq, dk_acc[i][jj]);
        }
      }
    }
  }

  const int64_t koff = static_cast<int64_t>(bh) * p.tk;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ty * 4 + i;
    if (c >= p.tk) continue;
#pragma unroll
    for (int jj = 0; jj < CPT; ++jj) {
      dk[(koff + c) * D + tx + 16 * jj] = from_f32<TOut>(dk_acc[i][jj]);
      dv[(koff + c) * D + tx + 16 * jj] = from_f32<TOut>(dv_acc[i][jj]);
    }
  }
}

}  // namespace
}  // namespace bjx_flash

// Plain C entry points, loaded with ctypes.  q/dout: (bh, tq, d); k/v:
// (bh / h_q * h_kv, tk, d); lse/delta: (bh, tq) f32; dq: (bh, tq, d); dk/dv:
// (bh, tk, d), per q head.  in_kind/out_kind 0 = float32, 1 = bfloat16;
// window 0 = none.  Each launches on `stream` without synchronising and
// returns the launch's cudaError_t (0 on success).
extern "C" int bjx_flash_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq, int bh, int h_q,
                            int h_kv, int tq, int tk, int d, float scale, int causal, int window,
                            int q_offset, int in_kind, int out_kind, void* stream) {
  using namespace bjx_flash;
  if (bh <= 0 || tq <= 0) return 0;
  const Problem p{h_q, h_kv, tq, tk, scale, causal, window, q_offset};
  const dim3 grid((tq + kBQ - 1) / kBQ, bh);
  auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(d, in_kind, out_kind, [&](auto ti, auto to, auto dc) {
    using TIn = typename decltype(ti)::type;
    using TOut = typename decltype(to)::type;
    constexpr int D = decltype(dc)::value;
    return launch(flash_dq_kernel<TIn, TOut, D>, grid, dq_smem<D>(), s,
                  static_cast<const TIn*>(q), static_cast<const TIn*>(k),
                  static_cast<const TIn*>(v), static_cast<const TIn*>(dout),
                  static_cast<const float*>(lse), static_cast<const float*>(delta),
                  static_cast<TOut*>(dq), p);
  }));
}

extern "C" int bjx_flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv, int bh,
                             int h_q, int h_kv, int tq, int tk, int d, float scale, int causal,
                             int window, int q_offset, int in_kind, int out_kind, void* stream) {
  using namespace bjx_flash;
  if (bh <= 0 || tk <= 0) return 0;
  const Problem p{h_q, h_kv, tq, tk, scale, causal, window, q_offset};
  const dim3 grid((tk + kBK - 1) / kBK, bh);
  auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(d, in_kind, out_kind, [&](auto ti, auto to, auto dc) {
    using TIn = typename decltype(ti)::type;
    using TOut = typename decltype(to)::type;
    constexpr int D = decltype(dc)::value;
    return launch(flash_dkv_kernel<TIn, TOut, D>, grid, dkv_smem<D>(), s,
                  static_cast<const TIn*>(q), static_cast<const TIn*>(k),
                  static_cast<const TIn*>(v), static_cast<const TIn*>(dout),
                  static_cast<const float*>(lse), static_cast<const float*>(delta),
                  static_cast<TOut*>(dk), static_cast<TOut*>(dv), p);
  }));
}

// Fused streaming Kalman filter for Hopper (sm_90a): B independent chains
// filtered over a whole (T, dy, B) observation stream in one launch.
//
// Replaces the TPU kernel `_filter_kernel` of
// rxinfer_tpu/ops/pallas_filter.py (lines 84-144).  The arithmetic is the
// step of rxinfer_tpu_torch/ops/fused_filter.py (`filter_step`, built from
// ops/entrywise.py), in the same order, on per-thread registers; the
// small-matrix helpers are those of smallmat.cuh, shared with the smoother.
//
// Per step (information form; unlike the smoother's forward kernel there is
// no bias, the evidence vector is formed here from the raw observation, and
// the transition is applied at EVERY step, t = 0 included):
//   xi = HR y_t                                   HR = H^T R^-1, (D, DY)
//   m_pred = F m ; P_pred = F P F^T + Q
//   L = P_pred^-1 ; P = (L + W)^-1 ; m = P (L m_pred + xi)
// L + W is formed on the upper triangle and mirrored before the second
// inverse, as the plain version does.
//
// Design: one thread per chain, the time loop inside the kernel, the chain
// state (D means + D(D+1)/2 covariance entries) in registers for the whole
// stream.  This takes the place of the TPU's sequential time grid with the
// state pinned in fast memory.  D and DY are template parameters (1..8
// each) so every index is a compile-time constant.  F, Q, W and HR are
// shared by all chains and steps and are passed by value in the kernel's
// parameter block (constant bank, uniform across threads).  The kernel loops
// to T exactly, so there is no time padding and no mask; the ragged batch
// edge is masked with b < B.
//
// Layout: struct of arrays, batch minor, so neighbouring threads touch
// neighbouring addresses: ys (T, DY, B), m0 (D, B), p0 (NS, B) upper
// triangle row by row, NS = D(D+1)/2; out means (T, D, B), mf (D, B),
// pf (NS, B).
//
// Bound on the card: at B = 10,000, T = 200, D = DY = 4 the kernel moves
// 65 MB (observations in, means out) for ~0.5 kFLOP per chain-step, so
// bytes bound it on paper (0.019 ms).  In practice a step is serial: the
// batch fills 313 warps, at most one a scheduler, and a lone warp's step
// takes ~1,000 cycles of dependent work while the memory system answers
// the observation loads issued one step ahead in about as long.  Taking out
// either alone barely moves the time, and spreading a chain's step over
// several lanes of a warp was slower at this batch (PERF.md, Findings).
// The next step's observation is loaded before the current step is
// computed so that no global load sits on the dependency chain.

#include <cuda_runtime.h>

#include <stdint.h>

#include "smallmat.cuh"

namespace {

using namespace rxt;

template <int D, int DY>
struct FilterParams {
  float F[D][D];
  float Q[D][D];
  float W[D][D];
  float HR[D][DY];
};

template <int D, int DY>
__global__ void filter_kernel(const float* __restrict__ ys,
                              const float* __restrict__ m0,
                              const float* __restrict__ p0,
                              float* __restrict__ means,
                              float* __restrict__ mf, float* __restrict__ pf,
                              int64_t T, int64_t B,
                              const FilterParams<D, DY> prm) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;

  float m[D], p[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i) m[i] = m0[i * B + b];
  load_packed<D>(p0 + b, B, p);

  float ycur[DY], ynext[DY];
#pragma unroll
  for (int k = 0; k < DY; ++k) ycur[k] = T > 0 ? ys[k * B + b] : 0.0f;

  for (int64_t t = 0; t < T; ++t) {
    if (t + 1 < T) {
#pragma unroll
      for (int k = 0; k < DY; ++k) ynext[k] = ys[((t + 1) * DY + k) * B + b];
    }
    float xi[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float s = prm.HR[i][0] * ycur[0];
#pragma unroll
      for (int k = 1; k < DY; ++k) s += prm.HR[i][k] * ycur[k];
      xi[i] = s;
    }
    float m_pred[D], p_pred[D][D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float s = prm.F[i][0] * m[0];
#pragma unroll
      for (int j = 1; j < D; ++j) s += prm.F[i][j] * m[j];
      m_pred[i] = s;
    }
    sandwich_sym<D>(prm.F, p, prm.Q, p_pred);
    float lam[D][D];
    sym_inv_scaled<D>(p_pred, lam);
    float w_post[D][D];
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = i; j < D; ++j) {
        w_post[i][j] = lam[i][j] + prm.W[i][j];
        w_post[j][i] = w_post[i][j];
      }
    sym_inv_scaled<D>(w_post, p);
    float h[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float s = lam[i][0] * m_pred[0];
#pragma unroll
      for (int j = 1; j < D; ++j) s += lam[i][j] * m_pred[j];
      h[i] = s + xi[i];
    }
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float s = p[i][0] * h[0];
#pragma unroll
      for (int j = 1; j < D; ++j) s += p[i][j] * h[j];
      m[i] = s;
    }
#pragma unroll
    for (int i = 0; i < D; ++i) means[(t * D + i) * B + b] = m[i];
#pragma unroll
    for (int k = 0; k < DY; ++k) ycur[k] = ynext[k];
  }

#pragma unroll
  for (int i = 0; i < D; ++i) mf[i * B + b] = m[i];
  store_packed<D>(pf + b, B, p);
}

// 64 threads a block: at B = 10,000 that is 157 blocks, more than the card's
// 132 SMs, so every SM gets work; each warp is latency-bound on its own.
constexpr int kThreads = 64;

template <int D, int DY>
int launch(const float* ys, const float* m0, const float* p0, float* means,
           float* mf, float* pf, int64_t T, int64_t B, const float* F,
           const float* Q, const float* W, const float* HR,
           cudaStream_t stream) {
  FilterParams<D, DY> prm;
  for (int i = 0; i < D; ++i) {
    for (int j = 0; j < D; ++j) {
      prm.F[i][j] = F[i * D + j];
      prm.Q[i][j] = Q[i * D + j];
      prm.W[i][j] = W[i * D + j];
    }
    for (int k = 0; k < DY; ++k) prm.HR[i][k] = HR[i * DY + k];
  }
  const unsigned blocks = static_cast<unsigned>((B + kThreads - 1) / kThreads);
  filter_kernel<D, DY><<<blocks, kThreads, 0, stream>>>(
      ys, m0, p0, means, mf, pf, T, B, prm);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dy(int dy, const float* ys, const float* m0, const float* p0,
              float* means, float* mf, float* pf, int64_t T, int64_t B,
              const float* F, const float* Q, const float* W, const float* HR,
              cudaStream_t s) {
  switch (dy) {
    case 1: return launch<D, 1>(ys, m0, p0, means, mf, pf, T, B, F, Q, W, HR, s);
    case 2: return launch<D, 2>(ys, m0, p0, means, mf, pf, T, B, F, Q, W, HR, s);
    case 3: return launch<D, 3>(ys, m0, p0, means, mf, pf, T, B, F, Q, W, HR, s);
    case 4: return launch<D, 4>(ys, m0, p0, means, mf, pf, T, B, F, Q, W, HR, s);
    case 5: return launch<D, 5>(ys, m0, p0, means, mf, pf, T, B, F, Q, W, HR, s);
    case 6: return launch<D, 6>(ys, m0, p0, means, mf, pf, T, B, F, Q, W, HR, s);
    case 7: return launch<D, 7>(ys, m0, p0, means, mf, pf, T, B, F, Q, W, HR, s);
    case 8: return launch<D, 8>(ys, m0, p0, means, mf, pf, T, B, F, Q, W, HR, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = success).  F, Q, W are
// host (d, d) row-major, HR host (d, dy) row-major; the rest device pointers.
int rxt_fused_filter(int d, int dy, const float* ys, const float* m0,
                     const float* p0, float* means, float* mf, float* pf,
                     int64_t T, int64_t B, const float* F, const float* Q,
                     const float* W, const float* HR, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: return launch_dy<1>(dy, ys, m0, p0, means, mf, pf, T, B, F, Q, W, HR, s);
    case 2: return launch_dy<2>(dy, ys, m0, p0, means, mf, pf, T, B, F, Q, W, HR, s);
    case 3: return launch_dy<3>(dy, ys, m0, p0, means, mf, pf, T, B, F, Q, W, HR, s);
    case 4: return launch_dy<4>(dy, ys, m0, p0, means, mf, pf, T, B, F, Q, W, HR, s);
    case 5: return launch_dy<5>(dy, ys, m0, p0, means, mf, pf, T, B, F, Q, W, HR, s);
    case 6: return launch_dy<6>(dy, ys, m0, p0, means, mf, pf, T, B, F, Q, W, HR, s);
    case 7: return launch_dy<7>(dy, ys, m0, p0, means, mf, pf, T, B, F, Q, W, HR, s);
    case 8: return launch_dy<8>(dy, ys, m0, p0, means, mf, pf, T, B, F, Q, W, HR, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* rxt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Fused batched Kalman (RTS) smoother for Hopper (sm_90a): a forward
// information-form filter kernel and a backward RTS kernel.
//
// Replaces the TPU kernels `_fwd_kernel` and `_bwd_kernel` of
// rxinfer_tpu/ops/pallas_smoother.py (lines 76-136 and 139-203).  The
// arithmetic is that of rxinfer_tpu_torch/ops/entrywise.py (sandwich_sym,
// sym_inv_scaled: unpivoted Schur recursion split at k = d/2 with
// mean-|diagonal| scaling), in the same order, on per-thread registers; the
// device helpers live in smallmat.cuh, shared with fused_filter.cu.
//
// Design: one thread per chain, the whole time loop inside the kernel, the
// chain state (d means + d(d+1)/2 covariance entries) in registers.  This
// takes the place of the TPU's sequential time grid with VMEM-resident state.
// D is a template parameter (1..8) so every matrix index is a compile-time
// constant after unrolling and the arrays below live in registers.  F, b, Q
// and W are shared by all chains and all steps: they are passed by value in
// the kernel's parameter block (constant bank, uniform across threads).
// The ragged batch edge is masked with b < B; there is no padding.
//
// Layouts.  Inputs in the wrapper's contract layout: xi (T, B, D),
// m0 (B, D), p0 (B, D, D).  Moments in struct-of-arrays layout, batch
// minor, so that neighbouring threads touch neighbouring addresses:
//   forward  out: mf (T, D, B), pf (T, NS, B)          NS = D(D+1)/2
//   backward out: ms (T, D, B), ps (T, NS, B), cross (T-1, D*D, B)
// pf/ps hold the upper triangle row by row ((0,0), (0,1), ..., (D-1,D-1));
// cross[t] = G_t P_s[t+1] = Cov(x_t, x_{t+1}), row-major.
//
// Bound on the card: the bytes.  At B=1024, T=10k, D=4 the forward kernel
// moves 0.74 GB and the backward 1.80 GB, for ~1.2 kFLOP per chain-step;
// both are HBM-bound on paper.  With one thread per chain, B=1024 fills a
// small fraction of the card's thread slots, so in practice each step's
// latency (a dependent chain of ~1k FLOPs, two divisions per inverse level)
// bounds the kernel, not bandwidth.  The next step's inputs are loaded
// before the current step is computed so that no global load sits on the
// serial dependency chain.

#include <cuda_runtime.h>

#include <stdint.h>

#include "smallmat.cuh"

namespace {

using namespace rxt;

template <int D>
struct Params {
  float F[D][D];
  float b[D];
  float Q[D][D];
  float W[D][D];
};

// ---- K1: forward information-form filter ----------------------------------
//   m_pred = F m + b ; P_pred = F P F^T + Q        (no transition at t = 0)
//   L = P_pred^-1 ; P = (L + W)^-1 ; m = P (L m_pred + xi_t)
template <int D>
__global__ void fwd_kernel(const float* __restrict__ xi,
                           const float* __restrict__ m0,
                           const float* __restrict__ p0,
                           float* __restrict__ mf, float* __restrict__ pf,
                           int64_t T, int64_t B, const Params<D> prm) {
  constexpr int NS = D * (D + 1) / 2;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;

  float m[D], p[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i) m[i] = m0[b * D + i];
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = i; j < D; ++j) {
      p[i][j] = p0[(b * D + i) * D + j];
      p[j][i] = p[i][j];
    }

  float xcur[D], xnext[D];
#pragma unroll
  for (int k = 0; k < D; ++k) xcur[k] = xi[b * D + k];

  for (int64_t t = 0; t < T; ++t) {
    if (t + 1 < T) {
#pragma unroll
      for (int k = 0; k < D; ++k) xnext[k] = xi[((t + 1) * B + b) * D + k];
    }
    float m_pred[D], p_pred[D][D];
    if (t == 0) {
#pragma unroll
      for (int i = 0; i < D; ++i) {
        m_pred[i] = m[i];
#pragma unroll
        for (int j = 0; j < D; ++j) p_pred[i][j] = p[i][j];
      }
    } else {
#pragma unroll
      for (int i = 0; i < D; ++i) {
        float s = prm.F[i][0] * m[0];
#pragma unroll
        for (int j = 1; j < D; ++j) s += prm.F[i][j] * m[j];
        m_pred[i] = s + prm.b[i];
      }
      sandwich_sym<D>(prm.F, p, prm.Q, p_pred);
    }
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
      h[i] = s + xcur[i];
    }
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float s = p[i][0] * h[0];
#pragma unroll
      for (int j = 1; j < D; ++j) s += p[i][j] * h[j];
      m[i] = s;
    }
#pragma unroll
    for (int i = 0; i < D; ++i) mf[(t * D + i) * B + b] = m[i];
    store_packed<D>(pf + t * NS * B + b, B, p);
#pragma unroll
    for (int k = 0; k < D; ++k) xcur[k] = xnext[k];
  }
}

// ---- K2: backward RTS pass --------------------------------------------------
//   P_pred = F P_f F^T + Q ; G = P_f F^T P_pred^-1
//   m_s = m_f + G (m_s' - F m_f - b) ; P_s = P_f + G (P_s' - P_pred) G^T
//   cross_t = G P_s'                  (smoothed == filtered at t = T-1)
template <int D>
__global__ void bwd_kernel(const float* __restrict__ mf,
                           const float* __restrict__ pf,
                           float* __restrict__ ms, float* __restrict__ ps,
                           float* __restrict__ cross, int64_t T, int64_t B,
                           const Params<D> prm) {
  constexpr int NS = D * (D + 1) / 2;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;

  float m_s[D], p_s[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i) m_s[i] = mf[((T - 1) * D + i) * B + b];
  load_packed<D>(pf + (T - 1) * NS * B + b, B, p_s);
#pragma unroll
  for (int i = 0; i < D; ++i) ms[((T - 1) * D + i) * B + b] = m_s[i];
  store_packed<D>(ps + (T - 1) * NS * B + b, B, p_s);
  if (T < 2) return;

  float mcur[D], pcur[NS], mnext[D], pnext[NS];
#pragma unroll
  for (int i = 0; i < D; ++i) mcur[i] = mf[((T - 2) * D + i) * B + b];
#pragma unroll
  for (int k = 0; k < NS; ++k) pcur[k] = pf[((T - 2) * NS + k) * B + b];

  for (int64_t t = T - 2; t >= 0; --t) {
    if (t > 0) {
#pragma unroll
      for (int i = 0; i < D; ++i) mnext[i] = mf[((t - 1) * D + i) * B + b];
#pragma unroll
      for (int k = 0; k < NS; ++k) pnext[k] = pf[((t - 1) * NS + k) * B + b];
    }
    float m_f[D], p_f[D][D];
#pragma unroll
    for (int i = 0; i < D; ++i) m_f[i] = mcur[i];
    {
      int k = 0;
#pragma unroll
      for (int i = 0; i < D; ++i)
#pragma unroll
        for (int j = i; j < D; ++j) {
          p_f[i][j] = pcur[k];
          p_f[j][i] = pcur[k];
          ++k;
        }
    }
    float p_pred[D][D];
    sandwich_sym<D>(prm.F, p_f, prm.Q, p_pred);
    float pft[D][D];  // P_f F^T
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) {
        float s = p_f[i][0] * prm.F[j][0];
#pragma unroll
        for (int k = 1; k < D; ++k) s += p_f[i][k] * prm.F[j][k];
        pft[i][j] = s;
      }
    float pinv[D][D];
    sym_inv_scaled<D>(p_pred, pinv);
    float g[D][D];
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) {
        float s = pft[i][0] * pinv[0][j];
#pragma unroll
        for (int k = 1; k < D; ++k) s += pft[i][k] * pinv[k][j];
        g[i][j] = s;
      }
    float diff[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float s = prm.F[i][0] * m_f[0];
#pragma unroll
      for (int j = 1; j < D; ++j) s += prm.F[i][j] * m_f[j];
      diff[i] = m_s[i] - (s + prm.b[i]);
    }
    float m_new[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float s = g[i][0] * diff[0];
#pragma unroll
      for (int j = 1; j < D; ++j) s += g[i][j] * diff[j];
      m_new[i] = m_f[i] + s;
    }
    float gd[D][D];  // G (P_s' - P_pred)
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) {
        float s = g[i][0] * (p_s[0][j] - p_pred[0][j]);
#pragma unroll
        for (int k = 1; k < D; ++k) s += g[i][k] * (p_s[k][j] - p_pred[k][j]);
        gd[i][j] = s;
      }
    float* cr = cross + t * (D * D) * B + b;
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) {
        float s = g[i][0] * p_s[0][j];
#pragma unroll
        for (int k = 1; k < D; ++k) s += g[i][k] * p_s[k][j];
        cr[(i * D + j) * B] = s;
      }
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = i; j < D; ++j) {
        float s = gd[i][0] * g[j][0];
#pragma unroll
        for (int k = 1; k < D; ++k) s += gd[i][k] * g[j][k];
        p_s[i][j] = p_f[i][j] + s;
        p_s[j][i] = p_s[i][j];
      }
#pragma unroll
    for (int i = 0; i < D; ++i) m_s[i] = m_new[i];
#pragma unroll
    for (int i = 0; i < D; ++i) ms[(t * D + i) * B + b] = m_s[i];
    store_packed<D>(ps + t * NS * B + b, B, p_s);
#pragma unroll
    for (int i = 0; i < D; ++i) mcur[i] = mnext[i];
#pragma unroll
    for (int k = 0; k < NS; ++k) pcur[k] = pnext[k];
  }
}

constexpr int kThreads = 128;

template <int D>
Params<D> make_params(const float* F, const float* bvec, const float* Q,
                      const float* W) {
  Params<D> prm;
  for (int i = 0; i < D; ++i) {
    prm.b[i] = bvec[i];
    for (int j = 0; j < D; ++j) {
      prm.F[i][j] = F[i * D + j];
      prm.Q[i][j] = Q[i * D + j];
      prm.W[i][j] = W[i * D + j];
    }
  }
  return prm;
}

template <int D>
int launch_fwd(const float* xi, const float* m0, const float* p0, float* mf,
               float* pf, int64_t T, int64_t B, const float* F,
               const float* bvec, const float* Q, const float* W,
               cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((B + kThreads - 1) / kThreads);
  fwd_kernel<D><<<blocks, kThreads, 0, stream>>>(
      xi, m0, p0, mf, pf, T, B, make_params<D>(F, bvec, Q, W));
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd(const float* mf, const float* pf, float* ms, float* ps,
               float* cross, int64_t T, int64_t B, const float* F,
               const float* bvec, const float* Q, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((B + kThreads - 1) / kThreads);
  bwd_kernel<D><<<blocks, kThreads, 0, stream>>>(
      mf, pf, ms, ps, cross, T, B, make_params<D>(F, bvec, Q, Q));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each launcher returns cudaGetLastError() after its launch (0 = success).
int rxt_fused_smoother_fwd(int d, const float* xi, const float* m0,
                           const float* p0, float* mf, float* pf, int64_t T,
                           int64_t B, const float* F, const float* bvec,
                           const float* Q, const float* W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: return launch_fwd<1>(xi, m0, p0, mf, pf, T, B, F, bvec, Q, W, s);
    case 2: return launch_fwd<2>(xi, m0, p0, mf, pf, T, B, F, bvec, Q, W, s);
    case 3: return launch_fwd<3>(xi, m0, p0, mf, pf, T, B, F, bvec, Q, W, s);
    case 4: return launch_fwd<4>(xi, m0, p0, mf, pf, T, B, F, bvec, Q, W, s);
    case 5: return launch_fwd<5>(xi, m0, p0, mf, pf, T, B, F, bvec, Q, W, s);
    case 6: return launch_fwd<6>(xi, m0, p0, mf, pf, T, B, F, bvec, Q, W, s);
    case 7: return launch_fwd<7>(xi, m0, p0, mf, pf, T, B, F, bvec, Q, W, s);
    case 8: return launch_fwd<8>(xi, m0, p0, mf, pf, T, B, F, bvec, Q, W, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int rxt_fused_smoother_bwd(int d, const float* mf, const float* pf, float* ms,
                           float* ps, float* cross, int64_t T, int64_t B,
                           const float* F, const float* bvec, const float* Q,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: return launch_bwd<1>(mf, pf, ms, ps, cross, T, B, F, bvec, Q, s);
    case 2: return launch_bwd<2>(mf, pf, ms, ps, cross, T, B, F, bvec, Q, s);
    case 3: return launch_bwd<3>(mf, pf, ms, ps, cross, T, B, F, bvec, Q, s);
    case 4: return launch_bwd<4>(mf, pf, ms, ps, cross, T, B, F, bvec, Q, s);
    case 5: return launch_bwd<5>(mf, pf, ms, ps, cross, T, B, F, bvec, Q, s);
    case 6: return launch_bwd<6>(mf, pf, ms, ps, cross, T, B, F, bvec, Q, s);
    case 7: return launch_bwd<7>(mf, pf, ms, ps, cross, T, B, F, bvec, Q, s);
    case 8: return launch_bwd<8>(mf, pf, ms, ps, cross, T, B, F, bvec, Q, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* rxt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Batched HMM forward-backward for Hopper (sm_90a): a log-space forward
// kernel and a backward kernel that emits singleton and pairwise marginals.
//
// Replaces the TPU kernels `_fb_fwd_kernel` and `_fb_bwd_kernel` of
// rxinfer_tpu/ops/pallas_discrete.py (lines 48-84 and 87-167).  The
// arithmetic is that of the plain versions in
// rxinfer_tpu_torch/ops/fused_fb.py (forward_step, backward_step), which
// repeat the TPU kernels' order: log-sum-exp takes the running maximum
// first, then the sum of exp(t - m) in index order, then m + log(s); alpha
// and beta are max-normalised each step; xi takes its maximum over (i, j)
// in row-major order and divides by the sum of its row sums.
//
// Convention: logA[i][j] = E[log p(s_{t+1} = i | s_t = j)] ([out, in]);
// xi_t[i][j] = q(s_{t+1} = i, s_t = j).
//
// Design: one thread per chain, the whole time loop inside the kernel, K (the
// number of states, 1..8) a template parameter so that every state index is
// a compile-time constant after unrolling and the per-chain K x K table,
// alpha, beta and the xi accumulators live in registers.  This takes the
// place of the TPU's sequential time grid with VMEM-resident carries and of
// its time padding (no t_pad, live or dead masks).  The ragged batch edge is
// masked with b < B; there is no padding.  Each step loads the next step's
// inputs before computing the current one, so that no global load sits on
// the serial dependency chain.
//
// Layouts (the engine's own, so the wrapper adds no copies):
//   forward  in:  log_prior (B, K), log_trans (B, K, K), log_evidence (T, B, K)
//            out: alphas (T, B, K) max-normalised, logz (B)
//   backward in:  log_trans (B, K, K), log_evidence (T, B, K), alphas
//            out: gammas (T, B, K), xi_sum (B, K, K) and, when asked,
//                 xi_steps (T-1, B, K, K)
// With one thread per chain, neighbouring threads read and write
// neighbouring K-float (or K*K-float) records, so every (T, B, ...) stream is
// coalesced across a warp.
//
// Bound on the card: at the HMM bench size (B=256, T=200, K=3) the forward
// kernel moves 1.2 MB and the backward 3.7 MB, under 2 us at the HBM rate,
// and the arithmetic (~50 and ~110 operations per chain-step, a fifth of
// them exp/log) is far below the float32 rate.  What bounds the kernels is
// the serial chain of T dependent steps of one thread, each a few exp/log
// latencies deep, with 256 threads occupying 2 of 132 SMs.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

// log-sum-exp of N terms in the TPU kernel's order.
template <int N>
__device__ __forceinline__ float lse(const float (&t)[N]) {
  float m = t[0];
#pragma unroll
  for (int i = 1; i < N; ++i) m = fmaxf(m, t[i]);
  float s = expf(t[0] - m);
#pragma unroll
  for (int i = 1; i < N; ++i) s += expf(t[i] - m);
  return m + logf(s);
}

// ---- K4: forward pass ------------------------------------------------------
//   alpha_0 = log_prior + le_0
//   alpha_t[i] = lse_j(logA[i][j] + alpha_{t-1}[j]) + le_t[i]
//   each step: m = max_i alpha_t[i]; alpha_t -= m; cum += m
//   logz = cum + m' + log(sum_i exp(alpha_{T-1}[i] - m'))
template <int K>
__global__ void fb_fwd_kernel(const float* __restrict__ lp,
                              const float* __restrict__ lt,
                              const float* __restrict__ le,
                              float* __restrict__ alphas,
                              float* __restrict__ logz, int64_t T, int64_t B) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;

  float a[K], A[K][K];
#pragma unroll
  for (int i = 0; i < K; ++i) a[i] = lp[b * K + i];
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < K; ++j) A[i][j] = lt[(b * K + i) * K + j];

  float lcur[K], lnext[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    lcur[i] = le[b * K + i];
    lnext[i] = 0.0f;
  }
  float cum = 0.0f;

  for (int64_t t = 0; t < T; ++t) {
    if (t + 1 < T) {
#pragma unroll
      for (int i = 0; i < K; ++i) lnext[i] = le[((t + 1) * B + b) * K + i];
    }
    float an[K];
    if (t == 0) {
#pragma unroll
      for (int i = 0; i < K; ++i) an[i] = a[i] + lcur[i];
    } else {
#pragma unroll
      for (int i = 0; i < K; ++i) {
        float terms[K];
#pragma unroll
        for (int j = 0; j < K; ++j) terms[j] = A[i][j] + a[j];
        an[i] = lse<K>(terms) + lcur[i];
      }
    }
    float m = an[0];
#pragma unroll
    for (int i = 1; i < K; ++i) m = fmaxf(m, an[i]);
#pragma unroll
    for (int i = 0; i < K; ++i) a[i] = an[i] - m;
    cum = cum + m;
    float* out = alphas + (t * B + b) * K;
#pragma unroll
    for (int i = 0; i < K; ++i) out[i] = a[i];
#pragma unroll
    for (int i = 0; i < K; ++i) lcur[i] = lnext[i];
  }
  float m = a[0];
#pragma unroll
  for (int i = 1; i < K; ++i) m = fmaxf(m, a[i]);
  float s = expf(a[0] - m);
#pragma unroll
  for (int i = 1; i < K; ++i) s += expf(a[i] - m);
  logz[b] = cum + m + logf(s);
}

// ---- K5: backward pass and marginals ---------------------------------------
// For t = T-1 down to 0, with beta_{T-1} = 0 and, for t < T-1,
//   s[i][j]     = logA[i][j] + le_{t+1}[i] + beta_{t+1}[i]
//   beta_t[j]   = lse_i(s[i][j]), max-normalised over j
//   gamma_t     = softmax(alpha_t + beta_t)
//   xi_t[i][j]  = softmax_ij(alpha_t[j] + s[i][j])      (none at t = T-1)
//   xi_sum     += xi_t
// STEPS also writes each xi_t to xi_steps[t].
template <int K, bool STEPS>
__global__ void fb_bwd_kernel(const float* __restrict__ lt,
                              const float* __restrict__ le,
                              const float* __restrict__ alphas,
                              float* __restrict__ gammas,
                              float* __restrict__ xi_sum,
                              float* __restrict__ xi_steps, int64_t T,
                              int64_t B) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;

  float A[K][K], acc[K][K];
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < K; ++j) {
      A[i][j] = lt[(b * K + i) * K + j];
      acc[i][j] = 0.0f;
    }
  float beta[K], lnx[K];  // beta_{t+1}, le_{t+1}
#pragma unroll
  for (int i = 0; i < K; ++i) {
    beta[i] = 0.0f;
    lnx[i] = 0.0f;
  }
  float acur[K], lcur[K], anext[K], lnext[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    acur[i] = alphas[((T - 1) * B + b) * K + i];
    lcur[i] = le[((T - 1) * B + b) * K + i];
    anext[i] = 0.0f;
    lnext[i] = 0.0f;
  }

  for (int64_t t = T - 1; t >= 0; --t) {
    if (t > 0) {
#pragma unroll
      for (int i = 0; i < K; ++i) {
        anext[i] = alphas[((t - 1) * B + b) * K + i];
        lnext[i] = le[((t - 1) * B + b) * K + i];
      }
    }
    const bool last = t == T - 1;
    float bn[K];
    if (last) {
#pragma unroll
      for (int j = 0; j < K; ++j) bn[j] = 0.0f;
    } else {
      float braw[K];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        float terms[K];
#pragma unroll
        for (int i = 0; i < K; ++i) terms[i] = A[i][j] + lnx[i] + beta[i];
        braw[j] = lse<K>(terms);
      }
      float mb = braw[0];
#pragma unroll
      for (int j = 1; j < K; ++j) mb = fmaxf(mb, braw[j]);
#pragma unroll
      for (int j = 0; j < K; ++j) bn[j] = braw[j] - mb;
    }

    // gamma_t = softmax(alpha_t + beta_t)
    float g[K];
#pragma unroll
    for (int i = 0; i < K; ++i) g[i] = acur[i] + bn[i];
    float mg = g[0];
#pragma unroll
    for (int i = 1; i < K; ++i) mg = fmaxf(mg, g[i]);
#pragma unroll
    for (int i = 0; i < K; ++i) g[i] = expf(g[i] - mg);
    float gs = g[0];
#pragma unroll
    for (int i = 1; i < K; ++i) gs += g[i];
    float* gout = gammas + (t * B + b) * K;
#pragma unroll
    for (int i = 0; i < K; ++i) gout[i] = g[i] / gs;

    if (!last) {
      // xi_t: the exponentials are recomputed in the second pass rather than
      // kept, which saves K*K registers (exp is deterministic, so both passes
      // see the same values)
      float mx = acur[0] + (A[0][0] + lnx[0] + beta[0]);
#pragma unroll
      for (int i = 0; i < K; ++i)
#pragma unroll
        for (int j = 0; j < K; ++j)
          mx = fmaxf(mx, acur[j] + (A[i][j] + lnx[i] + beta[i]));
      float xs = 0.0f;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        float rs = expf(acur[0] + (A[i][0] + lnx[i] + beta[i]) - mx);
#pragma unroll
        for (int j = 1; j < K; ++j)
          rs += expf(acur[j] + (A[i][j] + lnx[i] + beta[i]) - mx);
        xs = i == 0 ? rs : xs + rs;
      }
      float* xout = STEPS ? xi_steps + (t * B + b) * (K * K) : nullptr;
#pragma unroll
      for (int i = 0; i < K; ++i)
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const float v =
              expf(acur[j] + (A[i][j] + lnx[i] + beta[i]) - mx) / xs;
          acc[i][j] += v;
          if (STEPS) xout[i * K + j] = v;
        }
    }

#pragma unroll
    for (int i = 0; i < K; ++i) {
      beta[i] = bn[i];
      lnx[i] = lcur[i];
      acur[i] = anext[i];
      lcur[i] = lnext[i];
    }
  }
  float* xsum = xi_sum + b * (K * K);
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < K; ++j) xsum[i * K + j] = acc[i][j];
}

constexpr int kThreads = 128;

unsigned blocks_for(int64_t B) {
  return static_cast<unsigned>((B + kThreads - 1) / kThreads);
}

template <int K>
int launch_fwd(const float* lp, const float* lt, const float* le,
               float* alphas, float* logz, int64_t T, int64_t B,
               cudaStream_t stream) {
  fb_fwd_kernel<K><<<blocks_for(B), kThreads, 0, stream>>>(lp, lt, le, alphas,
                                                           logz, T, B);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int launch_bwd(bool steps, const float* lt, const float* le,
               const float* alphas, float* gammas, float* xi_sum,
               float* xi_steps, int64_t T, int64_t B, cudaStream_t stream) {
  if (steps) {
    fb_bwd_kernel<K, true><<<blocks_for(B), kThreads, 0, stream>>>(
        lt, le, alphas, gammas, xi_sum, xi_steps, T, B);
  } else {
    fb_bwd_kernel<K, false><<<blocks_for(B), kThreads, 0, stream>>>(
        lt, le, alphas, gammas, xi_sum, xi_steps, T, B);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each launcher returns cudaGetLastError() after its launch (0 = success).
int rxt_fb_fwd(int k, const float* lp, const float* lt, const float* le,
               float* alphas, float* logz, int64_t T, int64_t B,
               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch_fwd<1>(lp, lt, le, alphas, logz, T, B, s);
    case 2: return launch_fwd<2>(lp, lt, le, alphas, logz, T, B, s);
    case 3: return launch_fwd<3>(lp, lt, le, alphas, logz, T, B, s);
    case 4: return launch_fwd<4>(lp, lt, le, alphas, logz, T, B, s);
    case 5: return launch_fwd<5>(lp, lt, le, alphas, logz, T, B, s);
    case 6: return launch_fwd<6>(lp, lt, le, alphas, logz, T, B, s);
    case 7: return launch_fwd<7>(lp, lt, le, alphas, logz, T, B, s);
    case 8: return launch_fwd<8>(lp, lt, le, alphas, logz, T, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// xi_steps may be null when per_step is 0.
int rxt_fb_bwd(int k, int per_step, const float* lt, const float* le,
               const float* alphas, float* gammas, float* xi_sum,
               float* xi_steps, int64_t T, int64_t B, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool st = per_step != 0;
  switch (k) {
    case 1: return launch_bwd<1>(st, lt, le, alphas, gammas, xi_sum, xi_steps, T, B, s);
    case 2: return launch_bwd<2>(st, lt, le, alphas, gammas, xi_sum, xi_steps, T, B, s);
    case 3: return launch_bwd<3>(st, lt, le, alphas, gammas, xi_sum, xi_steps, T, B, s);
    case 4: return launch_bwd<4>(st, lt, le, alphas, gammas, xi_sum, xi_steps, T, B, s);
    case 5: return launch_bwd<5>(st, lt, le, alphas, gammas, xi_sum, xi_steps, T, B, s);
    case 6: return launch_bwd<6>(st, lt, le, alphas, gammas, xi_sum, xi_steps, T, B, s);
    case 7: return launch_bwd<7>(st, lt, le, alphas, gammas, xi_sum, xi_steps, T, B, s);
    case 8: return launch_bwd<8>(st, lt, le, alphas, gammas, xi_sum, xi_steps, T, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* rxt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Fused batched Kalman (RTS) smoother for Hopper (sm_90a): a forward
// information-form filter (K1) and a backward RTS pass (K2), each as three
// passes over blocks of time: fold, carry, replay.  The kernels and their
// launchers; fused_smoother.cu (float32 moments) and fused_smoother_bf16.cu
// (bf16 moments) each build them for one storage type into a library.
//
// Replaces the TPU kernels `_fwd_kernel` and `_bwd_kernel` of
// rxinfer_tpu/ops/pallas_smoother.py (lines 76-136 and 139-203).  The step
// arithmetic is that of rxinfer_tpu_torch/ops/entrywise.py (sandwich_sym,
// sym_inv_scaled: unpivoted Schur recursion split at k = d/2 with
// mean-|diagonal| scaling), in the same order, on per-thread registers; the
// device helpers live in smallmat.cuh, shared with fused_filter.cu.
//
// What bounds the kernels on an H100: the latency of one step.  By bytes
// both are HBM-bound on paper (at B=1024, T=10k, D=4 the forward pass must
// move 0.74 GB and the backward 1.80 GB, for ~1.2 kFLOP per chain-step), but
// a step is a dependent chain of about a thousand operations with IEEE
// divisions at each level of the inverses, and with one thread per chain
// 1,024 chains are 32 warps on a card with 528 warp schedulers: 8 of 132
// SMs, one warp each, nothing to hide the chain behind.  That design took
// 0.55 us (K1) and 0.64 us (K2) a step, 5.5 and 6.4 ms in all.
//
// Design: the batch cannot supply more threads, so the time axis does.  T is
// cut into S blocks of L steps (the last one ragged) and a thread owns one
// (chain, block) pair; blockIdx.y is the time block and threads are batch
// minor, so every load and store stays coalesced.
//   fold    B (S-1) threads.  Each composes the associative elements of its
//           block (rxinfer_tpu/ops/kalman.py: the filtering elements
//           (A, b, C, eta, J) of Sarkka and Garcia-Fernandez with offsets,
//           the RTS elements (E, g, L)) into one composite, step by step,
//           and stores it in the scratch tensor (S, rows, B).
//   carry   B threads.  Each applies the S-1 composites in order (front to
//           back for K1, back to front for K2) and leaves every block's
//           entry state in the scratch.
//   replay  B S threads.  Each runs the step recursion (fwd_step, bwd_step)
//           over its block from the entry state and writes the moments.
// Inside a block the result differs from the one-block recursion only
// through the entry state.  With S = 1 the replay kernel alone runs, in its
// BLOCKED = false instantiation: the one-thread-per-chain recursion with
// the block arithmetic compiled out, which is what a batch that fills the
// card by itself takes (at D = 8 it has no register to spare for more).
// The wrapper picks S (ops/fused_smoother.py pick_blocks).
// The fold re-reads xi (K1) or mf, pf (K2), and costs about 3 (K1) or 1.3
// (K2) steps per step; the inputs of the next step are loaded before the
// current step is computed in every pass, so no global load sits on the
// dependency chain.
//
// D is a template parameter (1..8) so every matrix index is a compile-time
// constant after unrolling and the arrays live in registers.  The fold and
// carry kernels are instantiated for D <= kFoldMaxDim = 5: a fold thread
// carries a whole composite (D*D + 2 D + D (D + 1) floats forward) beside
// the inverse's temporaries, and from D = 6 up ptxas spills (K1 fold: 112
// bytes at D = 6, 2,304 at D = 8).  For D in 6..8 the launchers take S = 1.
// F, b, Q and W are shared by all chains and all steps: they are passed by
// value in the kernel's parameter block (constant bank, uniform across
// threads).  The ragged batch edge is masked with b < B; there is no padding.
//
// Per-chain W and Q (V1, the dynamic-precision tier).  The TPU kernels also
// take W and/or Q as per-chain (nsym, S, L) tiles, re-closed every VMP sweep
// when the evidence precision or the transition noise is bound to a random
// variable (pallas_smoother.py:76-91, 139-145).  Here they are (NS, B)
// sym-packed tiles, batch minor like every other operand.  A thread reads its
// chain's NS entries of each once, at entry (coalesced along B), into its own
// copy of Params, so the step bodies read prm.W / prm.Q as before and the
// fold's per-block constants (Minv, A1, C1, J1) are the thread's own.  The
// forward passes that read parameters (fold, replay) take W and/or Q this
// way, the backward ones Q only; the carry passes read none.  The template
// flags DYN_W / DYN_Q select this at compile time, so the static
// instantiations run the same code as before.  Q in a tile is the transition
// noise COVARIANCE, as everywhere in this file.  What the tiles cost: 2 NS
// registers more a thread at most (72 at D = 8) and NS B floats read a tile
// and a pass, 40 KB at B = 1024, D = 4.  The launchers pick the
// instantiation from which tile pointers are null.
//
// bf16 moments (V2; pallas_smoother.py:127, 194, 196, 252, 271-272).  The
// template parameter M is the storage type of the packed covariances and the
// cross, float or __nv_bfloat16: K1 carries its state in float32 and stores
// pf rounded to nearest even; K2 reads pf rounded and upcast in its fold and
// its replay alike (so a blocked run holds the same inputs as one block),
// carries the smoothed state in float32 and stores ps and cross rounded.  At
// step T - 1 the smoothed moment is the rounded filtered one.  Means, the
// scratch and all arithmetic stay float32.  At B = 1024, T = 10k, D = 4 the
// bf16 moments cut K1's bytes from 0.74 to 0.53 GB and K2's from 1.80 to
// 1.06.  The carry passes read and write no moment and are not templated.
//
// Layouts.  Inputs in the wrapper's contract layout: xi (T, B, D),
// m0 (B, D), p0 (B, D, D).  Moments in struct-of-arrays layout, batch
// minor, so that neighbouring threads touch neighbouring addresses:
//   forward  out: mf (T, D, B), pf (T, NS, B)          NS = D(D+1)/2
//   backward out: ms (T, D, B), ps (T, NS, B), cross (T-1, D*D, B)
// pf/ps hold the upper triangle row by row ((0,0), (0,1), ..., (D-1,D-1));
// cross[t] = G_t P_s[t+1] = Cov(x_t, x_{t+1}), row-major.

#pragma once

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

// The per-chain tiles of the dynamic tier, (NS, B) each; null when shared.
struct DynTiles {
  const float* w;
  const float* q;
};

// Largest D for which the fold and carry kernels are instantiated: the
// composites of both passes fit the register file without spills up to here
// (see the -Xptxas -v report); above it the launchers take one block.
constexpr int kFoldMaxDim = 5;
constexpr int kThreads = 128;

__device__ __forceinline__ int64_t chain_index() {
  return static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
}

template <int D>
__device__ __forceinline__ void load_vec(const float* __restrict__ src,
                                         size_t stride, float (&v)[D]) {
#pragma unroll
  for (int i = 0; i < D; ++i) v[i] = src[i * stride];
}

template <int D>
__device__ __forceinline__ void store_vec(float* __restrict__ dst,
                                          size_t stride, const float (&v)[D]) {
#pragma unroll
  for (int i = 0; i < D; ++i) dst[i * stride] = v[i];
}

template <int D>
__device__ __forceinline__ void store_full(float* __restrict__ dst,
                                           size_t stride,
                                           const float (&a)[D][D]) {
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) dst[(i * D + j) * stride] = a[i][j];
}

// Rows of one time block's slot in the scratch tensor (S, ROWS, B): the
// block's composite, then the state the carry pass hands to its replay.
template <int D>
struct FwdSlot {  // composite (A, b, C, eta, J); entry = filtered (m, P)
  static constexpr int NS = D * (D + 1) / 2;
  static constexpr int A = 0, BV = D * D, C = BV + D, ETA = C + NS,
                       J = ETA + D, M = J + NS, P = M + D, ROWS = P + NS;
};

template <int D>
struct BwdSlot {  // composite (E, g, L); entry = smoothed (m, P)
  static constexpr int NS = D * (D + 1) / 2;
  static constexpr int E = 0, G = D * D, L = G + D, M = L + NS, P = M + D,
                       ROWS = P + NS;
};

// ---- K1: forward information-form filter ----------------------------------
//   m_pred = F m + b ; P_pred = F P F^T + Q        (no transition at t = 0)
//   L = P_pred^-1 ; P = (L + W)^-1 ; m = P (L m_pred + xi_t)
// Chain b's parameters: the shared ones, with W and/or Q replaced by the
// chain's entries of its tile.
template <int D, bool DYN_W, bool DYN_Q>
__device__ __forceinline__ Params<D> chain_params(const Params<D>& shared,
                                                  const DynTiles& dyn,
                                                  int64_t b, int64_t B) {
  Params<D> prm = shared;
  if constexpr (DYN_W) load_packed<D>(dyn.w + b, B, prm.W);
  if constexpr (DYN_Q) load_packed<D>(dyn.q + b, B, prm.Q);
  return prm;
}

template <int D>
__device__ __forceinline__ void fwd_step(bool first, const float (&xcur)[D],
                                         float (&m)[D], float (&p)[D][D],
                                         const Params<D>& prm) {
  float m_pred[D], p_pred[D][D];
  if (first) {
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
}

template <int D>
__device__ __forceinline__ void load_prior(const float* __restrict__ m0,
                                           const float* __restrict__ p0,
                                           int64_t b, float (&m)[D],
                                           float (&p)[D][D]) {
#pragma unroll
  for (int i = 0; i < D; ++i) m[i] = m0[b * D + i];
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = i; j < D; ++j) {
      p[i][j] = p0[(b * D + i) * D + j];
      p[j][i] = p[i][j];
    }
}

// Replay: the step loop over one time block [s L, min(T, (s+1) L)) from the
// block's entry state: the prior for block 0, else the filtered (m, P) of
// step s L - 1 that the carry pass left in the scratch.  BLOCKED = false is
// the one-block launch, the whole filter with one thread per chain: the
// block arithmetic and the scratch are compiled out, so a batch that fills
// the card by itself runs the recursion and nothing else.
template <int D, bool BLOCKED, bool DYN_W, bool DYN_Q, typename M>
__global__ void fwd_replay_kernel(
    const float* __restrict__ xi, const float* __restrict__ m0,
    const float* __restrict__ p0, const float* __restrict__ scratch,
    float* __restrict__ mf, M* __restrict__ pf, int64_t T, int64_t B,
    int64_t L, const Params<D> shared, const DynTiles dyn) {
  constexpr int NS = D * (D + 1) / 2;
  const int64_t b = chain_index();
  if (b >= B) return;
  const Params<D> prm = chain_params<D, DYN_W, DYN_Q>(shared, dyn, b, B);
  int64_t t0 = 0, t1 = T;
  if constexpr (BLOCKED) {
    t0 = static_cast<int64_t>(blockIdx.y) * L;
    t1 = t0 + L < T ? t0 + L : T;
  }

  float m[D], p[D][D];
  if (!BLOCKED || t0 == 0) {
    load_prior<D>(m0, p0, b, m, p);
  } else {
    using Slot = FwdSlot<D>;
    const float* slot = scratch + blockIdx.y * Slot::ROWS * B + b;
    load_vec<D>(slot + Slot::M * B, B, m);
    load_packed<D>(slot + Slot::P * B, B, p);
  }

  float xcur[D], xnext[D];
#pragma unroll
  for (int k = 0; k < D; ++k) xcur[k] = xi[(t0 * B + b) * D + k];

  for (int64_t t = t0; t < t1; ++t) {
    if (t + 1 < t1) {
#pragma unroll
      for (int k = 0; k < D; ++k) xnext[k] = xi[((t + 1) * B + b) * D + k];
    }
    fwd_step<D>(t == 0, xcur, m, p, prm);
#pragma unroll
    for (int i = 0; i < D; ++i) mf[(t * D + i) * B + b] = m[i];
    store_packed<D>(pf + t * NS * B + b, B, p);
#pragma unroll
    for (int k = 0; k < D; ++k) xcur[k] = xnext[k];
  }
}

// Fold: one thread composes the filtering elements (A, b, C, eta, J) of its
// time block into one composite (rxinfer_tpu/ops/kalman.py
// _make_filter_elements, _filter_compose).  Blocks 0 .. S-2 only (the last
// block's composite has no reader), each L steps long.  F, b, Q, W are the
// same at every step, so the step element's (A, C, J) and the constant parts
// of its (b, eta) are computed once, before the loop:
//   Minv = (I + Q W)^-1 ; A1 = Minv F ; C1 = sym(Minv Q) ;
//   J1 = sym(F^T Minv^T W F) ; b_t = Minv b + C1 xi_t ;
//   eta_t = A1^T (xi_t - W b)
// Block 0 starts from the exact filtered state at t = 0, (0, m_f, P_f, 0, 0);
// the others from the identity element (I, 0, 0, 0, 0).
template <int D, bool DYN_W, bool DYN_Q>
__global__ void __launch_bounds__(kThreads)
fwd_fold_kernel(const float* __restrict__ xi, const float* __restrict__ m0,
                const float* __restrict__ p0, float* __restrict__ scratch,
                int64_t B, int64_t L, const Params<D> shared,
                const DynTiles dyn) {
  using Slot = FwdSlot<D>;
  const int64_t b = chain_index();
  if (b >= B) return;
  const Params<D> prm = chain_params<D, DYN_W, DYN_Q>(shared, dyn, b, B);
  const int64_t s = blockIdx.y;
  int64_t t0 = s * L;
  const int64_t t1 = t0 + L;

  float a1[D][D], c1[D][D], j1[D][D], bc[D], wb[D];
  {
    float qw[D][D], minv[D][D], cq[D][D], mtw[D][D], fmw[D][D];
    mat_mul<D, D, D>(prm.Q, prm.W, qw);
#pragma unroll
    for (int i = 0; i < D; ++i) qw[i][i] += 1.0f;
    gen_inv_scaled<D>(qw, minv);
    mat_mul<D, D, D>(minv, prm.F, a1);
    mat_mul<D, D, D>(minv, prm.Q, cq);
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = i; j < D; ++j) {
        c1[i][j] = 0.5f * (cq[i][j] + cq[j][i]);
        c1[j][i] = c1[i][j];
      }
    mat_t_mul<D>(minv, prm.W, mtw);   // Minv^T W
    mat_t_mul<D>(prm.F, mtw, fmw);    // F^T Minv^T W
    float jfull[D][D];
    mat_mul<D, D, D>(fmw, prm.F, jfull);
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = i; j < D; ++j) {
        j1[i][j] = 0.5f * (jfull[i][j] + jfull[j][i]);
        j1[j][i] = j1[i][j];
      }
    mat_vec<D>(minv, prm.b, bc);
    mat_vec<D>(prm.W, prm.b, wb);
  }

  float a[D][D], bv[D], c[D][D], eta[D], j[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    eta[i] = 0.0f;
#pragma unroll
    for (int k = 0; k < D; ++k) j[i][k] = 0.0f;
  }
  if (s == 0) {
    float x0[D];
#pragma unroll
    for (int k = 0; k < D; ++k) x0[k] = xi[b * D + k];
    load_prior<D>(m0, p0, b, bv, c);
    fwd_step<D>(true, x0, bv, c, prm);
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int k = 0; k < D; ++k) a[i][k] = 0.0f;
    t0 = 1;
  } else {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      bv[i] = 0.0f;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        a[i][k] = i == k ? 1.0f : 0.0f;
        c[i][k] = 0.0f;
      }
    }
  }

  float xcur[D], xnext[D];
  if (t0 < t1) {
#pragma unroll
    for (int k = 0; k < D; ++k) xcur[k] = xi[(t0 * B + b) * D + k];
  }
  for (int64_t t = t0; t < t1; ++t) {
    if (t + 1 < t1) {
#pragma unroll
      for (int k = 0; k < D; ++k) xnext[k] = xi[((t + 1) * B + b) * D + k];
    }
    // the step's element: (a1, b_t, c1, eta_t, j1)
    float b_t[D], eta_t[D], u[D];
    mat_vec<D>(c1, xcur, b_t);
#pragma unroll
    for (int i = 0; i < D; ++i) {
      b_t[i] += bc[i];
      u[i] = xcur[i] - wb[i];
    }
    mat_t_vec<D>(a1, u, eta_t);

    // composite (earlier) x element (later)
    float mm[D][D], minv[D][D];
    mat_mul<D, D, D>(c, j1, mm);
#pragma unroll
    for (int i = 0; i < D; ++i) mm[i][i] += 1.0f;
    gen_inv_scaled<D>(mm, minv);          // (I + C J1)^-1

    float v[D], mv[D], b_new[D];
    mat_vec<D>(c, eta_t, v);
#pragma unroll
    for (int i = 0; i < D; ++i) v[i] += bv[i];
    mat_vec<D>(minv, v, mv);
    mat_vec<D>(a1, mv, b_new);

    float w[D], mw[D], eta_new[D];
    mat_vec<D>(j1, bv, w);
#pragma unroll
    for (int i = 0; i < D; ++i) w[i] = eta_t[i] - w[i];
    mat_t_vec<D>(minv, w, mw);
    mat_t_vec<D>(a, mw, eta_new);

    float mtj[D][D], amj[D][D], j_new[D][D];
    mat_t_mul<D>(minv, j1, mtj);          // (I + J1 C)^-1 J1
    mat_t_mul<D>(a, mtj, amj);            // A^T (..)
    mul_add_sym<D>(amj, a, j, j_new);     // A^T (..) A + J

    float mc[D][D], amc[D][D], c_new[D][D];
    mat_mul<D, D, D>(minv, c, mc);        // (I + C J1)^-1 C
    mat_mul<D, D, D>(a1, mc, amc);
    mul_t_add_sym<D>(amc, a1, c1, c_new); // A1 (..) A1^T + C1

    float ma[D][D], a_new[D][D];
    mat_mul<D, D, D>(minv, a, ma);
    mat_mul<D, D, D>(a1, ma, a_new);

#pragma unroll
    for (int i = 0; i < D; ++i) {
      bv[i] = b_new[i] + b_t[i];
      eta[i] += eta_new[i];
#pragma unroll
      for (int k = 0; k < D; ++k) {
        a[i][k] = a_new[i][k];
        c[i][k] = c_new[i][k];
        j[i][k] = j_new[i][k];
      }
      xcur[i] = xnext[i];
    }
  }

  float* slot = scratch + s * Slot::ROWS * B + b;
  store_full<D>(slot + Slot::A * B, B, a);
  store_vec<D>(slot + Slot::BV * B, B, bv);
  store_packed<D>(slot + Slot::C * B, B, c);
  store_vec<D>(slot + Slot::ETA * B, B, eta);
  store_packed<D>(slot + Slot::J * B, B, j);
}

// Carry: one thread per chain applies the composites front to back and
// leaves in slot s + 1 the filtered (m, P) of step (s + 1) L - 1, the entry
// state of block s + 1:  with (I + P J)^-1 = Minv,
//   m' = A Minv (m + P eta) + b ;  P' = A Minv P A^T + C
// The next composite is loaded before the current one is applied.
template <int D>
__global__ void __launch_bounds__(kThreads)
fwd_carry_kernel(const float* __restrict__ m0, const float* __restrict__ p0,
                 float* __restrict__ scratch, int64_t B, int64_t S) {
  using Slot = FwdSlot<D>;
  constexpr int NC = Slot::M;  // floats of a composite
  const int64_t b = chain_index();
  if (b >= B) return;
  float m[D], p[D][D];
  load_prior<D>(m0, p0, b, m, p);

  float cur[NC], nxt[NC];
#pragma unroll
  for (int r = 0; r < NC; ++r) cur[r] = scratch[r * B + b];
  for (int64_t s = 0; s + 1 < S; ++s) {
    if (s + 2 < S) {
#pragma unroll
      for (int r = 0; r < NC; ++r)
        nxt[r] = scratch[((s + 1) * Slot::ROWS + r) * B + b];
    }
    float a[D][D], bv[D], c[D][D], eta[D], j[D][D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      bv[i] = cur[Slot::BV + i];
      eta[i] = cur[Slot::ETA + i];
#pragma unroll
      for (int k = 0; k < D; ++k) a[i][k] = cur[Slot::A + i * D + k];
    }
    {
      int k = 0;
#pragma unroll
      for (int i = 0; i < D; ++i)
#pragma unroll
        for (int q = i; q < D; ++q) {
          c[i][q] = cur[Slot::C + k];
          c[q][i] = c[i][q];
          j[i][q] = cur[Slot::J + k];
          j[q][i] = j[i][q];
          ++k;
        }
    }
    float mm[D][D], minv[D][D];
    mat_mul<D, D, D>(p, j, mm);
#pragma unroll
    for (int i = 0; i < D; ++i) mm[i][i] += 1.0f;
    gen_inv_scaled<D>(mm, minv);
    float v[D], mv[D], m_new[D];
    mat_vec<D>(p, eta, v);
#pragma unroll
    for (int i = 0; i < D; ++i) v[i] += m[i];
    mat_vec<D>(minv, v, mv);
    mat_vec<D>(a, mv, m_new);
    float mp[D][D], amp[D][D], p_new[D][D];
    mat_mul<D, D, D>(minv, p, mp);
    mat_mul<D, D, D>(a, mp, amp);
    mul_t_add_sym<D>(amp, a, c, p_new);
#pragma unroll
    for (int i = 0; i < D; ++i) {
      m[i] = m_new[i] + bv[i];
#pragma unroll
      for (int k = 0; k < D; ++k) p[i][k] = p_new[i][k];
    }
    float* slot = scratch + (s + 1) * Slot::ROWS * B + b;
    store_vec<D>(slot + Slot::M * B, B, m);
    store_packed<D>(slot + Slot::P * B, B, p);
#pragma unroll
    for (int r = 0; r < NC; ++r) cur[r] = nxt[r];
  }
}

// ---- K2: backward RTS pass --------------------------------------------------
//   P_pred = F P_f F^T + Q ; G = P_f F^T P_pred^-1
//   m_s = m_f + G (m_s' - F m_f - b) ; P_s = P_f + G (P_s' - P_pred) G^T
//   cross_t = G P_s'                  (smoothed == filtered at t = T-1)

template <int D>
__device__ __forceinline__ void unpack_sym(
    const float (&packed)[D * (D + 1) / 2], float (&p)[D][D]) {
  int k = 0;
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = i; j < D; ++j) {
      p[i][j] = packed[k];
      p[j][i] = packed[k];
      ++k;
    }
}

// P_pred, and the gain G = P_f F^T P_pred^-1 of one step.
template <int D>
__device__ __forceinline__ void rts_gain(const float (&p_f)[D][D],
                                         const Params<D>& prm,
                                         float (&p_pred)[D][D],
                                         float (&g)[D][D]) {
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
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      float s = pft[i][0] * pinv[0][j];
#pragma unroll
      for (int k = 1; k < D; ++k) s += pft[i][k] * pinv[k][j];
      g[i][j] = s;
    }
}

// One RTS step: (m_s, P_s) of step t + 1 in, of step t out; cr points at
// cross[t] for this chain.
template <int D, typename M>
__device__ __forceinline__ void bwd_step(
    const float (&m_f)[D], const float (&pcur)[D * (D + 1) / 2],
    float (&m_s)[D], float (&p_s)[D][D], M* __restrict__ cr, int64_t B,
    const Params<D>& prm) {
  float p_f[D][D];
  unpack_sym<D>(pcur, p_f);
  float p_pred[D][D], g[D][D];
  rts_gain<D>(p_f, prm, p_pred, g);
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
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      float s = g[i][0] * p_s[0][j];
#pragma unroll
      for (int k = 1; k < D; ++k) s += g[i][k] * p_s[k][j];
      cr[(i * D + j) * B] = moment_out<M>(s);
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
}

// Replay: the RTS step loop over one time block, from t1 - 1 down to t0,
// starting from the smoothed (m, P) of step t1 that the carry pass left in
// the scratch; the block that holds step T - 1 starts from the filtered
// moments there.  BLOCKED = false is the one-block launch, the whole
// backward pass with one thread per chain (see fwd_replay_kernel).
template <int D, bool BLOCKED, bool DYN_Q, typename M>
__global__ void bwd_replay_kernel(
    const float* __restrict__ mf, const M* __restrict__ pf,
    const float* __restrict__ scratch, float* __restrict__ ms,
    M* __restrict__ ps, M* __restrict__ cross, int64_t T, int64_t B,
    int64_t L, const Params<D> shared, const DynTiles dyn) {
  constexpr int NS = D * (D + 1) / 2;
  const int64_t b = chain_index();
  if (b >= B) return;
  const Params<D> prm = chain_params<D, false, DYN_Q>(shared, dyn, b, B);
  int64_t t0 = 0, t1 = T;
  if constexpr (BLOCKED) {
    t0 = static_cast<int64_t>(blockIdx.y) * L;
    t1 = t0 + L < T ? t0 + L : T;
  }

  float m_s[D], p_s[D][D];
  int64_t t_hi;  // the first step this thread smooths
  if (!BLOCKED || t1 == T) {
#pragma unroll
    for (int i = 0; i < D; ++i) m_s[i] = mf[((T - 1) * D + i) * B + b];
    load_packed<D>(pf + (T - 1) * NS * B + b, B, p_s);
#pragma unroll
    for (int i = 0; i < D; ++i) ms[((T - 1) * D + i) * B + b] = m_s[i];
    store_packed<D>(ps + (T - 1) * NS * B + b, B, p_s);
    t_hi = T - 2;
  } else {
    using Slot = BwdSlot<D>;
    const float* slot = scratch + blockIdx.y * Slot::ROWS * B + b;
    load_vec<D>(slot + Slot::M * B, B, m_s);
    load_packed<D>(slot + Slot::P * B, B, p_s);
    t_hi = t1 - 1;
  }
  if (t_hi < t0) return;

  float mcur[D], pcur[NS], mnext[D], pnext[NS];
#pragma unroll
  for (int i = 0; i < D; ++i) mcur[i] = mf[(t_hi * D + i) * B + b];
#pragma unroll
  for (int k = 0; k < NS; ++k)
    pcur[k] = moment_in(pf[(t_hi * NS + k) * B + b]);

  for (int64_t t = t_hi; t >= t0; --t) {
    if (t > t0) {
#pragma unroll
      for (int i = 0; i < D; ++i) mnext[i] = mf[((t - 1) * D + i) * B + b];
#pragma unroll
      for (int k = 0; k < NS; ++k)
        pnext[k] = moment_in(pf[((t - 1) * NS + k) * B + b]);
    }
    bwd_step<D, M>(mcur, pcur, m_s, p_s, cross + t * (D * D) * B + b, B, prm);
#pragma unroll
    for (int i = 0; i < D; ++i) ms[(t * D + i) * B + b] = m_s[i];
    store_packed<D>(ps + t * NS * B + b, B, p_s);
#pragma unroll
    for (int i = 0; i < D; ++i) mcur[i] = mnext[i];
#pragma unroll
    for (int k = 0; k < NS; ++k) pcur[k] = pnext[k];
  }
}

// Fold: one thread composes the RTS elements (E, g, L) of its time block,
// last step first (rxinfer_tpu/ops/kalman.py _make_smoother_elements,
// _smooth_compose).  Blocks 1 .. S-1 only (block 0's composite has no
// reader).  Per step, from the filtered moments alone:
//   E = G ; g = m_f - E (F m_f + b) ; L = P_f - E P_pred E^T
// and composite <- (E_t E, E_t g + g_t, E_t L E_t^T + L_t): no inverse
// beyond P_pred's.  The block that holds step T - 1 starts from that step's
// element (0, m_f, P_f), the others from the identity (I, 0, 0).
template <int D, bool DYN_Q, typename M>
__global__ void __launch_bounds__(kThreads)
bwd_fold_kernel(const float* __restrict__ mf, const M* __restrict__ pf,
                float* __restrict__ scratch, int64_t T, int64_t B, int64_t L,
                const Params<D> shared, const DynTiles dyn) {
  constexpr int NS = D * (D + 1) / 2;
  using Slot = BwdSlot<D>;
  const int64_t b = chain_index();
  if (b >= B) return;
  const Params<D> prm = chain_params<D, false, DYN_Q>(shared, dyn, b, B);
  const int64_t s = static_cast<int64_t>(blockIdx.y) + 1;
  const int64_t t0 = s * L;
  const int64_t t1 = t0 + L < T ? t0 + L : T;

  float e[D][D], gv[D], l[D][D];
  int64_t t_hi;
  if (t1 == T) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      gv[i] = mf[((T - 1) * D + i) * B + b];
#pragma unroll
      for (int k = 0; k < D; ++k) e[i][k] = 0.0f;
    }
    load_packed<D>(pf + (T - 1) * NS * B + b, B, l);
    t_hi = T - 2;
  } else {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      gv[i] = 0.0f;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        e[i][k] = i == k ? 1.0f : 0.0f;
        l[i][k] = 0.0f;
      }
    }
    t_hi = t1 - 1;
  }

  float mcur[D], pcur[NS], mnext[D], pnext[NS];
  if (t_hi >= t0) {
#pragma unroll
    for (int i = 0; i < D; ++i) mcur[i] = mf[(t_hi * D + i) * B + b];
#pragma unroll
    for (int k = 0; k < NS; ++k)
      pcur[k] = moment_in(pf[(t_hi * NS + k) * B + b]);
  }
  for (int64_t t = t_hi; t >= t0; --t) {
    if (t > t0) {
#pragma unroll
      for (int i = 0; i < D; ++i) mnext[i] = mf[((t - 1) * D + i) * B + b];
#pragma unroll
      for (int k = 0; k < NS; ++k)
        pnext[k] = moment_in(pf[((t - 1) * NS + k) * B + b]);
    }
    // the step's element (e_t, g_t, l_t)
    float p_f[D][D];
    unpack_sym<D>(pcur, p_f);
    float p_pred[D][D], e_t[D][D];
    rts_gain<D>(p_f, prm, p_pred, e_t);
    float fm[D], efm[D], g_t[D];
    mat_vec<D>(prm.F, mcur, fm);
#pragma unroll
    for (int i = 0; i < D; ++i) fm[i] += prm.b[i];
    mat_vec<D>(e_t, fm, efm);
#pragma unroll
    for (int i = 0; i < D; ++i) g_t[i] = mcur[i] - efm[i];
    float ep[D][D], epe[D][D], l_t[D][D], zero[D][D];
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int k = 0; k < D; ++k) zero[i][k] = 0.0f;
    mat_mul<D, D, D>(e_t, p_pred, ep);
    mul_t_add_sym<D>(ep, e_t, zero, epe);
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int k = 0; k < D; ++k) l_t[i][k] = p_f[i][k] - epe[i][k];

    // element (earlier) applied to the composite (later)
    float e_new[D][D], eg[D], el[D][D], l_new[D][D];
    mat_mul<D, D, D>(e_t, e, e_new);
    mat_vec<D>(e_t, gv, eg);
    mat_mul<D, D, D>(e_t, l, el);
    mul_t_add_sym<D>(el, e_t, l_t, l_new);
#pragma unroll
    for (int i = 0; i < D; ++i) {
      gv[i] = eg[i] + g_t[i];
#pragma unroll
      for (int k = 0; k < D; ++k) {
        e[i][k] = e_new[i][k];
        l[i][k] = l_new[i][k];
      }
      mcur[i] = mnext[i];
    }
#pragma unroll
    for (int k = 0; k < NS; ++k) pcur[k] = pnext[k];
  }

  float* slot = scratch + s * Slot::ROWS * B + b;
  store_full<D>(slot + Slot::E * B, B, e);
  store_vec<D>(slot + Slot::G * B, B, gv);
  store_packed<D>(slot + Slot::L * B, B, l);
}

// Carry: one thread per chain applies the composites back to front and
// leaves in slot s - 1 the smoothed (m, P) of step s L, the entry state of
// block s - 1:  m' = E m + g ;  P' = E P E^T + L.  The last block's E is 0,
// so the walk may start from any finite state.
template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_carry_kernel(float* __restrict__ scratch, int64_t B, int64_t S) {
  using Slot = BwdSlot<D>;
  constexpr int NC = Slot::M;
  const int64_t b = chain_index();
  if (b >= B) return;
  float m[D], p[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    m[i] = 0.0f;
#pragma unroll
    for (int k = 0; k < D; ++k) p[i][k] = 0.0f;
  }
  float cur[NC], nxt[NC];
#pragma unroll
  for (int r = 0; r < NC; ++r)
    cur[r] = scratch[((S - 1) * Slot::ROWS + r) * B + b];
  for (int64_t s = S - 1; s >= 1; --s) {
    if (s >= 2) {
#pragma unroll
      for (int r = 0; r < NC; ++r)
        nxt[r] = scratch[((s - 1) * Slot::ROWS + r) * B + b];
    }
    float e[D][D], gv[D], l[D][D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      gv[i] = cur[Slot::G + i];
#pragma unroll
      for (int k = 0; k < D; ++k) e[i][k] = cur[Slot::E + i * D + k];
    }
    {
      int k = 0;
#pragma unroll
      for (int i = 0; i < D; ++i)
#pragma unroll
        for (int q = i; q < D; ++q) {
          l[i][q] = cur[Slot::L + k];
          l[q][i] = l[i][q];
          ++k;
        }
    }
    float em[D], ep[D][D], p_new[D][D];
    mat_vec<D>(e, m, em);
    mat_mul<D, D, D>(e, p, ep);
    mul_t_add_sym<D>(ep, e, l, p_new);
#pragma unroll
    for (int i = 0; i < D; ++i) {
      m[i] = em[i] + gv[i];
#pragma unroll
      for (int k = 0; k < D; ++k) p[i][k] = p_new[i][k];
    }
    float* slot = scratch + (s - 1) * Slot::ROWS * B + b;
    store_vec<D>(slot + Slot::M * B, B, m);
    store_packed<D>(slot + Slot::P * B, B, p);
#pragma unroll
    for (int r = 0; r < NC; ++r) cur[r] = nxt[r];
  }
}

// ---- launchers ------------------------------------------------------------------

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

inline dim3 chain_grid(int64_t B, int64_t blocks) {
  return dim3(static_cast<unsigned>((B + kThreads - 1) / kThreads),
              static_cast<unsigned>(blocks));
}

// L steps per time block, S = ceil(T / L) blocks.  S == 1: the one-block
// replay kernel alone.  S > 1 needs D <= kFoldMaxDim and a scratch of
// S * ROWS * B floats.  The per-chain tiles of dyn are read by the
// instantiations DYN_W / DYN_Q select; M is the moments' storage type.
template <int D, bool DYN_W, bool DYN_Q, typename M>
int launch_fwd(const float* xi, const float* m0, const float* p0, float* mf,
               M* pf, int64_t T, int64_t B, const float* F,
               const float* bvec, const float* Q, const float* W,
               DynTiles dyn, int64_t L, int64_t S, float* scratch,
               cudaStream_t stream) {
  const Params<D> prm = make_params<D>(F, bvec, Q, W);
  if (S == 1) {
    fwd_replay_kernel<D, false, DYN_W, DYN_Q, M>
        <<<chain_grid(B, 1), kThreads, 0, stream>>>(
            xi, m0, p0, scratch, mf, pf, T, B, L, prm, dyn);
    return static_cast<int>(cudaGetLastError());
  }
  if constexpr (D <= kFoldMaxDim) {
    fwd_fold_kernel<D, DYN_W, DYN_Q>
        <<<chain_grid(B, S - 1), kThreads, 0, stream>>>(
            xi, m0, p0, scratch, B, L, prm, dyn);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    fwd_carry_kernel<D><<<chain_grid(B, 1), kThreads, 0, stream>>>(
        m0, p0, scratch, B, S);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    fwd_replay_kernel<D, true, DYN_W, DYN_Q, M>
        <<<chain_grid(B, S), kThreads, 0, stream>>>(
            xi, m0, p0, scratch, mf, pf, T, B, L, prm, dyn);
    return static_cast<int>(cudaGetLastError());
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int D, bool DYN_Q, typename M>
int launch_bwd(const float* mf, const M* pf, float* ms, M* ps, M* cross,
               int64_t T, int64_t B, const float* F, const float* bvec,
               const float* Q, DynTiles dyn, int64_t L, int64_t S,
               float* scratch, cudaStream_t stream) {
  const Params<D> prm = make_params<D>(F, bvec, Q, Q);
  if (S == 1) {
    bwd_replay_kernel<D, false, DYN_Q, M>
        <<<chain_grid(B, 1), kThreads, 0, stream>>>(
            mf, pf, scratch, ms, ps, cross, T, B, L, prm, dyn);
    return static_cast<int>(cudaGetLastError());
  }
  if constexpr (D <= kFoldMaxDim) {
    bwd_fold_kernel<D, DYN_Q, M>
        <<<chain_grid(B, S - 1), kThreads, 0, stream>>>(
            mf, pf, scratch, T, B, L, prm, dyn);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    bwd_carry_kernel<D><<<chain_grid(B, 1), kThreads, 0, stream>>>(
        scratch, B, S);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    bwd_replay_kernel<D, true, DYN_Q, M>
        <<<chain_grid(B, S), kThreads, 0, stream>>>(
            mf, pf, scratch, ms, ps, cross, T, B, L, prm, dyn);
    return static_cast<int>(cudaGetLastError());
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool blocks_ok(int64_t T, int64_t L, int64_t S) {
  return T >= 1 && L >= 1 && S >= 1 && (S - 1) * L < T && S * L >= T &&
         S <= 65535;
}

// The entry points' dispatch on d and on which per-chain tiles are given,
// for the moments' storage type M: one library per M (fused_smoother.cu
// float32, fused_smoother_bf16.cu bf16), so the two builds run in parallel.
template <typename M>
int fwd_entry(int d, const float* xi, const float* m0, const float* p0,
              float* mf, void* pf_raw, int64_t T, int64_t B, const float* F,
              const float* bvec, const float* Q, const float* W,
              const float* wdyn, const float* qdyn, int64_t L, int64_t S,
              float* scratch, void* stream) {
  if (!blocks_ok(T, L, S)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  M* pf = static_cast<M*>(pf_raw);
  const DynTiles dyn{wdyn, qdyn};
#define RXT_FWD_AS(D, DW, DQ)                                              \
  launch_fwd<D, DW, DQ, M>(xi, m0, p0, mf, pf, T, B, F, bvec, Q, W, dyn, L, \
                           S, scratch, s)
#define RXT_FWD(D)                                                         \
  case D:                                                                  \
    if (wdyn && qdyn) return RXT_FWD_AS(D, true, true);                    \
    if (wdyn) return RXT_FWD_AS(D, true, false);                           \
    if (qdyn) return RXT_FWD_AS(D, false, true);                           \
    return RXT_FWD_AS(D, false, false);
  switch (d) {
    RXT_FWD(1) RXT_FWD(2) RXT_FWD(3) RXT_FWD(4)
    RXT_FWD(5) RXT_FWD(6) RXT_FWD(7) RXT_FWD(8)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RXT_FWD
#undef RXT_FWD_AS
}

template <typename M>
int bwd_entry(int d, const float* mf, const void* pf_raw, float* ms,
              void* ps_raw, void* cross_raw, int64_t T, int64_t B,
              const float* F, const float* bvec, const float* Q,
              const float* qdyn, int64_t L, int64_t S, float* scratch,
              void* stream) {
  if (!blocks_ok(T, L, S)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const M* pf = static_cast<const M*>(pf_raw);
  M* ps = static_cast<M*>(ps_raw);
  M* cross = static_cast<M*>(cross_raw);
  const DynTiles dyn{nullptr, qdyn};
#define RXT_BWD(D)                                                         \
  case D:                                                                  \
    if (qdyn)                                                              \
      return launch_bwd<D, true, M>(mf, pf, ms, ps, cross, T, B, F, bvec, \
                                    Q, dyn, L, S, scratch, s);             \
    return launch_bwd<D, false, M>(mf, pf, ms, ps, cross, T, B, F, bvec,  \
                                   Q, dyn, L, S, scratch, s);
  switch (d) {
    RXT_BWD(1) RXT_BWD(2) RXT_BWD(3) RXT_BWD(4)
    RXT_BWD(5) RXT_BWD(6) RXT_BWD(7) RXT_BWD(8)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RXT_BWD
}

}  // namespace

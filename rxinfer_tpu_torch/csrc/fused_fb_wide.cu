// Batched HMM forward-backward for K >= 9 states on Hopper (sm_90a): the
// forward pass (K4) and the backward pass with its marginals (K5) for
// chains too wide for the lanes of fused_fb.cu (K = 1..8).
//
// Replaces `_fb_fwd_kernel` and `_fb_bwd_kernel` of
// rxinfer_tpu/ops/pallas_discrete.py (lines 48-84 and 87-167), which unroll
// any K, where the register kernels stop.  Same convention, layouts and
// operation order as fused_fb.cu, i.e. as the plain versions of
// rxinfer_tpu_torch/ops/fused_fb.py: log-sum-exp takes the running maximum,
// then the sum of exp(t - m) in index order, then m + log(s); alphas and
// betas are max-normalised (a maximum is exact in any order, so a warp
// reduction gives the plain version's bits); xi takes its maximum over
// (i, j) and divides by the sum of its row sums in row order.  expf / logf
// are the accurate ones and division is IEEE (no fast math).
//
// What bounds the passes on this card.  At the 16-state cell (B = 1024,
// T = 1000) K4 moves 0.13 GB and K5 1.25 GB (the per-step xi stream is
// 1.05 GB of it): 0.04 and 0.37 ms at the HBM rate, and their arithmetic is
// below that at the float32 rate.  The forward and beta recursions are
// serial in time, a step a dependent chain of K exps, a log-sum-exp and a
// warp-wide maximum, with B = 1024 chains two warps a scheduler: latency
// bounds them.  The marginal pass is parallel over (time tile, chain) and
// its per-step xi stream is the one large byte count.
//
// Design.
//   * The forward and beta recursions: a warp a chain, a lane a state.  For
//     K <= 32 (KMAX = 16, 32) lane i keeps row i (forward) or column i
//     (beta) of the chain's K x K table in KMAX registers; the previous
//     alpha or beta vector and the next step's evidence are broadcast from
//     the warp's shared memory, one read a term, instead of K shuffles.
//     Above 32 (KMAX = 0) each lane takes states lane, lane + 32, ..., and
//     the table sits in the warp's shared memory (rows padded to K + 1
//     floats against bank conflicts) while it fits beside the ring, else it
//     is read from device memory through L1 / L2; `serial_cfg` decides.
//   * The evidence of a chain (K floats a step) is staged through a ring of
//     kStages tiles in the warp's shared memory, refilled one row a step by
//     cp.async as in fused_fb.cu; a warp has its own ring, so only
//     __syncwarp orders it and a warp of a chain b >= B leaves at once.
//     The ring's tile shrinks from kTileSteps where K is so large that a
//     full one would not fit; the ragged edges (T mod the tile, B mod the
//     chains of a CTA, K mod 32) are masked.
//   * The marginals: a warp a (time tile, chain), lane i row i of xi_t and
//     of the tile's partial (registers for K <= 32; above, each lane takes
//     rows lane, lane + 32, ... and the partial accumulates in the output
//     `part` in place).  The maxima are warp reductions; the row sums are
//     gathered through shared memory and summed in row order by every
//     lane.  With the per-step xi stream (STEPS) a step's K x K block is
//     staged in shared memory and written out by the warp in order, so the
//     stores are whole 128-byte lines (K <= 32).
//   * xi_sum: fused_fb.cuh's kernel sums the partials in tile order (one
//     tile: the marginal pass writes xi_sum itself).  No atomics: the same
//     inputs give the same bits on every run.

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "fused_fb.cuh"

namespace {

constexpr int kChainWarps = 4;  // warps a CTA (register variants, marginals)

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o /= 2)
    v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

// v[0] + v[1] + ... + v[n-1], in index order.
__device__ __forceinline__ float sum_in_order(const float* v, int n) {
  float s = v[0];
  for (int i = 1; i < n; ++i) s += v[i];
  return s;
}

// log-sum-exp of term(0..n-1), in lse's order; the terms are computed again
// for the sum (the same operations on the same values, so the same bits).
template <class Term>
__device__ __forceinline__ float lse_of(Term term, int n) {
  float m = term(0);
  for (int i = 1; i < n; ++i) m = fmaxf(m, term(i));
  float s = expf(term(0) - m);
  for (int i = 1; i < n; ++i) s += expf(term(i) - m);
  return m + logf(s);
}

// Floats of one warp's shared memory in a serial pass: the ring of
// kStages tiles of `ts` rows of K, `vecs` vectors of K and, with the
// table, its K rows of K + 1.
__host__ __device__ inline int64_t serial_warp_floats(int K, int ts, int vecs,
                                                      bool table) {
  return static_cast<int64_t>(kStages) * ts * K +
         static_cast<int64_t>(vecs) * K +
         (table ? static_cast<int64_t>(K) * (K + 1) : 0);
}

// One chain's rows of log_evidence (K floats a step), staged tile by tile
// in walk order (FORWARD: from t = 0; else from t = T-1).  Tile i covers
// steps [t0, t1) and takes slot i % kStages; row r of a slot holds step
// t0 + r.  prologue() queues the first kStages-1 tiles; after that each
// step copies the row kAhead steps on in the walk into the slot of the tile
// before, which every lane has finished with.  Lane l copies floats l,
// l + 32, ... of a row.  Every lane calls prologue(), acquire(i) and
// commit() for every i.
template <bool FORWARD>
struct WarpRing {
  float* ring;
  const float* le;
  int64_t T, B, b, tiles, ahead;
  int K, ts, lane;

  __device__ WarpRing(float* ring_, const float* le_, int64_t T_, int64_t B_,
                      int64_t b_, int K_, int ts_)
      : ring(ring_), le(le_), T(T_), B(B_), b(b_),
        tiles((T_ + ts_ - 1) / ts_),
        ahead(static_cast<int64_t>(kStages - 1) * ts_), K(K_), ts(ts_),
        lane(static_cast<int>(threadIdx.x) % kWarp) {}

  __device__ void span(int64_t i, int64_t& t0, int64_t& t1) const {
    if (FORWARD) {
      t0 = i * ts;
      t1 = t0 + ts < T ? t0 + ts : T;
    } else {
      t1 = T - i * ts;
      t0 = t1 - ts > 0 ? t1 - ts : 0;
    }
  }

  __device__ float* slot(int64_t i) const {
    return ring + (i % kStages) * static_cast<int64_t>(ts) * K;
  }

  __device__ void copy_row(float* dst, int64_t t) const {
    const float* src = le + (t * B + b) * K;
    for (int c = lane; c < K; c += kWarp) cp_async4(dst + c, src + c);
  }

  __device__ void prologue() const {
    for (int64_t i = 0; i < kStages - 1; ++i) {
      if (i < tiles) {
        int64_t t0, t1;
        span(i, t0, t1);
        float* dst = slot(i);
        for (int64_t t = t0; t < t1; ++t, dst += K) copy_row(dst, t);
      }
      cp_async_commit();
    }
  }

  // At step t (walk order) of tile i: the row kAhead steps on, which lies in
  // tile i + kStages - 1 at the same place (nothing past the data).
  __device__ void refill(int64_t i, int64_t t) const {
    const int64_t tn = FORWARD ? t + ahead : t - ahead;
    if (FORWARD ? tn >= T : tn < 0) return;
    int64_t t0n, t1n;
    span(i + kStages - 1, t0n, t1n);
    copy_row(slot(i + kStages - 1) + (tn - t0n) * K, tn);
  }

  // Tile i in shared memory: this lane's copies of it landed (the group of
  // the tile after it may still be in flight), then every lane's.  Returns
  // the slot's row 0.
  __device__ const float* acquire(int64_t i) const {
    cp_async_wait<kStages - 2>();
    __syncwarp();
    return slot(i);
  }

  // closes the group of tile i's refill (empty when it copied nothing)
  __device__ void commit() const { cp_async_commit(); }
};

// The chain's table for the K > 32 variant: copied into the warp's shared
// memory (rows of K + 1) when `in_smem`, else read where it lies.
struct Table {
  const float* p;
  int stride;
  __device__ float at(int i, int j) const { return p[i * stride + j]; }
};

__device__ __forceinline__ Table load_table(const float* lt_b, float* t_s,
                                            int K, bool in_smem, int lane) {
  if (!in_smem) return {lt_b, K};
  for (int idx = lane; idx < K * K; idx += kWarp)
    t_s[(idx / K) * (K + 1) + idx % K] = lt_b[idx];
  return {t_s, K + 1};  // read after the first acquire()'s __syncwarp
}

// ---- K4: forward pass ------------------------------------------------------
//   alpha_0 = log_prior + le_0
//   alpha_t[i] = lse_j(logA[i][j] + alpha_{t-1}[j]) + le_t[i]
//   each step: m = max_i alpha_t[i]; alpha_t -= m; cum += m
//   logz = cum + m' + log(sum_i exp(alpha_{T-1}[i] - m'))
template <int KMAX>
__global__ void __launch_bounds__(kWarp * kChainWarps)
    fb_wide_fwd_kernel(const float* __restrict__ lp,
                       const float* __restrict__ lt,
                       const float* __restrict__ le,
                       float* __restrict__ alphas, float* __restrict__ logz,
                       int64_t T, int64_t B, int K, int ts, int table_smem) {
  extern __shared__ __align__(16) float smem[];
  const int warp = static_cast<int>(threadIdx.x) / kWarp;
  const int lane = static_cast<int>(threadIdx.x) % kWarp;
  const int64_t b =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x / kWarp) + warp;
  if (b >= B) return;  // the whole warp: nothing below spans warps
  const bool table = KMAX == 0 && table_smem;
  float* ring = smem + warp * serial_warp_floats(K, ts, 2, table);
  float* a_s = ring + static_cast<int64_t>(kStages) * ts * K;  // alpha_{t-1}
  float* n_s = a_s + K;  // alpha_t before its shift (K > 32)
  const WarpRing<true> r(ring, le, T, B, b, K, ts);
  const float* lt_b = lt + b * K * K;
  const int64_t step = B * K;  // floats from one step to the next

  const bool own = lane < K;
  float row[KMAX > 0 ? KMAX : 1];  // logA[lane][:]
  Table tab{lt_b, K};
  if constexpr (KMAX > 0) {
#pragma unroll
    for (int j = 0; j < KMAX; ++j)
      row[j] = own && j < K ? lt_b[lane * K + j] : 0.0f;
  } else {
    tab = load_table(lt_b, n_s + K, K, table, lane);
  }
  float cum = 0.0f;

  r.prologue();
  for (int64_t tile = 0; tile < r.tiles; ++tile) {
    const float* ev = r.acquire(tile);
    int64_t t0, t1;
    r.span(tile, t0, t1);
    float* out = alphas + t0 * step + b * K;
    for (int64_t t = t0; t < t1; ++t, ev += K, out += step) {
      r.refill(tile, t);
      if constexpr (KMAX > 0) {
        float mine = -INFINITY;
        if (own) {
          if (t == 0) {
            mine = lp[b * K + lane] + ev[lane];
          } else {
            float terms[KMAX];
#pragma unroll
            for (int j = 0; j < KMAX; ++j)
              terms[j] = j < K ? row[j] + a_s[j] : 0.0f;
            mine = lse<KMAX>(terms, K) + ev[lane];
          }
        }
        const float m = warp_max(mine);
        __syncwarp();  // every lane has read alpha_{t-1}
        if (own) {
          const float a = mine - m;
          a_s[lane] = a;
          out[lane] = a;
        }
        cum = cum + m;
      } else {
        float lm = -INFINITY;
        for (int i = lane; i < K; i += kWarp) {
          float raw;
          if (t == 0) {
            raw = lp[b * K + i] + ev[i];
          } else {
            raw = lse_of([&](int j) { return tab.at(i, j) + a_s[j]; }, K) +
                  ev[i];
          }
          n_s[i] = raw;
          lm = fmaxf(lm, raw);
        }
        const float m = warp_max(lm);
        __syncwarp();
        for (int i = lane; i < K; i += kWarp) {
          const float a = n_s[i] - m;
          a_s[i] = a;
          out[i] = a;
        }
        cum = cum + m;
      }
      __syncwarp();
    }
    r.commit();
  }
  if (lane != 0) return;
  float m = a_s[0];
  for (int i = 1; i < K; ++i) m = fmaxf(m, a_s[i]);
  float s = expf(a_s[0] - m);
  for (int i = 1; i < K; ++i) s += expf(a_s[i] - m);
  logz[b] = cum + m + logf(s);
}

// ---- K5 (a): the beta recursion --------------------------------------------
// beta_{T-1} = 0; for t < T-1
//   s[i][j]   = logA[i][j] + le_{t+1}[i] + beta_{t+1}[i]
//   beta_t[j] = lse_i(s[i][j]), max-normalised over j
// Lane j computes beta_t[j] from column j of logA.
template <int KMAX>
__global__ void __launch_bounds__(kWarp * kChainWarps)
    fb_wide_beta_kernel(const float* __restrict__ lt,
                        const float* __restrict__ le,
                        float* __restrict__ betas, int64_t T, int64_t B,
                        int K, int ts, int table_smem) {
  extern __shared__ __align__(16) float smem[];
  const int warp = static_cast<int>(threadIdx.x) / kWarp;
  const int lane = static_cast<int>(threadIdx.x) % kWarp;
  const int64_t b =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x / kWarp) + warp;
  if (b >= B) return;
  const bool table = KMAX == 0 && table_smem;
  float* ring = smem + warp * serial_warp_floats(K, ts, 3, table);
  float* b_s = ring + static_cast<int64_t>(kStages) * ts * K;  // beta_{t+1}
  float* l_s = b_s + K;                                         // le_{t+1}
  float* n_s = l_s + K;  // beta_t before its shift (K > 32)
  const WarpRing<false> r(ring, le, T, B, b, K, ts);
  const float* lt_b = lt + b * K * K;
  const int64_t step = B * K;

  const bool own = lane < K;
  float col[KMAX > 0 ? KMAX : 1];  // logA[:][lane]
  Table tab{lt_b, K};
  if constexpr (KMAX > 0) {
#pragma unroll
    for (int i = 0; i < KMAX; ++i)
      col[i] = own && i < K ? lt_b[i * K + lane] : 0.0f;
  } else {
    tab = load_table(lt_b, n_s + K, K, table, lane);
  }
  for (int i = lane; i < K; i += kWarp) b_s[i] = 0.0f;

  r.prologue();
  for (int64_t tile = 0; tile < r.tiles; ++tile) {
    const float* base = r.acquire(tile);
    int64_t t0, t1;
    r.span(tile, t0, t1);
    const float* ev = base + (t1 - 1 - t0) * K;
    float* out = betas + (t1 - 1) * step + b * K;
    for (int64_t t = t1 - 1; t >= t0; --t, ev -= K, out -= step) {
      r.refill(tile, t);
      if (t < T - 1) {
        if constexpr (KMAX > 0) {
          float raw = -INFINITY;
          if (own) {
            float terms[KMAX];
#pragma unroll
            for (int i = 0; i < KMAX; ++i)
              terms[i] = i < K ? col[i] + l_s[i] + b_s[i] : 0.0f;
            raw = lse<KMAX>(terms, K);
          }
          const float mb = warp_max(raw);
          __syncwarp();  // every lane has read beta_{t+1} and le_{t+1}
          if (own) {
            const float v = raw - mb;
            b_s[lane] = v;
            out[lane] = v;
          }
        } else {
          float lm = -INFINITY;
          for (int j = lane; j < K; j += kWarp) {
            const float raw = lse_of(
                [&](int i) { return tab.at(i, j) + l_s[i] + b_s[i]; }, K);
            n_s[j] = raw;
            lm = fmaxf(lm, raw);
          }
          const float mb = warp_max(lm);
          __syncwarp();
          for (int j = lane; j < K; j += kWarp) {
            const float v = n_s[j] - mb;
            b_s[j] = v;
            out[j] = v;
          }
        }
      } else {
        for (int j = lane; j < K; j += kWarp) out[j] = 0.0f;
      }
      for (int c = lane; c < K; c += kWarp) l_s[c] = ev[c];  // le_t
      __syncwarp();
    }
    r.commit();
  }
}

// ---- K5 (b): the marginals --------------------------------------------------
// Warp (tile s, chain b), b fastest; steps [s * tile, (s+1) * tile):
//   gamma_t    = softmax(alpha_t + beta_t)
//   xi_t[i][j] = softmax_ij(alpha_t[j] + s[i][j])    (t < T-1; s as above)
//   part[s]    = sum of the tile's xi_t in step order
// STEPS also writes each xi_t to xi_steps[t].
template <int KMAX, bool STEPS>
__global__ void __launch_bounds__(kWarp * kChainWarps)
    fb_wide_marg_kernel(const float* __restrict__ lt,
                        const float* __restrict__ le,
                        const float* __restrict__ alphas,
                        const float* __restrict__ betas,
                        float* __restrict__ gammas, float* __restrict__ part,
                        float* __restrict__ xi_steps, int64_t T, int64_t B,
                        int K, int64_t tile, int64_t tiles) {
  constexpr int kVec = KMAX > 0 ? KMAX : 1;
  constexpr int kStage = KMAX > 0 && STEPS ? KMAX * (KMAX + 1) : 1;
  __shared__ __align__(16) float stat_s[kChainWarps][2 * kVec + kStage];
  extern __shared__ __align__(16) float dyn_s[];  // K > 32: 2 K a warp
  const int warp = static_cast<int>(threadIdx.x) / kWarp;
  const int lane = static_cast<int>(threadIdx.x) % kWarp;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kChainWarps + warp;
  if (w >= tiles * B) return;
  const int64_t b = w % B;
  const int64_t t0 = (w / B) * tile;
  const int64_t t_end = t0 + tile < T ? t0 + tile : T;
  const int64_t step = B * K;
  const int64_t kk = static_cast<int64_t>(K) * K;
  float* a_s = KMAX > 0 ? stat_s[warp] : dyn_s + warp * 2 * K;  // alpha_t
  float* v_s = a_s + (KMAX > 0 ? KMAX : K);  // a gathered vector
  const float* lt_b = lt + b * kk;
  float* part_b = part + w * kk;  // (tiles, B, K, K): w = s * B + b

  if constexpr (KMAX > 0) {
    float* x_s = v_s + kVec;  // a step's xi, rows of K + 1 (STEPS)
    const bool own = lane < K;
    float A[KMAX], acc[KMAX];
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      A[j] = own && j < K ? lt_b[lane * K + j] : 0.0f;
      acc[j] = 0.0f;
    }
    float bcur = own ? betas[t0 * step + b * K + lane] : 0.0f;
    for (int64_t t = t0; t < t_end; ++t) {
      const int64_t at = t * step + b * K;
      const float a = own ? alphas[at + lane] : 0.0f;
      const float g = a + bcur;
      const float mg = warp_max(own ? g : -INFINITY);
      const float e = expf(g - mg);
      if (own) {
        a_s[lane] = a;
        v_s[lane] = e;
      }
      __syncwarp();
      const float gs = sum_in_order(v_s, K);
      if (own) gammas[at + lane] = e / gs;
      if (t + 1 < T) {
        const float bnx = own ? betas[at + step + lane] : 0.0f;
        const float lnx = own ? le[at + step + lane] : 0.0f;
        float x[KMAX];
        float lm = -INFINITY;
#pragma unroll
        for (int j = 0; j < KMAX; ++j) {
          x[j] = j < K ? a_s[j] + (A[j] + lnx + bnx) : 0.0f;
          if (j < K) lm = fmaxf(lm, x[j]);
        }
        const float mx = warp_max(own ? lm : -INFINITY);
        float rs = 0.0f;
#pragma unroll
        for (int j = 0; j < KMAX; ++j) {
          if (j < K) {
            x[j] = expf(x[j] - mx);
            rs = j == 0 ? x[j] : rs + x[j];
          }
        }
        __syncwarp();  // every lane has read v_s's exps
        if (own) v_s[lane] = rs;
        __syncwarp();
        const float xs = sum_in_order(v_s, K);
#pragma unroll
        for (int j = 0; j < KMAX; ++j) {
          if (j < K) {
            const float v = x[j] / xs;
            acc[j] += v;
            if (STEPS && own) x_s[lane * (K + 1) + j] = v;
          }
        }
        if constexpr (STEPS) {
          __syncwarp();
          float* dst = xi_steps + at * K;
          for (int c = lane; c < K * K; c += kWarp)
            dst[c] = x_s[(c / K) * (K + 1) + c % K];
        }
        bcur = bnx;
      }
      __syncwarp();  // before a_s, v_s and x_s take the next step
    }
    if (own) {
#pragma unroll
      for (int j = 0; j < KMAX; ++j)
        if (j < K) part_b[lane * K + j] = acc[j];
    }
  } else {
    for (int i = lane; i < K; i += kWarp)
      for (int j = 0; j < K; ++j) part_b[i * K + j] = 0.0f;
    for (int64_t t = t0; t < t_end; ++t) {
      const int64_t at = t * step + b * K;
      float lm = -INFINITY;
      for (int i = lane; i < K; i += kWarp) {
        const float a = alphas[at + i];
        const float g = a + betas[at + i];
        a_s[i] = a;
        v_s[i] = g;
        lm = fmaxf(lm, g);
      }
      const float mg = warp_max(lm);
      for (int i = lane; i < K; i += kWarp) v_s[i] = expf(v_s[i] - mg);
      __syncwarp();
      const float gs = sum_in_order(v_s, K);
      for (int i = lane; i < K; i += kWarp) gammas[at + i] = v_s[i] / gs;
      if (t + 1 < T) {
        lm = -INFINITY;
        for (int i = lane; i < K; i += kWarp) {
          const float lnx = le[at + step + i], bnx = betas[at + step + i];
          for (int j = 0; j < K; ++j)
            lm = fmaxf(lm, a_s[j] + (lt_b[i * K + j] + lnx + bnx));
        }
        const float mx = warp_max(lm);
        __syncwarp();  // every lane is done with v_s's exps
        for (int i = lane; i < K; i += kWarp) {
          const float lnx = le[at + step + i], bnx = betas[at + step + i];
          float rs = 0.0f;
          for (int j = 0; j < K; ++j) {
            const float e =
                expf(a_s[j] + (lt_b[i * K + j] + lnx + bnx) - mx);
            rs = j == 0 ? e : rs + e;
          }
          v_s[i] = rs;
        }
        __syncwarp();
        const float xs = sum_in_order(v_s, K);
        float* dst = STEPS ? xi_steps + at * K : nullptr;
        for (int i = lane; i < K; i += kWarp) {
          const float lnx = le[at + step + i], bnx = betas[at + step + i];
          for (int j = 0; j < K; ++j) {
            const float v =
                expf(a_s[j] + (lt_b[i * K + j] + lnx + bnx) - mx) / xs;
            part_b[i * K + j] += v;
            if (STEPS) dst[i * K + j] = v;
          }
        }
      }
      __syncwarp();
    }
  }
}

// ---- launches ------------------------------------------------------------------

int smem_optin() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return bytes;
}

// A serial pass's launch: warps a CTA, staged steps a tile, whether the
// table sits in shared memory, and the CTA's dynamic shared memory.
struct SerialCfg {
  int warps, ts, table;
  int bytes;
};

// K <= 32: four chains a CTA, the longest tile that fits.  K > 32: a chain
// a CTA, the table in shared memory at the longest tile that lets it fit,
// else in device memory.  `vecs`: vectors of K a warp keeps (2 forward,
// 3 beta).  False when not even a one-step ring fits.
bool serial_cfg(int K, int vecs, SerialCfg& cfg) {
  const int64_t optin = smem_optin();
  const bool general = K > 32;
  const int warps = general ? 1 : kChainWarps;
  for (int with_table = general ? 1 : 0; with_table >= 0; --with_table) {
    for (int ts = kTileSteps; ts >= 1; ts /= 2) {
      const int64_t bytes = static_cast<int64_t>(sizeof(float)) * warps *
                            serial_warp_floats(K, ts, vecs, with_table != 0);
      if (bytes <= optin) {
        cfg = {warps, ts, with_table, static_cast<int>(bytes)};
        return true;
      }
    }
  }
  return false;
}

template <typename Kernel>
int allow_smem(Kernel* kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <int KMAX>
int launch_fwd(const SerialCfg& c, const float* lp, const float* lt,
               const float* le, float* alphas, float* logz, int64_t T,
               int64_t B, int K, cudaStream_t stream) {
  int rc = allow_smem(fb_wide_fwd_kernel<KMAX>, c.bytes);
  if (rc != 0) return rc;
  fb_wide_fwd_kernel<KMAX><<<grid_for(B, c.warps), c.warps * kWarp, c.bytes,
                             stream>>>(lp, lt, le, alphas, logz, T, B, K,
                                       c.ts, c.table);
  return static_cast<int>(cudaGetLastError());
}

template <int KMAX>
int launch_bwd(const SerialCfg& c, bool steps, const float* lt,
               const float* le, const float* alphas, float* betas,
               float* gammas, float* part, float* xi_sum, float* xi_steps,
               int64_t T, int64_t B, int K, int64_t tile, int64_t tiles,
               cudaStream_t stream) {
  int rc = allow_smem(fb_wide_beta_kernel<KMAX>, c.bytes);
  if (rc != 0) return rc;
  fb_wide_beta_kernel<KMAX><<<grid_for(B, c.warps), c.warps * kWarp, c.bytes,
                              stream>>>(lt, le, betas, T, B, K, c.ts,
                                        c.table);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const int marg_bytes =
      KMAX > 0 ? 0 : static_cast<int>(sizeof(float)) * kChainWarps * 2 * K;
  const unsigned grid = grid_for(tiles * B, kChainWarps);
  if (steps) {
    rc = allow_smem(fb_wide_marg_kernel<KMAX, true>, marg_bytes);
    if (rc != 0) return rc;
    fb_wide_marg_kernel<KMAX, true><<<grid, kChainWarps * kWarp, marg_bytes,
                                      stream>>>(
        lt, le, alphas, betas, gammas, part, xi_steps, T, B, K, tile, tiles);
  } else {
    rc = allow_smem(fb_wide_marg_kernel<KMAX, false>, marg_bytes);
    if (rc != 0) return rc;
    fb_wide_marg_kernel<KMAX, false><<<grid, kChainWarps * kWarp, marg_bytes,
                                       stream>>>(
        lt, le, alphas, betas, gammas, part, xi_steps, T, B, K, tile, tiles);
  }
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0 || tiles == 1) return rc;
  const int64_t n = B * K * K;
  fb_xisum_kernel<<<grid_for(n, 256), 256, 0, stream>>>(part, xi_sum, tiles,
                                                        n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each launcher returns the CUDA error of its launches (0 = success); K >= 1
// (the wrapper takes K > 8 here).  Layouts as in fused_fb.cu.
int rxt_fb_wide_fwd(int k, const float* lp, const float* lt, const float* le,
                    float* alphas, float* logz, int64_t T, int64_t B,
                    void* stream) {
  SerialCfg c;
  if (k < 1 || T < 1 || B < 1 || !serial_cfg(k, 2, c))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 16) return launch_fwd<16>(c, lp, lt, le, alphas, logz, T, B, k, s);
  if (k <= 32) return launch_fwd<32>(c, lp, lt, le, alphas, logz, T, B, k, s);
  return launch_fwd<0>(c, lp, lt, le, alphas, logz, T, B, k, s);
}

// betas (T, B, K) is scratch; part (tiles, B, K, K) is scratch, or xi_sum
// when tiles == 1; xi_steps may be null when per_step is 0.
int rxt_fb_wide_bwd(int k, int per_step, const float* lt, const float* le,
                    const float* alphas, float* betas, float* gammas,
                    float* part, float* xi_sum, float* xi_steps, int64_t T,
                    int64_t B, int64_t tile, int64_t tiles, void* stream) {
  SerialCfg c;
  if (k < 1 || T < 1 || B < 1 || tile < 1 || !serial_cfg(k, 3, c))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool st = per_step != 0;
#define RXT_BWD(KMAX)                                                      \
  launch_bwd<KMAX>(c, st, lt, le, alphas, betas, gammas, part, xi_sum,    \
                   xi_steps, T, B, k, tile, tiles, s)
  if (k <= 16) return RXT_BWD(16);
  if (k <= 32) return RXT_BWD(32);
  return RXT_BWD(0);
#undef RXT_BWD
}

// How a serial pass runs at K on the current device (pass 0 forward, 1
// beta): staged steps a tile and whether the table sits in shared memory
// (K > 32).  Returns 0, or the error when no launch fits.
int rxt_fb_wide_serial_plan(int k, int pass, int* ts, int* table) {
  SerialCfg c;
  if (k < 1 || !serial_cfg(k, pass == 0 ? 2 : 3, c))
    return static_cast<int>(cudaErrorInvalidValue);
  *ts = c.ts;
  *table = c.table;
  return 0;
}

const char* rxt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Batched HMM forward-backward for Hopper (sm_90a): a log-space forward pass
// (K4) and a backward pass that emits singleton and pairwise marginals (K5).
//
// Replaces the TPU kernels `_fb_fwd_kernel` and `_fb_bwd_kernel` of
// rxinfer_tpu/ops/pallas_discrete.py (lines 48-84 and 87-167).  The
// arithmetic is that of the plain versions in
// rxinfer_tpu_torch/ops/fused_fb.py (forward_step, beta_step,
// xi_from_scores), which repeat the TPU kernels' order: log-sum-exp takes the
// running maximum first, then the sum of exp(t - m) in index order, then
// m + log(s); alpha and beta are max-normalised each step; xi takes its
// maximum over (i, j) in row-major order and divides by the sum of its row
// sums.  expf / logf are the accurate ones and division is IEEE (no fast
// math).
//
// Convention: logA[i][j] = E[log p(s_{t+1} = i | s_t = j)] ([out, in]);
// xi_t[i][j] = q(s_{t+1} = i, s_t = j).
//
// Layouts (the engine's own, so the wrapper adds no copies):
//   forward  in:  log_prior (B, K), log_trans (B, K, K), log_evidence (T, B, K)
//            out: alphas (T, B, K) max-normalised, logz (B)
//   backward in:  log_trans (B, K, K), log_evidence (T, B, K), alphas
//            out: gammas (T, B, K), xi_sum (B, K, K) and, when asked,
//                 xi_steps (T-1, B, K, K); scratch: betas (T, B, K) and the
//                 per-tile xi partials (tiles, B, K, K)
//
// What bounds the passes on this card.  At the HMM bench size (B=256, T=200,
// K=3) the forward pass moves 1.2 MB and the backward 3.7 MB, under 2 us at
// the HBM rate, and the arithmetic is far below the float32 rate.  The
// forward and the beta recursions are serial in time, and B = 256 chains
// are a few warps, one to an SM, so what bounds them is the latency of one
// step's dependent instructions: a log-sum-exp (accurate expf, logf), a
// gather, a max-normalisation.  The marginals are not serial: they are
// bound by launch and memory latency, a few microseconds.
//
// Design.
//   * K4 and K5's beta pass: P lanes per chain (P = 1, 2, 4, 4, 8, 8, 8, 8
//     for K = 1..8), one state per lane.  Lane i computes alpha_t[i]'s (or
//     beta_t[i]'s) log-sum-exp from the whole previous vector it holds,
//     `__shfl_sync` gathers the K results within the chain's lanes, and
//     every lane max-normalises the whole vector in index order, so the
//     result is bit-for-bit the one-thread recursion's with one log-sum-exp
//     on the critical path instead of K.  Lanes i >= K shadow state K-1 and
//     write nothing.  K (1..8) is a template parameter, so every state index
//     is a compile-time constant after unrolling and the carries live in
//     registers.
//   * A step that short outruns a one-step prefetch, so one CTA of one warp
//     (32 / P chains) streams its chains' evidence through a ring of
//     kStages time tiles of kTileSteps steps in shared memory.  The ring is
//     refilled one row a step: each lane issues one 4-byte cp.async for the
//     row (kStages-1) * kTileSteps steps ahead, a few instructions that fill
//     the recursion's stall cycles (a loop that copied a whole tile at the
//     tile's start cost the one warp as much as the recursion itself).  The
//     recursion reads shared memory and never waits on device memory; one
//     barrier a tile.  One step of the CTA is (32 / P) K <= 32 contiguous
//     floats of log_evidence.  The forward pass walks the tiles from t = 0,
//     the beta pass from t = T-1; the ragged edges (T mod kTileSteps, B mod
//     32 / P) are masked, not padded.  The beta pass writes max-normalised
//     betas to a scratch tensor and reads no alphas.
//   * K5's marginal pass: parallel over (time tile, chain).  From alpha_t,
//     beta_t, beta_{t+1} and le_{t+1} each thread writes gamma_t and xi_t
//     for the steps of its tile and sums its xi in step order into a
//     per-tile partial.  The tile length comes from the wrapper's rule
//     (`pick_tile`), so B x T fills the card instead of a few warps.
//   * xi_sum: the partials are summed in tile order by a third kernel (with
//     one tile the marginal pass writes xi_sum itself).  No atomics: the
//     same inputs give the same bits on every run.
//
// The log-sum-exp, the cp.async copies and the xi_sum kernel sit in
// fused_fb.cuh, shared with fused_fb_wide.cu (K >= 9, a chain a warp).

#include <cuda_runtime.h>

#include <stdint.h>

#include "fused_fb.cuh"

namespace {

// lanes per chain in the serial passes: the least power of two >= K
template <int K>
__host__ __device__ constexpr int lanes_per_chain() {
  return K <= 1 ? 1 : K <= 2 ? 2 : K <= 4 ? 4 : 8;
}

template <int K>
__host__ __device__ constexpr int chains_per_cta() {
  return kWarp / lanes_per_chain<K>();
}

template <int K>
__host__ __device__ constexpr size_t ring_bytes() {
  return sizeof(float) * kStages * kTileSteps * chains_per_cta<K>() * K;
}
static_assert(ring_bytes<8>() <= 48 * 1024 && ring_bytes<3>() <= 48 * 1024,
              "the ring stays within the default dynamic shared memory");

// The K values of a chain, one per lane (lane i of the chain's P holds
// value i), gathered into every lane of the chain.
template <int K>
__device__ __forceinline__ void gather(float mine, float (&all)[K]) {
#pragma unroll
  for (int j = 0; j < K; ++j)
    all[j] = __shfl_sync(kFullMask, mine, j, lanes_per_chain<K>());
}

// ---- the evidence ring of the serial passes ---------------------------------

// The CTA's chains' rows of log_evidence, staged tile by tile in time order
// (FORWARD: from t = 0; else from t = T-1).  Tile i covers steps [t0, t1);
// row r of its slot holds step t0 + r.  A row is at most 32 floats (32 / P
// chains of K <= P states), one a lane.  prologue() queues the first
// kStages-1 tiles; after that the recursion copies one row a step, the row
// kAhead steps on in its walk, into the slot that tile i-1 held, so the
// copies are a few instructions that fill the recursion's stall cycles
// instead of a loop at each tile's start.  Every thread of the CTA calls
// prologue(), acquire(i) and commit() for every i: they hold the barriers
// and the group counts.
template <int K, bool FORWARD>
struct EvidenceRing {
  static constexpr int kRow = chains_per_cta<K>() * K;  // floats of a step
  static constexpr int kSlot = kTileSteps * kRow;       // floats of a tile
  static constexpr int64_t kAhead = (kStages - 1) * kTileSteps;

  float* ring;
  const float* le;
  int64_t T, B, b0, tiles;
  bool copies;  // this lane's float of a row belongs to a chain b < B

  __device__ EvidenceRing(float* ring_, const float* le_, int64_t T_,
                          int64_t B_)
      : ring(ring_), le(le_), T(T_), B(B_),
        b0(static_cast<int64_t>(blockIdx.x) * chains_per_cta<K>()),
        tiles((T_ + kTileSteps - 1) / kTileSteps) {
    const int64_t nb = B - b0 < chains_per_cta<K>() ? B - b0
                                                    : chains_per_cta<K>();
    copies = static_cast<int64_t>(threadIdx.x) < nb * K;
  }

  __device__ void span(int64_t i, int64_t& t0, int64_t& t1) const {
    if (FORWARD) {
      t0 = i * kTileSteps;
      t1 = t0 + kTileSteps < T ? t0 + kTileSteps : T;
    } else {
      t1 = T - i * kTileSteps;
      t0 = t1 - kTileSteps > 0 ? t1 - kTileSteps : 0;
    }
  }

  // A lane's copies of one row a step: step `tn` of tile j, then the step
  // after it in walk order.  Pointers past the data are formed but never
  // read: the caller passes valid = false there.
  struct Refill {
    float* dst;
    const float* src;
    int64_t dsrc;
    __device__ void step(bool valid) {
      if (valid) cp_async4(dst, src);
      dst += FORWARD ? kRow : -kRow;
      src += dsrc;
    }
  };

  // The refill of tile j = i + kStages - 1 (it takes tile i-1's slot) that
  // tile i runs, from tile i's first step t in walk order.
  __device__ Refill refill(int64_t i, int64_t t) const {
    const int64_t j = i + kStages - 1;
    const int64_t tn = FORWARD ? t + kAhead : t - kAhead;
    int64_t t0n, t1n;
    span(j, t0n, t1n);
    const int lane = static_cast<int>(threadIdx.x);
    return {ring + (j % kStages) * kSlot + (tn - t0n) * kRow + lane,
            le + (tn * B + b0) * K + lane, FORWARD ? B * K : -B * K};
  }

  // whether the refill copies at step t (walk order) of a tile
  __device__ bool refills(int64_t t) const {
    return copies && (FORWARD ? t + kAhead < T : t >= kAhead);
  }

  __device__ void prologue() const {
    for (int64_t i = 0; i < kStages - 1; ++i) {
      if (i < tiles) {
        int64_t t0, t1;
        span(i, t0, t1);
        float* dst = ring + i * kSlot + threadIdx.x;
        const float* src = le + (t0 * B + b0) * K + threadIdx.x;
        for (int64_t t = t0; t < t1; ++t, dst += kRow, src += B * K)
          if (copies) cp_async4(dst, src);
      }
      cp_async_commit();
    }
  }

  // Tile i in shared memory: this thread's copies of it landed (the groups
  // of the kStages-2 tiles after it may still be in flight), then every
  // thread's, and every thread is done with tile i-1.  Returns the slot's
  // row 0 (row r at + r * kRow).
  __device__ const float* acquire(int64_t i) const {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    return ring + (i % kStages) * kSlot;
  }

  // closes the group of tile i's refill (empty when it copied nothing)
  __device__ void commit() const { cp_async_commit(); }
};

// A lane of the serial passes: its chain b and the state it computes.
template <int K>
struct ChainLane {
  int c;       // chain within the CTA
  int state;   // lane % P, clamped to K-1 (lanes >= K shadow the last state)
  int64_t b;
  bool live;   // b < B
  bool owner;  // live and lane % P < K: writes its state

  __device__ ChainLane(int64_t b0, int64_t B) {
    constexpr int P = lanes_per_chain<K>();
    const int lane = static_cast<int>(threadIdx.x);
    c = lane / P;
    const int i = lane % P;
    state = i < K ? i : K - 1;
    b = b0 + c;
    live = b < B;
    owner = live && i < K;
  }
};

// ---- K4: forward pass ------------------------------------------------------
//   alpha_0 = log_prior + le_0
//   alpha_t[i] = lse_j(logA[i][j] + alpha_{t-1}[j]) + le_t[i]
//   each step: m = max_i alpha_t[i]; alpha_t -= m; cum += m
//   logz = cum + m' + log(sum_i exp(alpha_{T-1}[i] - m'))
// Every lane of a CTA runs every step (the shuffles take the whole warp);
// lanes of chains b >= B compute on stale shared memory and write nothing.
template <int K>
__global__ void __launch_bounds__(kWarp)
    fb_fwd_kernel(const float* __restrict__ lp, const float* __restrict__ lt,
                  const float* __restrict__ le, float* __restrict__ alphas,
                  float* __restrict__ logz, int64_t T, int64_t B) {
  extern __shared__ __align__(16) float ring[];
  const EvidenceRing<K, true> r(ring, le, T, B);
  const ChainLane<K> me(r.b0, B);

  float row[K], a[K];  // logA[state][:], alpha_{t-1}
#pragma unroll
  for (int j = 0; j < K; ++j) {
    row[j] = me.live ? lt[(me.b * K + me.state) * K + j] : 0.0f;
    a[j] = 0.0f;
  }
  const float prior = me.live ? lp[me.b * K + me.state] : 0.0f;
  float cum = 0.0f;

  r.prologue();
  for (int64_t tile = 0; tile < r.tiles; ++tile) {
    const float* ev = r.acquire(tile) + me.c * K + me.state;
    int64_t t0, t1;
    r.span(tile, t0, t1);
    auto fill = r.refill(tile, t0);
    float* out = alphas + (t0 * B + me.b) * K + me.state;
    for (int64_t t = t0; t < t1; ++t, ev += r.kRow, out += B * K) {
      fill.step(r.refills(t));
      float mine;
      if (t == 0) {
        mine = prior + *ev;
      } else {
        float terms[K];
#pragma unroll
        for (int j = 0; j < K; ++j) terms[j] = row[j] + a[j];
        mine = lse<K>(terms) + *ev;
      }
      float an[K];
      gather<K>(mine, an);
      float m = an[0];
#pragma unroll
      for (int i = 1; i < K; ++i) m = fmaxf(m, an[i]);
#pragma unroll
      for (int i = 0; i < K; ++i) a[i] = an[i] - m;
      cum = cum + m;
      if (me.owner) *out = mine - m;  // a[state]
    }
    r.commit();
  }
  if (!me.owner || me.state != 0) return;
  float m = a[0];
#pragma unroll
  for (int i = 1; i < K; ++i) m = fmaxf(m, a[i]);
  float s = expf(a[0] - m);
#pragma unroll
  for (int i = 1; i < K; ++i) s += expf(a[i] - m);
  logz[me.b] = cum + m + logf(s);
}

// ---- K5 (a): the beta recursion --------------------------------------------
// beta_{T-1} = 0; for t < T-1
//   s[i][j]   = logA[i][j] + le_{t+1}[i] + beta_{t+1}[i]
//   beta_t[j] = lse_i(s[i][j]), max-normalised over j
// Lane j computes beta_t[j] from column j of logA.
template <int K>
__global__ void __launch_bounds__(kWarp)
    fb_beta_kernel(const float* __restrict__ lt, const float* __restrict__ le,
                   float* __restrict__ betas, int64_t T, int64_t B) {
  extern __shared__ __align__(16) float ring[];
  const EvidenceRing<K, false> r(ring, le, T, B);
  const ChainLane<K> me(r.b0, B);

  float col[K], beta[K], lnx[K];  // logA[:][state], beta_{t+1}, le_{t+1}
#pragma unroll
  for (int i = 0; i < K; ++i) {
    col[i] = me.live ? lt[(me.b * K + i) * K + me.state] : 0.0f;
    beta[i] = 0.0f;
    lnx[i] = 0.0f;
  }

  r.prologue();
  for (int64_t tile = 0; tile < r.tiles; ++tile) {
    int64_t t0, t1;
    r.span(tile, t0, t1);
    const float* ev = r.acquire(tile) + (t1 - 1 - t0) * r.kRow + me.c * K;
    auto fill = r.refill(tile, t1 - 1);
    float* out = betas + ((t1 - 1) * B + me.b) * K + me.state;
    for (int64_t t = t1 - 1; t >= t0; --t, ev -= r.kRow, out -= B * K) {
      fill.step(r.refills(t));
      float mine = 0.0f;
      if (t < T - 1) {
        float terms[K];
#pragma unroll
        for (int i = 0; i < K; ++i) terms[i] = col[i] + lnx[i] + beta[i];
        const float raw = lse<K>(terms);
        float braw[K];
        gather<K>(raw, braw);
        float mb = braw[0];
#pragma unroll
        for (int j = 1; j < K; ++j) mb = fmaxf(mb, braw[j]);
#pragma unroll
        for (int j = 0; j < K; ++j) beta[j] = braw[j] - mb;
        mine = raw - mb;  // beta[state]
      }
      if (me.owner) *out = mine;
#pragma unroll
      for (int i = 0; i < K; ++i) lnx[i] = ev[i];
    }
    r.commit();
  }
}

// ---- K5 (b): the marginals --------------------------------------------------
// Thread (tile s, chain b), b fastest; steps [s * tile, (s+1) * tile):
//   gamma_t    = softmax(alpha_t + beta_t)
//   xi_t[i][j] = softmax_ij(alpha_t[j] + s[i][j])    (t < T-1; s as above)
//   part[s]    = sum of the tile's xi_t in step order
// STEPS also writes each xi_t to xi_steps[t].
template <int K, bool STEPS>
__global__ void __launch_bounds__(128)
    fb_marg_kernel(const float* __restrict__ lt, const float* __restrict__ le,
                   const float* __restrict__ alphas,
                   const float* __restrict__ betas, float* __restrict__ gammas,
                   float* __restrict__ part, float* __restrict__ xi_steps,
                   int64_t T, int64_t B, int64_t tile, int64_t tiles) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= tiles * B) return;
  const int64_t b = idx % B;
  const int64_t s = idx / B;
  const int64_t t0 = s * tile;
  const int steps = static_cast<int>((t0 + tile < T ? t0 + tile : T) - t0);
  const int64_t row = B * K;  // floats from one step to the next

  float A[K][K], acc[K][K], bcur[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      A[i][j] = lt[(b * K + i) * K + j];
      acc[i][j] = 0.0f;
    }
  }
  const float* al = alphas + (t0 * B + b) * K;  // step t of the tile
  const float* be = betas + (t0 * B + b) * K;
  const float* ln = le + (t0 * B + b) * K;
  float* gout = gammas + (t0 * B + b) * K;
  float* xout = STEPS ? xi_steps + (t0 * B + b) * (K * K) : nullptr;
#pragma unroll
  for (int i = 0; i < K; ++i) bcur[i] = be[i];

  for (int r = 0; r < steps; ++r) {
    float a[K], g[K];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      a[i] = al[i];
      g[i] = a[i] + bcur[i];
    }
    float mg = g[0];
#pragma unroll
    for (int i = 1; i < K; ++i) mg = fmaxf(mg, g[i]);
#pragma unroll
    for (int i = 0; i < K; ++i) g[i] = expf(g[i] - mg);
    float gs = g[0];
#pragma unroll
    for (int i = 1; i < K; ++i) gs += g[i];
#pragma unroll
    for (int i = 0; i < K; ++i) gout[i] = g[i] / gs;

    if (t0 + r + 1 < T) {
      float bnx[K], lnx[K];  // beta_{t+1}, le_{t+1}
#pragma unroll
      for (int i = 0; i < K; ++i) {
        bnx[i] = be[row + i];
        lnx[i] = ln[row + i];
      }
      // the exponentials are recomputed in the second pass rather than kept,
      // which saves K*K registers (expf is deterministic, so both passes see
      // the same values)
      float mx = a[0] + (A[0][0] + lnx[0] + bnx[0]);
#pragma unroll
      for (int i = 0; i < K; ++i)
#pragma unroll
        for (int j = 0; j < K; ++j)
          mx = fmaxf(mx, a[j] + (A[i][j] + lnx[i] + bnx[i]));
      float xs = 0.0f;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        float rs = expf(a[0] + (A[i][0] + lnx[i] + bnx[i]) - mx);
#pragma unroll
        for (int j = 1; j < K; ++j)
          rs += expf(a[j] + (A[i][j] + lnx[i] + bnx[i]) - mx);
        xs = i == 0 ? rs : xs + rs;
      }
#pragma unroll
      for (int i = 0; i < K; ++i)
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const float v = expf(a[j] + (A[i][j] + lnx[i] + bnx[i]) - mx) / xs;
          acc[i][j] += v;
          if (STEPS) xout[i * K + j] = v;
        }
#pragma unroll
      for (int i = 0; i < K; ++i) bcur[i] = bnx[i];
    }
    al += row;
    be += row;
    ln += row;
    gout += row;
    if (STEPS) xout += row * K;
  }
  float* pout = part + (s * B + b) * (K * K);
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < K; ++j) pout[i * K + j] = acc[i][j];
}

template <int K>
int launch_fwd(const float* lp, const float* lt, const float* le,
               float* alphas, float* logz, int64_t T, int64_t B,
               cudaStream_t stream) {
  fb_fwd_kernel<K><<<grid_for(B, chains_per_cta<K>()), kWarp, ring_bytes<K>(),
                     stream>>>(lp, lt, le, alphas, logz, T, B);
  return static_cast<int>(cudaGetLastError());
}

// part may be xi_sum itself when tiles == 1 (no third kernel then).
template <int K>
int launch_bwd(bool steps, const float* lt, const float* le,
               const float* alphas, float* betas, float* gammas, float* part,
               float* xi_sum, float* xi_steps, int64_t T, int64_t B,
               int64_t tile, int64_t tiles, cudaStream_t stream) {
  fb_beta_kernel<K><<<grid_for(B, chains_per_cta<K>()), kWarp,
                      ring_bytes<K>(), stream>>>(lt, le, betas, T, B);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  constexpr int kMargThreads = 128;
  const unsigned grid = grid_for(tiles * B, kMargThreads);
  if (steps) {
    fb_marg_kernel<K, true><<<grid, kMargThreads, 0, stream>>>(
        lt, le, alphas, betas, gammas, part, xi_steps, T, B, tile, tiles);
  } else {
    fb_marg_kernel<K, false><<<grid, kMargThreads, 0, stream>>>(
        lt, le, alphas, betas, gammas, part, xi_steps, T, B, tile, tiles);
  }
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0 || tiles == 1) return rc;
  const int64_t n = B * K * K;
  fb_xisum_kernel<<<grid_for(n, 256), 256, 0, stream>>>(part, xi_sum, tiles, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Steps of a staged time tile of the serial passes (the wrapper checks it).
int rxt_fb_staged_steps() { return kTileSteps; }

// Each launcher returns cudaGetLastError() after its launches (0 = success).
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

// betas (T, B, K) is scratch; part (tiles, B, K, K) is scratch, or xi_sum
// when tiles == 1; xi_steps may be null when per_step is 0.
int rxt_fb_bwd(int k, int per_step, const float* lt, const float* le,
               const float* alphas, float* betas, float* gammas, float* part,
               float* xi_sum, float* xi_steps, int64_t T, int64_t B,
               int64_t tile, int64_t tiles, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool st = per_step != 0;
#define RXT_BWD(KK)                                                          \
  launch_bwd<KK>(st, lt, le, alphas, betas, gammas, part, xi_sum, xi_steps, \
                 T, B, tile, tiles, s)
  switch (k) {
    case 1: return RXT_BWD(1);
    case 2: return RXT_BWD(2);
    case 3: return RXT_BWD(3);
    case 4: return RXT_BWD(4);
    case 5: return RXT_BWD(5);
    case 6: return RXT_BWD(6);
    case 7: return RXT_BWD(7);
    case 8: return RXT_BWD(8);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RXT_BWD
}

const char* rxt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

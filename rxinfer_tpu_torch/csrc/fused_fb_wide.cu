// Batched HMM forward-backward for K >= 9 states on Hopper (sm_90a): the
// forward pass (K4) and the backward pass with its marginals (K5) for
// chains too wide for the lanes of fused_fb.cu (K = 1..8).
//
// Replaces `_fb_fwd_kernel` and `_fb_bwd_kernel` of
// rxinfer_tpu/ops/pallas_discrete.py (lines 48-84 and 87-167), which unroll
// any K, where the register kernels stop.  Same convention and layouts as
// fused_fb.cu, and the operation order of the plain versions of
// rxinfer_tpu_torch/ops/fused_fb.py: log-sum-exp takes the maximum, then the
// sum of exp(t - m), then m + log(s); alphas and betas are max-normalised (a
// maximum is exact in any order, so a shuffle reduction gives the plain
// version's bits); xi takes its maximum over (i, j) and divides by the sum
// of its row sums.  At K <= 16 the sums run in the half-warp order below,
// which the plain versions repeat at those K; above 16 they run in index
// order.  expf / logf are the accurate ones and division is IEEE (no fast
// math).
//
// What bounds the passes on this card.  At the 16-state cell (B = 1024,
// T = 1000) the two recursions move 0.2 GB and the marginal pass 1.31 GB
// (the per-step xi stream is 1.05 GB of it): 0.06 and 0.39 ms at the HBM
// rate, and their arithmetic is below that at the float32 rate.  The
// forward and beta recursions are serial in time: a step is a dependent
// chain of exps, a log-sum-exp and a maximum over the states, so latency
// bounds them.  The marginal pass is parallel over (time tile, chain) and
// should run at the HBM rate.
//
// Design.
//   * One launch runs both recursions (`fb_wide_serial_kernel`): the beta
//     recursion reads no alphas, so each chain has a forward warp and a beta
//     warp side by side (`roles` = 3; 1 or 2 launch one of them).  A
//     scheduler then interleaves two independent chains of latency.
//   * K <= 16 (KMAX = 16): lane l takes state l % 16, and each log-sum-exp
//     is split over the two half-warps: the low half takes terms 0..7, the
//     high half terms 8..K-1, each from its 8 entries of the chain's table
//     in registers; one shuffle across the halves combines the maxima, one
//     the two exp sums (the low half's plus the high half's).  The previous
//     vector is read as float4 broadcasts from a ping-pong pair in the
//     warp's shared memory (one __syncwarp a step); the state maximum is a
//     four-shuffle reduction inside a half.  The beta warp keeps
//     u_t = le_t + beta_t, the row offset of the next step's scores
//     s[i][j] = logA[i][j] + u_{t+1}[i].
//   * K > 16 (KMAX = 32 registers; KMAX = 0 the table in the warp's shared
//     memory, rows padded to K + 1 floats, while it fits beside the ring,
//     else read from device memory; `serial_cfg` decides): a lane a state
//     (lane, lane + 32, ...), terms in index order, the vectors broadcast
//     from shared memory.
//   * The evidence of a chain (K floats a step) is staged through a ring of
//     kStages tiles in the warp's shared memory, refilled one row a step by
//     cp.async as in fused_fb.cu, from pointers set at the tile's start (the
//     index arithmetic of a refill was a quarter of the step at K = 16);
//     a warp has its own ring, so only __syncwarp orders it and a warp past
//     the batch leaves at once.  The ring's tile shrinks from kTileSteps
//     where K is so large that a full one would not fit; the ragged edges
//     are masked.
//   * The marginals at K <= 16 (`fb_wide_marg_half_kernel`): a half-warp a
//     (time tile, chain), the two halves of a warp on neighbouring chains,
//     all 32 lanes busy.  Lane l owns the entries (4m + l / 4, 4 (l % 4) + k)
//     of each step's 16 x 16 block (m, k = 0..3), so the block's float
//     index 64 m + 4 l + k: a half stores a step's block as four 16-byte
//     stores a lane, 256 contiguous bytes an instruction.  Gamma's and xi's
//     maxima and sums are shuffle butterflies inside the half: gamma's sum
//     and the sum of the row sums pair (l, l ^ 8), (l ^ 4), (l ^ 2),
//     (l ^ 1); a row sum is the sequential sum of a lane's four entries,
//     then (c, c ^ 1), (c ^ 2) over its four lanes.  The chain's table sits
//     in shared memory (a float4 a row) and a step's inputs are loaded one
//     step ahead: the pass is bound by each step's latency more than by its
//     bytes, so registers buy warps.  The tile rule (`pick_tile_wide`) puts
//     every (tile, chain) on the card in one wave at kMargBlocksPerSM blocks
//     an SM, the occupancy the launch bounds give.
//     K > 16 (`fb_wide_marg_kernel`): a warp a (tile, chain), lane i row i
//     (rows lane, lane + 32, ... above 32), the row sums summed in row
//     order.
//   * xi_sum: fused_fb.cuh's kernel sums the per-tile partials in tile order
//     (one tile: the marginal pass writes xi_sum itself).  No atomics: the
//     same inputs give the same bits on every run.

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "fused_fb.cuh"

namespace {

constexpr int kChainWarps = 4;  // warps a CTA (serial K <= 32, marginals)
constexpr int kHalf = 16;       // lanes of a half-warp: the split design's K
constexpr int kHalfTerms = 8;   // terms of a log-sum-exp the low half takes
constexpr int kMargBlocksPerSM = 5;  // K <= 16 marginal CTAs an SM holds

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o /= 2)
    v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

// The maximum over the 16 lanes of this lane's half-warp.
__device__ __forceinline__ float half_max(float v) {
#pragma unroll
  for (int o = kHalf / 2; o > 0; o /= 2)
    v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

// The sum over the 16 lanes of this lane's half-warp, butterfly order:
// (v_l + v_{l+8}) for l < 8, then (+4), (+2), (+1).  Each pairing adds two
// equal-bit values in either order, so every lane ends with the same bits,
// those of the plain version's `_tree_sum16`.
__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = kHalf / 2; o > 0; o /= 2)
    v = v + __shfl_xor_sync(kFullMask, v, o);
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

// log-sum-exp at K <= 16 split over the half-warps: this half's terms
// w[jj] + v[jj] for jj < n (n = 8 in the low half, K - 8 in the high one;
// v 16-byte aligned), the other half's through lane l ^ 16.  The maximum of
// both halves, each half's exp sum in index order, the low sum plus the
// high one, m + log(s): every lane of the pair gets the same bits.
__device__ __forceinline__ float lse_halves(const float (&w)[kHalfTerms],
                                            const float* v, int n) {
  const float4 v0 = *reinterpret_cast<const float4*>(v);
  const float4 v1 = *reinterpret_cast<const float4*>(v + 4);
  const float vv[kHalfTerms] = {v0.x, v0.y, v0.z, v0.w,
                                v1.x, v1.y, v1.z, v1.w};
  float t[kHalfTerms];
#pragma unroll
  for (int jj = 0; jj < kHalfTerms; ++jj)
    t[jj] = jj < n ? w[jj] + vv[jj] : -INFINITY;
  float m = fmaxf(fmaxf(fmaxf(t[0], t[1]), fmaxf(t[2], t[3])),
                  fmaxf(fmaxf(t[4], t[5]), fmaxf(t[6], t[7])));
  m = fmaxf(m, __shfl_xor_sync(kFullMask, m, kHalf));
  // a masked term adds expf(-inf) = 0, which leaves the sum's bits alone
  float s = expf(t[0] - m);
#pragma unroll
  for (int jj = 1; jj < kHalfTerms; ++jj) s += expf(t[jj] - m);
  s = s + __shfl_xor_sync(kFullMask, s, kHalf);
  return m + logf(s);
}

__host__ __device__ inline int64_t round4(int64_t n) { return (n + 3) / 4 * 4; }

// One warp's shared memory in the serial kernel (floats, each part a whole
// number of float4s): the ring of kStages tiles of `ts` rows of K, three
// vectors of max(K, 16) and, with the table, its K rows of K + 1.
__host__ __device__ inline int64_t serial_ring_floats(int K, int ts) {
  return round4(static_cast<int64_t>(kStages) * ts * K);
}
__host__ __device__ inline int64_t serial_vec_floats(int K) {
  return round4(K > kHalf ? K : kHalf);
}
__host__ __device__ inline int64_t serial_warp_floats(int K, int ts,
                                                      bool table) {
  return serial_ring_floats(K, ts) + 3 * serial_vec_floats(K) +
         (table ? round4(static_cast<int64_t>(K) * (K + 1)) : 0);
}

// One chain's rows of log_evidence (K floats a step), staged tile by tile
// in walk order (FORWARD: from t = 0; else from t = T-1).  Tile i covers
// steps [t0, t1) and takes slot i % kStages; row r of a slot holds step
// t0 + r.  prologue() queues the first kStages-1 tiles; after that step r
// of tile i copies row r of tile i + kStages - 1 into the slot of the tile
// before, which every lane has finished with (only the last tile is short,
// so tile i has a step for each row), from pointers set once a tile.  Lane
// l copies floats l, l + 32, ... of a row.  Every lane calls prologue(),
// acquire(i), feed(i), copy() at each step and commit() for every i.
template <bool FORWARD>
struct WarpRing {
  float* ring;
  const float* le;
  int64_t T, B, b;
  int tiles, K, ts, lane;

  __device__ WarpRing(float* ring_, const float* le_, int64_t T_, int64_t B_,
                      int64_t b_, int K_, int ts_)
      : ring(ring_), le(le_), T(T_), B(B_), b(b_),
        tiles(static_cast<int>((T_ + ts_ - 1) / ts_)), K(K_), ts(ts_),
        lane(static_cast<int>(threadIdx.x) % kWarp) {}

  __device__ void span(int i, int64_t& t0, int64_t& t1) const {
    if (FORWARD) {
      t0 = static_cast<int64_t>(i) * ts;
      t1 = t0 + ts < T ? t0 + ts : T;
    } else {
      t1 = T - static_cast<int64_t>(i) * ts;
      t0 = t1 - ts > 0 ? t1 - ts : 0;
    }
  }

  __device__ float* slot(int i) const { return ring + (i % kStages) * ts * K; }

  __device__ void copy_row(float* dst, int64_t t) const {
    const float* src = le + (t * B + b) * K;
    for (int c = lane; c < K; c += kWarp) cp_async4(dst + c, src + c);
  }

  __device__ void prologue() const {
    for (int i = 0; i < kStages - 1; ++i) {
      if (i < tiles) {
        int64_t t0, t1;
        span(i, t0, t1);
        float* dst = slot(i);
        for (int64_t t = t0; t < t1; ++t, dst += K) copy_row(dst, t);
      }
      cp_async_commit();
    }
  }

  // Where step r of tile i copies row r of tile i + kStages - 1 (no rows
  // past the last tile).
  struct Feed {
    float* dst;
    const float* src;
    int rows;
  };
  __device__ Feed feed(int i) const {
    if (i + kStages - 1 >= tiles) return {nullptr, nullptr, 0};
    int64_t t0n, t1n;
    span(i + kStages - 1, t0n, t1n);
    return {slot(i + kStages - 1) + lane, le + (t0n * B + b) * K + lane,
            static_cast<int>(t1n - t0n)};
  }
  // WIDE (K > 32): lane l copies floats l, l + 32, ...; else float l
  // only (a loop there cost the K = 16 step a sixth of its time).
  template <bool WIDE>
  __device__ void copy(Feed& f, int r) const {
    if (r < f.rows) {
      if constexpr (WIDE) {
        for (int c = 0; c + lane < K; c += kWarp)
          cp_async4(f.dst + c, f.src + c);
      } else if (lane < K) {
        cp_async4(f.dst, f.src);
      }
    }
    f.dst += K;
    f.src += B * K;
  }

  // Tile i in shared memory: this lane's copies of it landed (the group of
  // the tile after it may still be in flight), then every lane's.  Returns
  // the slot's row 0.
  __device__ const float* acquire(int i) const {
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

// Where a serial warp works: its chain, the ring and vectors in its shared
// memory, the table's place.
struct SerialWarp {
  int64_t T, B, b;
  int K, ts, lane;
  bool table;
  float* ring;
  float* vec;  // three vectors of serial_vec_floats(K), then the table
  int64_t vk;
};

// ---- K4: forward pass ------------------------------------------------------
//   alpha_0 = log_prior + le_0
//   alpha_t[i] = lse_j(logA[i][j] + alpha_{t-1}[j]) + le_t[i]
//   each step: m = max_i alpha_t[i]; alpha_t -= m; cum += m
//   logz = cum + m' + log(sum_i exp(alpha_{T-1}[i] - m'))   (index order)

// K <= 16: lane l state i = l % 16, terms of half l / 16; alpha_{t-1} in
// the ping-pong buffer (t - 1) % 2 of vec (two of 16 floats, zero past K).
__device__ void forward_halves(const SerialWarp& w, const float* lp,
                               const float* lt_b, const float* le,
                               float* alphas, float* logz) {
  const int lane = w.lane, K = w.K;
  const int i = lane % kHalf, half = lane / kHalf, j0 = half * kHalfTerms;
  const bool own = i < K;
  const int nh = half ? K - kHalfTerms : kHalfTerms;
  float row[kHalfTerms];  // logA[i][j0 .. j0 + 7]
#pragma unroll
  for (int jj = 0; jj < kHalfTerms; ++jj)
    row[jj] = own && jj < nh ? lt_b[i * K + j0 + jj] : 0.0f;
  float* a_s = w.vec;
  a_s[lane] = 0.0f;  // both buffers; read after acquire()'s __syncwarp
  const WarpRing<true> r(w.ring, le, w.T, w.B, w.b, K, w.ts);
  const int64_t step = w.B * K;
  float cum = 0.0f;

  r.prologue();
  for (int tile = 0; tile < r.tiles; ++tile) {
    const float* ev = r.acquire(tile);
    auto feed = r.feed(tile);
    int64_t t0, t1;
    r.span(tile, t0, t1);
    float* out = alphas + t0 * step + w.b * K;
    for (int64_t t = t0; t < t1; ++t, ev += K, out += step) {
      r.copy<false>(feed, static_cast<int>(t - t0));
      float raw;
      if (t == 0) {
        raw = own ? lp[w.b * K + i] + ev[i] : -INFINITY;
      } else {
        raw = lse_halves(row, a_s + kHalf * ((t - 1) & 1) + j0, nh);
        raw = own ? raw + ev[i] : -INFINITY;
      }
      const float m = half_max(raw);
      if (own && half == 0) {
        const float a = raw - m;
        a_s[kHalf * (t & 1) + i] = a;
        out[i] = a;
      }
      cum = cum + m;
      __syncwarp();
    }
    r.commit();
  }
  if (lane != 0) return;
  const float* a_last = a_s + kHalf * ((w.T - 1) & 1);
  float m = a_last[0];
  for (int k = 1; k < K; ++k) m = fmaxf(m, a_last[k]);
  float s = expf(a_last[0] - m);
  for (int k = 1; k < K; ++k) s += expf(a_last[k] - m);
  logz[w.b] = cum + m + logf(s);
}

// K > 16: lane i state i (KMAX = 32, the row in registers) or states
// lane, lane + 32, ... (KMAX = 0, the table in shared or device memory).
template <int KMAX>
__device__ void forward_rows(const SerialWarp& w, const float* lp,
                             const float* lt_b, const float* le,
                             float* alphas, float* logz) {
  const int lane = w.lane, K = w.K;
  float* a_s = w.vec;          // alpha_{t-1}
  float* n_s = w.vec + w.vk;   // alpha_t before its shift (K > 32)
  const WarpRing<true> r(w.ring, le, w.T, w.B, w.b, K, w.ts);
  const int64_t step = w.B * K;

  const bool own = lane < K;
  float row[KMAX > 0 ? KMAX : 1];  // logA[lane][:]
  Table tab{lt_b, K};
  if constexpr (KMAX > 0) {
#pragma unroll
    for (int j = 0; j < KMAX; ++j)
      row[j] = own && j < K ? lt_b[lane * K + j] : 0.0f;
  } else {
    tab = load_table(lt_b, w.vec + 3 * w.vk, K, w.table, lane);
  }
  float cum = 0.0f;

  r.prologue();
  for (int tile = 0; tile < r.tiles; ++tile) {
    const float* ev = r.acquire(tile);
    auto feed = r.feed(tile);
    int64_t t0, t1;
    r.span(tile, t0, t1);
    float* out = alphas + t0 * step + w.b * K;
    for (int64_t t = t0; t < t1; ++t, ev += K, out += step) {
      r.copy<KMAX == 0>(feed, static_cast<int>(t - t0));
      if constexpr (KMAX > 0) {
        float mine = -INFINITY;
        if (own) {
          if (t == 0) {
            mine = lp[w.b * K + lane] + ev[lane];
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
            raw = lp[w.b * K + i] + ev[i];
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
  logz[w.b] = cum + m + logf(s);
}

// ---- K5 (a): the beta recursion --------------------------------------------
// beta_{T-1} = 0; for t < T-1
//   s[i][j]   = logA[i][j] + le_{t+1}[i] + beta_{t+1}[i]
//   beta_t[j] = lse_i(s[i][j]), max-normalised over j

// K <= 16: s[i][j] = logA[i][j] + u_{t+1}[i], u = le + beta; lane l takes
// state j = l % 16 and the terms i of half l / 16 from its 8 entries of
// column j; u_{t+1} in the ping-pong buffer (t + 1) % 2 of vec.
__device__ void beta_halves(const SerialWarp& w, const float* lt_b,
                            const float* le, float* betas) {
  const int lane = w.lane, K = w.K;
  const int j = lane % kHalf, half = lane / kHalf, i0 = half * kHalfTerms;
  const bool own = j < K;
  const int nh = half ? K - kHalfTerms : kHalfTerms;
  float col[kHalfTerms];  // logA[i0 .. i0 + 7][j]
#pragma unroll
  for (int ii = 0; ii < kHalfTerms; ++ii)
    col[ii] = own && ii < nh ? lt_b[(i0 + ii) * K + j] : 0.0f;
  float* u_s = w.vec;
  u_s[lane] = 0.0f;  // both buffers; read after acquire()'s __syncwarp
  const WarpRing<false> r(w.ring, le, w.T, w.B, w.b, K, w.ts);
  const int64_t step = w.B * K;

  r.prologue();
  for (int tile = 0; tile < r.tiles; ++tile) {
    const float* base = r.acquire(tile);
    auto feed = r.feed(tile);
    int64_t t0, t1;
    r.span(tile, t0, t1);
    const float* ev = base + (t1 - 1 - t0) * K;
    float* out = betas + (t1 - 1) * step + w.b * K;
    for (int64_t t = t1 - 1; t >= t0; --t, ev -= K, out -= step) {
      r.copy<false>(feed, static_cast<int>(t1 - 1 - t));
      float beta = 0.0f;
      if (t < w.T - 1) {
        float raw = lse_halves(col, u_s + kHalf * ((t + 1) & 1) + i0, nh);
        raw = own ? raw : -INFINITY;
        beta = raw - half_max(raw);
      }
      if (own && half == 0) {
        out[j] = beta;
        u_s[kHalf * (t & 1) + j] = ev[j] + beta;
      }
      __syncwarp();
    }
    r.commit();
  }
}

// K > 16: lane j computes beta_t[j] from column j of logA (KMAX = 32), or
// states lane, lane + 32, ... (KMAX = 0).
template <int KMAX>
__device__ void beta_rows(const SerialWarp& w, const float* lt_b,
                          const float* le, float* betas) {
  const int lane = w.lane, K = w.K;
  float* b_s = w.vec;              // beta_{t+1}
  float* l_s = w.vec + w.vk;       // le_{t+1}
  float* n_s = w.vec + 2 * w.vk;   // beta_t before its shift (K > 32)
  const WarpRing<false> r(w.ring, le, w.T, w.B, w.b, K, w.ts);
  const int64_t step = w.B * K;

  const bool own = lane < K;
  float col[KMAX > 0 ? KMAX : 1];  // logA[:][lane]
  Table tab{lt_b, K};
  if constexpr (KMAX > 0) {
#pragma unroll
    for (int i = 0; i < KMAX; ++i)
      col[i] = own && i < K ? lt_b[i * K + lane] : 0.0f;
  } else {
    tab = load_table(lt_b, w.vec + 3 * w.vk, K, w.table, lane);
  }
  for (int i = lane; i < K; i += kWarp) b_s[i] = 0.0f;

  r.prologue();
  for (int tile = 0; tile < r.tiles; ++tile) {
    const float* base = r.acquire(tile);
    auto feed = r.feed(tile);
    int64_t t0, t1;
    r.span(tile, t0, t1);
    const float* ev = base + (t1 - 1 - t0) * K;
    float* out = betas + (t1 - 1) * step + w.b * K;
    for (int64_t t = t1 - 1; t >= t0; --t, ev -= K, out -= step) {
      r.copy<KMAX == 0>(feed, static_cast<int>(t1 - 1 - t));
      if (t < w.T - 1) {
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

// ---- K4 and K5 (a) in one launch ---------------------------------------------
// Global warp g: with roles 3, chain g / 2, the forward recursion when g is
// even and the beta recursion when odd; with roles 1 (forward) or 2 (beta),
// chain g.  Each warp's shared memory is serial_warp_floats(K, ts, table).
template <int KMAX>
__global__ void __launch_bounds__(kWarp * kChainWarps)
    fb_wide_serial_kernel(const float* __restrict__ lp,
                          const float* __restrict__ lt,
                          const float* __restrict__ le,
                          float* __restrict__ alphas, float* __restrict__ logz,
                          float* __restrict__ betas, int64_t T, int64_t B,
                          int K, int ts, int table_smem, int roles) {
  extern __shared__ __align__(16) float smem[];
  const int warp = static_cast<int>(threadIdx.x) / kWarp;
  const int64_t g =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x / kWarp) + warp;
  const bool both = roles == 3;
  const bool forward = both ? (g & 1) == 0 : roles == 1;
  const int64_t b = both ? g >> 1 : g;
  if (b >= B) return;  // the whole warp: nothing below spans warps
  const bool table = KMAX == 0 && table_smem;
  SerialWarp w;
  w.T = T;
  w.B = B;
  w.b = b;
  w.K = K;
  w.ts = ts;
  w.lane = static_cast<int>(threadIdx.x) % kWarp;
  w.table = table;
  w.ring = smem + warp * serial_warp_floats(K, ts, table);
  w.vec = w.ring + serial_ring_floats(K, ts);
  w.vk = serial_vec_floats(K);
  const float* lt_b = lt + b * K * K;
  if constexpr (KMAX == kHalf) {
    if (forward)
      forward_halves(w, lp, lt_b, le, alphas, logz);
    else
      beta_halves(w, lt_b, le, betas);
  } else {
    if (forward)
      forward_rows<KMAX>(w, lp, lt_b, le, alphas, logz);
    else
      beta_rows<KMAX>(w, lt_b, le, betas);
  }
}

// ---- K5 (b): the marginals --------------------------------------------------
// Unit (tile s, chain b), b fastest; steps [s * tile, (s+1) * tile):
//   gamma_t    = softmax(alpha_t + beta_t)
//   xi_t[i][j] = softmax_ij(alpha_t[j] + s[i][j])    (t < T-1; s as above)
//   part[s]    = sum of the tile's xi_t in step order
// STEPS also writes each xi_t to xi_steps[t].

// K <= 16: a half-warp a unit, lane l entries (4m + l / 4, 4 (l % 4) + k);
// s[i][j] = logA[i][j] + u[i], u = le_{t+1} + beta_{t+1}.  The chain's
// table sits in the half's 16 x 16 slot of shared memory (zero past K),
// read as one float4 a row; a step's inputs are loaded one step ahead.
// Every lane runs `tile` steps (a unit past the batch, or past its tile's
// end, computes and stores nothing), so the shuffles always find their
// whole warp.
template <bool STEPS>
__global__ void __launch_bounds__(kWarp * kChainWarps, kMargBlocksPerSM)
    fb_wide_marg_half_kernel(const float* __restrict__ lt,
                             const float* __restrict__ le,
                             const float* __restrict__ alphas,
                             const float* __restrict__ betas,
                             float* __restrict__ gammas,
                             float* __restrict__ part,
                             float* __restrict__ xi_steps, int64_t T,
                             int64_t B, int K, int64_t tile, int64_t tiles) {
  __shared__ __align__(16) float tab_s[2 * kChainWarps][kHalf * kHalf];
  const int lane = static_cast<int>(threadIdx.x) % kWarp;
  const int half = lane / kHalf, l = lane % kHalf;
  const int q = l / 4, c = l % 4;  // rows 4m + q, columns 4c + k
  const int64_t unit =
      (static_cast<int64_t>(blockIdx.x) * kChainWarps +
       static_cast<int>(threadIdx.x) / kWarp) * 2 + half;
  const bool active = unit < tiles * B;
  const int64_t b = active ? unit % B : 0;
  const int64_t t0 = active ? (unit / B) * tile : 0;
  const int64_t t_end = !active ? 0 : (t0 + tile < T ? t0 + tile : T);
  const int64_t step = B * K;
  const int64_t kk = static_cast<int64_t>(K) * K;
  const bool lk = l < K;
  const bool full = K == kHalf;  // whole float4s: the vector stores
  // bit m of rows_in: row 4m + q < K; bit k of cols_in: column 4c + k < K
  unsigned rows_in = 0, cols_in = 0;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    rows_in |= (4 * m + q < K ? 1u : 0u) << m;
    cols_in |= (4 * c + m < K ? 1u : 0u) << m;
  }
  const auto in = [&](int m, int k) {
    return ((rows_in >> m) & (cols_in >> k) & 1u) != 0;
  };
  float* tab = tab_s[threadIdx.x / kHalf];
  for (int idx = l; idx < kHalf * kHalf; idx += kHalf) {
    const int r = idx / kHalf, j = idx % kHalf;
    tab[idx] = active && r < K && j < K ? lt[b * kk + r * K + j] : 0.0f;
  }
  __syncwarp();
  float acc[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[m][k] = 0.0f;
  }
  // alpha_t[l], beta_t[l], le_{t+1}[l], beta_{t+1}[l] of the step to come
  int64_t at = t0 * step + b * K;
  const bool first = t0 < t_end && lk, first_xi = first && t0 + 1 < T;
  float a_c = first ? alphas[at + l] : 0.0f;
  float b_c = first ? betas[at + l] : 0.0f;
  float le_n = first_xi ? le[at + step + l] : 0.0f;
  float b_n = first_xi ? betas[at + step + l] : 0.0f;
  for (int64_t n = 0; n < tile; ++n, at += step) {
    const int64_t t = t0 + n;
    const bool on = t < t_end;
    const bool has_xi = on && t + 1 < T;
    // the next step's inputs, in flight while this step computes
    const bool next = t + 1 < t_end && lk, next_xi = next && t + 2 < T;
    const float a_x = next ? alphas[at + step + l] : 0.0f;
    const float le_x = next_xi ? le[at + 2 * step + l] : 0.0f;
    const float b_x = next_xi ? betas[at + 2 * step + l] : 0.0f;
    // gamma_t: lane l, state l
    const float g = on && lk ? a_c + b_c : -INFINITY;
    const float mg = half_max(g);
    const float e = on && lk ? expf(g - mg) : 0.0f;
    const float gs = half_sum(e);
    if (on && lk) gammas[at + l] = e / gs;
    // xi_t: u_l = le_{t+1}[l] + beta_{t+1}[l], spread to the rows' lanes
    const float u_l = has_xi && lk ? le_n + b_n : 0.0f;
    float ak[4], x[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      ak[k] = __shfl_sync(kFullMask, a_c, 4 * c + k, kHalf);
    float lm = -INFINITY;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const float um = __shfl_sync(kFullMask, u_l, 4 * m + q, kHalf);
      const float4 row =
          *reinterpret_cast<const float4*>(tab + (4 * m + q) * kHalf + 4 * c);
      const float am[4] = {row.x, row.y, row.z, row.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        x[m][k] = in(m, k) ? ak[k] + (am[k] + um) : -INFINITY;
        lm = fmaxf(lm, x[m][k]);
      }
    }
    const float mx = half_max(lm);
    float rs[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
#pragma unroll
      for (int k = 0; k < 4; ++k) x[m][k] = expf(x[m][k] - mx);
      rs[m] = ((x[m][0] + x[m][1]) + x[m][2]) + x[m][3];
      rs[m] = rs[m] + __shfl_xor_sync(kFullMask, rs[m], 1);
      rs[m] = rs[m] + __shfl_xor_sync(kFullMask, rs[m], 2);
    }
    float tot = (rs[0] + rs[1]) + (rs[2] + rs[3]);
    tot = tot + __shfl_xor_sync(kFullMask, tot, 4);
    tot = tot + __shfl_xor_sync(kFullMask, tot, 8);
    if (has_xi) {
#pragma unroll
      for (int m = 0; m < 4; ++m) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          x[m][k] = x[m][k] / tot;
          acc[m][k] += x[m][k];
        }
      }
      if constexpr (STEPS) {
        float* dst = xi_steps + at * K;
        if (full) {
#pragma unroll
          for (int m = 0; m < 4; ++m)
            reinterpret_cast<float4*>(dst)[kHalf * m + l] =
                make_float4(x[m][0], x[m][1], x[m][2], x[m][3]);
        } else {
#pragma unroll
          for (int m = 0; m < 4; ++m) {
#pragma unroll
            for (int k = 0; k < 4; ++k)
              if (in(m, k)) dst[(4 * m + q) * K + 4 * c + k] = x[m][k];
          }
        }
      }
    }
    a_c = a_x;
    b_c = b_n;
    le_n = le_x;
    b_n = b_x;
  }
  if (!active) return;
  float* part_u = part + unit * kk;  // (tiles, B, K, K): unit = s * B + b
  if (full) {
#pragma unroll
    for (int m = 0; m < 4; ++m)
      reinterpret_cast<float4*>(part_u)[kHalf * m + l] =
          make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  } else {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (in(m, k)) part_u[(4 * m + q) * K + 4 * c + k] = acc[m][k];
    }
  }
}

// K > 16: a warp a unit, lane i row i of xi_t and of the tile's partial
// (registers for K <= 32; above, rows lane, lane + 32, ... and the partial
// accumulates in the output `part` in place).  The maxima are warp
// reductions; the row sums are gathered through shared memory and summed in
// row order by every lane.  With STEPS at K <= 32 a step's K x K block is
// staged in shared memory and written out by the warp in order.
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

// The serial kernel's launch: warps a CTA, staged steps a tile, whether the
// table sits in shared memory, and the CTA's dynamic shared memory.
struct SerialCfg {
  int warps, ts, table;
  int bytes;
};

// K <= 32: four warps a CTA, the longest tile that fits.  K > 32: a warp a
// CTA, the table in shared memory at the longest tile that lets it fit,
// else in device memory.  False when not even a one-step ring fits.
bool serial_cfg(int K, SerialCfg& cfg) {
  const int64_t optin = smem_optin();
  const bool general = K > 32;
  const int warps = general ? 1 : kChainWarps;
  for (int with_table = general ? 1 : 0; with_table >= 0; --with_table) {
    for (int ts = kTileSteps; ts >= 1; ts /= 2) {
      const int64_t bytes = static_cast<int64_t>(sizeof(float)) * warps *
                            serial_warp_floats(K, ts, with_table != 0);
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
int launch_serial(const SerialCfg& c, int roles, const float* lp,
                  const float* lt, const float* le, float* alphas,
                  float* logz, float* betas, int64_t T, int64_t B, int K,
                  cudaStream_t stream) {
  int rc = allow_smem(fb_wide_serial_kernel<KMAX>, c.bytes);
  if (rc != 0) return rc;
  const int64_t warps = roles == 3 ? 2 * B : B;
  fb_wide_serial_kernel<KMAX><<<grid_for(warps, c.warps), c.warps * kWarp,
                                 c.bytes, stream>>>(
      lp, lt, le, alphas, logz, betas, T, B, K, c.ts, c.table, roles);
  return static_cast<int>(cudaGetLastError());
}

template <int KMAX, bool STEPS>
int launch_marg_rows(const float* lt, const float* le, const float* alphas,
                     const float* betas, float* gammas, float* part,
                     float* xi_steps, int64_t T, int64_t B, int K,
                     int64_t tile, int64_t tiles, cudaStream_t stream) {
  const int bytes =
      KMAX > 0 ? 0 : static_cast<int>(sizeof(float)) * kChainWarps * 2 * K;
  const int rc = allow_smem(fb_wide_marg_kernel<KMAX, STEPS>, bytes);
  if (rc != 0) return rc;
  fb_wide_marg_kernel<KMAX, STEPS><<<grid_for(tiles * B, kChainWarps),
                                     kChainWarps * kWarp, bytes, stream>>>(
      lt, le, alphas, betas, gammas, part, xi_steps, T, B, K, tile, tiles);
  return static_cast<int>(cudaGetLastError());
}

template <bool STEPS>
int launch_marg_half(const float* lt, const float* le, const float* alphas,
                     const float* betas, float* gammas, float* part,
                     float* xi_steps, int64_t T, int64_t B, int K,
                     int64_t tile, int64_t tiles, cudaStream_t stream) {
  fb_wide_marg_half_kernel<STEPS><<<grid_for(tiles * B, 2 * kChainWarps),
                                     kChainWarps * kWarp, 0, stream>>>(
      lt, le, alphas, betas, gammas, part, xi_steps, T, B, K, tile, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each launcher returns the CUDA error of its launches (0 = success); K >= 1
// (the wrapper takes K > 8 here).  Layouts as in fused_fb.cu.

// The forward and / or beta recursion: roles 1 writes alphas (T, B, K) and
// logz (B,), 2 writes betas (T, B, K), 3 both, in one launch (pointers a
// role does not write may be null).
int rxt_fb_wide_serial(int k, int roles, const float* lp, const float* lt,
                       const float* le, float* alphas, float* logz,
                       float* betas, int64_t T, int64_t B, void* stream) {
  SerialCfg c;
  if (k < 1 || T < 1 || B < 1 || roles < 1 || roles > 3 ||
      ((roles & 1) && (!lp || !alphas || !logz)) ||
      ((roles & 2) && !betas) || !serial_cfg(k, c))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RXT_SERIAL(KMAX) \
  launch_serial<KMAX>(c, roles, lp, lt, le, alphas, logz, betas, T, B, k, s)
  if (k <= kHalf) return RXT_SERIAL(kHalf);
  if (k <= 32) return RXT_SERIAL(32);
  return RXT_SERIAL(0);
#undef RXT_SERIAL
}

// The marginals from alphas and betas: gammas (T, B, K), the per-tile xi
// partials into part (tiles, B, K, K), summed into xi_sum in tile order
// (part is xi_sum when tiles == 1), and with per_step the per-step xi
// (T-1, B, K, K) (xi_steps may be null when per_step is 0 or T is 1).
int rxt_fb_wide_marg(int k, int per_step, const float* lt, const float* le,
                     const float* alphas, const float* betas, float* gammas,
                     float* part, float* xi_sum, float* xi_steps, int64_t T,
                     int64_t B, int64_t tile, int64_t tiles, void* stream) {
  if (k < 1 || T < 1 || B < 1 || tile < 1 || tiles != (T + tile - 1) / tile ||
      (per_step && T > 1 && !xi_steps))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool st = per_step != 0;
  int rc;
  if (k <= kHalf) {
    rc = st ? launch_marg_half<true>(lt, le, alphas, betas, gammas, part,
                                     xi_steps, T, B, k, tile, tiles, s)
            : launch_marg_half<false>(lt, le, alphas, betas, gammas, part,
                                      xi_steps, T, B, k, tile, tiles, s);
  } else if (k <= 32) {
    rc = st ? launch_marg_rows<32, true>(lt, le, alphas, betas, gammas, part,
                                         xi_steps, T, B, k, tile, tiles, s)
            : launch_marg_rows<32, false>(lt, le, alphas, betas, gammas,
                                          part, xi_steps, T, B, k, tile,
                                          tiles, s);
  } else {
    rc = st ? launch_marg_rows<0, true>(lt, le, alphas, betas, gammas, part,
                                        xi_steps, T, B, k, tile, tiles, s)
            : launch_marg_rows<0, false>(lt, le, alphas, betas, gammas, part,
                                         xi_steps, T, B, k, tile, tiles, s);
  }
  if (rc != 0 || tiles == 1) return rc;
  const int64_t n = B * static_cast<int64_t>(k) * k;
  fb_xisum_kernel<<<grid_for(n, 256), 256, 0, s>>>(part, xi_sum, tiles, n);
  return static_cast<int>(cudaGetLastError());
}

// How the serial kernel runs at K on the current device: staged steps a
// tile and whether the table sits in shared memory (K > 32).  Returns 0, or
// the error when no launch fits.
int rxt_fb_wide_serial_plan(int k, int* ts, int* table) {
  SerialCfg c;
  if (k < 1 || !serial_cfg(k, c))
    return static_cast<int>(cudaErrorInvalidValue);
  *ts = c.ts;
  *table = c.table;
  return 0;
}

// Warps an SM holds of the K <= 16 marginal kernel by its launch bounds
// (ops/fused_fb.py MARGINAL_WARPS_PER_SM checks it), and the blocks of it
// with the per-step xi an SM holds on the current device with its
// registers (0 on an error).
int rxt_fb_wide_marg_warps_per_sm() { return kMargBlocksPerSM * kChainWarps; }

int rxt_fb_wide_marg_blocks_per_sm() {
  int blocks = 0;
  const cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, fb_wide_marg_half_kernel<true>, kChainWarps * kWarp, 0);
  return rc == cudaSuccess ? blocks : 0;
}

const char* rxt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

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
//     16 < K <= 32 (`fb_wide_marg_rows_kernel`): a warp a (tile, chain),
//     lane i row i of each step's block, so that every sum keeps the plain
//     version's index order in one lane (a row sum) or over a vector in
//     shared memory (gamma's sum, the sum of the row sums) and the kernel
//     gives the plain version's bits.  What held its first design (a warp a
//     tile and chain with its rows in registers: 4.91 ms at (1024, 1000,
//     32) on an H100 80GB HBM3 at 700 W, 29% of its bound) to a quarter
//     of the HBM rate was instructions, not bytes: the per-step block was
//     copied out element by element with an integer division and a modulo
//     by K each, the broadcasts and the in-order sums read one float a
//     load, and the step's inputs were loaded when needed.  Now the chain's table
//     and each step's block sit in the warp's shared memory at a row stride
//     that spreads a column over the banks (K + 4 or K + 8 with an odd
//     number of float4s a row at K % 4 == 0, else an odd stride); the
//     block goes out in contiguous order, the lanes' offsets into the stage
//     fixed for the unit, as whole 16-byte stores (K % 4 == 0: 512
//     contiguous bytes a warp store, eight a step at K = 32) or 128
//     contiguous bytes a store; the table row, alpha_t and the sums'
//     vectors are read as float4s; the step's inputs are loaded one step
//     ahead; four CTAs of four warps an SM (`kMargRowsBlocksPerSM`, 128
//     registers), and the tile rule puts every (tile, chain) on the card
//     in one wave of them.
//     32 < K <= 64 (`fb_wide_marg_rows2_kernel`): the 16 < K <= 32
//     design on a CTA of four warps a (tile, chain), two threads a row
//     (lane l its first 32 columns, lane l ^ 16 the rest, the second
//     half's row sum taken on from the first's by a shuffle, so the sum
//     keeps its column order), the tile's partial of a half-row in its
//     thread's registers, the table and each step's block in the CTA's
//     shared memory at marg_row_stride(K) (17,408 bytes each at K = 64),
//     the block out in contiguous 16-byte stores, the step's inputs a step
//     ahead (alpha_{t+1} into a second vector, so that a step needs no
//     barrier for it), the exponentials computed once and kept for the
//     output.  The four warps meet at three barriers a step: their maxima,
//     their exps' and row sums' vectors, the staged block.  A first design,
//     two warps a unit and a thread a row, put two warps on a scheduler at
//     the 512 units of the 64-state cell, too few to hide a step's latency.
//     On an H100 80GB HBM3 at 700 W at (512, 1000, 64) with the per-step
//     xi (scripts/marg_rows2_variants.py): this design 6.03 ms (128
//     registers, 28 bytes of spill), without the quotients by a reciprocal
//     and the split sums 6.69; each warp copying its own staged rows out
//     without barrier C, 6.19; a block staged in two buffers and copied
//     out a step later, 7.10; four threads a row, 7.15.  What held
//     `fb_wide_marg_kernel` below a third of its bound at K = 32 held it
//     past 32 too: each (i, j) exp computed
//     three times (the maximum, the row sums, the output), the table read
//     from device memory on each pass, the partial accumulated in place in
//     device memory (a read and a write of K^2 floats a step), the per-step
//     block stored a row a lane (K floats apart), the inputs loaded when
//     needed.  Four CTAs an SM (`kMargRows2BlocksPerSM`: registers and
//     shared memory), the tile rule one wave of them.
//     K > 64 (`fb_wide_marg_kernel`): a warp a (tile, chain), rows lane,
//     lane + 32, ..., the partial accumulated in the output `part` in
//     place, the row sums summed in row order.
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
constexpr int kMargRowsBlocksPerSM = 4;  // 16 < K <= 32 marginal CTAs an SM
constexpr int kRowsMax = 32;            // 16 < K <= 32: a lane a row
constexpr int kRowStrideMax = 36;       // the rows' largest stride
constexpr int kRows2Max = 64;           // 32 < K <= 64: a thread a row
constexpr int kRows2StrideMax = 68;     // the rows' largest stride there
constexpr int kRows2Half = 32;          // columns a thread takes there
constexpr int kRows2Threads = 4 * kWarp;  // a CTA: one (tile, chain)
constexpr int kMargRows2BlocksPerSM = 4;  // 32 < K <= 64 marginal CTAs an SM

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

// The row stride of a 16 < K <= 32 chain's table and stage: at K % 4 == 0
// whole float4s, an odd number of them (a float4 column read takes eight
// distinct bank quads a phase); else odd (a column read takes 32 banks).
__host__ __device__ constexpr int marg_row_stride(int K) {
  return K % 4 != 0 ? (K | 1) : ((K / 4) % 2 == 0 ? K + 4 : K + 8);
}

// v[0] + v[1] + ... + v[n-1] in index order, n <= NMAX, v 16-byte aligned
// in shared memory and read as float4s.
template <int NMAX = kRowsMax>
__device__ __forceinline__ float sum_vec(const float* v, int n) {
  float s = v[0];
#pragma unroll
  for (int q = 0; q < NMAX / 4; ++q) {
    const float4 x = reinterpret_cast<const float4*>(v)[q];
    const float e[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = 4 * q + k;
      if (i > 0 && i < n) s += e[k];
    }
  }
  return s;
}

// 16 < K <= 32: a warp a unit, lane i row i of xi_t and of the tile's
// partial (registers); the chain's table and each step's xi in the warp's
// shared memory at row stride marg_row_stride(K); VEC (K % 4 == 0) reads
// rows as float4s and writes the step's block as 16-byte stores.  The
// maxima are warp reductions; the row sums run in column order in their
// lane and the sum of the row sums over a vector in shared memory in row
// order, as the plain version's.  A unit's warp runs all of its steps (no
// warp of the block waits on another).
template <bool VEC, bool STEPS>
__global__ void __launch_bounds__(kWarp * kChainWarps, kMargRowsBlocksPerSM)
    fb_wide_marg_rows_kernel(const float* __restrict__ lt,
                             const float* __restrict__ le,
                             const float* __restrict__ alphas,
                             const float* __restrict__ betas,
                             float* __restrict__ gammas,
                             float* __restrict__ part,
                             float* __restrict__ xi_steps, int64_t T,
                             int64_t B, int K, int64_t tile, int64_t tiles) {
  constexpr int kRows = kRowsMax * kRowStrideMax;
  __shared__ __align__(16) float tab_s[kChainWarps][kRows];
  __shared__ __align__(16) float stage_s[kChainWarps][STEPS ? kRows : 4];
  __shared__ __align__(16) float vec_s[kChainWarps][2 * kRowsMax];
  const int warp = static_cast<int>(threadIdx.x) / kWarp;
  const int lane = static_cast<int>(threadIdx.x) % kWarp;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kChainWarps + warp;
  if (w >= tiles * B) return;
  const int64_t b = w % B;
  const int64_t t0 = (w / B) * tile;
  const int64_t t_end = t0 + tile < T ? t0 + tile : T;
  const int64_t step = B * K;
  const int kk = K * K;
  const int sk = marg_row_stride(K);
  const bool own = lane < K;
  float* tab = tab_s[warp];
  float* stage = stage_s[warp];
  float* a_s = vec_s[warp];      // alpha_t
  float* v_s = a_s + kRowsMax;   // the exps of gamma, then the row sums
  for (int i = lane; i < kRowsMax; i += kWarp) {
    a_s[i] = 0.0f;
    v_s[i] = 0.0f;
  }
  for (int idx = lane; idx < kk; idx += kWarp)
    tab[(idx / K) * sk + idx % K] = lt[b * kk + idx];
  // VEC: the stage's offsets of this lane's float4s of a step's block, in
  // the block's contiguous order: float4 lane + 32 n
  constexpr int kOut4 = kRowsMax * kRowsMax / 4 / kWarp;
  int off[VEC ? kOut4 : 1];
  if constexpr (VEC) {
#pragma unroll
    for (int n = 0; n < kOut4; ++n) {
      const int e = 4 * (lane + kWarp * n);
      off[n] = e < kk ? (e / K) * sk + e % K : -1;
    }
  }
  __syncwarp();
  float acc[kRowsMax];
#pragma unroll
  for (int j = 0; j < kRowsMax; ++j) acc[j] = 0.0f;
  // alpha_t, beta_t, le_{t+1}, beta_{t+1} of the step to come
  int64_t at = t0 * step + b * K;
  const bool first_xi = own && t0 + 1 < T;
  float a_c = own ? alphas[at + lane] : 0.0f;
  float b_c = own ? betas[at + lane] : 0.0f;
  float le_n = first_xi ? le[at + step + lane] : 0.0f;
  float b_n = first_xi ? betas[at + step + lane] : 0.0f;
  const float* row = tab + lane * sk;
  for (int64_t t = t0; t < t_end; ++t, at += step) {
    // the next step's inputs, in flight while this step computes
    const bool next = own && t + 1 < t_end, next_xi = next && t + 2 < T;
    const float a_x = next ? alphas[at + step + lane] : 0.0f;
    const float le_x = next_xi ? le[at + 2 * step + lane] : 0.0f;
    const float b_x = next_xi ? betas[at + 2 * step + lane] : 0.0f;
    // gamma_t: lane i, state i
    const float g = a_c + b_c;
    const float mg = warp_max(own ? g : -INFINITY);
    const float e = expf(g - mg);
    if (own) {
      a_s[lane] = a_c;
      v_s[lane] = e;
    }
    __syncwarp();
    const float gs = sum_vec(v_s, K);
    if (own) gammas[at + lane] = e / gs;
    if (t + 1 < T) {
      // x[j] = alpha_t[j] + ((logA[i][j] + le_{t+1}[i]) + beta_{t+1}[i])
      float x[kRowsMax];
      float lm = -INFINITY;
#pragma unroll
      for (int q = 0; q < kRowsMax / 4; ++q) {
        const float4 av = reinterpret_cast<const float4*>(a_s)[q];
        float r4[4];
        if (VEC) {
          if (own && 4 * q < K) {
            const float4 rv = *reinterpret_cast<const float4*>(row + 4 * q);
            r4[0] = rv.x; r4[1] = rv.y; r4[2] = rv.z; r4[3] = rv.w;
          } else {
            r4[0] = r4[1] = r4[2] = r4[3] = 0.0f;
          }
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            r4[k] = own && 4 * q + k < K ? row[4 * q + k] : 0.0f;
        }
        const float a4[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int j = 4 * q + k;
          x[j] = a4[k] + ((r4[k] + le_n) + b_n);
          if (j < K) lm = fmaxf(lm, x[j]);
        }
      }
      const float mx = warp_max(own ? lm : -INFINITY);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < kRowsMax; ++j) {
        if (j < K) {
          x[j] = expf(x[j] - mx);
          rs = j == 0 ? x[j] : rs + x[j];
        }
      }
      __syncwarp();  // every lane has read a_s and v_s
      if (own) v_s[lane] = rs;
      __syncwarp();
      const float xs = sum_vec(v_s, K);
      if (own) {
#pragma unroll
        for (int j = 0; j < kRowsMax; ++j) {
          if (j < K) {
            x[j] = x[j] / xs;
            acc[j] += x[j];
          }
        }
      }
      if constexpr (STEPS) {
        if (own) {
          float* dst = stage + lane * sk;
          if (VEC) {
#pragma unroll
            for (int q = 0; q < kRowsMax / 4; ++q)
              if (4 * q < K)
                reinterpret_cast<float4*>(dst)[q] = make_float4(
                    x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
          } else {
#pragma unroll
            for (int j = 0; j < kRowsMax; ++j)
              if (j < K) dst[j] = x[j];
          }
        }
        __syncwarp();
        float* out = xi_steps + at * K;  // (t, b)'s block: (t B + b) K K
        if constexpr (VEC) {
#pragma unroll
          for (int n = 0; n < kOut4; ++n)
            if (off[n] >= 0)
              reinterpret_cast<float4*>(out)[lane + kWarp * n] =
                  *reinterpret_cast<const float4*>(stage + off[n]);
        } else {
          // float e = lane + 32 n sits at row r, column c; 32 floats on is
          // one row and 32 - K columns on (K > 16)
          int r = lane / K, c = lane % K;
          for (int e = lane; e < kk; e += kWarp) {
            out[e] = stage[r * sk + c];
            c += kWarp - K;
            r += 1;
            if (c >= K) {
              c -= K;
              r += 1;
            }
          }
        }
      }
    }
    __syncwarp();  // before a_s, v_s and the stage take the next step
    a_c = a_x;
    b_c = b_n;
    le_n = le_x;
    b_n = b_x;
  }
  if (own) {
    float* part_b = part + w * kk;  // (tiles, B, K, K): w = s * B + b
#pragma unroll
    for (int j = 0; j < kRowsMax; ++j)
      if (j < K) part_b[lane * K + j] = acc[j];
  }
}

// x / s, the IEEE quotient, for x >= 2^-100 and a sum s >= 1 whose
// reciprocal r = RN(1 / s) is known: q0 = x r, then q0 + (x - q0 s) r by
// two fused multiply-adds is the correctly rounded quotient wherever it is
// a normal float (Markstein's theorem; held against the division bit for
// bit on the card and, exactly, on the CPU).  A multiply and two
// multiply-adds a quotient in place of the division's reciprocal, four
// multiply-adds and range check.
__device__ __forceinline__ float quot_by_sum(float x, float s, float r) {
  const float q0 = x * r;
  return fmaf(fmaf(-q0, s, x), r, q0);
}

// The maximum and the minimum of a half-row's x[j], c0 + j < K, as trees
// (both exact in any order).
__device__ __forceinline__ float row_max(const float (&x)[kRows2Half], int c0,
                                        int K) {
  float m[kRows2Half / 4];
#pragma unroll
  for (int q = 0; q < kRows2Half / 4; ++q) {
    m[q] = -INFINITY;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (c0 + 4 * q + k < K) m[q] = fmaxf(m[q], x[4 * q + k]);
  }
#pragma unroll
  for (int w = kRows2Half / 8; w > 0; w /= 2)
#pragma unroll
    for (int q = 0; q < w; ++q) m[q] = fmaxf(m[q], m[q + w]);
  return m[0];
}

__device__ __forceinline__ float row_min(const float (&x)[kRows2Half], int c0,
                                        int K) {
  float m[kRows2Half / 4];
#pragma unroll
  for (int q = 0; q < kRows2Half / 4; ++q) {
    m[q] = INFINITY;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (c0 + 4 * q + k < K) m[q] = fminf(m[q], x[4 * q + k]);
  }
#pragma unroll
  for (int w = kRows2Half / 8; w > 0; w /= 2)
#pragma unroll
    for (int q = 0; q < w; ++q) m[q] = fminf(m[q], m[q + w]);
  return m[0];
}

// 32 < K <= 64: a CTA of four warps a unit, two threads a row: warp w,
// lane l takes row i = 16 w + l % 16 of xi_t and of the tile's partial, its
// columns 32 h .. 32 h + 31 (h = l / 16) in registers.  The chain's table
// and each step's xi sit in the CTA's shared memory at row stride
// marg_row_stride(K); VEC (K % 4 == 0) reads rows as float4s and writes
// the step's block as 16-byte stores.  The maxima are warp reductions met
// through `red`; a row sum runs in column order, its first half in lane l
// and its second half on it in lane l ^ 16 (one shuffle between), gamma's
// sum (lanes l < 16) and the sum of the row sums (lanes l >= 16) over a
// vector in shared memory in index order, as the plain version's, each
// handed to the other half by a shuffle; a row's quotients by the sum's
// reciprocal (quot_by_sum) unless one is below 2^-100, then by the
// division.  Three barriers a step (two without the per-step xi): the
// warps' maxima (A), the exps' and row sums' vectors and alpha_{t+1} (B),
// the staged block (C).  A vector written at a step was last read before
// the previous step's later barriers, so one barrier a vector suffices.
template <bool VEC, bool STEPS>
__global__ void __launch_bounds__(kRows2Threads, kMargRows2BlocksPerSM)
    fb_wide_marg_rows2_kernel(const float* __restrict__ lt,
                              const float* __restrict__ le,
                              const float* __restrict__ alphas,
                              const float* __restrict__ betas,
                              float* __restrict__ gammas,
                              float* __restrict__ part,
                              float* __restrict__ xi_steps, int64_t T,
                              int64_t B, int K, int64_t tile) {
  constexpr int kRows = kRows2Max * kRows2StrideMax;
  constexpr int kWarps = kRows2Threads / kWarp;
  __shared__ __align__(16) float tab[kRows];
  __shared__ __align__(16) float stage[STEPS ? kRows : 4];
  __shared__ __align__(16) float a_s[2][kRows2Max];  // alpha_t by parity
  __shared__ __align__(16) float vg[kRows2Max];      // gamma's exps
  __shared__ __align__(16) float vr[kRows2Max];      // the row sums
  __shared__ float red[kWarps][2];                   // each warp's maxima
  const int tid = static_cast<int>(threadIdx.x);
  const int warp = tid / kWarp, lane = tid % kWarp;
  const int half = lane / kHalf;
  const int i = kHalf * warp + lane % kHalf;  // the thread's row (state)
  const int c0 = kRows2Half * half;           // and its first column
  const int64_t w = blockIdx.x;  // the unit: s * B + b
  const int64_t b = w % B;
  const int64_t t0 = (w / B) * tile;
  const int64_t t_end = t0 + tile < T ? t0 + tile : T;
  const int64_t step = B * K;
  const int kk = K * K;
  const int sk = marg_row_stride(K);
  const bool own = i < K;                // a row of the block
  const bool lead = own && half == 0;    // the row's state: gamma, alpha
  for (int n = tid; n < kRows2Max; n += kRows2Threads) {
    a_s[0][n] = 0.0f;
    a_s[1][n] = 0.0f;
    vg[n] = 0.0f;
    vr[n] = 0.0f;
  }
  for (int idx = tid; idx < kk; idx += kRows2Threads)
    tab[(idx / K) * sk + idx % K] = lt[b * kk + idx];
  float acc[kRows2Half];
#pragma unroll
  for (int j = 0; j < kRows2Half; ++j) acc[j] = 0.0f;
  // alpha_t, beta_t (the row's state), le_{t+1}, beta_{t+1} of the step to
  // come (both halves)
  int64_t at = t0 * step + b * K;
  const bool first_xi = own && t0 + 1 < T;
  float a_c = lead ? alphas[at + i] : 0.0f;
  float b_c = lead ? betas[at + i] : 0.0f;
  float le_n = first_xi ? le[at + step + i] : 0.0f;
  float b_n = first_xi ? betas[at + step + i] : 0.0f;
  __syncthreads();  // the vectors are zero (another thread zeroed row i's)
  if (lead) a_s[0][i] = a_c;
  // the copy-out: this thread's first (row, column) of the block in its
  // contiguous order and the step to the next one (VEC: float4 tid + 128 n;
  // else float tid + 128 n)
  const int span = VEC ? 4 * kRows2Threads : kRows2Threads;
  const int dr = span / K, dc = span % K;
  const int e0 = VEC ? 4 * tid : tid;
  const int r_first = e0 / K, c_first = e0 % K;
  __syncthreads();
  const float* row = tab + i * sk + c0;
  int par = 0;
  for (int64_t t = t0; t < t_end; ++t, at += step, par ^= 1) {
    // the next step's inputs, in flight while this step computes
    const bool next = own && t + 1 < t_end, next_xi = next && t + 2 < T;
    const float a_x = lead && next ? alphas[at + step + i] : 0.0f;
    const float le_x = next_xi ? le[at + 2 * step + i] : 0.0f;
    const float b_x = next_xi ? betas[at + 2 * step + i] : 0.0f;
    const bool xi_t = t + 1 < T;
    // gamma_t: the row's state; x[j] = alpha_t[c0 + j] + ((logA[i][c0 + j]
    // + le_{t+1}[i]) + beta_{t+1}[i])
    const float g = a_c + b_c;
    const float mg_w = warp_max(lead ? g : -INFINITY);
    float x[kRows2Half];
    float lm = -INFINITY;
    if (xi_t) {
#pragma unroll
      for (int q = 0; q < kRows2Half / 4; ++q) {
        const float4 av =
            reinterpret_cast<const float4*>(a_s[par] + c0)[q];
        float r4[4];
        if (VEC) {
          if (own && c0 + 4 * q < K) {
            const float4 rv = *reinterpret_cast<const float4*>(row + 4 * q);
            r4[0] = rv.x; r4[1] = rv.y; r4[2] = rv.z; r4[3] = rv.w;
          } else {
            r4[0] = r4[1] = r4[2] = r4[3] = 0.0f;
          }
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            r4[k] = own && c0 + 4 * q + k < K ? row[4 * q + k] : 0.0f;
        }
        const float a4[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int j = 4 * q + k;
          x[j] = a4[k] + ((r4[k] + le_n) + b_n);
        }
      }
      lm = row_max(x, c0, K);
    }
    const float mx_w = warp_max(own ? lm : -INFINITY);
    if (lane == 0) {
      red[warp][0] = mg_w;
      red[warp][1] = mx_w;
    }
    __syncthreads();  // A
    float mg = red[0][0];
#pragma unroll
    for (int v = 1; v < kWarps; ++v) mg = fmaxf(mg, red[v][0]);
    const float e = expf(g - mg);
    if (lead) vg[i] = e;
    if (xi_t) {
      float mx = red[0][1];
#pragma unroll
      for (int v = 1; v < kWarps; ++v) mx = fmaxf(mx, red[v][1]);
      // the row sum in column order: the first half from x[0], the second
      // half on the first's sum
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < kRows2Half; ++j) {
        if (c0 + j < K) {
          x[j] = expf(x[j] - mx);
          rs = j == 0 ? x[j] : rs + x[j];
        }
      }
      const float first = __shfl_xor_sync(kFullMask, rs, kHalf);
      if (half == 1) {
        rs = first;
#pragma unroll
        for (int j = 0; j < kRows2Half; ++j)
          if (c0 + j < K) rs = rs + x[j];
        if (own) vr[i] = rs;
      }
    }
    if (lead && next) a_s[par ^ 1][i] = a_x;
    __syncthreads();  // B
    // gamma's sum in the first half-warp, the row sums' in the second
    const float mine = sum_vec<kRows2Max>(half ? vr : vg, K);
    const float other = __shfl_xor_sync(kFullMask, mine, kHalf);
    const float gs = half ? other : mine;
    if (lead) gammas[at + i] = e / gs;
    if (xi_t) {
      const float xs = half ? mine : other;
      if (own) {
        if (row_min(x, c0, K) >= 0x1p-100f) {
          const float rx = __frcp_rn(xs);
#pragma unroll
          for (int j = 0; j < kRows2Half; ++j) {
            if (c0 + j < K) {
              x[j] = quot_by_sum(x[j], xs, rx);
              acc[j] += x[j];
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < kRows2Half; ++j) {
            if (c0 + j < K) {
              x[j] = x[j] / xs;
              acc[j] += x[j];
            }
          }
        }
      }
      if constexpr (STEPS) {
        if (own) {
          float* dst = stage + i * sk + c0;
          if (VEC) {
#pragma unroll
            for (int q = 0; q < kRows2Half / 4; ++q)
              if (c0 + 4 * q < K)
                reinterpret_cast<float4*>(dst)[q] = make_float4(
                    x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
          } else {
#pragma unroll
            for (int j = 0; j < kRows2Half; ++j)
              if (c0 + j < K) dst[j] = x[j];
          }
        }
        __syncthreads();  // C
        float* out = xi_steps + at * K;  // (t, b)'s block: (t B + b) K K
        int r = r_first, c = c_first;
        if constexpr (VEC) {
          for (int e4 = tid; 4 * e4 < kk; e4 += kRows2Threads) {
            reinterpret_cast<float4*>(out)[e4] =
                *reinterpret_cast<const float4*>(stage + r * sk + c);
            r += dr;
            c += dc;
            if (c >= K) {
              c -= K;
              r += 1;
            }
          }
        } else {
          for (int el = tid; el < kk; el += kRows2Threads) {
            out[el] = stage[r * sk + c];
            r += dr;
            c += dc;
            if (c >= K) {
              c -= K;
              r += 1;
            }
          }
        }
      }
    }
    a_c = a_x;
    b_c = b_n;
    le_n = le_x;
    b_n = b_x;
  }
  if (own) {
    float* part_b = part + w * kk + i * K + c0;  // (tiles, B, K, K)
#pragma unroll
    for (int j = 0; j < kRows2Half; ++j)
      if (c0 + j < K) part_b[j] = acc[j];
  }
}

// K > 64 (it takes any K): a warp a unit, rows lane, lane + 32, ... of
// xi_t, the tile's partial accumulated in the output `part` in place.  The maxima are warp
// reductions; the row sums are gathered through shared memory and summed
// in row order by every lane.
template <bool STEPS>
__global__ void __launch_bounds__(kWarp * kChainWarps)
    fb_wide_marg_kernel(const float* __restrict__ lt,
                        const float* __restrict__ le,
                        const float* __restrict__ alphas,
                        const float* __restrict__ betas,
                        float* __restrict__ gammas, float* __restrict__ part,
                        float* __restrict__ xi_steps, int64_t T, int64_t B,
                        int K, int64_t tile, int64_t tiles) {
  extern __shared__ __align__(16) float dyn_s[];  // 2 K floats a warp
  const int warp = static_cast<int>(threadIdx.x) / kWarp;
  const int lane = static_cast<int>(threadIdx.x) % kWarp;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kChainWarps + warp;
  if (w >= tiles * B) return;
  const int64_t b = w % B;
  const int64_t t0 = (w / B) * tile;
  const int64_t t_end = t0 + tile < T ? t0 + tile : T;
  const int64_t step = B * K;
  const int64_t kk = static_cast<int64_t>(K) * K;
  float* a_s = dyn_s + warp * 2 * K;  // alpha_t
  float* v_s = a_s + K;               // a gathered vector
  const float* lt_b = lt + b * kk;
  float* part_b = part + w * kk;  // (tiles, B, K, K): w = s * B + b

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

template <bool STEPS>
int launch_marg_general(const float* lt, const float* le, const float* alphas,
                        const float* betas, float* gammas, float* part,
                        float* xi_steps, int64_t T, int64_t B, int K,
                        int64_t tile, int64_t tiles, cudaStream_t stream) {
  const int bytes = static_cast<int>(sizeof(float)) * kChainWarps * 2 * K;
  const int rc = allow_smem(fb_wide_marg_kernel<STEPS>, bytes);
  if (rc != 0) return rc;
  fb_wide_marg_kernel<STEPS><<<grid_for(tiles * B, kChainWarps),
                               kChainWarps * kWarp, bytes, stream>>>(
      lt, le, alphas, betas, gammas, part, xi_steps, T, B, K, tile, tiles);
  return static_cast<int>(cudaGetLastError());
}

template <bool VEC, bool STEPS>
int launch_marg_rows(const float* lt, const float* le, const float* alphas,
                     const float* betas, float* gammas, float* part,
                     float* xi_steps, int64_t T, int64_t B, int K,
                     int64_t tile, int64_t tiles, cudaStream_t stream) {
  fb_wide_marg_rows_kernel<VEC, STEPS><<<grid_for(tiles * B, kChainWarps),
                                         kChainWarps * kWarp, 0, stream>>>(
      lt, le, alphas, betas, gammas, part, xi_steps, T, B, K, tile, tiles);
  return static_cast<int>(cudaGetLastError());
}

template <bool VEC, bool STEPS>
int launch_marg_rows2(const float* lt, const float* le, const float* alphas,
                      const float* betas, float* gammas, float* part,
                      float* xi_steps, int64_t T, int64_t B, int K,
                      int64_t tile, int64_t tiles, cudaStream_t stream) {
  // four CTAs of 35 KB an SM need more than the default shared carveout
  const int rc = static_cast<int>(cudaFuncSetAttribute(
      fb_wide_marg_rows2_kernel<VEC, STEPS>,
      cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared));
  if (rc != 0) return rc;
  fb_wide_marg_rows2_kernel<VEC, STEPS><<<grid_for(tiles * B, 1),
                                          kRows2Threads, 0, stream>>>(
      lt, le, alphas, betas, gammas, part, xi_steps, T, B, K, tile);
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
  } else if (k <= kRowsMax) {
#define RXT_ROWS(VEC, STEPS)                                                \
  launch_marg_rows<VEC, STEPS>(lt, le, alphas, betas, gammas, part, xi_steps, \
                               T, B, k, tile, tiles, s)
    const bool vec = k % 4 == 0;
    rc = vec ? (st ? RXT_ROWS(true, true) : RXT_ROWS(true, false))
             : (st ? RXT_ROWS(false, true) : RXT_ROWS(false, false));
#undef RXT_ROWS
  } else if (k <= kRows2Max) {
#define RXT_ROWS2(VEC, STEPS)                                                \
  launch_marg_rows2<VEC, STEPS>(lt, le, alphas, betas, gammas, part,          \
                                xi_steps, T, B, k, tile, tiles, s)
    const bool vec = k % 4 == 0;
    rc = vec ? (st ? RXT_ROWS2(true, true) : RXT_ROWS2(true, false))
             : (st ? RXT_ROWS2(false, true) : RXT_ROWS2(false, false));
#undef RXT_ROWS2
  } else {
    rc = st ? launch_marg_general<true>(lt, le, alphas, betas, gammas, part,
                                        xi_steps, T, B, k, tile, tiles, s)
            : launch_marg_general<false>(lt, le, alphas, betas, gammas, part,
                                         xi_steps, T, B, k, tile, tiles, s);
  }
  if (rc != 0 || tiles == 1) return rc;
  const int64_t n = B * static_cast<int64_t>(k) * k;
  fb_xisum_kernel<<<grid_for(n, 256), 256, 0, s>>>(part, xi_sum, tiles, n);
  return static_cast<int>(cudaGetLastError());
}

// The same with `fb_wide_marg_kernel` at any K (past 64 rxt_fb_wide_marg
// takes it too): the first-written design, timed beside the row kernels.
int rxt_fb_wide_marg_general(int k, int per_step, const float* lt,
                             const float* le, const float* alphas,
                             const float* betas, float* gammas, float* part,
                             float* xi_sum, float* xi_steps, int64_t T,
                             int64_t B, int64_t tile, int64_t tiles,
                             void* stream) {
  if (k < 1 || T < 1 || B < 1 || tile < 1 || tiles != (T + tile - 1) / tile ||
      (per_step && T > 1 && !xi_steps))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc =
      per_step ? launch_marg_general<true>(lt, le, alphas, betas, gammas,
                                           part, xi_steps, T, B, k, tile,
                                           tiles, s)
               : launch_marg_general<false>(lt, le, alphas, betas, gammas,
                                            part, xi_steps, T, B, k, tile,
                                            tiles, s);
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

// The same for the 16 < K <= 32 marginal kernel (ops/fused_fb.py
// MARGINAL_ROW_WARPS_PER_SM checks it), and the blocks of it with the
// per-step xi at K = 32 an SM holds on the current device (0 on an error).
int rxt_fb_wide_marg_rows_warps_per_sm() {
  return kMargRowsBlocksPerSM * kChainWarps;
}

int rxt_fb_wide_marg_rows_blocks_per_sm() {
  int blocks = 0;
  const cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, fb_wide_marg_rows_kernel<true, true>, kChainWarps * kWarp, 0);
  return rc == cudaSuccess ? blocks : 0;
}

// The same for the 32 < K <= 64 marginal kernel (ops/fused_fb.py
// MARGINAL_ROWS2_WARPS_PER_SM checks it), and its CTAs with the per-step xi
// at K = 64 an SM holds on the current device (0 on an error).
int rxt_fb_wide_marg_rows2_warps_per_sm() {
  return kMargRows2BlocksPerSM * kRows2Threads / kWarp;
}

int rxt_fb_wide_marg_rows2_blocks_per_sm() {
  int blocks = 0;
  if (cudaFuncSetAttribute(fb_wide_marg_rows2_kernel<true, true>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared) != cudaSuccess)
    return 0;
  const cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, fb_wide_marg_rows2_kernel<true, true>, kRows2Threads, 0);
  return rc == cudaSuccess ? blocks : 0;
}

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

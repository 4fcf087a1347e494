// Fused batched Kalman (RTS) smoother for state dims 9..16 on Hopper
// (sm_90a): the forward information-form filter (K1) and the backward RTS
// pass (K2) of fused_smoother.cu for chains too wide for its registers.
//
// Replaces `_fwd_kernel` and `_bwd_kernel` of
// rxinfer_tpu/ops/pallas_smoother.py (lines 76-136 and 139-203) where the
// JAX engine launches them for d in (8, 16] (rxinfer_tpu/engine/batched.py
// 106-141: chunk = 1, one step a grid point).  Same math and layouts as
// fused_smoother.cu:
//   forward   m_pred = F m + b ; P_pred = F P F^T + Q   (no transition at 0)
//             L = P_pred^-1 ; P = (L + W)^-1 ; m = P (L m_pred + xi_t)
//   backward  P_pred = F P_f F^T + Q ; G = P_f F^T P_pred^-1
//             m_s = m_f + G (m_s' - F m_f - b) ; P_s = P_f + G (P_s' - P_pred) G^T
//             cross_t = G P_s'              (smoothed == filtered at T - 1)
// inputs xi (T, B, d), m0 (B, d), p0 (B, d, d); moments batch minor: mf, ms
// (T, d, B), pf, ps (T, nsym, B) upper triangle row by row, cross
// (T-1, d*d, B) row-major.
//
// The design: a chain's 16 x 16 matrices (the state padded to 16 with an
// exact identity block: F, b and W with zeros, Q and P with the identity;
// d is a runtime argument) sit in registers in mma.sync.m16n8k8's
// accumulator layout, eight floats a lane (tc16.cuh, shared with the warp
// K3's tensor-core tier; the step's helpers in wide_step.cuh, shared with the
// wide K3).  Every 16 x 16 product runs on the tensor cores in
// 3xTF32 as C = A N^T; each symmetric inverse is scaled by its mean
// |diagonal| (sym_inv_scaled's scale) and inverted by the Schur blocks at 8
// with Gauss-Jordan leaves of 8 by shuffles and the hardware reciprocal.
// The plain version inverts by the Schur recursion split at d / 2, so the
// two differ in rounding only.  F's TF32 parts and F^T sit in the block's
// shared memory; the chain's vectors in shared memory.  The moments'
// storage type M is float or bf16 (V2).  A block's chains are neighbours
// in B, so each step's moments are staged in shared memory and written (K2:
// and read) by the whole block a row of neighbouring chains at a time, one
// sector a row, where a chain a warp would touch a sector a word (that
// alone held K2 at 11.7 ms).
//
// K1, wide_fwd_tc_kernel<M>: a chain a warp, eight warps a block, Q and W
// (shared, or the chain's own: V1) in registers, kFwdStaged = 4 steps'
// moments staged between the block's barriers (a barrier a step held the
// warps of a scheduler in phase, stalling together).  Its step is serial:
// two products and two inverses on the chain's critical path, the mean
// beside them; the inverses' leaves swept two pivots at a time
// (tc16.cuh leaf8_pairs: half the dependent steps).  After the second
// inverse P's lower triangle becomes the mirror of its upper (tc16.cuh
// mirror_upper), as the wide K3 does: the Schur blocks leave the two
// triangles apart by rounding and two inverses a step amplify that (a
// rank-one W of 16 states reached NaN); K2 reads the stored upper
// triangle.  The wide K3's filter
// step (fused_filter_wide.cu) is this step with the transition at every
// step, no bias, and xi = HR y formed from the observations in place of xi
// given.
//
// K2, wide_bwd_ring_kernel<M>: the gain is taken off the serial chain.
// P_pred,t, G_t and F m_f,t + b read only K1's outputs at step t, so
// kProducers = 2 producer warps a chain compute them a step each a round, a
// round ahead, into a ring of slots in shared memory; the chain's consumer
// warp runs only what reads the smoothed step after it: D = P_s' - P_pred,
// G D, P_f + (G D) G^T, the mean's mat-vec and the cross G P_s' (three
// products a step).  Its inverse sweeps its leaves a pivot at a time (tc16.cuh
// leaf8: the pairs gained nothing off the serial chain).  A block is eight
// chains; its warps meet at one __syncthreads a round.  The slots are G,
// P_pred and P_f lane by lane, then m_f and F m_f + b: 800 floats.  Q sits
// in the chain's shared memory, read by the producers.
//
// What bounds them, at (B, T, d) = (1024, 2048, 16) on an H100: 1,024
// chains are 1,024 warps in K1, two a scheduler, and its step is a chain
// of dependent latencies (a shuffle 26 cycles, mma.sync 24, the reciprocal
// 42, an IEEE division 80: scripts/wide_smoother_variants.py); K2 holds 24
// warps an SM and issues about 1,600 instructions a chain-step, half of them
// integer, so it is bound by issue.  By the work alone K1 needs 0.71 ms at
// the float32 rate and K2 1.69 (by bytes 0.42 and 1.40 ms); with the
// products and the Schur blocks priced at the 3xTF32 rate
// (chip_smoke.kernel_bounds) the bytes bound both.  One time block, no fold
// or carry (the JAX tier's chunk = 1).  A chain index past B runs on the
// last chain's inputs and stores nothing, so every lane reaches every
// shuffle and barrier.

#include <cuda_runtime.h>

#include <stdint.h>

#include "smallmat.cuh"
#include "wide_step.cuh"

namespace {

using rxt::moment_in;
using rxt::moment_out;

constexpr int kWarps = 8;               // K1: warps a block; K2: chains a block
constexpr int kFwdStaged = 4;           // K1: steps staged between barriers
constexpr int kProducers = 2;           // K2: producer warps a chain, and
                                        // steps a round (one each)

// K2's slot: G, P_pred, P_f (register r of tile nj at (4 nj + r) * 32 +
// lane), m_f, F m_f + b.
constexpr int kSlotG = 0;
constexpr int kSlotPP = 8 * kLanes;
constexpr int kSlotPF = 16 * kLanes;
constexpr int kSlotMF = 24 * kLanes;
constexpr int kSlotFMB = kSlotMF + kW;
constexpr int kSlot = kSlotFMB + kW;

// The shared parameters padded to 16: F, b, W with zeros, Q with the
// identity on the padded diagonal.  Read in place (__grid_constant__).
struct WideParams {
  float F[kW * kW];
  float b[kW];
  float Q[kW * kW];
  float W[kW * kW];
};

// A symmetric matrix from a packed upper triangle, entry k at src[k B]
// (src at the chain's column), `pad` on the padded diagonal.
template <typename T>
__device__ __forceinline__ void load_sym(Blk& m, const T* __restrict__ src,
                                         int64_t B, int d, int g, int t,
                                         float pad) {
#pragma unroll
  for (int nj = 0; nj < 2; ++nj)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = frag_row(g, r), col = frag_col(t, nj, r);
      if (row < d && col < d) {
        const int k = row <= col ? sym_slot(row, col, d) : sym_slot(col, row, d);
        m[nj][r] = moment_in(src[static_cast<int64_t>(k) * B]);
      } else {
        m[nj][r] = row == col ? pad : 0.0f;
      }
    }
}

// The upper triangle of the real block, entry k at dst[k B].
template <typename M>
__device__ __forceinline__ void store_upper(const Blk& m, M* __restrict__ dst,
                                            int64_t B, int d, int g, int t) {
#pragma unroll
  for (int nj = 0; nj < 2; ++nj)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = frag_row(g, r), col = frag_col(t, nj, r);
      if (row <= col && col < d)
        dst[static_cast<int64_t>(sym_slot(row, col, d)) * B] =
            moment_out<M>(m[nj][r]);
    }
}

// Staged rows: a block's chains are neighbours in B, so the moments of one
// step are rows of the block's chains, one row a packed entry.  A step's
// rows are staged in shared memory (a float a chain, and one more, so that
// a warp's column of rows spreads over the banks) and moved by the whole
// block a row of neighbouring words at a time: one sector a row of eight
// chains, where a chain a warp would touch a sector a word.
constexpr int kFwdRows = kW * (kW + 1) / 2 + kW;          // pf, mf
constexpr int kBwdInRows = kW * (kW + 1) / 2 + kW;        // pf, mf
constexpr int kBwdOutRows = kW * (kW + 1) / 2 + kW * kW + kW;  // ps, cross, ms
constexpr int kSW = kWarps + 1;               // a staged row's floats (K2)

// Where stage_upper puts this lane's entries (-1: not stored), once a
// kernel (K1): out[off[4 nj + r]] takes register r of tile nj.
__device__ __forceinline__ void upper_offsets(int (&off)[8], int s, int d,
                                              int g, int t) {
#pragma unroll
  for (int nj = 0; nj < 2; ++nj)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = frag_row(g, r), col = frag_col(t, nj, r);
      off[4 * nj + r] = row <= col && col < d ? sym_slot(row, col, d) * s : -1;
    }
}

// The upper triangle of the real block into a staged step: entry k of the
// chain at column j at out[k s].
__device__ __forceinline__ void stage_upper(const Blk& m, float* out, int s,
                                            int d, int g, int t) {
#pragma unroll
  for (int nj = 0; nj < 2; ++nj)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = frag_row(g, r), col = frag_col(t, nj, r);
      if (row <= col && col < d) out[sym_slot(row, col, d) * s] = m[nj][r];
    }
}

// A symmetric matrix from a staged step's packed upper triangle (entry k
// at in[k s]), the identity past d.
__device__ __forceinline__ void gather_sym(Blk& m, const float* in, int s,
                                           int d, int g, int t) {
#pragma unroll
  for (int nj = 0; nj < 2; ++nj)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = frag_row(g, r), col = frag_col(t, nj, r);
      if (row < d && col < d) {
        const int k = row <= col ? sym_slot(row, col, d) : sym_slot(col, row, d);
        m[nj][r] = in[k * s];
      } else {
        m[nj][r] = row == col ? 1.0f : 0.0f;
      }
    }
}

// ---- K1: forward filter -------------------------------------------------------

// K1's staged step to the moments: pf's rows then mf's, the block's NCB
// chains from b0 (those past B skipped), by every thread of the block:
// thread i takes column i % NCB of rows i / NCB, i / NCB + NT / NCB, ...
template <typename M, int NCB, int NT>
__device__ __forceinline__ void flush_fwd(const float* st, float* __restrict__ mf,
                                          M* __restrict__ pf, int64_t step,
                                          int64_t B, int64_t b0, int d,
                                          int nsym) {
  constexpr int RS = NT / NCB;
  const int j = threadIdx.x % NCB, r0 = threadIdx.x / NCB;
  const int64_t b = b0 + j;
  if (b >= B) return;
  M* dst = pf + step * nsym * B + b;
  for (int row = r0; row < nsym; row += RS)
    dst[row * B] = moment_out<M>(st[row * (NCB + 1) + j]);
  if (r0 < d) mf[(step * d + r0) * B + b] = st[(nsym + r0) * (NCB + 1) + j];
}

// K1's shared floats: F's parts, each chain's m, m_pred and h, two groups
// of kFwdStaged staged steps.
constexpr int kFwdSW = kWarps + 1;                  // a staged row's floats
constexpr int kFwdFloats =
    3 * kFMat + kWarps * 3 * kW + 2 * kFwdStaged * kFwdRows * kFwdSW;

// kFwdStaged steps are staged between the block's barriers: a group's
// moments are written out by the block during the next group's first step.
template <typename M>
__global__ void __launch_bounds__(kWarps * kLanes, 2)
wide_fwd_tc_kernel(const float* __restrict__ xi, const float* __restrict__ m0,
                   const float* __restrict__ p0, float* __restrict__ mf,
                   M* __restrict__ pf, int64_t T, int64_t B, int d,
                   const __grid_constant__ WideParams prm,
                   const float* __restrict__ wdyn,
                   const float* __restrict__ qdyn) {
  constexpr int S = kFwdStaged;
  constexpr int SW = kFwdSW;
  constexpr int kStep = kFwdRows * SW;      // a staged step's floats
  extern __shared__ __align__(16) float smem[];
  float* f_s = smem;
  float* v_s = f_s + 3 * kFMat;             // per chain: m, m_pred, h
  float* out_s = v_s + kWarps * 3 * kW;     // two groups of S steps
  float* ft = f_s;
  float* fh = f_s + kFMat;
  float* fl = fh + kFMat;
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int g = lane >> 2, t = lane & 3;
  load_f(ft, fh, fl, prm.F);
  const int nsym = d * (d + 1) / 2;
  const int my_row = g + 8 * (t & 1);   // the row of m v this lane keeps
  const bool writer = t < 2;
  const float b_r = lane < kW ? prm.b[lane] : 0.0f;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * kWarps;
  int up[8];
  upper_offsets(up, SW, d, g, t);

  const int64_t b_raw = b0 + warp;
  const int64_t b = b_raw < B ? b_raw : B - 1;
  float* mv = v_s + warp * 3 * kW;
  float* mp = mv + kW;
  float* hv = mp + kW;
  Blk p, q, w;
  if (lane < kW) mv[lane] = lane < d ? m0[b * d + lane] : 0.0f;
  if (qdyn)
    load_sym(q, qdyn + b, B, d, g, t, 1.0f);
  else
    load_dense(q, prm.Q, g, t);
  if (wdyn)
    load_sym(w, wdyn + b, B, d, g, t, 0.0f);
  else
    load_dense(w, prm.W, g, t);
  // the prior, read from its upper triangle; the padding an identity block
#pragma unroll
  for (int nj = 0; nj < 2; ++nj)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = frag_row(g, r), col = frag_col(t, nj, r);
      const int lo = row < col ? row : col, hi = row < col ? col : row;
      p[nj][r] = row < d && col < d ? p0[(b * d + lo) * d + hi]
                                    : (row == col ? 1.0f : 0.0f);
    }
  float x_cur = lane < d ? xi[b * d + lane] : 0.0f;
  __syncthreads();

  for (int64_t step = 0; step < T; ++step) {
    const float x_next =
        step + 1 < T && lane < d ? xi[((step + 1) * B + b) * d + lane] : 0.0f;
    // the last group's moments out, while this one is formed
    const int64_t grp = step / S;
    const int sl = static_cast<int>(step - grp * S);
    if (sl == 0 && step > 0)
      for (int u = 0; u < S; ++u)
        flush_fwd<M, kWarps, kWarps * kLanes>(
            out_s + (((grp - 1) & 1) * S + u) * kStep, mf, pf,
            step - S + u, B, b0, d, nsym);
    float* st = out_s + ((grp & 1) * S + sl) * kStep;
    if (step > 0) {
      // m_pred = F m + b ; P_pred = (F P) F^T + Q
      if (lane < kW) mp[lane] = f_row_dot(ft, mv, lane) + b_r;
      Blk x;
      mul_f_m(x, fh, fl, p, g, t);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
#pragma unroll
        for (int r = 0; r < 4; ++r) p[nj][r] = q[nj][r];
      mul_a_ft<true>(p, x, fh, fl, g, t);
    } else if (lane < kW) {
      mp[lane] = mv[lane];
    }
    // L = P_pred^-1
    sym_inv_scaled<true>(p, d, g, t, lane);
    __syncwarp();  // m_pred is in place
    // h = L m_pred + xi_t (a row a lane) ; L + W
    {
      float s[2];
      mat_vec(p, mp, t, s);
      const float x_row = __shfl_sync(tc::kFull, x_cur, my_row);
      const float h_row = (t & 1 ? s[1] : s[0]) + x_row;
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
#pragma unroll
        for (int r = 0; r < 4; ++r) p[nj][r] += w[nj][r];
      if (writer) hv[my_row] = h_row;
    }
    // P = (L + W)^-1, its lower triangle the mirror of its upper ; m = P h
    sym_inv_scaled<true>(p, d, g, t, lane);
    mirror_upper(p, g, t);
    __syncwarp();  // h is in place
    {
      float s[2];
      mat_vec(p, hv, t, s);
      const float m_row = t & 1 ? s[1] : s[0];
      if (writer) {
        mv[my_row] = m_row;
        if (my_row < d) st[(nsym + my_row) * SW + warp] = m_row;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (up[i] >= 0) st[up[i] + warp] = p[i >> 2][i & 3];
      x_cur = x_next;
    }
    if (sl == S - 1 || step == T - 1)
      __syncthreads();  // m and the staged group are in place
    else
      __syncwarp();     // m is in place
  }
  const int64_t last = (T - 1) / S;
  for (int64_t u = last * S; u < T; ++u)
    flush_fwd<M, kWarps, kWarps * kLanes>(
        out_s + ((last & 1) * S + (u - last * S)) * kStep, mf, pf, u, B, b0,
        d, nsym);
}

// ---- K2: backward RTS pass ------------------------------------------------------

__device__ __forceinline__ void put(float* s, const Blk& m, int lane) {
#pragma unroll
  for (int nj = 0; nj < 2; ++nj)
#pragma unroll
    for (int r = 0; r < 4; ++r) s[(4 * nj + r) * kLanes + lane] = m[nj][r];
}

__device__ __forceinline__ void get(Blk& m, const float* s, int lane) {
#pragma unroll
  for (int nj = 0; nj < 2; ++nj)
#pragma unroll
    for (int r = 0; r < 4; ++r) m[nj][r] = s[(4 * nj + r) * kLanes + lane];
}

// The producer of one step: into its slot what its backward step needs
// that does not read the smoothed moments: P_pred = F P_f F^T + Q,
// G = P_f F^T P_pred^-1, P_f, m_f and F m_f + b.  Q's fragment is read
// from the chain's shared copy (q_s, lane by lane).
__device__ __forceinline__ void produce(float* slot, const Blk& pfm, float mfl,
                                        const float* ft, const float* fh,
                                        const float* fl, const float* q_s,
                                        float b_r, int d, int g, int t,
                                        int lane) {
  Blk pp, pft;
  {
    Blk x;
    mul_f_m(x, fh, fl, pfm, g, t);                 // F P_f
    get(pp, q_s, lane);
    mul_a_ft<true>(pp, x, fh, fl, g, t);           // F P_f F^T + Q
    mul_a_ft<false>(pft, pfm, fh, fl, g, t);       // P_f F^T
  }
  put(slot + kSlotPP, pp, lane);
  put(slot + kSlotPF, pfm, lane);
  if (lane < kW) slot[kSlotMF + lane] = mfl;
  sym_inv_scaled<false>(pp, d, g, t, lane);
  tc::blk_mul<false, false>(pft, pft, pp);
  __syncwarp();  // m_f is in place
  put(slot + kSlotG, pft, lane);
  if (lane < kW) slot[kSlotFMB + lane] = f_row_dot(ft, slot + kSlotMF, lane) + b_r;
}

// The consumer of one step, from its slot: what reads the smoothed step
// after it.  ps and msv (m_s', 16 floats in shared memory, zero past d)
// carry the smoothed moments from step tt + 1 to tt; dv is a 16-float
// scratch vector.  Returns the cross G P_s' in cr and this lane's row of
// m_s (rows g, g + 8 by t & 1).
__device__ __forceinline__ float consume(const float* slot, Blk& ps,
                                         Blk& cr, float* msv, float* dv,
                                         int g, int t, int lane) {
  Blk gm, dm, pm;
  get(gm, slot + kSlotG, lane);
  get(dm, slot + kSlotPP, lane);
  get(pm, slot + kSlotPF, lane);
  if (lane < kW) dv[lane] = msv[lane] - slot[kSlotFMB + lane];
#pragma unroll
  for (int nj = 0; nj < 2; ++nj)
#pragma unroll
    for (int r = 0; r < 4; ++r) dm[nj][r] = ps[nj][r] - dm[nj][r];  // D
  tc::blk_mul<false, false>(cr, gm, ps);              // G P_s' = Cov(x_t, x_t+1)
  tc::blk_mul<false, false>(dm, gm, dm);              // G D
  tc::blk_mul<true, false>(pm, dm, gm);               // P_f + (G D) G^T
  __syncwarp();  // dv is in place
  // m_s = m_f + G (m_s' - F m_f - b)
  float s[2];
  mat_vec(gm, dv, t, s);
  const int my_row = g + 8 * (t & 1);
  const float m_row = slot[kSlotMF + my_row] + (t & 1 ? s[1] : s[0]);
  __syncwarp();  // every lane has read msv and dv
  if (t < 2) msv[my_row] = m_row;
#pragma unroll
  for (int nj = 0; nj < 2; ++nj)
#pragma unroll
    for (int r = 0; r < 4; ++r) ps[nj][r] = pm[nj][r];
  __syncwarp();  // m_s is in place
  return m_row;
}

// A backward step's outputs into its staged rows (ps, cross, ms; entry k
// at out[k s]).
__device__ __forceinline__ void stage_bwd(float* out, int s, const Blk& ps,
                                          const Blk& cr, float m_row, int d,
                                          int nsym, int g, int t) {
  stage_upper(ps, out, s, d, g, t);
#pragma unroll
  for (int nj = 0; nj < 2; ++nj)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = frag_row(g, r), col = frag_col(t, nj, r);
      if (row < d && col < d) out[(nsym + row * d + col) * s] = cr[nj][r];
    }
  const int my_row = g + 8 * (t & 1);
  if (t < 2 && my_row < d) out[(nsym + d * d + my_row) * s] = m_row;
}

// Step T - 1: smoothed == filtered (the stored moments, rounded as stored).
template <typename M>
__device__ __forceinline__ void last_step(Blk& ps, float* msv,
                                          const float* __restrict__ mf,
                                          const M* __restrict__ pf,
                                          float* __restrict__ ms,
                                          M* __restrict__ ps_out, int64_t T,
                                          int64_t B, int64_t b, int d,
                                          int nsym, bool valid, int g, int t,
                                          int lane) {
  load_sym(ps, pf + (T - 1) * nsym * B + b, B, d, g, t, 1.0f);
  const float m_last = lane < d ? mf[((T - 1) * d + lane) * B + b] : 0.0f;
  if (lane < kW) msv[lane] = m_last;
  if (valid) {
    if (lane < d) ms[((T - 1) * d + lane) * B + b] = m_last;
    store_upper<M>(ps, ps_out + (T - 1) * nsym * B + b, B, d, g, t);
  }
}

// K2's shared floats: F's parts, each chain's ring, vectors and Q, two
// rounds of staged inputs and two of staged outputs.
constexpr int kRound = kProducers;             // steps a round
constexpr int kBwdFloats =
    3 * kFMat + kWarps * (2 * kRound * kSlot + 2 * kW + 8 * kLanes) +
    2 * kRound * (kBwdInRows + kBwdOutRows) * kSW;

// Eight chains a block: warps 0-7 the chains' consumers, then kProducers
// producers a chain (warp 8 + 8 p + chain).  A round is kProducers steps
// (counted from T - 2 down), step p of it producer p's.  Round i: K1's
// outputs of round i + 1 are loaded into registers by every thread, a row
// of eight chains at a time; the producers fill round i's slots from its
// staged inputs while the consumers take round i - 1's slots and stage its
// outputs; the outputs of round i - 2 are written out, a row at a time;
// then the loaded inputs are staged, and the block meets at one
// __syncthreads.
template <typename M>
__global__ void __launch_bounds__(kWarps * (kProducers + 1) * kLanes, 1)
wide_bwd_ring_kernel(const float* __restrict__ mf, const M* __restrict__ pf,
                     float* __restrict__ ms, M* __restrict__ ps,
                     M* __restrict__ cross, int64_t T, int64_t B, int d,
                     const __grid_constant__ WideParams prm,
                     const float* __restrict__ qdyn) {
  extern __shared__ __align__(16) float smem[];
  constexpr int R = kRound;
  constexpr int NT = kWarps * (kProducers + 1) * kLanes;
  // a thread's column (chain) and rows of the staged rounds: rows r0,
  // r0 + RS, ...; KP of pf's and one of mf's a step
  constexpr int RS = NT / kWarps;
  constexpr int KP = (kW * (kW + 1) / 2 + RS - 1) / RS;
  static_assert(RS >= kW, "a pass over the rows covers m's");
  float* ft = smem;
  float* fh = ft + kFMat;
  float* fl = fh + kFMat;
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int g = lane >> 2, t = lane & 3;
  const bool consumer = warp < kWarps;
  const int chain = warp % kWarps;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * kWarps;
  const int64_t b_raw = b0 + chain;
  const bool valid = b_raw < B;
  const int64_t b = valid ? b_raw : B - 1;
  constexpr int kChainFloats = 2 * R * kSlot + 2 * kW + 8 * kLanes;
  float* ring = smem + 3 * kFMat + chain * kChainFloats;
  float* msv = ring + 2 * R * kSlot;
  float* dv = msv + kW;
  float* q_s = dv + kW;
  float* in_s = smem + 3 * kFMat + kWarps * kChainFloats;
  float* out_s = in_s + 2 * R * kBwdInRows * kSW;
  load_f(ft, fh, fl, prm.F);
  const int nsym = d * (d + 1) / 2;
  const float b_r = lane < kW ? prm.b[lane] : 0.0f;
  if (consumer) {
    // the chain's Q for its producers
    Blk q;
    if (qdyn)
      load_sym(q, qdyn + b, B, d, g, t, 1.0f);
    else
      load_dense(q, prm.Q, g, t);
    put(q_s, q, lane);
  }
  const int64_t n = T - 1;                    // steps T - 2 down to 0
  const int64_t rounds = (n + R - 1) / R;

  const int col = threadIdx.x % kWarps, r0 = threadIdx.x / kWarps;
  const int64_t bb = b0 + col < B ? b0 + col : B - 1;
  // K1's outputs of a round's steps (pf's rows, then mf's) into registers,
  // a row of the block's chains at a time; those past B read the last
  // chain's
  auto load_round = [&](int64_t round, float (&pre)[R][KP + 1]) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int64_t s = round * R + j;
      const int64_t tt = s < n ? n - 1 - s : 0;
      const M* src = pf + tt * nsym * B + bb;
#pragma unroll
      for (int k = 0; k < KP; ++k) {
        const int row = r0 + k * RS;
        pre[j][k] = row < nsym ? moment_in(src[row * B]) : 0.0f;
      }
      pre[j][KP] = r0 < d ? mf[(tt * d + r0) * B + bb] : 0.0f;
    }
  };
  auto stage_round = [&](int buf, const float (&pre)[R][KP + 1]) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      float* dst = in_s + (buf * R + j) * kBwdInRows * kSW + col;
#pragma unroll
      for (int k = 0; k < KP; ++k) {
        const int row = r0 + k * RS;
        if (row < nsym) dst[row * kSW] = pre[j][k];
      }
      if (r0 < d) dst[(nsym + r0) * kSW] = pre[j][KP];
    }
  };
  // a round's staged outputs to ps, cross, ms, a row of chains at a time
  auto flush_round = [&](int64_t round) {
    if (b0 + col >= B) return;
    for (int j = 0; j < R; ++j) {
      const int64_t s = round * R + j;
      if (s >= n) break;
      const int64_t tt = n - 1 - s;
      const float* st = out_s + ((round & 1) * R + j) * kBwdOutRows * kSW + col;
      M* dps = ps + tt * nsym * B + bb;
      for (int row = r0; row < nsym; row += RS)
        dps[row * B] = moment_out<M>(st[row * kSW]);
      M* dcr = cross + tt * (d * d) * B + bb;
      for (int row = r0; row < d * d; row += RS)
        dcr[row * B] = moment_out<M>(st[(nsym + row) * kSW]);
      if (r0 < d) ms[(tt * d + r0) * B + bb] = st[(nsym + d * d + r0) * kSW];
    }
  };

  Blk psm;
  if (consumer)
    last_step<M>(psm, msv, mf, pf, ms, ps, T, B, b, d, nsym, valid, g, t,
                 lane);
  {
    float pre[R][KP + 1];
    load_round(0, pre);
    stage_round(0, pre);
  }
  __syncthreads();

  for (int64_t i = 0; i <= rounds + 1; ++i) {
    const int64_t r = i - 1;                  // the round the consumers take
    float pre[R][KP + 1];
    if (i + 1 < rounds) load_round(i + 1, pre);
    if (r >= 1 && r - 1 < rounds) flush_round(r - 1);
    // (this shape of the producers' branch holds ptxas at 40 bytes spilled;
    // the round's pointers folded into the call spilled 60 and took 10%
    // longer)
    if (i < rounds) {
      const float* in_round = in_s + (i & 1) * R * kBwdInRows * kSW + chain;
      float* ring_round = ring + (i & 1) * R * kSlot;
      if (!consumer) {
        const int j = warp / kWarps - 1;      // this producer's step
        const float* in = in_round + j * kBwdInRows * kSW;
        Blk pfm;
        gather_sym(pfm, in, kSW, d, g, t);
        const float mfl = lane < d ? in[(nsym + lane) * kSW] : 0.0f;
        produce(ring_round + j * kSlot, pfm, mfl, ft, fh, fl, q_s, b_r, d, g,
                t, lane);
      }
    }
    if (consumer && r >= 0 && r < rounds) {
      float* st = out_s + (r & 1) * R * kBwdOutRows * kSW + chain;
      for (int j = 0; j < R; ++j) {
        if (r * R + j >= n) break;
        Blk cr;
        const float m_row = consume(ring + ((r & 1) * R + j) * kSlot, psm, cr,
                                    msv, dv, g, t, lane);
        stage_bwd(st + j * kBwdOutRows * kSW, kSW, psm, cr, m_row, d, nsym,
                  g, t);
      }
    }
    if (i + 1 < rounds) stage_round((i + 1) & 1, pre);
    __syncthreads();
  }
}

WideParams make_params(int d, const float* F, const float* bvec,
                       const float* Q, const float* W) {
  WideParams prm;
  for (int i = 0; i < kW; ++i) {
    prm.b[i] = i < d ? bvec[i] : 0.0f;
    for (int j = 0; j < kW; ++j) {
      const bool real = i < d && j < d;
      prm.F[i * kW + j] = real ? F[i * d + j] : 0.0f;
      prm.Q[i * kW + j] = real ? Q[i * d + j] : (i == j ? 1.0f : 0.0f);
      prm.W[i * kW + j] = real ? W[i * d + j] : 0.0f;
    }
  }
  return prm;
}

constexpr int kFwdSmemBytes = 4 * kFwdFloats;
static_assert(kFwdSmemBytes <= 232448,
              "K1's staged steps exceed an H100 block's 227 KB");

template <typename M>
int launch_fwd(const float* xi, const float* m0, const float* p0, float* mf,
               M* pf, int64_t T, int64_t B, int d, const WideParams& prm,
               const float* wdyn, const float* qdyn, cudaStream_t s) {
  auto kernel = wide_fwd_tc_kernel<M>;
  if (kFwdSmemBytes > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kFwdSmemBytes);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const unsigned blocks = static_cast<unsigned>((B + kWarps - 1) / kWarps);
  kernel<<<blocks, kWarps * kLanes, kFwdSmemBytes, s>>>(
      xi, m0, p0, mf, pf, T, B, d, prm, wdyn, qdyn);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kBwdThreads = kWarps * (kProducers + 1) * kLanes;
constexpr int kBwdSmemBytes = 4 * kBwdFloats;
static_assert(kBwdSmemBytes <= 232448,
              "K2's ring and staged rounds exceed an H100 block's 227 KB");

template <typename M>
int launch_bwd(const float* mf, const M* pf, float* ms, M* ps, M* cross,
               int64_t T, int64_t B, int d, const WideParams& prm,
               const float* qdyn, cudaStream_t s) {
  auto kernel = wide_bwd_ring_kernel<M>;
  if (kBwdSmemBytes > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdSmemBytes);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const unsigned blocks = static_cast<unsigned>((B + kWarps - 1) / kWarps);
  kernel<<<blocks, kBwdThreads, kBwdSmemBytes, s>>>(mf, pf, ms, ps, cross, T,
                                                    B, d, prm, qdyn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each launcher returns the CUDA error of its launch (0 = success).  d in
// 1..16 (the engine takes it for d in 9..16); F, Q, W (d, d) and b (d,)
// shared, row-major, host memory; wdyn / qdyn the (nsym, B) per-chain
// tiles of W / Q or null; pf, ps and cross float32, or bf16 when bf16 != 0.
// The backward pass reads Q only.
int rxt_wide_smoother_fwd(int d, const float* xi, const float* m0,
                          const float* p0, float* mf, void* pf, int64_t T,
                          int64_t B, const float* F, const float* bvec,
                          const float* Q, const float* W, const float* wdyn,
                          const float* qdyn, int bf16, void* stream) {
  if (d < 1 || d > kW || T < 1 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const WideParams prm = make_params(d, F, bvec, Q, W);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_fwd<__nv_bfloat16>(xi, m0, p0, mf,
                                     static_cast<__nv_bfloat16*>(pf), T, B, d,
                                     prm, wdyn, qdyn, s);
  return launch_fwd<float>(xi, m0, p0, mf, static_cast<float*>(pf), T, B, d,
                           prm, wdyn, qdyn, s);
}

int rxt_wide_smoother_bwd(int d, const float* mf, const void* pf, float* ms,
                          void* ps, void* cross, int64_t T, int64_t B,
                          const float* F, const float* bvec, const float* Q,
                          const float* qdyn, int bf16, void* stream) {
  if (d < 1 || d > kW || T < 1 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const WideParams prm = make_params(d, F, bvec, Q, Q);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_bwd<__nv_bfloat16>(
        mf, static_cast<const __nv_bfloat16*>(pf), ms,
        static_cast<__nv_bfloat16*>(ps), static_cast<__nv_bfloat16*>(cross),
        T, B, d, prm, qdyn, s);
  return launch_bwd<float>(mf, static_cast<const float*>(pf), ms,
                           static_cast<float*>(ps), static_cast<float*>(cross),
                           T, B, d, prm, qdyn, s);
}

// The widest state the kernels take (the padded dim).
int rxt_wide_smoother_max_dim() { return kW; }

// The kernels' shape: K1's chains a warp and warps a block; K2's producer
// warps a chain, steps a producer takes a round, chains a block, threads a
// block and shared bytes a block.
void rxt_wide_smoother_shape(int* out) {
  out[0] = 1;
  out[1] = kWarps;
  out[2] = kProducers;
  out[3] = 1;
  out[4] = kWarps;
  out[5] = kBwdThreads;
  out[6] = kBwdSmemBytes;
}

// Blocks an SM holds of K1 (bwd = 0) or K2 (bwd = 1), or -1.
int rxt_wide_smoother_blocks_per_sm(int bwd, int bf16) {
  int n = 0;
  cudaError_t rc;
  if (bwd)
    rc = bf16 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &n, wide_bwd_ring_kernel<__nv_bfloat16>, kBwdThreads,
                    kBwdSmemBytes)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &n, wide_bwd_ring_kernel<float>, kBwdThreads,
                    kBwdSmemBytes);
  else
    rc = bf16 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &n, wide_fwd_tc_kernel<__nv_bfloat16>, kWarps * kLanes,
                    kFwdSmemBytes)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &n, wide_fwd_tc_kernel<float>, kWarps * kLanes,
                    kFwdSmemBytes);
  return rc == cudaSuccess ? n : -1;
}

const char* rxt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

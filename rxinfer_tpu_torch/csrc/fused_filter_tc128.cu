// Fused streaming Kalman filter for state dims 64 < d <= 128 on Hopper
// (sm_90a): the warp K3's tensor-core tier past d = 64, beside the tiers of
// fused_filter_warp.cu (to d = 64; past d = 128 its sweep tier stays).
//
// Replaces the TPU kernel `_filter_kernel` of
// rxinfer_tpu/ops/pallas_filter.py (lines 84-144) at these d.  Same math,
// order and layouts as the other tiers and the plain version
// (ops/fused_filter.py `filter_step`):
//   xi = HR y_t                                   HR = H^T R^-1, (d, dy)
//   m_pred = F m ; P_pred = F P F^T + Q
//   L = P_pred^-1 ; P = (L + W)^-1 ; m = P (L m_pred + xi)
// with the transition applied at EVERY step, t = 0 included, and no bias.
// ys (T, dy, B), m0 (d, B), p0 (nsym, B) upper triangle row by row; out
// means (T, d, B), mf (d, B), pf (nsym, B).
//
// The arithmetic is the tier past 32's (fused_filter_warp.cu namespace
// tc64, on tc16.cuh and tc_blocks.cuh): the state padded to DP = 128 with
// an identity block, 3xTF32 products C = A N^T of 16 x 16 blocks in
// mma.sync's accumulator layout, each k tile's three products on a zero
// accumulator added by a float32 add (chained on the tensor cores over a
// 64-deep sum they left P past ORACLE_TOL on one-observation chains; at
// 128 deep it would be worse), both inverses the plain version's Schur
// recursion with the mean-|diagonal| scale split 128 -> 64 -> 32 -> 16 -> 8
// with Gauss-Jordan leaves of 8, every lower-left block the exact transpose
// of its upper-right one, P's diagonal 16 x 16 blocks mirrored each step.
// The second inverse, P = (L + W)^-1, is refined by one Newton step, P0 +
// P0 (I - M P0), in the same products: at this depth the Schur blocks of a
// 128-wide inverse alone lose too much (phase 17 (a)'s system at d = 100
// with 7 observations: 1.2e-3 from the float64 filter, the plain version
// 6e-5; with the step 6e-5).
// * Where the matrices live.  At DP = 128 a matrix is 69,632 B at rows
//   DP + 8 = 136 floats apart (8 modulo the 32 banks: a quad's float2
//   fragment loads take distinct banks).  The tier past 32 kept F's two
//   TF32 parts, Q and W in shared memory once a block beside each chain's P
//   and work matrix: six matrices, 417,792 B, where a block has 232,448.
//   Here a block is one chain: its P and work matrix (139,264 B) and F (as
//   float32, split into its TF32 parts when a product reads it) sit in
//   shared memory, 211,488 B with the vectors, one block an SM; Q and W,
//   read once a step each (an add), come from device memory, where every
//   chain's reads of the same 139 KB stay in the L2.  F's matrix holds
//   L + W while the step refines P, and the refined P then; F is read
//   back from device memory into the first P's matrix, and the two swap
//   roles every step.
// * Warps a chain: eight (a block of 256 threads), sub-warp s taking work
//   unit n of a phase when n % 8 == s: F P a block row each (in registers,
//   stored over P once every warp has read it), then the 36 lower blocks of
//   (F P) F^T + Q; in each inverse the 16-block products of X = A^-1 B, S =
//   D - B^T X, Y = X S^-1 and TL = A^-1 + Y X^T at each level, the 32 x 32
//   inverses (four an inverse, in registers) on sub-warp 0.  One chain's
//   warps run in lockstep, so __syncthreads orders them; a chain a block
//   means no chain index past B.
// * The inverse at 128 (sym_inv128): scale; A^-1 by the 64 x 64 Schur
//   inverse (inv64, the tier past 32's sym_inv64 at DP = 64 without its
//   scale) on the top-left quarter; X = A^-1 B into the work matrix's
//   blocks (0..3, 0..3) and X^T into (4..7, 0..3); S = D - B^T X; S^-1 by
//   inv64 on the bottom-right quarter; -Y upper right, -Y^T lower left;
//   TL's lower blocks, its upper ones their transposes; the scale back.
//   inv64 keeps its own X and X^T in the work matrix's blocks (0..3, 4..5).
// * Operations a step: 64 + 288 products of 16 x 16 x 16 for F P F^T + Q,
//   208 for each inverse's top level and 2 x 28 for its two 64 x 64
//   inverses, eight 32 x 32 inverses in registers, and 512 + 288 for the
//   Newton step.
//
// The evidence is formed here as in the other tiers: thread j sums xi_j =
// HR[j][0] y[0] + HR[j][1] y[1] + ... in k order, reading HR's row j as
// column j of HR^T (dy, d) from device memory, each warp staging the
// step's observations kYChunk at a time: dy has no cap.

#include <cuda_runtime.h>

#include <stdint.h>

#include "tc16.cuh"
#include "tc_blocks.cuh"

namespace {

constexpr int kLanes = 32;
constexpr int kYChunk = kLanes;      // observations staged at a time

namespace tc128 {

using tc::Blk;
using tc64::Team;

constexpr int kNB = 8;               // 16-blocks a side
constexpr int kDP = 16 * kNB;        // the padded state
constexpr int kS = kDP + 8;          // a matrix's row stride
constexpr int kMat = kDP * kS;
constexpr int kWarps = 8;            // warps a chain (one chain a block)
constexpr int kThreads = kWarps * kLanes;
constexpr int kLower = kNB * (kNB + 1) / 2;  // lower blocks of a matrix
// m, m_pred, h, each warp's observation chunk and partial sum
constexpr int kVec = 3 * kDP + kWarps * kYChunk + kWarps;
// F, the chain's P and work matrix, its vectors
constexpr int kSmemFloats = 3 * kMat + kVec;

// Slot of entry (i, j), i <= j < d, in the packed upper triangle.
__device__ __forceinline__ int64_t sym_slot(int i, int j, int d) {
  return static_cast<int64_t>(i) * (2 * d - i + 1) / 2 + (j - i);
}

// Block (bi, bj) of Q (device memory, row stride kS, zero past d), its
// padded diagonal 1: the padded block of every matrix of the step is then
// the identity, as in the other tiers.  Entry r of tile nj sits at row
// 16 bi + g + 8 (r / 2), column 16 bj + 8 nj + 2 t + r % 2.
__device__ __forceinline__ void ld_q(Blk& x, const float* q, int bi, int bj,
                                     int d, int g, int t) {
  tc64::ld_blk<kS>(x, q, bi, bj, g, t);
  if (bi != bj) return;
#pragma unroll
  for (int nj = 0; nj < 2; ++nj)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = 16 * bi + g + 8 * (r / 2);
      const int col = 16 * bj + 8 * nj + 2 * t + r % 2;
      if (row == col && row >= d) x[nj][r] += 1.0f;
    }
}

// In place: the inverse of the symmetric 64 x 64 matrix at m (16-blocks at
// row stride kS; its lower blocks read, every block written) by the Schur
// blocks at 32, unscaled: the 32 x 32 inverses of A and S on sub-warp 0,
// each block product on the sub-warp of its block.  w: X in its blocks
// (0..1, 0..1), X^T in (2..3, 0..1).
__device__ __forceinline__ void inv64(float* m, float* w, const Team& tm) {
  const int g = tm.g, t = tm.t;
  if (tm.s == 0) {  // A^-1
    Blk a, bt, dd, bu;
    tc64::ld_blk<kS>(a, m, 0, 0, g, t);
    tc64::ld_blk<kS>(bt, m, 1, 0, g, t);
    tc64::ld_blk<kS>(dd, m, 1, 1, g, t);
    tc64::inv32(a, bt, dd, bu, g, t, tm.lane);
    tc64::st_blk<kS>(a, m, 0, 0, g, t);
    tc64::st_blk<kS>(bu, m, 0, 1, g, t);
    tc64::st_blk<kS>(bt, m, 1, 0, g, t);
    tc64::st_blk<kS>(dd, m, 1, 1, g, t);
  }
  __syncthreads();
  if (tm.s < 4) {  // X = A^-1 B (B^T is m's block row 2..), and X^T
    const int bi = tm.s / 2, j = tm.s % 2;
    Blk acc = {};
    tc64::blk_prod<kS, 2, false>(acc, m, bi, 0, m, 2 + j, 0, g, t);
    Blk tr;
    tc::transpose(tr, acc, g, t);
    tc64::st_blk<kS>(acc, w, bi, j, g, t);
    tc64::st_blk<kS>(tr, w, 2 + j, bi, g, t);
  }
  __syncthreads();
  if (tm.s < 3) {  // S = D - B^T X, its lower blocks
    int i, j;
    tc64::lower_block<2>(tm.s, i, j);
    Blk acc;
    tc64::ld_blk<kS>(acc, m, 2 + i, 2 + j, g, t);
    tc64::blk_prod<kS, 2, true>(acc, m, 2 + i, 0, w, 2 + j, 0, g, t);
    tc64::st_blk<kS>(acc, m, 2 + i, 2 + j, g, t);
  }
  __syncthreads();
  if (tm.s == 0) {  // S^-1
    Blk a, bt, dd, bu;
    tc64::ld_blk<kS>(a, m, 2, 2, g, t);
    tc64::ld_blk<kS>(bt, m, 3, 2, g, t);
    tc64::ld_blk<kS>(dd, m, 3, 3, g, t);
    tc64::inv32(a, bt, dd, bu, g, t, tm.lane);
    tc64::st_blk<kS>(a, m, 2, 2, g, t);
    tc64::st_blk<kS>(bu, m, 2, 3, g, t);
    tc64::st_blk<kS>(bt, m, 3, 2, g, t);
    tc64::st_blk<kS>(dd, m, 3, 3, g, t);
  }
  __syncthreads();
  if (tm.s < 4) {  // Y = X S^-1: -Y upper right, -Y^T lower left
    const int bi = tm.s / 2, j = tm.s % 2;
    Blk acc = {};
    tc64::blk_prod<kS, 2, true>(acc, w, bi, 0, m, 2 + j, 2, g, t);
    Blk tr;
    tc::transpose(tr, acc, g, t);
    tc64::st_blk<kS>(acc, m, bi, 2 + j, g, t);
    tc64::st_blk<kS>(tr, m, 2 + j, bi, g, t);
  }
  __syncthreads();
  if (tm.s < 3) {  // TL = A^-1 + Y X^T; (0, 1) the transpose of (1, 0)
    int bi, bj;
    tc64::lower_block<2>(tm.s, bi, bj);
    Blk acc;
    tc64::ld_blk<kS>(acc, m, bi, bj, g, t);
    tc64::blk_prod<kS, 2, true>(acc, m, bi, 2, w, bj, 0, g, t);
    tc64::st_blk<kS>(acc, m, bi, bj, g, t);
    if (bi != bj) {
      Blk tr;
      tc::transpose(tr, acc, g, t);
      tc64::st_blk<kS>(tr, m, bj, bi, g, t);
    }
  }
  __syncthreads();
}

// In place: the inverse of the symmetric m (its lower blocks; identity past
// d), scaled as sym_inv_scaled, by the Schur blocks at 64 over the team; w
// is the chain's work matrix.  Every block of the result is written.
__device__ __forceinline__ void sym_inv128(float* m, float* w, float* red,
                                           int d, const Team& tm) {
  const int g = tm.g, t = tm.t;
  const float inv_s = tc64::inverse_scale<kS, kWarps>(m, red, d, tm);
  for (int n = tm.s; n < kLower; n += kWarps) {
    int bi, bj;
    tc64::lower_block<kNB>(n, bi, bj);
    Blk x;
    tc64::ld_blk<kS>(x, m, bi, bj, g, t);
    tc64::blk_scale(x, inv_s);
    tc64::st_blk<kS>(x, m, bi, bj, g, t);
  }
  __syncthreads();
  inv64(m, w + 64, tm);  // A^-1
  // X = A^-1 B (B^T is m's block row 4..), and X^T
  for (int n = tm.s; n < 16; n += kWarps) {
    const int bi = n / 4, j = n % 4;
    Blk acc = {};
    tc64::blk_prod<kS, 4, false>(acc, m, bi, 0, m, 4 + j, 0, g, t);
    Blk tr;
    tc::transpose(tr, acc, g, t);
    tc64::st_blk<kS>(acc, w, bi, j, g, t);
    tc64::st_blk<kS>(tr, w, 4 + j, bi, g, t);
  }
  __syncthreads();
  // S = D - B^T X, its lower blocks
  for (int n = tm.s; n < 10; n += kWarps) {
    int i, j;
    tc64::lower_block<4>(n, i, j);
    Blk acc;
    tc64::ld_blk<kS>(acc, m, 4 + i, 4 + j, g, t);
    tc64::blk_prod<kS, 4, true>(acc, m, 4 + i, 0, w, 4 + j, 0, g, t);
    tc64::st_blk<kS>(acc, m, 4 + i, 4 + j, g, t);
  }
  __syncthreads();
  inv64(m + 64 * kS + 64, w + 64, tm);  // S^-1
  // Y = X S^-1: -Y upper right, -Y^T lower left
  for (int n = tm.s; n < 16; n += kWarps) {
    const int bi = n / 4, j = n % 4;
    Blk acc = {};
    tc64::blk_prod<kS, 4, true>(acc, w, bi, 0, m, 4 + j, 4, g, t);
    Blk tr;
    tc::transpose(tr, acc, g, t);
    tc64::st_blk<kS>(acc, m, bi, 4 + j, g, t);
    tc64::st_blk<kS>(tr, m, 4 + j, bi, g, t);
  }
  __syncthreads();
  // TL = A^-1 + Y X^T: its lower blocks, the upper ones their transposes
  for (int n = tm.s; n < 10; n += kWarps) {
    int bi, bj;
    tc64::lower_block<4>(n, bi, bj);
    Blk acc;
    tc64::ld_blk<kS>(acc, m, bi, bj, g, t);
    tc64::blk_prod<kS, 4, true>(acc, m, bi, 4, w, bj, 0, g, t);  // -(-Y) X^T
    tc64::st_blk<kS>(acc, m, bi, bj, g, t);
    if (bi != bj) {
      Blk tr;
      tc::transpose(tr, acc, g, t);
      tc64::st_blk<kS>(tr, m, bj, bi, g, t);
    }
  }
  __syncthreads();
  for (int n = tm.s; n < kNB * kNB; n += kWarps) {
    Blk x;
    tc64::ld_blk<kS>(x, m, n / kNB, n % kNB, g, t);
    tc64::blk_scale(x, inv_s);
    tc64::st_blk<kS>(x, m, n / kNB, n % kNB, g, t);
  }
  __syncthreads();
}

// acc (+)= (NEG ? -1 : 1) A's blocks (ai, kb) times N's blocks (ni, kb)
// transposed, kb over the 8 block columns in order (tc_blocks.cuh
// blk_prod, a k block at a time: unrolled, the loads of the later blocks
// were hoisted past the registers and spilled).
template <bool NEG>
__device__ __forceinline__ void row_prod(Blk& acc, const float* a, int ai,
                                         const float* n, int ni, int g,
                                         int t) {
#pragma unroll 1
  for (int kb = 0; kb < kNB; ++kb)
    tc64::blk_prod<kS, 1, NEG>(acc, a, ai, kb, n, ni, kb, g, t);
}

// x = the identity block at i == j, else zero, in accumulator layout.
__device__ __forceinline__ void blk_eye(Blk& x, bool diag, int g, int t) {
#pragma unroll
  for (int nj = 0; nj < 2; ++nj)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      x[nj][r] = diag && g + 8 * (r / 2) == 8 * nj + 2 * t + r % 2 ? 1.0f
                                                                   : 0.0f;
}

// Stores x at (bi, bj) of m and, off the diagonal, its exact transpose at
// (bj, bi).
__device__ __forceinline__ void st_sym(const Blk& x, float* m, int bi, int bj,
                                       int g, int t) {
  tc64::st_blk<kS>(x, m, bi, bj, g, t);
  if (bi != bj) {
    Blk tr;
    tc::transpose(tr, x, g, t);
    tc64::st_blk<kS>(tr, m, bj, bi, g, t);
  }
}

// P0's diagonal blocks: the lower triangle the mirror of the upper (one
// block a warp).
__device__ __forceinline__ void mirror_diagonal(float* pm, const Team& tm) {
  Blk x;
  tc64::ld_blk<kS>(x, pm, tm.s, tm.s, tm.g, tm.t);
  tc::mirror_upper(x, tm.g, tm.t);
  tc64::st_blk<kS>(x, pm, tm.s, tm.s, tm.g, tm.t);
}

// P_pred = F P F^T + Q: X = F P a block row a warp (sub-warp s row s, in
// registers), stored over P once every warp has read P; then the lower
// blocks (i, j <= i) of X F^T + Q into w.  Returns after the barrier that
// follows X's stores; the caller syncs after w.
__device__ __forceinline__ void predict_cov(float* pm, float* w,
                                            const float* f, const float* q,
                                            int d, const Team& tm) {
  const int g = tm.g, t = tm.t;
  float x[kNB][2][4] = {};
  // one k block at a time (the tier past 32's predict_row: unrolled, the
  // next blocks' loads are hoisted past the registers)
#pragma unroll 1
  for (int kb = 0; kb < kNB; ++kb) {
    Blk a;
    tc64::ld_blk<kS>(a, f, tm.s, kb, g, t);
    uint32_t ah[2][4], al[2][4];
    tc64::a_parts(a, false, ah, al);
#pragma unroll
    for (int j = 0; j < kNB; ++j) {
      Blk n;
      tc64::ld_blk<kS>(n, pm, j, kb, g, t);  // P symmetric: P_(kb, j)^T
      tc64::mul_acc(x[j], ah, al, n);
    }
  }
  __syncthreads();  // every warp has read P
#pragma unroll
  for (int j = 0; j < kNB; ++j) tc64::st_blk<kS>(x[j], pm, tm.s, j, g, t);
  __syncthreads();
  for (int n = tm.s; n < kLower; n += kWarps) {
    int i, j;
    tc64::lower_block<kNB>(n, i, j);
    Blk acc;
    ld_q(acc, q, i, j, d, g, t);
    row_prod<false>(acc, pm, i, f, j, g, t);
    tc64::st_blk<kS>(acc, w, i, j, g, t);
  }
}

// Entry j of M v for the shared symmetric M (its column j read as row j,
// 32 neighbouring floats a warp) and the vector v, zero past d.
__device__ __forceinline__ float col_vec(const float* m, const float* v,
                                        int j) {
  float acc = 0.0f;
#pragma unroll 8
  for (int k = 0; k < kDP; ++k) acc = fmaf(m[k * kS + j], v[k], acc);
  return acc;
}

// params: the (4, kDP, kS) F, F^T, Q, W of the other tiers, zero past d,
// in device memory.  A block is one chain: blockIdx.x.
__global__ void __launch_bounds__(kThreads, 1)
    warp_filter_tc128_kernel(const float* __restrict__ ys,
                             const float* __restrict__ m0,
                             const float* __restrict__ p0,
                             const float* __restrict__ hr_t,
                             const float* __restrict__ params,
                             float* __restrict__ means,
                             float* __restrict__ mf, float* __restrict__ pf,
                             int64_t T, int64_t B, int d, int dy) {
  extern __shared__ __align__(16) float smem[];
  float* f = smem;               // F; L + W; the refined P
  float* pm = smem + kMat;       // P; F P; L + W, P0 = (L + W)^-1
  float* wk = smem + 2 * kMat;   // P_pred, L; the inverses' work; R^T
  float* mv = smem + 3 * kMat;
  float* mp = mv + kDP;
  float* hv = mp + kDP;
  const float* q = params + 2 * kMat;
  const float* wo = params + 3 * kMat;
  Team tm;
  tm.s = threadIdx.x / kLanes;
  tm.lane = threadIdx.x % kLanes;
  tm.g = tm.lane >> 2;
  tm.t = tm.lane & 3;
  float* y_s = hv + kDP + tm.s * kYChunk;  // each warp's observation chunk
  float* red = hv + kDP + kWarps * kYChunk;  // the warps' partial sums
  const int r0 = threadIdx.x;              // the thread's row
  const int64_t b = blockIdx.x;
  for (int i = r0; i < kMat; i += kThreads) f[i] = params[i];
  for (int i = r0; i < 2 * kMat + kVec; i += kThreads) pm[i] = 0.0f;
  __syncthreads();
  // the state handed in; identity past d
  if (r0 < kDP) {
    const int j = r0;
    if (j < d) {
      mv[j] = m0[j * B + b];
      for (int i = 0; i <= j; ++i) {
        const float v = p0[sym_slot(i, j, d) * B + b];
        pm[i * kS + j] = v;
        pm[j * kS + i] = v;
      }
    } else {
      pm[j * kS + j] = 1.0f;
    }
  }
  __syncthreads();  // F and the state are in place

  for (int64_t step = 0; step < T; ++step) {
    const float* yt = ys + step * dy * B + b;
    float y_next = tm.lane < dy ? yt[tm.lane * B] : 0.0f;

    // m_pred = F m, row j summed from column j on, so that the lanes read
    // distinct banks
    if (r0 < kDP) {
      const int j = r0;
      float acc = 0.0f;
      for (int kk = 0; kk < kDP; ++kk) {
        const int k = j + kk < kDP ? j + kk : j + kk - kDP;
        acc = fmaf(f[j * kS + k], mv[k], acc);
      }
      mp[j] = acc;
    }
    // P_pred = F P F^T + Q into the work matrix ; L = P_pred^-1
    predict_cov(pm, wk, f, q, d, tm);
    __syncthreads();
    sym_inv128(wk, pm, red, d, tm);

    // xi_j = sum_k HR[j][k] y_t[k], k in order, a chunk at a time (into h;
    // each warp stages the chunk for its own rows)
    for (int c = 0; c < dy; c += kYChunk) {
      if (c > 0) y_next = c + tm.lane < dy ? yt[(c + tm.lane) * B] : 0.0f;
      __syncwarp();  // the warp is done with the last chunk
      y_s[tm.lane] = y_next;
      __syncwarp();
      const int n = dy - c < kYChunk ? dy - c : kYChunk;
      if (r0 < d) {
        const float* hr = hr_t + static_cast<int64_t>(c) * d + r0;
        float xi = c > 0 ? hv[r0] : 0.0f;
        for (int k = 0; k < n; ++k, hr += d)
          xi = c + k == 0 ? *hr * y_s[k] : fmaf(*hr, y_s[k], xi);
        hv[r0] = xi;
      }
    }
    // h = L m_pred + xi (each thread its own entry; zero past d)
    if (r0 < d) hv[r0] = col_vec(wk, mp, r0) + hv[r0];
    // M = L + W: its lower blocks into P's matrix, to be inverted, and
    // whole into F's (F is read again only next step)
    for (int n = tm.s; n < kLower; n += kWarps) {
      int bi, bj;
      tc64::lower_block<kNB>(n, bi, bj);
      Blk x, o;
      tc64::ld_blk<kS>(x, wk, bi, bj, tm.g, tm.t);
      tc64::ld_blk<kS>(o, wo, bi, bj, tm.g, tm.t);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
#pragma unroll
        for (int r = 0; r < 4; ++r) x[nj][r] += o[nj][r];
      tc64::st_blk<kS>(x, pm, bi, bj, tm.g, tm.t);
      st_sym(x, f, bi, bj, tm.g, tm.t);
    }
    __syncthreads();
    sym_inv128(pm, wk, red, d, tm);  // P0 = M^-1
    mirror_diagonal(pm, tm);
    __syncthreads();
    // One Newton step, P = P0 + P0 (I - M P0), in the same 3xTF32
    // products: the Schur inverse alone left the filter 1.2e-3 from the
    // float64 one at d = 100 with 7 observations (phase 17 (a)), where the
    // plain version stays within 6e-5; the step takes it there.  R = I - M
    // P0, stored transposed into the work matrix, a block a unit.
    for (int n = tm.s; n < kNB * kNB; n += kWarps) {
      const int i = n / kNB, j = n % kNB;
      Blk acc;
      blk_eye(acc, i == j, tm.g, tm.t);
      row_prod<true>(acc, f, i, pm, j, tm.g, tm.t);
      Blk tr;
      tc::transpose(tr, acc, tm.g, tm.t);
      tc64::st_blk<kS>(tr, wk, j, i, tm.g, tm.t);
    }
    __syncthreads();
    // P = P0 + P0 R, its lower blocks (the upper their transposes, the
    // diagonal blocks mirrored) into F's matrix
    for (int n = tm.s; n < kLower; n += kWarps) {
      int bi, bj;
      tc64::lower_block<kNB>(n, bi, bj);
      Blk acc;
      tc64::ld_blk<kS>(acc, pm, bi, bj, tm.g, tm.t);
      row_prod<false>(acc, pm, bi, wk, bj, tm.g, tm.t);
      if (bi == bj) tc::mirror_upper(acc, tm.g, tm.t);
      st_sym(acc, f, bi, bj, tm.g, tm.t);
    }
    __syncthreads();
    // F back into P0's matrix, which becomes F's; P is F's
    for (int i = r0; i < kMat; i += kThreads) pm[i] = params[i];
    float* const p_new = f;
    f = pm;
    pm = p_new;
    // m = P h
    if (r0 < d) {
      const float m = col_vec(pm, hv, r0);
      mv[r0] = m;
      means[(step * d + r0) * B + b] = m;
    }
    __syncthreads();
  }

  if (r0 < d) {
    const int j = r0;
    mf[j * B + b] = mv[j];
    for (int i = 0; i <= j; ++i)
      pf[sym_slot(i, j, d) * B + b] = pm[i * kS + j];
  }
}

constexpr int kSmemBytes = 4 * kSmemFloats;

int allow_smem() {
  return static_cast<int>(cudaFuncSetAttribute(
      warp_filter_tc128_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes));
}

int launch(const float* ys, const float* m0, const float* p0,
           const float* hr_t, const float* params, float* means, float* mf,
           float* pf, int64_t T, int64_t B, int d, int dy,
           cudaStream_t stream) {
  const int rc = allow_smem();
  if (rc != 0) return rc;
  warp_filter_tc128_kernel<<<static_cast<unsigned>(B), kThreads, kSmemBytes,
                             stream>>>(ys, m0, p0, hr_t, params, means, mf,
                                       pf, T, B, d, dy);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc128

}  // namespace

extern "C" {

// The tier's shared bytes a block (ops/fused_filter.py tc128_plan computes
// the same), the blocks an SM holds (or -1), its padded state and the
// parameters' row stride.
int64_t rxt_warp_filter_tc128_smem_bytes() { return tc128::kSmemBytes; }

int rxt_warp_filter_tc128_blocks_per_sm() {
  int n = 0;
  if (tc128::allow_smem() != 0 ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, tc128::warp_filter_tc128_kernel, tc128::kThreads,
          tc128::kSmemBytes) != cudaSuccess)
    return -1;
  return n;
}

int rxt_warp_filter_tc128_dims(int* padded, int* stride) {
  *padded = tc128::kDP;
  *stride = tc128::kS;
  return 0;
}

// Returns the CUDA error of the launch (0 = success).  64 < d <= 128,
// dy >= 1; params the device (4, 128, s_in) F, F^T, Q, W, zero past d, at
// s_in == 136; hr_t the device (dy, d) HR^T, row-major; the rest device
// pointers.
int rxt_warp_filter_tc128(int d, int dy, const float* ys, const float* m0,
                          const float* p0, const float* hr_t,
                          const float* params, float* means, float* mf,
                          float* pf, int64_t T, int64_t B, int s_in,
                          void* stream) {
  if (d <= 64 || d > tc128::kDP || dy < 1 || T < 1 || B < 1 ||
      s_in != tc128::kS)
    return static_cast<int>(cudaErrorInvalidValue);
  return tc128::launch(ys, m0, p0, hr_t, params, means, mf, pf, T, B, d, dy,
                       static_cast<cudaStream_t>(stream));
}

const char* rxt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Fused streaming Kalman filter for state dims above 16 on Hopper (sm_90a):
// K3 for the d that the register kernel (fused_filter.cu, d, dy <= 8) and
// the wide kernel (fused_filter_wide.cu, d <= 16) do not take, at any
// observation dim.
//
// Replaces the TPU kernel `_filter_kernel` of
// rxinfer_tpu/ops/pallas_filter.py (lines 84-144), which unrolls its step
// for any d and dy.  Same math, order and layouts as fused_filter_wide.cu
// and the plain version (ops/fused_filter.py `filter_step`):
//   xi = HR y_t                                   HR = H^T R^-1, (d, dy)
//   m_pred = F m ; P_pred = F P F^T + Q
//   L = P_pred^-1 ; P = (L + W)^-1 ; m = P (L m_pred + xi)
// with the transition applied at EVERY step, t = 0 included, and no bias.
// ys (T, dy, B), m0 (d, B), p0 (nsym, B) upper triangle row by row; out
// means (T, d, B), mf (d, B), pf (nsym, B).
//
// Three tiers, a chain on a whole warp in each; the host-side rule that
// picks the tier and the chains a block is ops/fused_filter.py `warp_plan`.
// To d = 32 the tensor-core tier (namespace tc below): the chain's two
// matrices in registers, their products and the inverses' Schur blocks on
// the tensor cores in 3xTF32.  To d = 64 the tensor-core tier past 32
// (namespace tc64): the same arithmetic on 16 x 16 blocks of matrices that
// sit in shared memory.  Past d = 64 the sweep tiers, described here (the
// plan of ops/fused_filter.py `sweep_warp_plan` still launches them at any
// d, where the timing scripts set them beside the tensor-core tiers).
//
// The sweep tiers: a chain's two d x d matrices (P and a work matrix) live
// in memory, not in registers: rows at a padded stride S (the dim padded
// to dp, a multiple of 8, and S = dp + 4, so a row is whole float4s and a
// column read spreads over 8 banks), the padding zero.  Lane l owns columns
// l, l + 32, ... (ceil(d / 32) of them; the matrices of the step are
// symmetric, so a column is a row).  A product C = A B has lane l
// accumulate column j of C for 8 rows at a time: A's rows are read as
// float4 broadcasts, B's row k as 32 neighbouring floats (no bank
// conflict); a symmetric product computes the upper triangle and writes
// each entry to (i, j) and (j, i).  The inverses are the scaled
// Gauss-Jordan sweep (scale by the mean |diagonal|, d unpivoted pivots in
// series, the upper triangle kept and mirrored), column by column: the
// pivot's column is copied to a vector first, then each lane updates its
// own columns with the pivot row's entry of that column.  The plain
// version inverts by a Schur recursion, so the two differ in rounding only.
// F, F^T, Q and W, shared by every chain, come from one device tensor (4
// padded matrices); they are copied to the block's shared memory while they
// fit beside one chain, else read from device memory through L1.  A
// chain's two matrices sit in shared memory while one chain fits a block,
// else in a device-memory scratch (a slot a warp), so no d has a cap.  The
// launcher recomputes the shared bytes from the plan
// (rxt_warp_filter_smem_bytes) and refuses more than the device's opt-in
// limit.  The evidence is formed here, in both tiers, as in
// fused_filter_wide.cu: lane l sums xi_j = HR[j][0] y[0] + HR[j][1] y[1] +
// ... in k order, reading HR's row j as column j of HR^T (dy, d) from device
// memory, the step's observations staged in shared memory kYChunk at a
// time: dy has no cap.
//
// What bounds them: at path A's (B, T, d, dy) = (10,000, 200, 32, 32) the
// operations of the plain step (3.49e11, counted on stand-ins) take 5.21 ms
// at the float32 rate, or 2.38 ms with the 91% of them that the
// tensor-core tier runs as products at the 3xTF32 rate (495 / 3 TFLOP/s),
// and the bytes (0.557 GB) 0.17 ms, so on paper the operations.  A sweep
// tier is bound by its shared-memory instructions
// instead: the sweep loads and stores an entry for each multiply-add, the
// products load 0.375 words a multiply-add, and a warp of one chain has
// one dependent chain of d pivots (51.98 ms at that shape on an H100; at
// (2,000, 200, 64, 64) 358.9 ms).
// The tensor-core tier is bound by its instructions' issue and latency at
// 16 warps an SM (128 registers a thread): the splits of the operands into
// TF32 parts, the leaves' pivots and the 3xTF32 products (14.2 ms).  The
// tier past 32 at (2,000, 200, 64, 64): the operations take 3.46 ms with
// the 96% of them it runs on the tensor cores at the 3xTF32 rate (8.08 ms
// at float32 only), the bytes (0.239 GB) 0.07 ms; it is bound by its
// warps' latency (two warps a chain, four chains an SM, shared memory the
// limit): 39.2 ms on an H100 80GB HBM3 at 700 W, 9.0 times the sweep
// tier (358.9 ms).
//
// A chain index past B runs on the last chain's inputs and stores nothing,
// so every lane reaches every __syncwarp.

#include <cuda_runtime.h>

#include <stdint.h>

#include "tc16.cuh"
#include "tc_blocks.cuh"

namespace {

constexpr int kLanes = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxChains = 8;        // chains a block: up to 8 warps
constexpr int kYChunk = kLanes;      // observations staged at a time
constexpr int kRowBlock = 8;         // rows of a product a lane sums at once

// Slot of entry (i, j), i <= j < d, in the packed upper triangle.
__device__ __forceinline__ int64_t sym_slot(int i, int j, int d) {
  return static_cast<int64_t>(i) * (2 * d - i + 1) / 2 + (j - i);
}

// Column j of m^T v for a matrix m (its rows at stride s) and a vector v,
// both zero past d: sum_k m[k][j] v[k] in k order.
__device__ __forceinline__ float col_dot(const float* m, const float* v,
                                         int d4, int s, int j) {
  float acc = 0.0f;
  for (int k0 = 0; k0 < d4; k0 += 4) {
    const float4 vv = *reinterpret_cast<const float4*>(v + k0);
    acc = fmaf(m[k0 * s + j], vv.x, acc);
    acc = fmaf(m[(k0 + 1) * s + j], vv.y, acc);
    acc = fmaf(m[(k0 + 2) * s + j], vv.z, acc);
    acc = fmaf(m[(k0 + 3) * s + j], vv.w, acc);
  }
  return acc;
}

// C = A B (+ ADD) over the real d x d block: lane owns columns lane + 32 c.
// A's and B's columns past d are zero up to d4, A's rows up to dp exist.
// UPPER: only i <= j, each entry written to (i, j) and (j, i).  C must not
// alias A, B or ADD.  No barrier: the caller syncs.
template <bool UPPER, bool ADD>
__device__ __forceinline__ void mat_mul(const float* a, const float* b,
                                        const float* add, float* c, int d,
                                        int d4, int s, int lane) {
  for (int j0 = 0; j0 < d; j0 += kLanes) {
    const int j = j0 + lane;
    const bool col = j < d;
    const int jj = col ? j : 0;
    for (int i0 = 0; i0 < d; i0 += kRowBlock) {
      if (UPPER && i0 > j0 + kLanes - 1) break;  // the same for every lane
      float acc[kRowBlock];
#pragma unroll
      for (int r = 0; r < kRowBlock; ++r) acc[r] = 0.0f;
      for (int k0 = 0; k0 < d4; k0 += 4) {
        const float b0 = b[k0 * s + jj];
        const float b1 = b[(k0 + 1) * s + jj];
        const float b2 = b[(k0 + 2) * s + jj];
        const float b3 = b[(k0 + 3) * s + jj];
#pragma unroll
        for (int r = 0; r < kRowBlock; ++r) {
          const float4 av =
              *reinterpret_cast<const float4*>(a + (i0 + r) * s + k0);
          acc[r] = fmaf(av.x, b0, acc[r]);
          acc[r] = fmaf(av.y, b1, acc[r]);
          acc[r] = fmaf(av.z, b2, acc[r]);
          acc[r] = fmaf(av.w, b3, acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRowBlock; ++r) {
        const int i = i0 + r;
        if (col && i < d && (!UPPER || i <= j)) {
          const float v = ADD ? add[i * s + j] + acc[r] : acc[r];
          c[i * s + j] = v;
          if (UPPER) c[j * s + i] = v;
        }
      }
    }
  }
}

// Rows i0 .. i0 + 7 of column j (rows up to dp exist).  Every helper below
// loads a block of rows before it stores any: the stores may alias the
// loads as far as the compiler knows, so a row at a time would wait for
// each load in turn.
__device__ __forceinline__ void load_col(const float* m, int i0, int s,
                                         int j, float (&e)[kRowBlock]) {
#pragma unroll
  for (int r = 0; r < kRowBlock; ++r) e[r] = m[(i0 + r) * s + j];
}

// Entries below the diagonal become those above it: lane l reads row j's
// entries right of the diagonal (whole float4s) into column j.
__device__ __forceinline__ void mirror_upper(float* m, int d, int s,
                                             int lane) {
  __syncwarp();
  for (int j = lane; j < d; j += kLanes) {
    for (int i0 = (j + 1) & ~(kRowBlock - 1); i0 < d; i0 += kRowBlock) {
      const float4 lo = *reinterpret_cast<const float4*>(m + j * s + i0);
      const float4 hi = *reinterpret_cast<const float4*>(m + j * s + i0 + 4);
      const float e[kRowBlock] = {lo.x, lo.y, lo.z, lo.w,
                                  hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int r = 0; r < kRowBlock; ++r) {
        const int i = i0 + r;
        if (i > j && i < d) m[i * s + j] = e[r];
      }
    }
  }
  __syncwarp();
}

// 1 / the mean |diagonal| of m (ops/entrywise.py sym_inv_scaled's scale;
// 1 for a zero diagonal), the same on every lane.
__device__ __forceinline__ float inverse_scale(const float* m, int d, int s,
                                               int lane) {
  float sum = 0.0f;
  for (int j = lane; j < d; j += kLanes) sum += fabsf(m[j * s + j]);
#pragma unroll
  for (int o = kLanes / 2; o > 0; o /= 2)
    sum += __shfl_xor_sync(kFull, sum, o);
  float scale = sum / static_cast<float>(d);
  scale = scale > 0.0f ? scale : 1.0f;
  return 1.0f / scale;
}

// In place: the inverse of the symmetric matrix m, scaled by the mean
// |diagonal| (ops/entrywise.py sym_inv_scaled), an unpivoted Gauss-Jordan
// sweep over the d pivots, the upper triangle mirrored.  `v` is a vector of
// the chain's (dp floats, zero past d), the pivot's column.
__device__ __forceinline__ void sym_inv_scaled(float* m, float* v, int d,
                                               int s, int lane) {
  const float inv_s = inverse_scale(m, d, s, lane);
  for (int j = lane; j < d; j += kLanes) {
    for (int i0 = 0; i0 < d; i0 += kRowBlock) {
      float e[kRowBlock];
      load_col(m, i0, s, j, e);
#pragma unroll
      for (int r = 0; r < kRowBlock; ++r)
        if (i0 + r < d) m[(i0 + r) * s + j] = e[r] * inv_s;
    }
  }
  __syncwarp();
  for (int k = 0; k < d; ++k) {
    for (int i = lane; i < d; i += kLanes) v[i] = m[i * s + k];
    __syncwarp();
    const float p = 1.0f / v[k];
    for (int j = lane; j < d; j += kLanes) {
      const bool pc = j == k;
      const float qj = m[k * s + j] * p;
      for (int i0 = 0; i0 < d; i0 += kRowBlock) {
        float e[kRowBlock];
        load_col(m, i0, s, j, e);
        const float4 f_lo = *reinterpret_cast<const float4*>(v + i0);
        const float4 f_hi = *reinterpret_cast<const float4*>(v + i0 + 4);
        const float f[kRowBlock] = {f_lo.x, f_lo.y, f_lo.z, f_lo.w,
                                    f_hi.x, f_hi.y, f_hi.z, f_hi.w};
#pragma unroll
        for (int r = 0; r < kRowBlock; ++r) {
          const int i = i0 + r;
          const float out = i == k ? (pc ? p : qj)
                                   : (pc ? -f[r] * p : fmaf(-f[r], qj, e[r]));
          if (i < d) m[i * s + j] = out;
        }
      }
    }
    __syncwarp();
  }
  for (int j = lane; j < d; j += kLanes) {
    for (int i0 = 0; i0 <= j; i0 += kRowBlock) {
      float e[kRowBlock];
      load_col(m, i0, s, j, e);
#pragma unroll
      for (int r = 0; r < kRowBlock; ++r)
        if (i0 + r <= j) m[(i0 + r) * s + j] = e[r] * inv_s;
    }
  }
  mirror_upper(m, d, s, lane);
}

// Floats of the per-chain vectors: m, m_pred, h, a pivot column, the
// observation chunk.
__host__ __device__ constexpr int vec_floats(int dp) {
  return 4 * dp + kYChunk;
}

template <bool PARAMS_SHARED, bool CHAIN_SHARED>
__global__ void __launch_bounds__(kMaxChains * kLanes)
warp_filter_kernel(const float* __restrict__ ys, const float* __restrict__ m0,
                   const float* __restrict__ p0,
                   const float* __restrict__ hr_t,
                   const float* __restrict__ params,
                   float* __restrict__ means, float* __restrict__ mf,
                   float* __restrict__ pf, float* scratch, int64_t T,
                   int64_t B, int d, int dy, int dp, int s, int chains) {
  extern __shared__ __align__(16) float smem[];
  const int mat = dp * s;
  const int d4 = (d + 3) & ~3;
  const int g = threadIdx.x / kLanes;  // chain within the block
  const int lane = threadIdx.x % kLanes;
  const int64_t b_raw = static_cast<int64_t>(blockIdx.x) * chains + g;
  const bool valid = b_raw < B;
  const int64_t b = valid ? b_raw : B - 1;

  const float* prm = params;
  float* rest = smem;
  if (PARAMS_SHARED) {
    const float4* src = reinterpret_cast<const float4*>(params);
    float4* dst = reinterpret_cast<float4*>(smem);
    for (int i = threadIdx.x; i < mat; i += blockDim.x) dst[i] = src[i];
    prm = smem;
    rest = smem + 4 * mat;
  }
  const float* f = prm;
  const float* ft = prm + mat;
  const float* q = prm + 2 * mat;
  const float* w = prm + 3 * mat;
  float* mv = rest + g * vec_floats(dp);
  float* mp = mv + dp;
  float* hv = mp + dp;
  float* cv = hv + dp;
  float* y_s = cv + dp;
  float* pm = CHAIN_SHARED
                  ? rest + chains * vec_floats(dp) + g * 2 * mat
                  : scratch + (static_cast<int64_t>(blockIdx.x) * chains + g) *
                                  2 * mat;
  float* xm = pm + mat;

  // zero the chain's matrices and vectors (their padding stays zero)
  for (int i = lane; i < 2 * mat; i += kLanes) pm[i] = 0.0f;
  for (int i = lane; i < 4 * dp; i += kLanes) mv[i] = 0.0f;
  __syncwarp();
  // the state handed in: the posterior of the step before the stream
  for (int j = lane; j < d; j += kLanes) {
    mv[j] = m0[j * B + b];
    for (int i = 0; i <= j; ++i) {
      const float v = p0[sym_slot(i, j, d) * B + b];
      pm[i * s + j] = v;
      pm[j * s + i] = v;
    }
  }
  __syncthreads();  // the parameters and the state are in place

  for (int64_t t = 0; t < T; ++t) {
    // the first observation chunk, stored after the inverses
    const float* yt = ys + t * dy * B + b;
    float y_next = lane < dy ? yt[lane * B] : 0.0f;

    // m_pred = F m ; X = F P ; P = X F^T + Q (upper, mirrored)
    for (int j = lane; j < d; j += kLanes) mp[j] = col_dot(ft, mv, d4, s, j);
    mat_mul<false, false>(f, pm, nullptr, xm, d, d4, s, lane);
    __syncwarp();
    mat_mul<true, true>(xm, ft, q, pm, d, d4, s, lane);
    __syncwarp();
    // L = P_pred^-1 in place ; X = L + W (upper, mirrored)
    sym_inv_scaled(pm, cv, d, s, lane);
    for (int j = lane; j < d; j += kLanes) {
      for (int i0 = 0; i0 <= j; i0 += kRowBlock) {
        float lam[kRowBlock], wo[kRowBlock];
        load_col(pm, i0, s, j, lam);
        load_col(w, i0, s, j, wo);
#pragma unroll
        for (int r = 0; r < kRowBlock; ++r) {
          const int i = i0 + r;
          if (i <= j) {
            const float v = lam[r] + wo[r];
            xm[i * s + j] = v;
            xm[j * s + i] = v;
          }
        }
      }
    }

    // xi_j = sum_k HR[j][k] y_t[k], k in order, a chunk at a time (into h)
    for (int c = 0; c < dy; c += kYChunk) {
      if (c > 0) y_next = c + lane < dy ? yt[(c + lane) * B] : 0.0f;
      __syncwarp();  // the chain is done with the last chunk
      y_s[lane] = y_next;
      __syncwarp();
      const int n = dy - c < kYChunk ? dy - c : kYChunk;
      for (int j = lane; j < d; j += kLanes) {
        const float* hr = hr_t + static_cast<int64_t>(c) * d + j;
        float xi = c > 0 ? hv[j] : 0.0f;
        for (int k = 0; k < n; ++k, hr += d)
          xi = c + k == 0 ? *hr * y_s[k] : fmaf(*hr, y_s[k], xi);
        hv[j] = xi;
      }
    }
    // h = L m_pred + xi (each lane its own entries of h)
    for (int j = lane; j < d; j += kLanes)
      hv[j] = col_dot(pm, mp, d4, s, j) + hv[j];
    __syncwarp();

    // P = (L + W)^-1 ; m = P h
    sym_inv_scaled(xm, cv, d, s, lane);
    for (int j = lane; j < d; j += kLanes) {
      const float m = col_dot(xm, hv, d4, s, j);
      mv[j] = m;
      if (valid) means[(t * d + j) * B + b] = m;
    }
    float* tmp = pm;
    pm = xm;
    xm = tmp;
    __syncwarp();
  }

  if (valid) {
    for (int j = lane; j < d; j += kLanes) {
      mf[j * B + b] = mv[j];
      for (int i = 0; i <= j; ++i) pf[sym_slot(i, j, d) * B + b] = pm[i * s + j];
    }
  }
}

// ---- The tensor-core tier: 16 < d <= 32 -----------------------------------
//
// The same step on a chain a warp, with the state padded to 32 and both of
// the chain's matrices in registers, in the accumulator layout of
// mma.sync.m16n8k8 (struct Mat below): lane (g, t) = (lane / 4, lane % 4)
// holds rows g, g + 8, g + 16, g + 24 and columns 2t, 2t + 1, 2t + 8, ... .
// * Products on the tensor cores, float32-accurate: every operand is split
//   into a TF32 high part (rounded to nearest as cvt.rna does) and a low
//   part (the float32 rest, of which the tensor cores read the top 19
//   bits), and three TF32 products are summed (lo hi + hi lo + hi hi,
//   "3xTF32").  A plain TF32 product keeps about three decimal digits and
//   is not used.
// * No fragment changes layout.  mma's A operand holds (row g, k = t) and
//   (row g, k = t + 4), where the accumulator holds columns 2t and 2t + 1:
//   read with k permuted within each 8 (k = t -> column 2t, t + 4 -> 2t + 1)
//   an accumulator is an A operand as it stands.  The B operand of C = A N^T
//   with that permutation is N's rows 8n + g at columns 2t, 2t + 1: again
//   N's accumulator registers.  So every product is written C = A N^T with
//   A and N in accumulator layout (blk_mul, mul8, row_block_*), and a
//   symmetric N is its own transpose.
// * Both inverses are the plain version's Schur recursion split at 16
//   (ops/entrywise.py sym_inv, scaled by the mean |diagonal| as
//   sym_inv_scaled): A^-1 on the leaf; X = A^-1 B and Z = B^T A^-1 (which
//   is X^T, formed so that no block is transposed); S = D - Z B; S^-1 on
//   the leaf; Y = X S^-1; TL = A^-1 + Y X^T; the lower-left block -Y^T the
//   transpose of the upper-right -Y by shuffles (tc16.cuh transpose), not a
//   product of its own, so the two are exact mirrors.  Five 16 x 16 x 16
//   products on the tensor cores.  After the second inverse the two
//   diagonal blocks' lower triangles become the mirror of their upper
//   (tc16.cuh mirror_upper), so P is the symmetric matrix of its upper
//   triangle each step, as the plain version keeps it: the Schur blocks
//   leave the triangles apart by rounding, and two inverses a step amplify
//   that on chains with few observations (one observation of 24 states
//   reached NaN).  Each 16 x 16 inverse is the same
//   recursion split at 8, its four 8 x 8 x 8 products two a m16n8k8 (the
//   8-row halves of mma's A carry two products that share B); the 8 x 8
//   leaves are the Gauss-Jordan sweep of the sweep tiers, their pivots'
//   rows and columns exchanged by shuffles.  The upper-right block of an
//   input is never read: its transpose B^T is.
// * The padding: Q's padded diagonal is 1 in shared memory, so the padded
//   block of every matrix of the step is the identity, and the products
//   keep the real and padded parts apart exactly (zeros times finite
//   numbers); the scale is the mean over the d real diagonal entries.
// * F (split into its TF32 parts, and F^T in float32 for m_pred = F m), Q
//   and W sit in shared memory once a block, at a row stride of 40 floats:
//   a quad's float2 loads of rows g, columns 2t, 2t + 1 take all 32 banks
//   of a half-warp.  A chain's vectors (m, m_pred, h, the observation
//   chunk) sit in shared memory, and one 16 x 16 block of P_pred while F P
//   is formed (predict_cov); xi = HR y is formed as in the sweep tiers.
// A step at d = 32 is 336 mma.sync (96 + 72 for F P F^T, 2 x 60 for the
// inverses' 16 x 16 products, 4 x 12 for the 8 x 8 ones) and eight leaves
// of 8 pivots.  To d = 24 a second instance pads the state to 24 for the
// products: the last 8-column tile of every operand is then zero padding
// or the padding's identity, so its products are not formed (189
// mma.sync a step) and the padded half of D is inverted as a diagonal (six
// leaves).  F P is formed a 16-row block at a time, and only the three
// blocks of F P F^T + Q the inverse reads, so that a thread stays within
// 128 registers without spilling.  The 16 x 16 primitives (the 3xTF32
// split and products, blk_mul, the leaves, inv16) sit in tc16.cuh, shared
// with the wide K1/K2 of fused_smoother_wide.cu.

namespace tc {

constexpr int kDim = 32;
constexpr int kS = 40;                 // a shared matrix's row stride
constexpr int kMat = kDim * kS;
// a chain's m, m_pred, h, observation chunk, and a block of P_pred (8
// floats a lane) while the next block row of F P is formed
constexpr int kVec = 3 * kDim + kYChunk + 8 * kLanes;
constexpr int kMinBlocks = 2;          // blocks an SM (__launch_bounds__)

// A 32 x 32 matrix in mma.m16n8k8's accumulator layout: 16 x 16 blocks
// [bi][bj], each two 16 x 8 tiles [nj] of four registers [r]; entry r of
// tile nj of block (bi, bj) sits at row 16 bi + g + 8 (r / 2), column
// 16 bj + 8 nj + 2 t + r % 2.
struct Mat {
  float b[2][2][2][4];
};

// x = F_i m^T, the 16-row block i of F m^T: F's TF32 parts from shared
// memory (rows 16 i + g, + 8 at columns 8 ki + 2t, + 1: float2 loads), m
// in registers.  x[bj][nj] is the tile at columns 16 bj + 8 nj.  Column
// and k tiles at or past DP are zero padding (F's columns, m's identity
// block against F's zero columns) and are not formed.
template <int I, int DP>
__device__ __forceinline__ void row_block_fmt(float (&x)[2][2][4],
                                              const float* fh,
                                              const float* fl, const Mat& m,
                                              int g, int t) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int nj = 0; nj < 2; ++nj)
#pragma unroll
      for (int r = 0; r < 4; ++r) x[j][nj][r] = 0.0f;
#pragma unroll
  for (int ki = 0; ki < DP / 8; ++ki) {
    const int o = (16 * I + g) * kS + 8 * ki + 2 * t;
    const float2 h0 = *reinterpret_cast<const float2*>(fh + o);
    const float2 h1 = *reinterpret_cast<const float2*>(fh + o + 8 * kS);
    const float2 l0 = *reinterpret_cast<const float2*>(fl + o);
    const float2 l1 = *reinterpret_cast<const float2*>(fl + o + 8 * kS);
    const uint32_t ah[4] = {__float_as_uint(h0.x), __float_as_uint(h1.x),
                            __float_as_uint(h0.y), __float_as_uint(h1.y)};
    const uint32_t al[4] = {__float_as_uint(l0.x), __float_as_uint(l1.x),
                            __float_as_uint(l0.y), __float_as_uint(l1.y)};
#pragma unroll
    for (int ni = 0; ni < DP / 8; ++ni) {
      // B: m's rows 8 ni + g at k tile ki
      uint32_t bh[2], bl[2];
#pragma unroll
      for (int e = 0; e < 2; ++e)
        split(m.b[ni >> 1][ki >> 1][ki & 1][2 * (ni & 1) + e], bh[e], bl[e]);
      mma3(x[ni >> 1][ni & 1], ah, al, bh, bl);
    }
  }
}

// c = x F_j^T + Q over NB column blocks j = 0 .. NB - 1 of block row I: x a
// 16-row block in registers, F's TF32 parts and Q from shared memory.
// Column and k tiles at or past DP are padding: c keeps Q's there.
template <int I, int NB, int DP>
__device__ __forceinline__ void row_block_xft(float (&c)[NB][2][4],
                                              const float (&x)[2][2][4],
                                              const float* fh,
                                              const float* fl,
                                              const float* q, int g, int t) {
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int nj = 0; nj < 2; ++nj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 v = *reinterpret_cast<const float2*>(
            q + (16 * I + g + 8 * h) * kS + 16 * j + 8 * nj + 2 * t);
        c[j][nj][2 * h] = v.x;
        c[j][nj][2 * h + 1] = v.y;
      }
#pragma unroll
  for (int ki = 0; ki < DP / 8; ++ki) {
    uint32_t ah[4], al[4];
    a_frag(x[ki >> 1][ki & 1], false, ah, al);
#pragma unroll
    for (int ni = 0; ni < 2 * NB && ni < DP / 8; ++ni) {
      // B: F's rows 8 ni + g at k tile ki
      const int o = (8 * ni + g) * kS + 8 * ki + 2 * t;
      const float2 vh = *reinterpret_cast<const float2*>(fh + o);
      const float2 vl = *reinterpret_cast<const float2*>(fl + o);
      const uint32_t bh[2] = {__float_as_uint(vh.x), __float_as_uint(vh.y)};
      const uint32_t bl[2] = {__float_as_uint(vl.x), __float_as_uint(vl.y)};
      mma3(c[ni >> 1][ni & 1], ah, al, bh, bl);
    }
  }
}

// In place: P = F P F^T + Q, a 16-row block of F P at a time, so that P
// and one block row of F P are live at once.  Only the blocks the inverse
// reads are formed: (0, 0) from the first block row, (1, 0) and (1, 1) from
// the second; the upper-right block keeps P's (the inverse reads its
// transpose).  Block (0, 0) waits in the chain's shared `park` (8 floats a
// lane, i-major) while the second block row is formed.
template <int DP>
__device__ __forceinline__ void predict_cov(Mat& pm, const float* fh,
                                            const float* fl, const float* q,
                                            float* park, int g, int t,
                                            int lane) {
  float x[2][2][4];
  {
    float top[1][2][4];
    row_block_fmt<0, DP>(x, fh, fl, pm, g, t);
    row_block_xft<0, 1, DP>(top, x, fh, fl, q, g, t);
#pragma unroll
    for (int i = 0; i < 8; ++i) park[i * kLanes + lane] = top[0][i >> 2][i & 3];
  }
  row_block_fmt<1, DP>(x, fh, fl, pm, g, t);
  row_block_xft<1, 2, DP>(pm.b[1], x, fh, fl, q, g, t);
#pragma unroll
  for (int i = 0; i < 8; ++i) pm.b[0][0][i >> 2][i & 3] = park[i * kLanes + lane];
}

// 1 / the mean |diagonal| over the d real entries (1 for a zero diagonal),
// the same on every lane: lane (g, g / 2) holds entries 16 b + 8 h + g.
// (A register is picked by a select: an index that differs between lanes
// would put the matrix in local memory.)
__device__ __forceinline__ float inverse_scale(const Mat& m, int d, int g,
                                               int t) {
  float sum = 0.0f;
  if (t == (g >> 1)) {
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* tile = m.b[b][b][h];
        const float v = g & 1 ? tile[2 * h + 1] : tile[2 * h];
        if (16 * b + 8 * h + g < d) sum += fabsf(v);
      }
  }
#pragma unroll
  for (int o = kLanes / 2; o > 0; o /= 2) sum += __shfl_xor_sync(kFull, sum, o);
  float scale = sum / static_cast<float>(d);
  scale = scale > 0.0f ? scale : 1.0f;
  return 1.0f / scale;
}

// In place: the inverse of the symmetric m (identity past d), scaled as
// sym_inv_scaled, by the Schur blocks at 16.  DP = 24: rows and columns
// 24-31 are padding (the second tile of B^T's rows and of D's columns is
// zero or the identity's), so the products skip those tiles and D's
// inverse its padded half.
template <int DP>
__device__ __forceinline__ void sym_inv_scaled(Mat& m, int d, int g, int t,
                                               int lane) {
  constexpr int P = DP == 32 ? 2 : 1;   // live tiles of the second block
  const float inv_s = inverse_scale(m, d, g, t);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
#pragma unroll
        for (int r = 0; r < 4; ++r) m.b[i][j][nj][r] *= inv_s;
  Blk& a = m.b[0][0];
  Blk& bu = m.b[0][1];
  Blk& bt = m.b[1][0];
  Blk& dd = m.b[1][1];
  inv16<false>(a, g, t, lane);                 // A^-1
  Blk x, z;
  blk_mul<false, false, P>(x, a, bt);          // X = A^-1 B
  blk_mul<false, false>(z, bt, a);             // Z = B^T A^-1
  blk_mul<true, true, P>(dd, z, bt);           // S = D - Z B
  inv16<DP != 32>(dd, g, t, lane);             // S^-1
  blk_mul<false, false, P, P>(bu, x, dd);      // Y = X S^-1
  blk_mul<true, false, 2, P>(a, bu, x);        // TL = A^-1 + Y X^T
#pragma unroll
  for (int nj = 0; nj < 2; ++nj)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      a[nj][r] *= inv_s;
      dd[nj][r] *= inv_s;
      bu[nj][r] *= -inv_s;
    }
  transpose<P>(bt, bu, g, t);                  // -Y^T, exactly
}

// Row 16 (t / 2) + 8 (t % 2) + g of m v (v: 32 floats, zero past d, so
// columns past DP are not read), the quad's partial sums joined by
// shuffles.
template <int DP>
__device__ __forceinline__ float mat_vec_row(const Mat& m, const float* v,
                                             int g, int t) {
  float s[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      if (16 * j + 8 * nj >= DP) continue;
      const float2 vv =
          *reinterpret_cast<const float2*>(v + 16 * j + 8 * nj + 2 * t);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          s[i][h] = fmaf(m.b[i][j][nj][2 * h], vv.x, s[i][h]);
          s[i][h] = fmaf(m.b[i][j][nj][2 * h + 1], vv.y, s[i][h]);
        }
    }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      s[i][h] += __shfl_xor_sync(kFull, s[i][h], 1);
      s[i][h] += __shfl_xor_sync(kFull, s[i][h], 2);
    }
  return t == 0 ? s[0][0] : t == 1 ? s[0][1] : t == 2 ? s[1][0] : s[1][1];
}

__host__ __device__ constexpr int smem_floats(int chains) {
  return 5 * kMat + chains * kVec;
}

// params: the (4, 32, s_in) F, F^T, Q, W of the sweep tiers, zero past d.
// DP: the state padded to 24 (d <= 24) or 32 for the products.
template <int DP>
__global__ void __launch_bounds__(kMaxChains * kLanes, kMinBlocks)
warp_filter_tc_kernel(const float* __restrict__ ys,
                      const float* __restrict__ m0,
                      const float* __restrict__ p0,
                      const float* __restrict__ hr_t,
                      const float* __restrict__ params,
                      float* __restrict__ means, float* __restrict__ mf,
                      float* __restrict__ pf, int64_t T, int64_t B, int d,
                      int dy, int s_in, int chains) {
  extern __shared__ __align__(16) float smem[];
  float* ft = smem;             // F^T, float32
  float* fh = smem + kMat;      // F's TF32 high part
  float* fl = smem + 2 * kMat;  // F's TF32 low part
  float* q = smem + 3 * kMat;   // Q, its padded diagonal 1
  float* w = smem + 4 * kMat;   // W
  const int wg = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int g = lane >> 2, t = lane & 3;
  const int64_t b_raw = static_cast<int64_t>(blockIdx.x) * chains + wg;
  const bool valid = b_raw < B;
  const int64_t b = valid ? b_raw : B - 1;
  const int mat_in = kDim * s_in;
  for (int i = threadIdx.x; i < kDim * kDim; i += blockDim.x) {
    const int r = i / kDim, c = i % kDim;
    const float fv = params[r * s_in + c];
    uint32_t hi, lo;
    split(fv, hi, lo);
    fh[r * kS + c] = __uint_as_float(hi);
    fl[r * kS + c] = __uint_as_float(lo);
    ft[r * kS + c] = params[mat_in + r * s_in + c];
    q[r * kS + c] = params[2 * mat_in + r * s_in + c] +
                    (r == c && r >= d ? 1.0f : 0.0f);
    w[r * kS + c] = params[3 * mat_in + r * s_in + c];
  }
  float* mv = smem + 5 * kMat + wg * kVec;
  float* mp = mv + kDim;
  float* hv = mp + kDim;
  float* y_s = hv + kDim;
  float* park = y_s + kYChunk;
  for (int i = lane; i < kVec; i += kLanes) mv[i] = 0.0f;
  __syncwarp();
  if (lane < d) mv[lane] = m0[lane * B + b];
  // the state handed in; identity past d
  Mat pm;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = 16 * i + g + 8 * (r >> 1);
          const int col = 16 * j + 8 * nj + 2 * t + (r & 1);
          pm.b[i][j][nj][r] =
              row < d && col < d
                  ? p0[(row <= col ? sym_slot(row, col, d)
                                   : sym_slot(col, row, d)) * B + b]
                  : (row == col ? 1.0f : 0.0f);
        }
  __syncthreads();  // the parameters and the vectors are in place
  const int d4 = (d + 3) & ~3;
  const int my_row = 16 * (t >> 1) + 8 * (t & 1) + g;

  for (int64_t step = 0; step < T; ++step) {
    const float* yt = ys + step * dy * B + b;
    float y_next = lane < dy ? yt[lane * B] : 0.0f;

    // m_pred = F m ; P_pred = (F P) F^T + Q ; L = P_pred^-1
    if (lane < d) mp[lane] = col_dot(ft, mv, d4, kS, lane);
    predict_cov<DP>(pm, fh, fl, q, park, g, t, lane);
    sym_inv_scaled<DP>(pm, d, g, t, lane);

    // xi_j = sum_k HR[j][k] y_t[k], k in order, a chunk at a time (into h)
    for (int c = 0; c < dy; c += kYChunk) {
      if (c > 0) y_next = c + lane < dy ? yt[(c + lane) * B] : 0.0f;
      __syncwarp();  // the chain is done with the last chunk
      y_s[lane] = y_next;
      __syncwarp();
      const int n = dy - c < kYChunk ? dy - c : kYChunk;
      if (lane < d) {
        const float* hr = hr_t + static_cast<int64_t>(c) * d + lane;
        float xi = c > 0 ? hv[lane] : 0.0f;
        for (int k = 0; k < n; ++k, hr += d)
          xi = c + k == 0 ? *hr * y_s[k] : fmaf(*hr, y_s[k], xi);
        hv[lane] = xi;
      }
    }
    __syncwarp();  // m_pred and xi are in place
    // h = L m_pred + xi (a row a lane) ; L + W
    const float h_row = mat_vec_row<DP>(pm, mp, g, t) + hv[my_row];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int nj = 0; nj < 2; ++nj)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 v = *reinterpret_cast<const float2*>(
                w + (16 * i + g + 8 * h) * kS + 16 * j + 8 * nj + 2 * t);
            pm.b[i][j][nj][2 * h] += v.x;
            pm.b[i][j][nj][2 * h + 1] += v.y;
          }
    __syncwarp();  // every lane has read its xi
    hv[my_row] = h_row;
    // P = (L + W)^-1, its lower triangle the mirror of its upper ; m = P h
    sym_inv_scaled<DP>(pm, d, g, t, lane);
    mirror_upper(pm.b[0][0], g, t);
    mirror_upper(pm.b[1][1], g, t);
    __syncwarp();  // h is in place
    const float m_row = mat_vec_row<DP>(pm, hv, g, t);
    mv[my_row] = m_row;
    if (valid && my_row < d) means[(step * d + my_row) * B + b] = m_row;
    __syncwarp();
  }

  if (valid) {
    if (lane < d) mf[lane * B + b] = mv[lane];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int nj = 0; nj < 2; ++nj)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int row = 16 * i + g + 8 * (r >> 1);
            const int col = 16 * j + 8 * nj + 2 * t + (r & 1);
            if (row <= col && col < d)
              pf[sym_slot(row, col, d) * B + b] = pm.b[i][j][nj][r];
          }
  }
}

// The state's padding for the products: 24 to d = 24, else 32.
constexpr int padded(int d) { return d <= 24 ? 24 : kDim; }

template <int DP>
int launch(const float* ys, const float* m0, const float* p0,
           const float* hr_t, const float* params, float* means, float* mf,
           float* pf, int64_t T, int64_t B, int d, int dy, int s_in,
           int chains, cudaStream_t stream) {
  const int bytes = 4 * smem_floats(chains);
  if (bytes > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        warp_filter_tc_kernel<DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const unsigned blocks = static_cast<unsigned>((B + chains - 1) / chains);
  warp_filter_tc_kernel<DP><<<blocks, chains * kLanes, bytes, stream>>>(
      ys, m0, p0, hr_t, params, means, mf, pf, T, B, d, dy, s_in, chains);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int blocks_per_sm(int chains) {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, warp_filter_tc_kernel<DP>, chains * kLanes,
          4 * smem_floats(chains)) != cudaSuccess)
    return -1;
  return n;
}

}  // namespace tc

// ---- The tensor-core tier past 32: 32 < d <= 64 ---------------------------
//
// The d <= 32 tier's arithmetic (3xTF32 products C = A N^T on operands in
// mma.sync's accumulator layout, the Schur recursion with Gauss-Jordan
// leaves of 8, P mirrored each step, the evidence formed here) carried to a
// state padded to DP = 16 NB: NB = 3 (DP = 48) to d = 48, NB = 4 (DP = 64)
// past it.
// * Where the matrices live.  At DP = 64 one chain's matrix is 16 KB: in
//   the accumulator layout a warp would hold 128 registers a lane for each
//   of the chain's two matrices, so they cannot stay in registers as at
//   d <= 32.  Two ways were open: (a) a warpgroup a chain, each warp a
//   16-row strip of each matrix in registers, or (b) both matrices in
//   shared memory, 16 x 16 blocks loaded into registers for each product.
//   (a) needs every product and every Schur level to trade strips between
//   the four warps through shared memory anyway, with a barrier at each of
//   them; (b) keeps the d <= 32 tier's warp-level primitives.  Shared
//   memory sets the occupancy under both: two matrices a chain (36 KB at
//   DP = 64) and F, Q, W a block (72 KB) let 4 chains share an SM at DP =
//   64 (8 at DP = 48).  This tier is (b).
// * Warps a chain (Dim::kWarps, a team): one at DP = 48 (8 warps an SM),
//   two at DP = 64, which split each step's block products (F P F^T + Q a
//   block row each in a snake order, the inverses' X, S, Y and TL a block
//   each) while the 32 x 32 inverses of A and S run on the first.  Every
//   chain of a block runs the same steps, so __syncthreads orders a team.
//   On an H100 80GB HBM3 at 700 W at (B, T, d, dy) = (2000, 200, 64, 64)
//   (scripts/warp_filter_variants.py): one warp a chain 48.5 ms, two 39.4,
//   four (128 registers, spilled) 40.8.  Of the two warps' 39.4 ms (each
//   part taken out in turn): F P F^T + Q 8.6, the 32 x 32 inverses 11.1,
//   the other Schur products 9.5, the rest (vectors, the scale and mirror
//   passes, 22 barriers a step) about 10; pivot-pair leaves were slower
//   (40.6).  Each warp runs one dependent chain of products and leaves,
//   two warps a scheduler: latency, not the tensor cores' rate, bounds it.
// * Rows sit DP + 8 floats apart (8 or 24 modulo the 32 banks): a quad's
//   float2 loads of rows g, columns 2t, 2t + 1 take 32 distinct banks a
//   half-warp, and a lane's column read of a row of 32 consecutive floats
//   none twice.  F (split once into its TF32 parts), Q (padded diagonal 1)
//   and W sit in shared memory once a block; a chain's P and a work matrix
//   W2 beside its vectors.
// * The step: m_pred = F m (a row a thread, the sum staggered so that the
//   lanes read distinct banks); P_pred = F P F^T + Q a 16-row block row at
//   a time (X_i = F_i P in registers, then the blocks (i, j <= i) of X_i
//   F^T + Q into W2): the inverse reads the lower blocks only.  Both
//   inverses are the plain version's Schur recursion split at 32
//   (sym_inv64): A^-1 by the d <= 32 tier's 32 x 32 inverse in registers
//   (split at 16, leaves of 8), X = A^-1 B and its transpose into the work
//   matrix, S = D - B^T X, S^-1 (32 x 32 in registers, or 16 x 16 at
//   DP = 48), Y = X S^-1, TL = A^-1 + Y X^T; the upper-right block -Y and
//   the lower-left its exact transpose (by shuffles), TL's upper-right
//   16 x 16 block the transpose of its lower-left, so that after the
//   diagonal blocks are mirrored (tc16.cuh mirror_upper) P is the symmetric
//   matrix of its upper triangle each step (ROADMAP C7).
// * Operations a step at DP = 64: 104 products of 16 x 16 x 16 for
//   F P F^T + Q, 38 for each inverse and 4 leaf-level 16 x 16 inverses
//   (each four 8 x 8 x 8 products and two leaves of 8 pivots): 2,256
//   mma.sync a step, three for each TF32 product.

namespace tc64 {

template <int NB>
struct Dim {
  static constexpr int kDP = 16 * NB;              // the padded state
  static constexpr int kS = kDP + 8;               // a matrix's row stride
  static constexpr int kMat = kDP * kS;
  static constexpr int kChains = NB == 4 ? 4 : 8;  // chains a block
  static constexpr int kWarps = NB == 4 ? 2 : 1;   // warps a chain
  // a chain's m, m_pred, h, each warp's observation chunk and partial sum
  static constexpr int kVec = 3 * kDP + kWarps * kYChunk + 4;
  // F's two TF32 parts, Q and W; each chain's P, work matrix and vectors
  static constexpr int kSmemFloats = 4 * kMat + kChains * (2 * kMat + kVec);
};

// In place: the inverse of the symmetric m (its lower blocks; identity
// past d), scaled as sym_inv_scaled, by the Schur blocks at 32, over the
// team's W warps: the 32 x 32 (or, at DP = 48, 16 x 16) inverses of A and
// of S on sub-warp 0, every block product on the sub-warp of its block.
// w is the chain's work matrix (X in its blocks (0..1, 0..NB-3), X^T in
// (2.., 0..1)).  Every block of the result is written.
template <int NB, int W>
__device__ __forceinline__ void sym_inv64(float* m, float* w, float* red,
                                          int d, const Team& tm) {
  constexpr int S = Dim<NB>::kS;
  constexpr int NR = NB - 2;  // blocks of D
  const int g = tm.g, t = tm.t;
  const float inv_s = inverse_scale<S, W>(m, red, d, tm);
#pragma unroll
  for (int n = 0; n < NB * (NB + 1) / 2; ++n) {
    if (n % W != tm.s) continue;
    int bi, bj;
    lower_block<NB>(n, bi, bj);
    Blk x;
    ld_blk<S>(x, m, bi, bj, g, t);
    blk_scale(x, inv_s);
    st_blk<S>(x, m, bi, bj, g, t);
  }
  __syncthreads();
  if (tm.s == 0) {  // A^-1
    Blk a, bt, dd, bu;
    ld_blk<S>(a, m, 0, 0, g, t);
    ld_blk<S>(bt, m, 1, 0, g, t);
    ld_blk<S>(dd, m, 1, 1, g, t);
    inv32(a, bt, dd, bu, g, t, tm.lane);
    st_blk<S>(a, m, 0, 0, g, t);
    st_blk<S>(bu, m, 0, 1, g, t);
    st_blk<S>(bt, m, 1, 0, g, t);
    st_blk<S>(dd, m, 1, 1, g, t);
  }
  __syncthreads();
  // X = A^-1 B (B^T is m's block row 2..), and X^T
#pragma unroll
  for (int n = 0; n < 2 * NR; ++n) {
    if (n % W != tm.s) continue;
    const int bi = n / NR, j = n % NR;
    Blk acc = {};
    blk_prod<S, 2, false>(acc, m, bi, 0, m, 2 + j, 0, g, t);
    Blk tr;
    tc::transpose(tr, acc, g, t);
    st_blk<S>(acc, w, bi, j, g, t);
    st_blk<S>(tr, w, 2 + j, bi, g, t);
  }
  __syncthreads();
  // S = D - B^T X, its lower blocks
#pragma unroll
  for (int n = 0; n < NR * (NR + 1) / 2; ++n) {
    if (n % W != tm.s) continue;
    int i, j;
    lower_block<NR>(n, i, j);
    Blk acc;
    ld_blk<S>(acc, m, 2 + i, 2 + j, g, t);
    blk_prod<S, 2, true>(acc, m, 2 + i, 0, w, 2 + j, 0, g, t);
    st_blk<S>(acc, m, 2 + i, 2 + j, g, t);
  }
  __syncthreads();
  if (tm.s == 0) {  // S^-1
    if constexpr (NR == 2) {
      Blk a, bt, dd, bu;
      ld_blk<S>(a, m, 2, 2, g, t);
      ld_blk<S>(bt, m, 3, 2, g, t);
      ld_blk<S>(dd, m, 3, 3, g, t);
      inv32(a, bt, dd, bu, g, t, tm.lane);
      st_blk<S>(a, m, 2, 2, g, t);
      st_blk<S>(bu, m, 2, 3, g, t);
      st_blk<S>(bt, m, 3, 2, g, t);
      st_blk<S>(dd, m, 3, 3, g, t);
    } else {
      Blk a;
      ld_blk<S>(a, m, 2, 2, g, t);
      tc::inv16<false>(a, g, t, tm.lane);
      st_blk<S>(a, m, 2, 2, g, t);
    }
  }
  __syncthreads();
  // Y = X S^-1: -Y upper right, -Y^T lower left
#pragma unroll
  for (int n = 0; n < 2 * NR; ++n) {
    if (n % W != tm.s) continue;
    const int bi = n / NR, j = n % NR;
    Blk acc = {};
    blk_prod<S, NR, true>(acc, w, bi, 0, m, 2 + j, 2, g, t);
    Blk tr;
    tc::transpose(tr, acc, g, t);
    st_blk<S>(acc, m, bi, 2 + j, g, t);
    st_blk<S>(tr, m, 2 + j, bi, g, t);
  }
  __syncthreads();
  // TL = A^-1 + Y X^T: its blocks (0, 0), (1, 0), (1, 1); (0, 1) the
  // transpose of (1, 0)
#pragma unroll
  for (int n = 0; n < 3; ++n) {
    if (n % W != tm.s) continue;
    int bi, bj;
    lower_block<2>(n, bi, bj);
    Blk acc;
    ld_blk<S>(acc, m, bi, bj, g, t);
    blk_prod<S, NR, true>(acc, m, bi, 2, w, bj, 0, g, t);  // -(-Y) X^T
    st_blk<S>(acc, m, bi, bj, g, t);
    if (bi != bj) {
      Blk tr;
      tc::transpose(tr, acc, g, t);
      st_blk<S>(tr, m, bj, bi, g, t);
    }
  }
  __syncthreads();
#pragma unroll
  for (int n = 0; n < NB * NB; ++n) {
    if (n % W != tm.s) continue;
    Blk x;
    ld_blk<S>(x, m, n / NB, n % NB, g, t);
    blk_scale(x, inv_s);
    st_blk<S>(x, m, n / NB, n % NB, g, t);
  }
  __syncthreads();
}

// Into w: the lower blocks (i, j <= i) of block row I of F P F^T + Q: X_I
// = F_I P (P symmetric, so its block (j, kb) is the N of block (kb, j)) in
// registers, then X_I F^T + Q.
template <int NB, int I>
__device__ __forceinline__ void predict_row(const float* p, float* w,
                                            const float* fh, const float* fl,
                                            const float* q, int g, int t) {
  constexpr int S = Dim<NB>::kS;
  float x[NB][2][4] = {};
  // one k block at a time: unrolled, the next blocks' loads were hoisted
  // past 255 registers (16 independent products a block are ILP enough)
#pragma unroll 1
  for (int kb = 0; kb < NB; ++kb) {
    Blk h, l;
    ld_blk<S>(h, fh, I, kb, g, t);
    ld_blk<S>(l, fl, I, kb, g, t);
    uint32_t ah[2][4], al[2][4];
    a_split(h, l, ah, al);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      Blk n;
      ld_blk<S>(n, p, j, kb, g, t);
      mul_acc(x[j], ah, al, n);
    }
  }
  float c[I + 1][2][4];
#pragma unroll
  for (int j = 0; j <= I; ++j) ld_blk<S>(c[j], q, I, j, g, t);
#pragma unroll
  for (int kb = 0; kb < NB; ++kb) {
    uint32_t ah[2][4], al[2][4];
    a_parts(x[kb], false, ah, al);
#pragma unroll
    for (int j = 0; j <= I; ++j) {
      Blk h, l;
      ld_blk<S>(h, fh, j, kb, g, t);
      ld_blk<S>(l, fl, j, kb, g, t);
      mul_acc_split(c[j], ah, al, h, l);
    }
  }
#pragma unroll
  for (int j = 0; j <= I; ++j) st_blk<S>(c[j], w, I, j, g, t);
}

// The block rows of F P F^T + Q over the team: row I to the sub-warp of
// the snake order 0, 1, .., W-1, W-1, .., 0, 0, 1, .. (row I has I + 1
// blocks of the second product, so the sub-warps' shares even out).
template <int NB, int W>
__device__ __forceinline__ void predict_cov(const float* p, float* w,
                                            const float* fh, const float* fl,
                                            const float* q, const Team& tm) {
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const int r = i % (2 * W);
    if ((r < W ? r : 2 * W - 1 - r) != tm.s) continue;
    switch (i) {
      case 0: predict_row<NB, 0>(p, w, fh, fl, q, tm.g, tm.t); break;
      case 1: predict_row<NB, 1>(p, w, fh, fl, q, tm.g, tm.t); break;
      case 2: predict_row<NB, 2>(p, w, fh, fl, q, tm.g, tm.t); break;
      default:
        if constexpr (NB > 3)
          predict_row<NB, (NB > 3 ? 3 : 0)>(p, w, fh, fl, q, tm.g, tm.t);
        break;
    }
  }
}

// Entry j of M v for the shared matrix M (symmetric: its column j read as
// row j, 32 neighbouring floats a warp) and the vector v, zero past d.
template <int NB>
__device__ __forceinline__ float col_vec(const float* m, const float* v,
                                         int j) {
  constexpr int S = Dim<NB>::kS;
  float acc = 0.0f;
#pragma unroll 8
  for (int k = 0; k < Dim<NB>::kDP; ++k) acc = fmaf(m[k * S + j], v[k], acc);
  return acc;
}

// params: the (4, DP, s_in) F, F^T, Q, W of the other tiers, zero past d.
template <int NB>
__global__ void __launch_bounds__(Dim<NB>::kChains * Dim<NB>::kWarps * kLanes,
                                  1)
warp_filter_tc64_kernel(const float* __restrict__ ys,
                        const float* __restrict__ m0,
                        const float* __restrict__ p0,
                        const float* __restrict__ hr_t,
                        const float* __restrict__ params,
                        float* __restrict__ means, float* __restrict__ mf,
                        float* __restrict__ pf, int64_t T, int64_t B, int d,
                        int dy, int s_in) {
  using D = Dim<NB>;
  constexpr int DP = D::kDP, S = D::kS, MAT = D::kMat, W = D::kWarps;
  constexpr int TEAM = W * kLanes;
  extern __shared__ __align__(16) float smem[];
  float* fh = smem;             // F's TF32 high part
  float* fl = smem + MAT;       // F's TF32 low part
  float* q = smem + 2 * MAT;    // Q, its padded diagonal 1
  float* w = smem + 3 * MAT;    // W
  const int wid = threadIdx.x / kLanes;
  const int chain = wid / W;
  Team tm;
  tm.s = wid % W;
  tm.lane = threadIdx.x % kLanes;
  tm.g = tm.lane >> 2;
  tm.t = tm.lane & 3;
  const int r0 = tm.s * kLanes + tm.lane;  // the thread's first row
  const int64_t b_raw = static_cast<int64_t>(blockIdx.x) * D::kChains + chain;
  const bool valid = b_raw < B;
  const int64_t b = valid ? b_raw : B - 1;
  const int mat_in = DP * s_in;
  for (int i = threadIdx.x; i < DP * S; i += blockDim.x) {
    const int r = i / S, c = i % S;
    const bool in = c < DP;
    const float fv = in ? params[r * s_in + c] : 0.0f;
    uint32_t hi, lo;
    tc::split(fv, hi, lo);
    fh[i] = __uint_as_float(hi);
    fl[i] = __uint_as_float(lo);
    q[i] = in ? params[2 * mat_in + r * s_in + c] +
                    (r == c && r >= d ? 1.0f : 0.0f)
              : 0.0f;
    w[i] = in ? params[3 * mat_in + r * s_in + c] : 0.0f;
  }
  float* pm = smem + 4 * MAT + chain * (2 * MAT + D::kVec);
  float* wk = pm + MAT;
  float* mv = wk + MAT;
  float* mp = mv + DP;
  float* hv = mp + DP;
  float* y_s = hv + DP + tm.s * kYChunk;  // each warp's observation chunk
  float* red = hv + DP + W * kYChunk;     // the warps' partial sums
  for (int i = r0; i < 2 * MAT + D::kVec; i += TEAM) pm[i] = 0.0f;
  __syncthreads();
  // the state handed in; identity past d
  for (int j = r0; j < DP; j += TEAM) {
    if (j < d) {
      mv[j] = m0[j * B + b];
      for (int i = 0; i <= j; ++i) {
        const float v = p0[sym_slot(i, j, d) * B + b];
        pm[i * S + j] = v;
        pm[j * S + i] = v;
      }
    } else {
      pm[j * S + j] = 1.0f;
    }
  }
  __syncthreads();  // the parameters and the state are in place

  for (int64_t step = 0; step < T; ++step) {
    const float* yt = ys + step * dy * B + b;
    float y_next = tm.lane < dy ? yt[tm.lane * B] : 0.0f;

    // m_pred = F m (F = its high part + its low part exactly), row j
    // summed from column j on, so that the lanes read distinct banks
    for (int j = r0; j < DP; j += TEAM) {
      float acc = 0.0f;
      for (int kk = 0; kk < DP; ++kk) {
        const int k = j + kk < DP ? j + kk : j + kk - DP;
        acc = fmaf(fh[j * S + k] + fl[j * S + k], mv[k], acc);
      }
      mp[j] = acc;
    }
    // P_pred = F P F^T + Q into the work matrix ; L = P_pred^-1
    predict_cov<NB, W>(pm, wk, fh, fl, q, tm);
    __syncthreads();
    sym_inv64<NB, W>(wk, pm, red, d, tm);

    // xi_j = sum_k HR[j][k] y_t[k], k in order, a chunk at a time (into h;
    // each warp stages the chunk for its own rows)
    for (int c = 0; c < dy; c += kYChunk) {
      if (c > 0) y_next = c + tm.lane < dy ? yt[(c + tm.lane) * B] : 0.0f;
      __syncwarp();  // the warp is done with the last chunk
      y_s[tm.lane] = y_next;
      __syncwarp();
      const int n = dy - c < kYChunk ? dy - c : kYChunk;
      for (int j = r0; j < d; j += TEAM) {
        const float* hr = hr_t + static_cast<int64_t>(c) * d + j;
        float xi = c > 0 ? hv[j] : 0.0f;
        for (int k = 0; k < n; ++k, hr += d)
          xi = c + k == 0 ? *hr * y_s[k] : fmaf(*hr, y_s[k], xi);
        hv[j] = xi;
      }
    }
    // h = L m_pred + xi (each thread its own entries; zero past d)
    for (int j = r0; j < d; j += TEAM)
      hv[j] = col_vec<NB>(wk, mp, j) + hv[j];
    // L + W, its lower blocks, into P's matrix ; P = (L + W)^-1
#pragma unroll
    for (int n = 0; n < NB * (NB + 1) / 2; ++n) {
      if (n % W != tm.s) continue;
      int bi, bj;
      lower_block<NB>(n, bi, bj);
      Blk x, o;
      ld_blk<S>(x, wk, bi, bj, tm.g, tm.t);
      ld_blk<S>(o, w, bi, bj, tm.g, tm.t);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
#pragma unroll
        for (int r = 0; r < 4; ++r) x[nj][r] += o[nj][r];
      st_blk<S>(x, pm, bi, bj, tm.g, tm.t);
    }
    __syncthreads();
    sym_inv64<NB, W>(pm, wk, red, d, tm);
    // P's diagonal blocks: the lower triangle the mirror of the upper
#pragma unroll
    for (int bi = 0; bi < NB; ++bi) {
      if (bi % W != tm.s) continue;
      Blk x;
      ld_blk<S>(x, pm, bi, bi, tm.g, tm.t);
      tc::mirror_upper(x, tm.g, tm.t);
      st_blk<S>(x, pm, bi, bi, tm.g, tm.t);
    }
    __syncthreads();
    // m = P h
    for (int j = r0; j < d; j += TEAM) {
      const float m = col_vec<NB>(pm, hv, j);
      mv[j] = m;
      if (valid) means[(step * d + j) * B + b] = m;
    }
    __syncthreads();
  }

  if (valid) {
    for (int j = r0; j < d; j += TEAM) {
      mf[j * B + b] = mv[j];
      for (int i = 0; i <= j; ++i) pf[sym_slot(i, j, d) * B + b] = pm[i * S + j];
    }
  }
}

// The state's padding: 48 to d = 48, else 64.
constexpr int blocks(int d) { return d <= 48 ? 3 : 4; }

template <int NB>
int launch(const float* ys, const float* m0, const float* p0,
           const float* hr_t, const float* params, float* means, float* mf,
           float* pf, int64_t T, int64_t B, int d, int dy, int s_in,
           cudaStream_t stream) {
  const int bytes = 4 * Dim<NB>::kSmemFloats;
  const cudaError_t rc = cudaFuncSetAttribute(
      warp_filter_tc64_kernel<NB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int chains = Dim<NB>::kChains;
  const unsigned grid = static_cast<unsigned>((B + chains - 1) / chains);
  const unsigned threads = chains * Dim<NB>::kWarps * kLanes;
  warp_filter_tc64_kernel<NB><<<grid, threads, bytes, stream>>>(
      ys, m0, p0, hr_t, params, means, mf, pf, T, B, d, dy, s_in);
  return static_cast<int>(cudaGetLastError());
}

template <int NB>
int blocks_per_sm() {
  int n = 0;
  if (cudaFuncSetAttribute(warp_filter_tc64_kernel<NB>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           4 * Dim<NB>::kSmemFloats) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, warp_filter_tc64_kernel<NB>,
          Dim<NB>::kChains * Dim<NB>::kWarps * kLanes,
          4 * Dim<NB>::kSmemFloats) != cudaSuccess)
    return -1;
  return n;
}

}  // namespace tc64

int64_t smem_bytes(int dp, int s, int chains, bool params_shared,
                   bool chain_shared) {
  const int64_t mat = static_cast<int64_t>(dp) * s;
  return 4 * ((params_shared ? 4 * mat : 0) +
              chains * (vec_floats(dp) + (chain_shared ? 2 * mat : 0)));
}

int smem_optin() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return bytes;
}

template <bool PS, bool CS>
int launch(const float* ys, const float* m0, const float* p0,
           const float* hr_t, const float* params, float* means, float* mf,
           float* pf, float* scratch, int64_t T, int64_t B, int d, int dy,
           int dp, int s, int chains, int64_t bytes, cudaStream_t stream) {
  if (bytes > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        warp_filter_kernel<PS, CS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const unsigned blocks = static_cast<unsigned>((B + chains - 1) / chains);
  warp_filter_kernel<PS, CS><<<blocks, chains * kLanes, bytes, stream>>>(
      ys, m0, p0, hr_t, params, means, mf, pf, scratch, T, B, d, dy, dp, s,
      chains);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared bytes a block of `chains` chains takes with the given placement
// (ops/fused_filter.py warp_plan computes the same).
int64_t rxt_warp_filter_smem_bytes(int dp, int s, int chains,
                                   int params_shared, int chain_shared) {
  return smem_bytes(dp, s, chains, params_shared != 0, chain_shared != 0);
}

// The current device's opt-in limit of shared bytes a block.
int rxt_warp_filter_smem_optin() { return smem_optin(); }

// Returns the CUDA error of the launch (0 = success).  d >= 1, dy >= 1;
// params the device (4, dp, s) F, F^T, Q, W, zero past d; hr_t the device
// (dy, d) HR^T, row-major; scratch, when the chain matrices are not shared,
// a device buffer of ceil(B / chains) * chains * 2 * dp * s floats; the
// rest device pointers.  dp a multiple of 8 >= d, s a multiple of 4 > dp.
int rxt_warp_filter(int d, int dy, const float* ys, const float* m0,
                    const float* p0, const float* hr_t, const float* params,
                    float* means, float* mf, float* pf, float* scratch,
                    int64_t T, int64_t B, int dp, int s, int chains,
                    int params_shared, int chain_shared, void* stream) {
  if (d < 1 || dy < 1 || T < 1 || B < 1 || dp < d || dp % 8 != 0 ||
      s % 4 != 0 || s <= dp || chains < 1 || chains > kMaxChains ||
      (params_shared && !chain_shared) || (!chain_shared && !scratch))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t bytes =
      smem_bytes(dp, s, chains, params_shared != 0, chain_shared != 0);
  if (bytes > smem_optin()) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (params_shared)
    return launch<true, true>(ys, m0, p0, hr_t, params, means, mf, pf,
                              scratch, T, B, d, dy, dp, s, chains, bytes, st);
  if (chain_shared)
    return launch<false, true>(ys, m0, p0, hr_t, params, means, mf, pf,
                               scratch, T, B, d, dy, dp, s, chains, bytes,
                               st);
  return launch<false, false>(ys, m0, p0, hr_t, params, means, mf, pf,
                              scratch, T, B, d, dy, dp, s, chains, bytes, st);
}

// The tensor-core tier (16 < d <= 32 on the plan; it takes any d <= 32):
// its shared bytes for `chains` chains a block, and its launch.  params is
// the sweep tiers' device (4, 32, s_in) F, F^T, Q, W, zero past d.
int64_t rxt_warp_filter_tc_smem_bytes(int chains) {
  return 4 * static_cast<int64_t>(tc::smem_floats(chains));
}

// Blocks of `chains` chains an SM holds at state dim d (registers, shared
// memory), or -1.
int rxt_warp_filter_tc_blocks_per_sm(int d, int chains) {
  return tc::padded(d) == 24 ? tc::blocks_per_sm<24>(chains)
                             : tc::blocks_per_sm<tc::kDim>(chains);
}

int rxt_warp_filter_tc(int d, int dy, const float* ys, const float* m0,
                       const float* p0, const float* hr_t,
                       const float* params, float* means, float* mf,
                       float* pf, int64_t T, int64_t B, int s_in, int chains,
                       void* stream) {
  if (d < 1 || d > tc::kDim || dy < 1 || T < 1 || B < 1 ||
      s_in < tc::kDim || s_in % 4 != 0 || chains < 1 || chains > kMaxChains)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tc::padded(d) == 24)
    return tc::launch<24>(ys, m0, p0, hr_t, params, means, mf, pf, T, B, d,
                          dy, s_in, chains, st);
  return tc::launch<tc::kDim>(ys, m0, p0, hr_t, params, means, mf, pf, T, B,
                              d, dy, s_in, chains, st);
}

// The tensor-core tier past 32 (32 < d <= 64, the state padded to 48 to
// d = 48, else 64): a block's shared bytes (ops/fused_filter.py tc64_plan
// computes the same), the blocks an SM holds (or -1), and its launch.
// params is the other tiers' device (4, DP, s_in) F, F^T, Q, W, zero past
// d.
int64_t rxt_warp_filter_tc64_smem_bytes(int d) {
  return 4 * static_cast<int64_t>(tc64::blocks(d) == 3
                                      ? tc64::Dim<3>::kSmemFloats
                                      : tc64::Dim<4>::kSmemFloats);
}

int rxt_warp_filter_tc64_blocks_per_sm(int d) {
  return tc64::blocks(d) == 3 ? tc64::blocks_per_sm<3>()
                              : tc64::blocks_per_sm<4>();
}

int rxt_warp_filter_tc64(int d, int dy, const float* ys, const float* m0,
                         const float* p0, const float* hr_t,
                         const float* params, float* means, float* mf,
                         float* pf, int64_t T, int64_t B, int s_in,
                         void* stream) {
  const int nb = tc64::blocks(d);
  if (d <= tc::kDim || d > 64 || dy < 1 || T < 1 || B < 1 ||
      s_in < 16 * nb || s_in % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nb == 3)
    return tc64::launch<3>(ys, m0, p0, hr_t, params, means, mf, pf, T, B, d,
                           dy, s_in, st);
  return tc64::launch<4>(ys, m0, p0, hr_t, params, means, mf, pf, T, B, d,
                         dy, s_in, st);
}

const char* rxt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

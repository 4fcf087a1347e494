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
// Why another design: one thread a chain keeps d + d(d+1)/2 state floats
// and the inverses' temporaries in registers; at d = 8 that already takes
// 255 registers and spills, and at d = 16 the state alone is 152 floats.
// Here a chain is a group of 16 lanes, two chains a warp: lane r holds row
// r of every matrix of the step (P, P_pred, the inverses, the gain) in 16
// registers, and the state is padded to 16 (F, b and W with zeros, Q and
// P with the identity, so the padding stays an exact identity block and
// rows >= d do no harm); d is a runtime argument.  Products take the other
// factor's rows from shared memory as 16-byte broadcast loads (rows of 20
// floats, so a lane's row store is free of bank conflicts); symmetric
// results are mirrored from their upper triangle through shared memory,
// as the plain version aliases them; inverses are an unpivoted Gauss-Jordan
// sweep on the matrix scaled by its mean |diagonal| (sym_inv_scaled's
// scaling), the pivot row broadcast by shuffles.  F sits in the block's
// shared memory, each chain's Q and W rows (shared or its own, V1) in the
// chain's: rows read once a step cost no registers, which the products'
// 16-float rows need (ptxas, sm_90a).  The JAX kernel and the
// plain version invert by a Schur recursion split at d / 2: the same
// inverse in exact arithmetic, so the two differ in rounding only.
//
// What bounds it: the latency of a step.  A step is a dependent chain of
// 16 x 16 row products (two forward, seven backward), shared-memory
// mirrors and 16-pivot sweeps (two forward, one backward), and B = 1024
// chains are 512 warps, about one a warp scheduler, so nothing hides that
// chain.  By the work alone K1 at (B, T, d) = (1024, 2048, 16) needs
// 0.71 ms at the card's float32 rate (by bytes 1.41 GB, 0.42 ms) and K2
// 1.69 ms (4.70 GB, 1.40 ms).  One time block, no fold or carry (the JAX
// tier's chunk = 1).  Per-chain W / Q (V1) are read once, each lane its
// row, at entry; the moments' storage type M is float or bf16 (V2, as in
// fused_smoother.cu).  A chain index past B runs on the last chain's
// inputs and stores nothing, so every lane reaches every shuffle and
// __syncwarp.  The row algebra (products, mirrors, the inverse, the padded
// tile rows) sits in wide_rows.cuh, shared with fused_filter_wide.cu.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "smallmat.cuh"
#include "wide_rows.cuh"

namespace {

using rxt::moment_in;
using rxt::moment_out;

constexpr int kChains = 8;              // chains a block: 4 warps
constexpr int kThreads = kChains * kW;

// The shared parameters padded to 16: F, b, W with zeros, Q with the
// identity on the padded diagonal.  Read in place (__grid_constant__).
struct WideParams {
  float F[kW * kW];
  float b[kW];
  float Q[kW * kW];
  float W[kW * kW];
};

// ---- K1: forward filter -------------------------------------------------------

template <typename M>
__global__ void __launch_bounds__(kThreads)
wide_fwd_kernel(const float* __restrict__ xi, const float* __restrict__ m0,
                const float* __restrict__ p0, float* __restrict__ mf,
                M* __restrict__ pf, int64_t T, int64_t B, int d,
                const __grid_constant__ WideParams prm,
                const float* __restrict__ wdyn,
                const float* __restrict__ qdyn) {
  __shared__ __align__(16) float f_s[kMat];
  // per chain: P's rows, a staging matrix, Q's and W's rows, two vectors
  // (+16 floats so the two chains of a warp sit 16 banks apart)
  constexpr int kChainFloats = 4 * kMat + 2 * kW + 16;
  __shared__ __align__(16) float chain_s[kChains * kChainFloats];

  const int g = threadIdx.x / kW;            // chain within the block
  const int r = threadIdx.x % kW;            // this lane's row
  const int64_t b_raw = static_cast<int64_t>(blockIdx.x) * kChains + g;
  const bool valid = b_raw < B;
  const int64_t b = valid ? b_raw : B - 1;
  float* p_s = chain_s + g * kChainFloats;
  float* x_s = p_s + kMat;
  float* q_s = x_s + kMat;
  float* w_s = q_s + kMat;
  float* v0 = w_s + kMat;
  float* v1 = v0 + kW;

  for (int i = threadIdx.x; i < kW * kW; i += kThreads)
    f_s[(i / kW) * kStride + i % kW] = prm.F[i];
  {
    // this chain's Q and W (the shared ones, or its rows of the tiles),
    // kept in shared memory: rows are read once a step, registers are
    // the scarce resource
    float row[kW];
    if (qdyn) {
      tile_row(qdyn, b, B, r, d, true, row);
    } else {
#pragma unroll
      for (int j = 0; j < kW; ++j) row[j] = prm.Q[r * kW + j];
    }
    store_row(q_s, r, row);
    if (wdyn) {
      tile_row(wdyn, b, B, r, d, false, row);
    } else {
#pragma unroll
      for (int j = 0; j < kW; ++j) row[j] = prm.W[r * kW + j];
    }
    store_row(w_s, r, row);
  }
  const float b_r = prm.b[r];
  const int nsym = d * (d + 1) / 2;
  const int slot0 = r < d ? sym_slot(r, r, d) - r : 0;   // slot of (r, j): + j

  // the prior, upper triangle mirrored; the padding an identity block
  float m = r < d ? m0[b * d + r] : 0.0f;
  float p_row[kW];
#pragma unroll
  for (int j = 0; j < kW; ++j) {
    if (r < d && j < d)
      p_row[j] = r <= j ? p0[(b * d + r) * d + j] : p0[(b * d + j) * d + r];
    else
      p_row[j] = j == r ? 1.0f : 0.0f;
  }
  __syncthreads();

  float x_cur = r < d ? xi[b * d + r] : 0.0f;
  for (int64_t t = 0; t < T; ++t) {
    float x_next = 0.0f;
    if (t + 1 < T && r < d) x_next = xi[((t + 1) * B + b) * d + r];
    float m_pred, pp[kW];
    if (t == 0) {
      m_pred = m;
#pragma unroll
      for (int j = 0; j < kW; ++j) pp[j] = p_row[j];
    } else {
      // v0 holds m, p_s P's rows (stored at the end of the last step)
      float fp[kW], row[kW];
      load_row(f_s, r, row);
      m_pred = row_dot(row, v0) + b_r;
      row_mul(row, p_s, fp);                     // (F P)[r]
      row_mul_t(fp, f_s, pp);                    // (F P F^T)[r]
      load_row(q_s, r, row);
#pragma unroll
      for (int j = 0; j < kW; ++j) pp[j] += row[j];
      mirror_upper(pp, x_s, r);
    }
    float lam[kW];
    sym_inv_scaled_rows(pp, lam, r, d);
    mirror_upper(lam, x_s, r);
    float w_post[kW];
    load_row(w_s, r, w_post);
#pragma unroll
    for (int j = 0; j < kW; ++j) w_post[j] += lam[j];
    sym_inv_scaled_rows(w_post, p_row, r, d);
    mirror_upper(p_row, x_s, r);
    // h = L m_pred + xi_t ; m = P h
    v1[r] = m_pred;
    __syncwarp();
    const float h = row_dot(lam, v1) + x_cur;
    v0[r] = h;
    __syncwarp();
    m = row_dot(p_row, v0);
    __syncwarp();
    v0[r] = m;
    store_row(p_s, r, p_row);
    __syncwarp();
    if (valid && r < d) {
      mf[(t * d + r) * B + b] = m;
      M* dst = pf + t * nsym * B + b;
#pragma unroll
      for (int j = 0; j < kW; ++j)
        if (j >= r && j < d) dst[(slot0 + j) * B] = moment_out<M>(p_row[j]);
    }
    x_cur = x_next;
  }
}

// ---- K2: backward RTS pass ------------------------------------------------------

template <typename M>
__device__ __forceinline__ void load_pf_row(const M* __restrict__ pf_t,
                                            int64_t b, int64_t B, int r,
                                            int d, float (&row)[kW]) {
#pragma unroll
  for (int j = 0; j < kW; ++j) {
    if (r < d && j < d) {
      const int k = r <= j ? sym_slot(r, j, d) : sym_slot(j, r, d);
      row[j] = moment_in(pf_t[static_cast<int64_t>(k) * B + b]);
    } else {
      row[j] = j == r ? 1.0f : 0.0f;
    }
  }
}

template <typename M>
__global__ void __launch_bounds__(kThreads)
wide_bwd_kernel(const float* __restrict__ mf, const M* __restrict__ pf,
                float* __restrict__ ms, M* __restrict__ ps,
                M* __restrict__ cross, int64_t T, int64_t B, int d,
                const __grid_constant__ WideParams prm,
                const float* __restrict__ qdyn) {
  __shared__ __align__(16) float f_s[kMat];
  // per chain: P_f's rows, P_s's rows, a staging matrix, Q's rows, two
  // vectors
  constexpr int kChainFloats = 4 * kMat + 2 * kW + 16;
  __shared__ __align__(16) float chain_s[kChains * kChainFloats];

  const int g = threadIdx.x / kW;
  const int r = threadIdx.x % kW;
  const int64_t b_raw = static_cast<int64_t>(blockIdx.x) * kChains + g;
  const bool valid = b_raw < B;
  const int64_t b = valid ? b_raw : B - 1;
  float* pf_s = chain_s + g * kChainFloats;
  float* ps_s = pf_s + kMat;
  float* x_s = ps_s + kMat;
  float* q_s = x_s + kMat;
  float* v0 = q_s + kMat;
  float* v1 = v0 + kW;

  for (int i = threadIdx.x; i < kW * kW; i += kThreads)
    f_s[(i / kW) * kStride + i % kW] = prm.F[i];
  {
    float row[kW];
    if (qdyn) {
      tile_row(qdyn, b, B, r, d, true, row);
    } else {
#pragma unroll
      for (int j = 0; j < kW; ++j) row[j] = prm.Q[r * kW + j];
    }
    store_row(q_s, r, row);
  }
  const float b_r = prm.b[r];
  const int nsym = d * (d + 1) / 2;
  const int slot0 = r < d ? sym_slot(r, r, d) - r : 0;

  // step T - 1: smoothed == filtered (the stored moments, rounded as stored)
  float m_s = r < d ? mf[((T - 1) * d + r) * B + b] : 0.0f;
  float s_row[kW];
  load_pf_row(pf + (T - 1) * nsym * B, b, B, r, d, s_row);
  if (valid && r < d) {
    ms[((T - 1) * d + r) * B + b] = m_s;
    M* dst = ps + (T - 1) * nsym * B + b;
#pragma unroll
    for (int j = 0; j < kW; ++j)
      if (j >= r && j < d) dst[(slot0 + j) * B] = moment_out<M>(s_row[j]);
  }
  store_row(ps_s, r, s_row);
  __syncthreads();
  if (T < 2) return;

  float m_cur = r < d ? mf[((T - 2) * d + r) * B + b] : 0.0f;
  float f_cur[kW];
  load_pf_row(pf + (T - 2) * nsym * B, b, B, r, d, f_cur);
  for (int64_t t = T - 2; t >= 0; --t) {
    float m_next = 0.0f, f_next[kW] = {};
    if (t > 0) {
      if (r < d) m_next = mf[((t - 1) * d + r) * B + b];
      load_pf_row(pf + (t - 1) * nsym * B, b, B, r, d, f_next);
    }
    store_row(pf_s, r, f_cur);
    v0[r] = m_cur;
    __syncwarp();
    // P_pred = F P_f F^T + Q ; P_f F^T
    float fp[kW], pp[kW], pft[kW], row[kW];
    load_row(f_s, r, row);
    const float fm = row_dot(row, v0);           // (F m_f)[r]
    row_mul(row, pf_s, fp);
    row_mul_t(fp, f_s, pp);
    load_row(q_s, r, row);
#pragma unroll
    for (int j = 0; j < kW; ++j) pp[j] += row[j];
    mirror_upper(pp, x_s, r);
    row_mul_t(f_cur, f_s, pft);
    // G = P_f F^T P_pred^-1
    float pinv[kW];
    sym_inv_scaled_rows(pp, pinv, r, d);
    mirror_upper(pinv, x_s, r);
    __syncwarp();
    store_row(x_s, r, pinv);
    __syncwarp();
    float gain[kW];
    row_mul(pft, x_s, gain);
    // m_s = m_f + G (m_s' - F m_f - b)
    const float diff = m_s - (fm + b_r);
    float dmat[kW];
#pragma unroll
    for (int j = 0; j < kW; ++j) dmat[j] = s_row[j] - pp[j];
    __syncwarp();
    v1[r] = diff;
    store_row(x_s, r, dmat);
    __syncwarp();
    const float m_new = m_cur + row_dot(gain, v1);
    float gd[kW];
    row_mul(gain, x_s, gd);                    // G (P_s' - P_pred)
    __syncwarp();
    store_row(x_s, r, gain);
    __syncwarp();
    float s_new[kW];
    row_mul_t(gd, x_s, s_new);                 // G (P_s' - P_pred) G^T
#pragma unroll
    for (int j = 0; j < kW; ++j) s_new[j] += f_cur[j];
    {
      // the cross last, stored at once: fewer rows live at a time
      float cr[kW];
      row_mul(gain, ps_s, cr);                 // G P_s' = Cov(x_t, x_t+1)
      if (valid && r < d) {
        M* cdst = cross + t * (d * d) * B + b;
#pragma unroll
        for (int j = 0; j < kW; ++j)
          if (j < d) cdst[(r * d + j) * B] = moment_out<M>(cr[j]);
      }
    }
    mirror_upper(s_new, x_s, r);
    if (valid && r < d) {
      ms[(t * d + r) * B + b] = m_new;
      M* dst = ps + t * nsym * B + b;
#pragma unroll
      for (int j = 0; j < kW; ++j)
        if (j >= r && j < d) dst[(slot0 + j) * B] = moment_out<M>(s_new[j]);
    }
    m_s = m_new;
#pragma unroll
    for (int j = 0; j < kW; ++j) {
      s_row[j] = s_new[j];
      f_cur[j] = f_next[j];
    }
    m_cur = m_next;
    __syncwarp();
    store_row(ps_s, r, s_row);
    __syncwarp();
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

inline unsigned chain_blocks(int64_t B) {
  return static_cast<unsigned>((B + kChains - 1) / kChains);
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
    wide_fwd_kernel<__nv_bfloat16><<<chain_blocks(B), kThreads, 0, s>>>(
        xi, m0, p0, mf, static_cast<__nv_bfloat16*>(pf), T, B, d, prm, wdyn,
        qdyn);
  else
    wide_fwd_kernel<float><<<chain_blocks(B), kThreads, 0, s>>>(
        xi, m0, p0, mf, static_cast<float*>(pf), T, B, d, prm, wdyn, qdyn);
  return static_cast<int>(cudaGetLastError());
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
    wide_bwd_kernel<__nv_bfloat16><<<chain_blocks(B), kThreads, 0, s>>>(
        mf, static_cast<const __nv_bfloat16*>(pf), ms,
        static_cast<__nv_bfloat16*>(ps), static_cast<__nv_bfloat16*>(cross),
        T, B, d, prm, qdyn);
  else
    wide_bwd_kernel<float><<<chain_blocks(B), kThreads, 0, s>>>(
        mf, static_cast<const float*>(pf), ms, static_cast<float*>(ps),
        static_cast<float*>(cross), T, B, d, prm, qdyn);
  return static_cast<int>(cudaGetLastError());
}

// The widest state the kernels take (the padded dim).
int rxt_wide_smoother_max_dim() { return kW; }

const char* rxt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Fused streaming Kalman filter for state dims up to 16 at any observation
// dim on Hopper (sm_90a): K3 for the (d, dy) that the register kernel of
// fused_filter.cu (d, dy = 1..8) does not take.
//
// Replaces the TPU kernel `_filter_kernel` of
// rxinfer_tpu/ops/pallas_filter.py (lines 84-144), which unrolls any d and
// dy.  Same math, order and layouts as fused_filter.cu and the plain
// version (ops/fused_filter.py `filter_step`):
//   xi = HR y_t                                   HR = H^T R^-1, (d, dy)
//   m_pred = F m ; P_pred = F P F^T + Q
//   L = P_pred^-1 ; P = (L + W)^-1 ; m = P (L m_pred + xi)
// with the transition applied at EVERY step, t = 0 included, and no bias.
// ys (T, dy, B), m0 (d, B), p0 (nsym, B) upper triangle row by row; out
// means (T, d, B), mf (d, B), pf (nsym, B).
//
// Design: the wide K1's former step (fused_smoother_wide.cu, before it
// moved to the tensor cores) through the row algebra of wide_rows.cuh: a
// chain is a group of 16 lanes, two chains a warp, lane r holds row r of
// every matrix of the step, the state padded to 16 with an exact identity
// block (F and W padded with zeros, Q and P with the identity), so one
// kernel serves every d <= 16; products
// against rows broadcast from shared memory, mirrors of upper triangles
// through shared memory, scaled Gauss-Jordan inverses with the pivot row
// shuffled.  The plain version inverts by a Schur recursion, so the two
// differ in rounding only.  F, Q and W, shared by every chain, sit in the
// block's shared memory.  The evidence is formed here: lane r sums
// xi_r = HR[r][0] y[0] + HR[r][1] y[1] + ... in k order (ew.mat_vec's),
// reading HR's row r as column r of HR^T (dy, d) from device memory
// through L1 (lanes on neighbouring addresses), and the step's observations
// from the chain's shared memory, staged kYChunk at a time: dy has no cap.
// The first chunk is loaded at the step's start and lands while the step's
// inverses run.
//
// What bounds it: the latency of a step, as for the former wide K1 (a
// dependent chain of row products, mirrors and two 16-pivot sweeps).  At path A's
// (B, T, d, dy) = (10,000, 200, 16, 16) the bytes are 0.27 GB (ys in, means
// out), 0.08 ms at the HBM rate, and the operations of the plain step
// (4.6e10, counted on stand-ins) 0.69 ms at the float32 rate, which bound it
// on paper; 5,000 warps of two chains keep every scheduler about nine warps
// deep, so there the issue rate and not one warp's latency is the limit.
// A chain index past B runs on the last chain's inputs and stores nothing,
// so every lane reaches every shuffle and __syncwarp.  (d <= 8 with dy > 8
// runs here too, doing the padded 16-wide work.)

#include <cuda_runtime.h>

#include <stdint.h>

#include "wide_rows.cuh"

namespace {

constexpr int kChains = 8;  // chains a block: 4 warps
constexpr int kThreads = kChains * kW;
constexpr int kYChunk = 2 * kW;  // observations staged at a time

// F, Q and W padded to 16: F and W with zeros, Q with the identity on the
// padded diagonal.  Read in place (__grid_constant__).
struct FilterParams {
  float F[kW * kW];
  float Q[kW * kW];
  float W[kW * kW];
};

__global__ void __launch_bounds__(kThreads)
wide_filter_kernel(const float* __restrict__ ys, const float* __restrict__ m0,
                   const float* __restrict__ p0,
                   const float* __restrict__ hr_t, float* __restrict__ means,
                   float* __restrict__ mf, float* __restrict__ pf, int64_t T,
                   int64_t B, int d, int dy,
                   const __grid_constant__ FilterParams prm) {
  __shared__ __align__(16) float f_s[kMat];
  __shared__ __align__(16) float q_s[kMat];
  __shared__ __align__(16) float w_s[kMat];
  // per chain: P's rows, a staging matrix, two vectors, an observation chunk
  // (+16 floats so the two chains of a warp sit 16 banks apart)
  constexpr int kChainFloats = 2 * kMat + 2 * kW + kYChunk + 16;
  __shared__ __align__(16) float chain_s[kChains * kChainFloats];

  const int g = threadIdx.x / kW;  // chain within the block
  const int r = threadIdx.x % kW;  // this lane's row
  const int64_t b_raw = static_cast<int64_t>(blockIdx.x) * kChains + g;
  const bool valid = b_raw < B;
  const int64_t b = valid ? b_raw : B - 1;
  float* p_s = chain_s + g * kChainFloats;
  float* x_s = p_s + kMat;
  float* v0 = x_s + kMat;
  float* v1 = v0 + kW;
  float* y_s = v1 + kW;

  for (int i = threadIdx.x; i < kW * kW; i += kThreads) {
    const int at = (i / kW) * kStride + i % kW;
    f_s[at] = prm.F[i];
    q_s[at] = prm.Q[i];
    w_s[at] = prm.W[i];
  }
  const int slot0 = r < d ? sym_slot(r, r, d) - r : 0;  // slot of (r, j): + j

  // the state handed in: the posterior of the step before the stream
  float m = r < d ? m0[r * B + b] : 0.0f;
  float p_row[kW];
  tile_row(p0, b, B, r, d, true, p_row);
  v0[r] = m;
  store_row(p_s, r, p_row);
  __syncthreads();

  for (int64_t t = 0; t < T; ++t) {
    // observations r and r + 16 of the first chunk, used after the inverses
    const float* yt = ys + t * dy * B + b;
    float y_lo = r < dy ? yt[r * B] : 0.0f;
    float y_hi = r + kW < dy ? yt[(r + kW) * B] : 0.0f;

    // m_pred = F m ; P_pred = F P F^T + Q (v0 holds m, p_s P's rows)
    float fp[kW], pp[kW], row[kW];
    load_row(f_s, r, row);
    const float m_pred = row_dot(row, v0);
    row_mul(row, p_s, fp);                       // (F P)[r]
    row_mul_t(fp, f_s, pp);                      // (F P F^T)[r]
    load_row(q_s, r, row);
#pragma unroll
    for (int j = 0; j < kW; ++j) pp[j] += row[j];
    mirror_upper(pp, x_s, r);
    float lam[kW];
    sym_inv_scaled_rows(pp, lam, r, d);
    mirror_upper(lam, x_s, r);
    float w_post[kW];
    load_row(w_s, r, w_post);
#pragma unroll
    for (int j = 0; j < kW; ++j) w_post[j] += lam[j];
    sym_inv_scaled_rows(w_post, p_row, r, d);
    mirror_upper(p_row, x_s, r);

    // xi_r = sum_k HR[r][k] y_t[k], k in order, a chunk at a time
    float xi = 0.0f;
    for (int c = 0; c < dy; c += kYChunk) {
      if (c > 0) {
        y_lo = c + r < dy ? yt[(c + r) * B] : 0.0f;
        y_hi = c + r + kW < dy ? yt[(c + r + kW) * B] : 0.0f;
      }
      __syncwarp();  // the chain is done with the last chunk
      y_s[r] = y_lo;
      y_s[r + kW] = y_hi;
      __syncwarp();
      const int n = dy - c < kYChunk ? dy - c : kYChunk;
      if (r < d) {
        const float* hr = hr_t + static_cast<int64_t>(c) * d + r;
        for (int k = 0; k < n; ++k, hr += d)
          xi = c + k == 0 ? *hr * y_s[k] : fmaf(*hr, y_s[k], xi);
      }
    }

    // h = L m_pred + xi ; m = P h
    v1[r] = m_pred;
    __syncwarp();
    const float h = row_dot(lam, v1) + xi;
    v0[r] = h;
    __syncwarp();
    m = row_dot(p_row, v0);
    __syncwarp();
    v0[r] = m;
    store_row(p_s, r, p_row);
    __syncwarp();
    if (valid && r < d) means[(t * d + r) * B + b] = m;
  }

  if (valid && r < d) {
    mf[r * B + b] = m;
#pragma unroll
    for (int j = 0; j < kW; ++j)
      if (j >= r && j < d) pf[(slot0 + j) * B + b] = p_row[j];
  }
}

FilterParams make_params(int d, const float* F, const float* Q,
                         const float* W) {
  FilterParams prm;
  for (int i = 0; i < kW; ++i) {
    for (int j = 0; j < kW; ++j) {
      const bool real = i < d && j < d;
      prm.F[i * kW + j] = real ? F[i * d + j] : 0.0f;
      prm.Q[i * kW + j] = real ? Q[i * d + j] : (i == j ? 1.0f : 0.0f);
      prm.W[i * kW + j] = real ? W[i * d + j] : 0.0f;
    }
  }
  return prm;
}

}  // namespace

extern "C" {

// Returns the CUDA error of the launch (0 = success).  d in 1..16, dy >= 1;
// F, Q, W host (d, d) row-major; hr_t the device (dy, d) HR^T, row-major;
// the rest device pointers.
int rxt_wide_filter(int d, int dy, const float* ys, const float* m0,
                    const float* p0, const float* hr_t, float* means,
                    float* mf, float* pf, int64_t T, int64_t B,
                    const float* F, const float* Q, const float* W,
                    void* stream) {
  if (d < 1 || d > kW || dy < 1 || T < 1 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const FilterParams prm = make_params(d, F, Q, W);
  const unsigned blocks = static_cast<unsigned>((B + kChains - 1) / kChains);
  wide_filter_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      ys, m0, p0, hr_t, means, mf, pf, T, B, d, dy, prm);
  return static_cast<int>(cudaGetLastError());
}

// The widest state the kernel takes (the padded dim).
int rxt_wide_filter_max_dim() { return kW; }

const char* rxt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

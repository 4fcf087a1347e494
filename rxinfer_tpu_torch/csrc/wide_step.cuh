// The step of a chain a warp on a 16 x 16 state, shared by the wide K1
// (fused_smoother_wide.cu, wide_fwd_tc_kernel, d 9-16) and the wide K3
// (fused_filter_wide.cu, wide_filter_tc_kernel, d 9-16 or dy > 8): the
// state padded to 16 with an exact identity block, a chain's 16 x 16
// matrices in mma.sync.m16n8k8's accumulator layout (tc16.cuh), F's TF32
// parts and F^T in the block's shared memory at rows kS floats apart, F P
// and (F P) F^T in 3xTF32, the mean's products against vectors in shared
// memory, and the inverse scaled by the mean |diagonal| by the Schur blocks
// at 8.

#pragma once

#include <cuda_runtime.h>

#include <stdint.h>

#include "tc16.cuh"

namespace {

using tc::Blk;
using tc::mirror_upper;

constexpr int kW = 16;                  // the padded state dim
constexpr int kLanes = 32;
constexpr int kS = 24;                  // floats a shared row: a quad's float2
                                        // loads of rows g fill 32 banks
constexpr int kFMat = kW * kS;

// Slot of entry (i, j), i <= j < d, in the packed upper triangle.
__device__ __forceinline__ int sym_slot(int i, int j, int d) {
  return i * (2 * d - i + 1) / 2 + (j - i);
}

// Row and column of register r of tile nj at lane (g, t).
__device__ __forceinline__ int frag_row(int g, int r) { return g + 8 * (r >> 1); }
__device__ __forceinline__ int frag_col(int t, int nj, int r) {
  return 8 * nj + 2 * t + (r & 1);
}

// F^T in float32 (for F v) and F's TF32 parts (for the products) into the
// block's shared memory, from F padded to 16 x 16, row-major.
__device__ __forceinline__ void load_f(float* ft, float* fh, float* fl,
                                       const float* F) {
  for (int i = threadIdx.x; i < kW * kW; i += blockDim.x) {
    const int r = i / kW, c = i % kW;
    const float fv = F[i];
    uint32_t hi, lo;
    tc::split(fv, hi, lo);
    fh[r * kS + c] = __uint_as_float(hi);
    fl[r * kS + c] = __uint_as_float(lo);
    ft[c * kS + r] = fv;
  }
}

// A padded 16 x 16 row-major matrix of the parameters.
__device__ __forceinline__ void load_dense(Blk& m, const float* src, int g,
                                           int t) {
#pragma unroll
  for (int nj = 0; nj < 2; ++nj)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      m[nj][r] = src[frag_row(g, r) * kW + frag_col(t, nj, r)];
}

// c = F m^T (= F m for a symmetric m): F's TF32 parts from shared memory as
// the A operand (rows g, g + 8 at columns 8 ki + 2t, + 1: float2 loads).
__device__ __forceinline__ void mul_f_m(Blk& c, const float* fh,
                                        const float* fl, const Blk& m, int g,
                                        int t) {
  float acc[2][4];
#pragma unroll
  for (int nj = 0; nj < 2; ++nj)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[nj][r] = 0.0f;
#pragma unroll
  for (int ki = 0; ki < 2; ++ki) {
    const int o = g * kS + 8 * ki + 2 * t;
    const float2 h0 = *reinterpret_cast<const float2*>(fh + o);
    const float2 h1 = *reinterpret_cast<const float2*>(fh + o + 8 * kS);
    const float2 l0 = *reinterpret_cast<const float2*>(fl + o);
    const float2 l1 = *reinterpret_cast<const float2*>(fl + o + 8 * kS);
    const uint32_t ah[4] = {__float_as_uint(h0.x), __float_as_uint(h1.x),
                            __float_as_uint(h0.y), __float_as_uint(h1.y)};
    const uint32_t al[4] = {__float_as_uint(l0.x), __float_as_uint(l1.x),
                            __float_as_uint(l0.y), __float_as_uint(l1.y)};
    uint32_t nh[4], nl[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) tc::split(m[ki][r], nh[r], nl[r]);
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      // B: m's rows 8 nj + g at k tile ki
      const uint32_t bh[2] = {nh[2 * nj], nh[2 * nj + 1]};
      const uint32_t bl[2] = {nl[2 * nj], nl[2 * nj + 1]};
      tc::mma3(acc[nj], ah, al, bh, bl);
    }
  }
#pragma unroll
  for (int nj = 0; nj < 2; ++nj)
#pragma unroll
    for (int r = 0; r < 4; ++r) c[nj][r] = acc[nj][r];
}

// c = (ADD ? c : 0) + a F^T: F's TF32 parts from shared memory as the B
// operand (F's rows 8 ni + g at k tile ki).  c must not alias a.
template <bool ADD>
__device__ __forceinline__ void mul_a_ft(Blk& c, const Blk& a,
                                         const float* fh, const float* fl,
                                         int g, int t) {
  float acc[2][4];
#pragma unroll
  for (int nj = 0; nj < 2; ++nj)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[nj][r] = ADD ? c[nj][r] : 0.0f;
#pragma unroll
  for (int ki = 0; ki < 2; ++ki) {
    uint32_t ah[4], al[4];
    tc::a_frag(a[ki], false, ah, al);
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) {
      const int o = (8 * ni + g) * kS + 8 * ki + 2 * t;
      const float2 vh = *reinterpret_cast<const float2*>(fh + o);
      const float2 vl = *reinterpret_cast<const float2*>(fl + o);
      const uint32_t bh[2] = {__float_as_uint(vh.x), __float_as_uint(vh.y)};
      const uint32_t bl[2] = {__float_as_uint(vl.x), __float_as_uint(vl.y)};
      tc::mma3(acc[ni], ah, al, bh, bl);
    }
  }
#pragma unroll
  for (int nj = 0; nj < 2; ++nj)
#pragma unroll
    for (int r = 0; r < 4; ++r) c[nj][r] = acc[nj][r];
}

// Rows g and g + 8 of m v (v: 16 floats in shared memory, zero past d),
// the quad's partial sums joined by shuffles: every lane of the quad holds
// both.
__device__ __forceinline__ void mat_vec(const Blk& m, const float* v, int t,
                                        float (&out)[2]) {
  float s[2] = {0.0f, 0.0f};
#pragma unroll
  for (int nj = 0; nj < 2; ++nj) {
    const float2 vv = *reinterpret_cast<const float2*>(v + 8 * nj + 2 * t);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      s[h] = fmaf(m[nj][2 * h], vv.x, s[h]);
      s[h] = fmaf(m[nj][2 * h + 1], vv.y, s[h]);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    s[h] += __shfl_xor_sync(tc::kFull, s[h], 1);
    s[h] += __shfl_xor_sync(tc::kFull, s[h], 2);
    out[h] = s[h];
  }
}

// (F v)[r] for lane r < 16: F^T's column r against v (shared).
__device__ __forceinline__ float f_row_dot(const float* ft, const float* v,
                                           int r) {
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < kW; ++k) acc = fmaf(ft[k * kS + r], v[k], acc);
  return acc;
}

// In place: the inverse of the symmetric m (identity past d), scaled by
// 1 / the mean |diagonal| of its d real rows (1 for a zero diagonal) on the
// way in and out, as sym_inv_scaled (its d / sum a rounding of the plain
// version's 1 / (sum / d)).  Lane (g, g / 2) holds the diagonal
// entries (g, g) and (g + 8, g + 8).  (A register is picked by a select: an
// index that differs between lanes would put the matrix in local memory.)
template <bool PAIRS>
__device__ __forceinline__ void sym_inv_scaled(Blk& m, int d, int g, int t,
                                               int lane) {
  float sum = 0.0f;
  if (t == (g >> 1)) {
    const float top = g & 1 ? m[0][1] : m[0][0];
    const float bot = g & 1 ? m[1][3] : m[1][2];
    if (g < d) sum = fabsf(top);
    if (g + 8 < d) sum += fabsf(bot);
  }
#pragma unroll
  for (int o = kLanes / 2; o > 0; o /= 2)
    sum += __shfl_xor_sync(tc::kFull, sum, o);
  // 1 / (sum / d) as d / sum, one IEEE division
  const float inv_s = sum > 0.0f ? static_cast<float>(d) / sum : 1.0f;
#pragma unroll
  for (int nj = 0; nj < 2; ++nj)
#pragma unroll
    for (int r = 0; r < 4; ++r) m[nj][r] *= inv_s;
  tc::inv16<false, PAIRS>(m, g, t, lane);
#pragma unroll
  for (int nj = 0; nj < 2; ++nj)
#pragma unroll
    for (int r = 0; r < 4; ++r) m[nj][r] *= inv_s;
}

}  // namespace

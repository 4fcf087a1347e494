// The 16-lane row algebra of the wide K3 (fused_filter_wide.cu, d 9..16 or
// dy > 8): a chain on a group of 16 lanes, lane r holding row r of every
// 16 x 16 matrix of its step, the state padded to 16 with an exact
// identity block: row products against matrices in shared memory, the
// mirror of an upper triangle, and the scaled Gauss-Jordan inverse.  The
// wide K1/K2 (fused_smoother_wide.cu) ran on it until they moved to the
// tensor-core step of tc16.cuh.

#pragma once

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kW = 16;                  // lanes a chain; the padded state dim
constexpr int kStride = 20;             // floats a shared-memory row
constexpr int kMat = kW * kStride;      // floats a shared-memory matrix
constexpr unsigned kFull = 0xffffffffu;

// Slot of entry (i, j), i <= j < d, in the packed upper triangle.
__device__ __forceinline__ int sym_slot(int i, int j, int d) {
  return i * (2 * d - i + 1) / 2 + (j - i);
}

__device__ __forceinline__ void store_row(float* __restrict__ mat, int r,
                                          const float (&row)[kW]) {
  float4* dst = reinterpret_cast<float4*>(mat + r * kStride);
#pragma unroll
  for (int q = 0; q < kW / 4; ++q)
    dst[q] = make_float4(row[4 * q], row[4 * q + 1], row[4 * q + 2],
                         row[4 * q + 3]);
}

__device__ __forceinline__ void load_row(const float* __restrict__ mat, int r,
                                         float (&row)[kW]) {
  const float4* src = reinterpret_cast<const float4*>(mat + r * kStride);
#pragma unroll
  for (int q = 0; q < kW / 4; ++q) {
    const float4 v = src[q];
    row[4 * q] = v.x;
    row[4 * q + 1] = v.y;
    row[4 * q + 2] = v.z;
    row[4 * q + 3] = v.w;
  }
}

// out[j] = sum_k a[k] mat[k][j]: row r of A times the matrix in shared.
__device__ __forceinline__ void row_mul(const float (&a)[kW],
                                        const float* __restrict__ mat,
                                        float (&out)[kW]) {
#pragma unroll
  for (int k = 0; k < kW; ++k) {
    const float4* rk = reinterpret_cast<const float4*>(mat + k * kStride);
#pragma unroll
    for (int q = 0; q < kW / 4; ++q) {
      const float4 v = rk[q];
      if (k == 0) {
        out[4 * q] = a[0] * v.x;
        out[4 * q + 1] = a[0] * v.y;
        out[4 * q + 2] = a[0] * v.z;
        out[4 * q + 3] = a[0] * v.w;
      } else {
        out[4 * q] = fmaf(a[k], v.x, out[4 * q]);
        out[4 * q + 1] = fmaf(a[k], v.y, out[4 * q + 1]);
        out[4 * q + 2] = fmaf(a[k], v.z, out[4 * q + 2]);
        out[4 * q + 3] = fmaf(a[k], v.w, out[4 * q + 3]);
      }
    }
  }
}

// out[j] = sum_k a[k] mat[j][k]: row r of A times the transpose of the
// matrix in shared.
__device__ __forceinline__ void row_mul_t(const float (&a)[kW],
                                          const float* __restrict__ mat,
                                          float (&out)[kW]) {
#pragma unroll
  for (int j = 0; j < kW; ++j) {
    const float4* rj = reinterpret_cast<const float4*>(mat + j * kStride);
    float s = 0.0f;
#pragma unroll
    for (int q = 0; q < kW / 4; ++q) {
      const float4 v = rj[q];
      s = q == 0 ? a[0] * v.x : fmaf(a[4 * q], v.x, s);
      s = fmaf(a[4 * q + 1], v.y, s);
      s = fmaf(a[4 * q + 2], v.z, s);
      s = fmaf(a[4 * q + 3], v.w, s);
    }
    out[j] = s;
  }
}

// v . vec for a vector in shared (16 floats).
__device__ __forceinline__ float row_dot(const float (&a)[kW],
                                         const float* __restrict__ vec) {
  const float4* v4 = reinterpret_cast<const float4*>(vec);
  float s = 0.0f;
#pragma unroll
  for (int q = 0; q < kW / 4; ++q) {
    const float4 v = v4[q];
    s = q == 0 ? a[0] * v.x : fmaf(a[4 * q], v.x, s);
    s = fmaf(a[4 * q + 1], v.y, s);
    s = fmaf(a[4 * q + 2], v.z, s);
    s = fmaf(a[4 * q + 3], v.w, s);
  }
  return s;
}

// Entries below the diagonal become those above it: row r's (r, j < r) is
// row j's (j, r), read through the chain's staging matrix x.
__device__ __forceinline__ void mirror_upper(float (&row)[kW],
                                             float* __restrict__ x, int r) {
  __syncwarp();
  store_row(x, r, row);
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kW; ++j)
    if (j < r) row[j] = x[j * kStride + r];
}

// Inverse of the symmetric matrix whose row r this lane holds: scaled by
// the mean |diagonal| of the d real rows (ops/entrywise.py sym_inv_scaled),
// then an unpivoted Gauss-Jordan sweep over the d real pivots with the
// pivot row broadcast by shuffles.  Padded rows and columns are an
// identity block and stay one.  Not mirrored: the caller mirrors.
__device__ __forceinline__ void sym_inv_scaled_rows(const float (&m)[kW],
                                                    float (&out)[kW], int r,
                                                    int d) {
  float diag = 0.0f;
#pragma unroll
  for (int j = 0; j < kW; ++j) diag = j == r ? m[j] : diag;
  float s = r < d ? fabsf(diag) : 0.0f;
#pragma unroll
  for (int o = kW / 2; o > 0; o /= 2) s += __shfl_xor_sync(kFull, s, o, kW);
  float scale = s / static_cast<float>(d);
  scale = scale > 0.0f ? scale : 1.0f;
  const float inv_s = 1.0f / scale;
  const bool real_row = r < d;
  float a[kW];
#pragma unroll
  for (int j = 0; j < kW; ++j)
    a[j] = real_row && j < d ? m[j] * inv_s : m[j];
#pragma unroll
  for (int k = 0; k < kW; ++k) {
    if (k >= d) break;
    float pk[kW];
#pragma unroll
    for (int j = 0; j < kW; ++j) pk[j] = __shfl_sync(kFull, a[j], k, kW);
    const float p = 1.0f / pk[k];
    const float f = a[k];
    const bool piv = r == k;
#pragma unroll
    for (int j = 0; j < kW; ++j) {
      if (j == k) {
        a[j] = piv ? p : -f * p;
      } else {
        const float qj = pk[j] * p;
        a[j] = piv ? qj : fmaf(-f, qj, a[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kW; ++j)
    out[j] = real_row && j < d ? a[j] * inv_s : a[j];
}

// Row r of a per-chain (nsym, B) tile, padded: the identity's row past d
// when pad_one, else zeros.
__device__ __forceinline__ void tile_row(const float* __restrict__ tile,
                                         int64_t b, int64_t B, int r, int d,
                                         bool pad_one, float (&row)[kW]) {
#pragma unroll
  for (int j = 0; j < kW; ++j) {
    if (r < d && j < d) {
      const int k = r <= j ? sym_slot(r, j, d) : sym_slot(j, r, d);
      row[j] = tile[static_cast<int64_t>(k) * B + b];
    } else {
      row[j] = pad_one && j == r ? 1.0f : 0.0f;
    }
  }
}

}  // namespace

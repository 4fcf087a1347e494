// Per-thread small-matrix helpers shared by the chain kernels
// (fused_smoother.cu, fused_filter.cu): the device-side counterpart of
// rxinfer_tpu_torch/ops/entrywise.py, same operations in the same order.
//
// Every matrix is a float[N][N] with N a template parameter, so after
// unrolling each index is a compile-time constant and the arrays live in
// registers.  Symmetric results are computed on the upper triangle and
// mirrored (entrywise.sym_alias).

#pragma once

#include <stddef.h>

namespace rxt {

// ---- symmetric inverse: unpivoted Schur recursion, split at K = N / 2 -----

template <int N>
__device__ __forceinline__ void sym_inv(const float (&m)[N][N],
                                        float (&out)[N][N]);

template <>
__device__ __forceinline__ void sym_inv<1>(const float (&m)[1][1],
                                           float (&out)[1][1]) {
  out[0][0] = 1.0f / m[0][0];
}

template <>
__device__ __forceinline__ void sym_inv<2>(const float (&m)[2][2],
                                           float (&out)[2][2]) {
  const float det = m[0][0] * m[1][1] - m[0][1] * m[0][1];
  const float inv_det = 1.0f / det;
  const float x01 = -m[0][1] * inv_det;
  out[0][0] = m[1][1] * inv_det;
  out[0][1] = x01;
  out[1][0] = x01;
  out[1][1] = m[0][0] * inv_det;
}

template <int N>
__device__ __forceinline__ void sym_inv(const float (&m)[N][N],
                                        float (&out)[N][N]) {
  constexpr int K = N / 2;
  constexpr int M = N - K;
  float a[K][K], bb[K][M], dd[M][M];
#pragma unroll
  for (int i = 0; i < K; ++i) {
#pragma unroll
    for (int j = 0; j < K; ++j) a[i][j] = m[i][j];
#pragma unroll
    for (int j = 0; j < M; ++j) bb[i][j] = m[i][K + j];
  }
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) dd[i][j] = m[K + i][K + j];

  float a_inv[K][K];
  sym_inv<K>(a, a_inv);
  float ab[K][M];  // X = A^-1 B
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) {
      float s = a_inv[i][0] * bb[0][j];
#pragma unroll
      for (int p = 1; p < K; ++p) s += a_inv[i][p] * bb[p][j];
      ab[i][j] = s;
    }
  float sc[M][M];  // Schur complement D - B^T X, upper triangle, aliased
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = i; j < M; ++j) {
      float s = bb[0][i] * ab[0][j];
#pragma unroll
      for (int p = 1; p < K; ++p) s += bb[p][i] * ab[p][j];
      sc[i][j] = dd[i][j] - s;
      sc[j][i] = sc[i][j];
    }
  float s_inv[M][M];
  sym_inv<M>(sc, s_inv);
  float xs[K][M];  // X S^-1
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) {
      float s = ab[i][0] * s_inv[0][j];
#pragma unroll
      for (int p = 1; p < M; ++p) s += ab[i][p] * s_inv[p][j];
      xs[i][j] = s;
    }
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = i; j < K; ++j) {
      float s = xs[i][0] * ab[j][0];
#pragma unroll
      for (int p = 1; p < M; ++p) s += xs[i][p] * ab[j][p];
      out[i][j] = a_inv[i][j] + s;
      out[j][i] = out[i][j];
    }
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int p = 0; p < M; ++p) {
      out[i][K + p] = -xs[i][p];
      out[K + p][i] = -xs[i][p];
    }
#pragma unroll
  for (int p = 0; p < M; ++p)
#pragma unroll
    for (int q = 0; q < M; ++q) out[K + p][K + q] = s_inv[p][q];
}

template <int N>
__device__ __forceinline__ void sym_inv_scaled(const float (&m)[N][N],
                                               float (&out)[N][N]) {
  float scale = fabsf(m[0][0]);
#pragma unroll
  for (int i = 1; i < N; ++i) scale += fabsf(m[i][i]);
  scale = scale / static_cast<float>(N);
  scale = scale > 0.0f ? scale : 1.0f;
  const float inv_s = 1.0f / scale;
  float ms[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = i; j < N; ++j) {
      ms[i][j] = m[i][j] * inv_s;
      ms[j][i] = ms[i][j];
    }
  float inv[N][N];
  sym_inv<N>(ms, inv);
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = i; j < N; ++j) {
      out[i][j] = inv[i][j] * inv_s;
      out[j][i] = out[i][j];
    }
}

// F P F^T + Q for symmetric P, Q (upper triangle computed, lower aliased).
template <int D>
__device__ __forceinline__ void sandwich_sym(const float (&f)[D][D],
                                             const float (&p)[D][D],
                                             const float (&q)[D][D],
                                             float (&out)[D][D]) {
  float fp[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      float s = f[i][0] * p[0][j];
#pragma unroll
      for (int k = 1; k < D; ++k) s += f[i][k] * p[k][j];
      fp[i][j] = s;
    }
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = i; j < D; ++j) {
      float s = fp[i][0] * f[j][0];
#pragma unroll
      for (int k = 1; k < D; ++k) s += fp[i][k] * f[j][k];
      out[i][j] = q[i][j] + s;
      out[j][i] = out[i][j];
    }
}

template <int D>
__device__ __forceinline__ void load_packed(const float* __restrict__ src,
                                            size_t stride,
                                            float (&p)[D][D]) {
  int k = 0;
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = i; j < D; ++j) {
      p[i][j] = src[k * stride];
      p[j][i] = p[i][j];
      ++k;
    }
}

template <int D>
__device__ __forceinline__ void store_packed(float* __restrict__ dst,
                                             size_t stride,
                                             const float (&p)[D][D]) {
  int k = 0;
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = i; j < D; ++j) {
      dst[k * stride] = p[i][j];
      ++k;
    }
}

}  // namespace rxt

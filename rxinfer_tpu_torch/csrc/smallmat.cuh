// Per-thread small-matrix helpers shared by the chain kernels
// (fused_smoother.cuh, fused_filter.cu): the device-side counterpart of
// rxinfer_tpu_torch/ops/entrywise.py, same operations in the same order;
// and the moments' float32 / bf16 conversions (also fused_smoother_wide.cu).
//
// Every matrix is a float[N][N] with N a template parameter, so after
// unrolling each index is a compile-time constant and the arrays live in
// registers.  Symmetric results are computed on the upper triangle and
// mirrored (entrywise.sym_alias).  The general (non-symmetric) inverse and
// the products below it serve the time-blocked smoother's fold and carry
// passes; the filter kernel uses the symmetric helpers only.

#pragma once

#include <cuda_bf16.h>
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

// ---- general inverse: cofactors up to N = 3, unpivoted block Schur above ---
//
// Counterpart of ops/smallmat.py small_inv (2|2 blocks at N = 4, 4|rest for
// N in 5..8), for matrices that are not symmetric: (I + C J) of the filter
// elements' composition, with C and J symmetric positive semi-definite.

template <int N>
__device__ __forceinline__ void gen_inv(const float (&m)[N][N],
                                        float (&out)[N][N]);

template <>
__device__ __forceinline__ void gen_inv<1>(const float (&m)[1][1],
                                           float (&out)[1][1]) {
  out[0][0] = 1.0f / m[0][0];
}

template <>
__device__ __forceinline__ void gen_inv<2>(const float (&m)[2][2],
                                           float (&out)[2][2]) {
  const float det = m[0][0] * m[1][1] - m[0][1] * m[1][0];
  const float inv_det = 1.0f / det;
  out[0][0] = m[1][1] * inv_det;
  out[0][1] = -m[0][1] * inv_det;
  out[1][0] = -m[1][0] * inv_det;
  out[1][1] = m[0][0] * inv_det;
}

template <>
__device__ __forceinline__ void gen_inv<3>(const float (&m)[3][3],
                                           float (&out)[3][3]) {
  const float a = m[0][0], b = m[0][1], c = m[0][2];
  const float d = m[1][0], e = m[1][1], f = m[1][2];
  const float g = m[2][0], h = m[2][1], i = m[2][2];
  const float co_a = e * i - f * h;
  const float co_b = -(d * i - f * g);
  const float co_c = d * h - e * g;
  const float det = a * co_a + b * co_b + c * co_c;
  const float inv_det = 1.0f / det;
  out[0][0] = co_a * inv_det;
  out[0][1] = -(b * i - c * h) * inv_det;
  out[0][2] = (b * f - c * e) * inv_det;
  out[1][0] = co_b * inv_det;
  out[1][1] = (a * i - c * g) * inv_det;
  out[1][2] = -(a * f - c * d) * inv_det;
  out[2][0] = co_c * inv_det;
  out[2][1] = -(a * h - b * g) * inv_det;
  out[2][2] = (a * e - b * d) * inv_det;
}

// C = A B for an (R x K) by (K x C) product.
template <int R, int K, int C>
__device__ __forceinline__ void mat_mul(const float (&a)[R][K],
                                        const float (&b)[K][C],
                                        float (&out)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) {
      float s = a[i][0] * b[0][j];
#pragma unroll
      for (int p = 1; p < K; ++p) s += a[i][p] * b[p][j];
      out[i][j] = s;
    }
}

template <int N>
__device__ __forceinline__ void gen_inv(const float (&m)[N][N],
                                        float (&out)[N][N]) {
  constexpr int K = N <= 4 ? 2 : 4;
  constexpr int M = N - K;
  float a[K][K], bb[K][M], cc[M][K], dd[M][M];
#pragma unroll
  for (int i = 0; i < K; ++i) {
#pragma unroll
    for (int j = 0; j < K; ++j) a[i][j] = m[i][j];
#pragma unroll
    for (int j = 0; j < M; ++j) bb[i][j] = m[i][K + j];
  }
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = 0; j < K; ++j) cc[i][j] = m[K + i][j];
#pragma unroll
    for (int j = 0; j < M; ++j) dd[i][j] = m[K + i][K + j];
  }
  float a_inv[K][K];
  gen_inv<K>(a, a_inv);
  float ca[M][K];  // C A^-1
  mat_mul<M, K, K>(cc, a_inv, ca);
  float cab[M][M];
  mat_mul<M, K, M>(ca, bb, cab);
  float sc[M][M];  // Schur complement D - C A^-1 B
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) sc[i][j] = dd[i][j] - cab[i][j];
  float s_inv[M][M];
  gen_inv<M>(sc, s_inv);
  float ab[K][M];  // A^-1 B
  mat_mul<K, K, M>(a_inv, bb, ab);
  float abs_[K][M];  // A^-1 B S^-1
  mat_mul<K, M, M>(ab, s_inv, abs_);
  float tl[K][K];
  mat_mul<K, M, K>(abs_, ca, tl);
  float bl[M][K];  // S^-1 C A^-1
  mat_mul<M, M, K>(s_inv, ca, bl);
#pragma unroll
  for (int i = 0; i < K; ++i) {
#pragma unroll
    for (int j = 0; j < K; ++j) out[i][j] = a_inv[i][j] + tl[i][j];
#pragma unroll
    for (int j = 0; j < M; ++j) out[i][K + j] = -abs_[i][j];
  }
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = 0; j < K; ++j) out[K + i][j] = -bl[i][j];
#pragma unroll
    for (int j = 0; j < M; ++j) out[K + i][K + j] = s_inv[i][j];
  }
}

// gen_inv with the mean-|diagonal| scaling of sym_inv_scaled.
template <int N>
__device__ __forceinline__ void gen_inv_scaled(const float (&m)[N][N],
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
    for (int j = 0; j < N; ++j) ms[i][j] = m[i][j] * inv_s;
  float inv[N][N];
  gen_inv<N>(ms, inv);
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) out[i][j] = inv[i][j] * inv_s;
}

// out = A v.
template <int D>
__device__ __forceinline__ void mat_vec(const float (&a)[D][D],
                                        const float (&v)[D], float (&out)[D]) {
#pragma unroll
  for (int i = 0; i < D; ++i) {
    float s = a[i][0] * v[0];
#pragma unroll
    for (int j = 1; j < D; ++j) s += a[i][j] * v[j];
    out[i] = s;
  }
}

// out = A^T v.
template <int D>
__device__ __forceinline__ void mat_t_vec(const float (&a)[D][D],
                                          const float (&v)[D],
                                          float (&out)[D]) {
#pragma unroll
  for (int i = 0; i < D; ++i) {
    float s = a[0][i] * v[0];
#pragma unroll
    for (int j = 1; j < D; ++j) s += a[j][i] * v[j];
    out[i] = s;
  }
}

// out = A^T B.
template <int D>
__device__ __forceinline__ void mat_t_mul(const float (&a)[D][D],
                                          const float (&b)[D][D],
                                          float (&out)[D][D]) {
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      float s = a[0][i] * b[0][j];
#pragma unroll
      for (int p = 1; p < D; ++p) s += a[p][i] * b[p][j];
      out[i][j] = s;
    }
}

// out = X A^T + add on the upper triangle, lower aliased: for X A^T + add
// known to be symmetric (X = A P with P symmetric).
template <int D>
__device__ __forceinline__ void mul_t_add_sym(const float (&x)[D][D],
                                              const float (&a)[D][D],
                                              const float (&add)[D][D],
                                              float (&out)[D][D]) {
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = i; j < D; ++j) {
      float s = x[i][0] * a[j][0];
#pragma unroll
      for (int k = 1; k < D; ++k) s += x[i][k] * a[j][k];
      out[i][j] = add[i][j] + s;
      out[j][i] = out[i][j];
    }
}

// out = X A + add on the upper triangle, lower aliased (X = A^T P).
template <int D>
__device__ __forceinline__ void mul_add_sym(const float (&x)[D][D],
                                            const float (&a)[D][D],
                                            const float (&add)[D][D],
                                            float (&out)[D][D]) {
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = i; j < D; ++j) {
      float s = x[i][0] * a[0][j];
#pragma unroll
      for (int k = 1; k < D; ++k) s += x[i][k] * a[k][j];
      out[i][j] = add[i][j] + s;
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

// Moment storage: float32, or bf16 rounded to nearest even (as torch and
// JAX cast); the packed loads and stores below convert through these.
__device__ __forceinline__ float moment_in(float x) { return x; }
__device__ __forceinline__ float moment_in(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T moment_out(float x);

template <>
__device__ __forceinline__ float moment_out<float>(float x) { return x; }

template <>
__device__ __forceinline__ __nv_bfloat16 moment_out<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int D, typename T>
__device__ __forceinline__ void load_packed(const T* __restrict__ src,
                                            size_t stride,
                                            float (&p)[D][D]) {
  int k = 0;
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = i; j < D; ++j) {
      p[i][j] = moment_in(src[k * stride]);
      p[j][i] = p[i][j];
      ++k;
    }
}

template <int D, typename T>
__device__ __forceinline__ void store_packed(T* __restrict__ dst,
                                             size_t stride,
                                             const float (&p)[D][D]) {
  int k = 0;
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = i; j < D; ++j) {
      dst[k * stride] = moment_out<T>(p[i][j]);
      ++k;
    }
}

}  // namespace rxt

// The 16 x 16 block helpers of the warp K3's tensor-core tiers past d = 32
// (fused_filter_warp.cu's tier to d = 64 and fused_filter_tc128.cu's to
// d = 128): a block of a matrix in shared (or device) memory loaded into
// mma.sync's accumulator layout and stored back, 3xTF32 products of one
// k tile of 8 at a time on a zero accumulator added by a float32 add, the
// 32 x 32 inverse in registers, the team of warps a chain runs on, the
// mean-|diagonal| scale and the lower blocks' order.  Include after
// tc16.cuh, whose primitives these build on.

#pragma once

#include <cuda_runtime.h>

#include <stdint.h>

namespace {
namespace tc64 {

using tc::Blk;

constexpr int kLanes = 32;

// Block (bi, bj) of a shared matrix at row stride S, in accumulator layout.
template <int S>
__device__ __forceinline__ void ld_blk(Blk& x, const float* m, int bi, int bj,
                                       int g, int t) {
  const float* p = m + (16 * bi + g) * S + 16 * bj + 2 * t;
#pragma unroll
  for (int nj = 0; nj < 2; ++nj)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 v = *reinterpret_cast<const float2*>(p + 8 * h * S + 8 * nj);
      x[nj][2 * h] = v.x;
      x[nj][2 * h + 1] = v.y;
    }
}

template <int S>
__device__ __forceinline__ void st_blk(const Blk& x, float* m, int bi, int bj,
                                       int g, int t) {
  float* p = m + (16 * bi + g) * S + 16 * bj + 2 * t;
#pragma unroll
  for (int nj = 0; nj < 2; ++nj)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(p + 8 * h * S + 8 * nj) =
          make_float2(x[nj][2 * h], x[nj][2 * h + 1]);
}

// The A operand's TF32 parts of both k tiles of a block (tc16.cuh a_frag).
__device__ __forceinline__ void a_parts(const Blk& a, bool neg,
                                        uint32_t (&ah)[2][4],
                                        uint32_t (&al)[2][4]) {
  tc::a_frag(a[0], neg, ah[0], al[0]);
  tc::a_frag(a[1], neg, ah[1], al[1]);
}

// The same from a block already split: its high and low parts.
__device__ __forceinline__ void a_split(const Blk& h, const Blk& l,
                                        uint32_t (&ah)[2][4],
                                        uint32_t (&al)[2][4]) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const int perm[4] = {0, 2, 1, 3};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      ah[kk][r] = __float_as_uint(h[kk][perm[r]]);
      al[kk][r] = __float_as_uint(l[kk][perm[r]]);
    }
  }
}

// acc += the three TF32 products of one k tile of 8, formed on a zero
// accumulator and added to acc by a float32 add.  The tensor cores do not
// round a sum to nearest as an add does: chained over the 24 products of a
// 64-deep sum, their accumulation left P past ORACLE_TOL from the float64
// filter after 200 one-observation steps at d = 64 on an H100 (ROADMAP
// C7's test; `64: chained k tiles` of scripts/warp_filter_variants.py),
// where tests/test_torch_filter_tc64.py's emulation, every sum rounded to
// nearest, stays within it; a k tile at a time keeps each chain three
// products long.
__device__ __forceinline__ void mma3_add(float (&acc)[4],
                                         const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4],
                                         const uint32_t (&bh)[2],
                                         const uint32_t (&bl)[2]) {
  float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  tc::mma3(part, ah, al, bh, bl);
#pragma unroll
  for (int r = 0; r < 4; ++r) acc[r] += part[r];
}

// acc += A n^T over a 16 x 16 x 16 product, A given as its TF32 parts.
__device__ __forceinline__ void mul_acc(float (&acc)[2][4],
                                        const uint32_t (&ah)[2][4],
                                        const uint32_t (&al)[2][4],
                                        const Blk& n) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    uint32_t nh[4], nl[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) tc::split(n[kk][r], nh[r], nl[r]);
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      const uint32_t bh[2] = {nh[2 * nj], nh[2 * nj + 1]};
      const uint32_t bl[2] = {nl[2 * nj], nl[2 * nj + 1]};
      mma3_add(acc[nj], ah[kk], al[kk], bh, bl);
    }
  }
}

// The same with n already split into its high and low parts.
__device__ __forceinline__ void mul_acc_split(float (&acc)[2][4],
                                              const uint32_t (&ah)[2][4],
                                              const uint32_t (&al)[2][4],
                                              const Blk& nh, const Blk& nl) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      const uint32_t bh[2] = {__float_as_uint(nh[kk][2 * nj]),
                              __float_as_uint(nh[kk][2 * nj + 1])};
      const uint32_t bl[2] = {__float_as_uint(nl[kk][2 * nj]),
                              __float_as_uint(nl[kk][2 * nj + 1])};
      mma3_add(acc[nj], ah[kk], al[kk], bh, bl);
    }
}

__device__ __forceinline__ void blk_scale(Blk& x, float s) {
#pragma unroll
  for (int nj = 0; nj < 2; ++nj)
#pragma unroll
    for (int r = 0; r < 4; ++r) x[nj][r] *= s;
}

// In place, in registers: the inverse of the symmetric 32 x 32 matrix
// [a bt^T; bt dd] (its lower blocks; the upper-right one is not read), as
// the d <= 32 tier's sym_inv_scaled without the scale: bu becomes the
// upper-right block -Y, bt its exact transpose.
__device__ __forceinline__ void inv32(Blk& a, Blk& bt, Blk& dd, Blk& bu, int g,
                                      int t, int lane) {
  tc::inv16<false>(a, g, t, lane);             // A^-1
  Blk x, z;
  tc::blk_mul<false, false>(x, a, bt);         // X = A^-1 B
  tc::blk_mul<false, false>(z, bt, a);         // Z = B^T A^-1
  tc::blk_mul<true, true>(dd, z, bt);          // S = D - Z B
  tc::inv16<false>(dd, g, t, lane);            // S^-1
  tc::blk_mul<false, false>(bu, x, dd);        // Y = X S^-1
  tc::blk_mul<true, false>(a, bu, x);          // TL = A^-1 + Y X^T
  blk_scale(bu, -1.0f);
  tc::transpose(bt, bu, g, t);                 // -Y^T, exactly
}

// A chain's team: W warps (sub-warp s, lane), every chain of a block in
// lockstep, so that __syncthreads orders a team's shared memory (every
// chain runs the same steps: a chain index past B runs the last chain's
// inputs and stores nothing).  Work unit n of a phase goes to sub-warp
// n % W.
struct Team {
  int s, lane, g, t;
};

// 1 / the mean |diagonal| over the d real entries (1 for a zero
// diagonal), the same on every thread of the team: each warp sums its rows
// (row s * 32 + lane, + 32 W, ...), the W sums through `red` in order.
template <int S, int W>
__device__ __forceinline__ float inverse_scale(const float* m, float* red,
                                               int d, const Team& tm) {
  float sum = 0.0f;
  for (int j = tm.s * kLanes + tm.lane; j < d; j += W * kLanes)
    sum += fabsf(m[j * S + j]);
#pragma unroll
  for (int o = kLanes / 2; o > 0; o /= 2)
    sum += __shfl_xor_sync(tc::kFull, sum, o);
  if (tm.lane == 0) red[tm.s] = sum;
  __syncthreads();
  sum = red[0];
#pragma unroll
  for (int w = 1; w < W; ++w) sum += red[w];
  float scale = sum / static_cast<float>(d);
  scale = scale > 0.0f ? scale : 1.0f;
  return 1.0f / scale;
}

// acc (+)= (NEG ? -1 : 1) sum over kb < KB of A's block (ai, a0 + kb) times
// N's block (ni, n0 + kb) transposed, A and N in shared memory.
template <int S, int KB, bool NEG>
__device__ __forceinline__ void blk_prod(Blk& acc, const float* a, int ai,
                                         int a0, const float* n, int ni,
                                         int n0, int g, int t) {
#pragma unroll
  for (int kb = 0; kb < KB; ++kb) {
    Blk x, y;
    ld_blk<S>(x, a, ai, a0 + kb, g, t);
    ld_blk<S>(y, n, ni, n0 + kb, g, t);
    uint32_t ah[2][4], al[2][4];
    a_parts(x, NEG, ah, al);
    mul_acc(acc, ah, al, y);
  }
}

// The lower blocks (i, j <= i) of an NB x NB block matrix, the n-th in row
// order.
template <int NB>
__device__ __forceinline__ void lower_block(int n, int& i, int& j) {
  i = 0;
  while (n > i) {
    n -= i + 1;
    ++i;
  }
  j = n;
}

}  // namespace tc64
}  // namespace

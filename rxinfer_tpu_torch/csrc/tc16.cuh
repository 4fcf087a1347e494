// The tensor-core primitives of a 16 x 16 block held by a warp in
// mma.sync.m16n8k8's accumulator layout: lane (g, t) = (lane / 4, lane % 4)
// holds, in tile nj (columns 8 nj .. 8 nj + 7) and register r, the entry at
// row g + 8 (r / 2), column 8 nj + 2 t + r % 2.  Products in 3xTF32 as
// C = A N^T (an accumulator is an A operand with k permuted within each 8),
// the 16 x 16 symmetric inverse by the Schur blocks at 8 with Gauss-Jordan
// leaves of 8 by shuffles; a symmetric block's mirror and a block's
// transpose by shuffles.  Shared by fused_filter_warp.cu (the warp K3's
// tensor-core tier, d 17-32, which runs them on the blocks of a 32 x 32
// matrix) and fused_smoother_wide.cu (the wide K1/K2, d 9-16, one block).

#pragma once

#include <cuda_runtime.h>

#include <stdint.h>

namespace {
namespace tc {

constexpr unsigned kFull = 0xffffffffu;

// A 16 x 16 block: two 16 x 8 tiles [nj] of four registers [r].
using Blk = float[2][4];

// x rounded to TF32: to nearest on the 13 dropped bits, ties away from zero,
// by an add and a mask (cvt.rna.tf32.f32's bits for finite x, at half its
// instructions).  A NaN may come out as -0 or an infinity, but its low part
// below is NaN, and every product takes the low parts, so a NaN operand
// still gives a NaN product.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo: hi rounded to TF32, lo the exact float32 rest, of which
// the tensor cores read the top 19 bits (|lo| <= 2^-11 |x|, so hi + lo
// carries x to 21 bits)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a b, one m16n8k8 TF32 product
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32, the small products first
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// The A operand of k tile kk from an accumulator-layout block row: (row g,
// k = t) is column 2t, (row g, k = t + 4) column 2t + 1.
__device__ __forceinline__ void a_frag(const float (&tile)[4], bool neg,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float sg = neg ? -1.0f : 1.0f;
  split(sg * tile[0], hi[0], lo[0]);
  split(sg * tile[2], hi[1], lo[1]);
  split(sg * tile[1], hi[2], lo[2]);
  split(sg * tile[3], hi[3], lo[3]);
}

// c = (ADD ? c : 0) + (NEG ? -1 : 1) a n^T over 16 x 16 blocks, a k tile
// of operands split at a time.  c is written last, so it may alias a or n.
// NJ, KK: the output column tiles and k tiles formed (2, or 1 where the
// second is zero padding by construction: then c's second tile is 0, or
// kept with ADD).
template <bool ADD, bool NEG, int NJ = 2, int KK = 2>
__device__ __forceinline__ void blk_mul(Blk& c, const Blk& a, const Blk& n) {
  float acc[2][4];
#pragma unroll
  for (int nj = 0; nj < 2; ++nj)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[nj][r] = ADD ? c[nj][r] : 0.0f;
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    uint32_t ah[4], al[4], nh[4], nl[4];
    a_frag(a[kk], NEG, ah, al);
#pragma unroll
    for (int r = 0; r < 4; ++r) split(n[kk][r], nh[r], nl[r]);
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj) {
      // B: n's rows 8 nj + g (registers 2 nj, 2 nj + 1) at k tile kk
      const uint32_t bh[2] = {nh[2 * nj], nh[2 * nj + 1]};
      const uint32_t bl[2] = {nl[2 * nj], nl[2 * nj + 1]};
      mma3(acc[nj], ah, al, bh, bl);
    }
  }
#pragma unroll
  for (int nj = 0; nj < 2; ++nj)
#pragma unroll
    for (int r = 0; r < 4; ++r) c[nj][r] = acc[nj][r];
}

// In place: the inverse of an 8 x 8 block, two registers a lane (row g,
// columns 2t and 2t + 1), by the unpivoted Gauss-Jordan sweep of the sweep
// tiers, its pivot's row and column fetched by shuffles from the lanes
// that hold them.  The pivot's reciprocal is the hardware's (about 1 ulp;
// an IEEE division is a range test and a call a pivot), and every entry's
// update is selected, not branched to.
__device__ __forceinline__ void leaf8(float& x0, float& x1, int g, int t,
                                      int lane) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int kt = k >> 1, ke = k & 1;
    const float f = __shfl_sync(kFull, ke ? x1 : x0, (lane & ~3) | kt);
    const float r0 = __shfl_sync(kFull, x0, 4 * k + t);   // M[k][2t]
    const float r1 = __shfl_sync(kFull, x1, 4 * k + t);   // M[k][2t + 1]
    const float p =
        __fdividef(1.0f, __shfl_sync(kFull, ke ? x1 : x0, 4 * k + kt));
    const bool rowk = g == k;
    const bool ck0 = t == kt && ke == 0, ck1 = t == kt && ke == 1;
    const float q0 = r0 * p, q1 = r1 * p, fp = -f * p;
    const float u0 = fmaf(-f, q0, x0), u1 = fmaf(-f, q1, x1);
    const float row0 = ck0 ? p : q0, row1 = ck1 ? p : q1;
    const float col0 = ck0 ? fp : u0, col1 = ck1 ? fp : u1;
    x0 = rowk ? row0 : col0;
    x1 = rowk ? row1 : col1;
  }
}

// In place: the inverse of an 8 x 8 block as leaf8, by pairs of pivots:
// four steps of the 2 x 2 block Gauss-Jordan sweep.  Each step's pivot
// block Pi (rows and columns k, k + 1) is inverted by its determinant and
// the hardware reciprocal; rows k, k + 1 become Pi^-1 R (R their entries),
// the others x - F Pi^-1 R (F their entries in the pivot columns), and the
// pivot columns Pi^-1 and -F Pi^-1.  The ten shuffles of a step are
// independent, so a step's dependent chain is one shuffle, one reciprocal
// and a few products: half the steps of leaf8, each longer by a product.
// For blocks whose 2 x 2 pivot blocks are invertible (symmetric positive
// definite ones).
__device__ __forceinline__ void leaf8_pairs(float& x0, float& x1, int g,
                                            int t, int lane) {
#pragma unroll
  for (int kt = 0; kt < 4; ++kt) {
    const int k = 2 * kt;
    const int own = (lane & ~3) | kt;                 // this row, k and k + 1
    const float f0 = __shfl_sync(kFull, x0, own);
    const float f1 = __shfl_sync(kFull, x1, own);
    const float r00 = __shfl_sync(kFull, x0, 4 * k + t);      // M[k][2t]
    const float r01 = __shfl_sync(kFull, x1, 4 * k + t);      // M[k][2t + 1]
    const float r10 = __shfl_sync(kFull, x0, 4 * k + 4 + t);  // M[k + 1][2t]
    const float r11 = __shfl_sync(kFull, x1, 4 * k + 4 + t);
    const float a = __shfl_sync(kFull, x0, 4 * k + kt);       // Pi
    const float b = __shfl_sync(kFull, x1, 4 * k + kt);
    const float c = __shfl_sync(kFull, x0, 4 * k + 4 + kt);
    const float e = __shfl_sync(kFull, x1, 4 * k + 4 + kt);
    const float rdet = __fdividef(1.0f, fmaf(a, e, -b * c));
    const float i00 = e * rdet, i01 = -b * rdet;              // Pi^-1
    const float i10 = -c * rdet, i11 = a * rdet;
    const float q00 = fmaf(i00, r00, i01 * r10);              // Pi^-1 R
    const float q01 = fmaf(i00, r01, i01 * r11);
    const float q10 = fmaf(i10, r00, i11 * r10);
    const float q11 = fmaf(i10, r01, i11 * r11);
    const float n0 = -fmaf(f0, i00, f1 * i10);                // -F Pi^-1
    const float n1 = -fmaf(f0, i01, f1 * i11);
    const float u0 = fmaf(-f0, q00, fmaf(-f1, q10, x0));      // x - F Pi^-1 R
    const float u1 = fmaf(-f0, q01, fmaf(-f1, q11, x1));
    const bool row0 = g == k, row1 = g == k + 1, col = t == kt;
    const float c0 = row0 ? i00 : row1 ? i10 : n0;
    const float c1 = row0 ? i01 : row1 ? i11 : n1;
    const float o0 = row0 ? q00 : row1 ? q10 : u0;
    const float o1 = row0 ? q01 : row1 ? q11 : u1;
    x0 = col ? c0 : o0;
    x1 = col ? c1 : o1;
  }
}

// [c0 c1; c2 c3] += [a0 a1; a2 a3] [n0 n1]^T over 8 x 8 blocks of two
// registers a lane (row g, columns 2t, 2t + 1): one m16n8k8 product in
// 3xTF32, the top block rows 0-7 of mma's A and D, the bottom rows 8-15.
// TOP / BOT: whether that half of A is a block (else zero, and its part of
// D is not used).
template <bool TOP, bool BOT>
__device__ __forceinline__ void mul8(float& c0, float& c1, float& c2,
                                     float& c3, float a0, float a1, float a2,
                                     float a3, float n0, float n1) {
  uint32_t ah[4] = {0u, 0u, 0u, 0u}, al[4] = {0u, 0u, 0u, 0u};
  if (TOP) {
    split(a0, ah[0], al[0]);
    split(a1, ah[2], al[2]);
  }
  if (BOT) {
    split(a2, ah[1], al[1]);
    split(a3, ah[3], al[3]);
  }
  uint32_t bh[2], bl[2];
  split(n0, bh[0], bl[0]);
  split(n1, bh[1], bl[1]);
  float acc[4] = {c0, c1, c2, c3};
  mma3(acc, ah, al, bh, bl);
  c0 = acc[0];
  c1 = acc[1];
  c2 = acc[2];
  c3 = acc[3];
}

// In place: the inverse of a symmetric 16 x 16 block by the Schur blocks at
// 8 (sym_inv's recursion one level down) with 8-pivot leaves.  Its tile 0
// (columns 0-7) holds A in registers 0, 1 and B^T in 2, 3; tile 1 holds B
// and D.  A^-1; Z = B^T A^-1; then X = A^-1 B and S = D - Z B in one
// product (the two share B); S^-1; Y = X S^-1; then TL = A^-1 + Y X^T and
// Y^T = S^-1 X^T in one product (the two share X).  B is never read.
// PAD: D is the padding's diagonal and B zero, so the inverse is A^-1 and
// D's reciprocal diagonal (lane (g, t) holds a diagonal entry of D where
// g = 2t + e).  PAIRS: the leaves by leaf8_pairs.
template <bool PAD, bool PAIRS = false>
__device__ __forceinline__ void inv16(Blk& m, int g, int t, int lane) {
  if (PAD) {
    leaf8(m[0][0], m[0][1], g, t, lane);
    if (g == 2 * t) m[1][2] = __fdividef(1.0f, m[1][2]);
    if (g == 2 * t + 1) m[1][3] = __fdividef(1.0f, m[1][3]);
    return;
  }
  float u0 = 0.0f, u1 = 0.0f;                       // an unused half
  if constexpr (PAIRS) {                            // A^-1
    leaf8_pairs(m[0][0], m[0][1], g, t, lane);
  } else {
    leaf8(m[0][0], m[0][1], g, t, lane);
  }
  float z0 = 0.0f, z1 = 0.0f;                       // Z = B^T A^-1
  mul8<false, true>(u0, u1, z0, z1, 0.0f, 0.0f, m[0][2], m[0][3], m[0][0],
                    m[0][1]);
  float x0 = 0.0f, x1 = 0.0f;                       // X ; S = D - Z B
  mul8<true, true>(x0, x1, m[1][2], m[1][3], m[0][0], m[0][1], -z0, -z1,
                   m[0][2], m[0][3]);
  if constexpr (PAIRS) {                            // S^-1
    leaf8_pairs(m[1][2], m[1][3], g, t, lane);
  } else {
    leaf8(m[1][2], m[1][3], g, t, lane);
  }
  float y0 = 0.0f, y1 = 0.0f;                       // Y = X S^-1
  mul8<true, false>(y0, y1, u0, u1, x0, x1, 0.0f, 0.0f, m[1][2], m[1][3]);
  float w0 = 0.0f, w1 = 0.0f;                       // TL ; Y^T
  mul8<true, true>(m[0][0], m[0][1], w0, w1, y0, y1, m[1][2], m[1][3], x0,
                   x1);
  m[1][0] = -y0;
  m[1][1] = -y1;
  m[0][2] = -w0;
  m[0][3] = -w1;
}

// In place: the entries of the symmetric m below its diagonal replaced by
// the mirror of those above, as the plain version keeps a symmetric matrix
// (its upper triangle).  The Schur inverse leaves its blocks' two triangles
// apart by rounding; a filter's recursion through two inverses a step can
// amplify what sets them apart (one observation of 16 states: the means
// drift without bound), and a P mirrored each step keeps them a step's
// rounding apart.  Lane (g, t) takes entry (2t + e, g) of each 8 x 8 block
// from lane 4 (2t + e) + g / 2, register g % 2 there (both shuffled, one
// selected: a lane's two readers want different registers).
__device__ __forceinline__ void mirror_upper(Blk& m, int g, int t) {
  const bool odd = g & 1;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int src = 4 * (2 * t + e) + (g >> 1);
    const float tr0 = __shfl_sync(kFull, m[1][0], src);
    const float tr1 = __shfl_sync(kFull, m[1][1], src);
    const float tl0 = __shfl_sync(kFull, m[0][0], src);
    const float tl1 = __shfl_sync(kFull, m[0][1], src);
    const float br0 = __shfl_sync(kFull, m[1][2], src);
    const float br1 = __shfl_sync(kFull, m[1][3], src);
    m[0][2 + e] = odd ? tr1 : tr0;               // rows 8-15, columns 0-7
    if (g > 2 * t + e) {                         // below the blocks' diagonal
      m[0][e] = odd ? tl1 : tl0;
      m[1][2 + e] = odd ? br1 : br0;
    }
  }
}

// dst = src^T over 16 x 16 blocks (dst must not alias src), by shuffles:
// lane (g, t) takes entry (8 nj + 2t + e, g + 8 h) of src, register
// 2 nj + g % 2 of tile h at lane 4 (2t + e) + g / 2 (both shuffled, one
// selected, as mirror_upper).  NT: src's live column tiles (1 where its
// second is zero padding: dst's rows 8-15 are then zero).
template <int NT = 2>
__device__ __forceinline__ void transpose(Blk& dst, const Blk& src, int g,
                                          int t) {
  const bool odd = g & 1;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int lane_src = 4 * (2 * t + e) + (g >> 1);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        if (h < NT) {
          const float v0 = __shfl_sync(kFull, src[h][2 * nj], lane_src);
          const float v1 = __shfl_sync(kFull, src[h][2 * nj + 1], lane_src);
          dst[nj][2 * h + e] = odd ? v1 : v0;
        } else {
          dst[nj][2 * h + e] = 0.0f;
        }
      }
  }
}

}  // namespace tc
}  // namespace

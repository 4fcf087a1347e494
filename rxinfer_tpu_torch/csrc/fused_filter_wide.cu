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
// Design: the wide K1's step (fused_smoother_wide.cu, wide_fwd_tc_kernel)
// on the helpers both kernels take from wide_step.cuh.  A chain is a warp;
// the state is padded to 16 with an exact identity block (F and W padded
// with zeros, Q and P with the identity), so one kernel serves every
// d <= 16; P sits in registers in mma.sync.m16n8k8's accumulator layout;
// F P F^T + Q runs on the tensor cores in 3xTF32 (F's TF32 parts in the
// block's shared memory), and L = P_pred^-1 and P = (L + W)^-1 are each
// the inverse scaled by the mean |diagonal|, by the Schur blocks at 8 with
// Gauss-Jordan leaves of 8 (swept a pivot at a time unless kPairs); the
// mean is formed beside them from vectors in shared memory.  The plain
// version inverts by the Schur recursion split at d / 2 and keeps one
// triangle of each symmetric matrix, so P's lower triangle is set to the
// mirror of its upper after each step's second inverse (wide_step.cuh
// mirror_upper: the two inverses a step would otherwise amplify the
// rounding that sets the triangles apart, and with few observations the
// means drift without bound); the two then differ in rounding only.
//
// The evidence is formed here, for the block's eight chains at once: the
// xi of one step is XI = HR Y, 16 states by 8 chains, exactly one m16n8k8
// tile, run on the tensor cores in 3xTF32 a k tile of eight observations
// at a time (dy has no cap).  A block's chains are neighbours in B, so a
// k tile's observations are read a row of eight chains, a sector, at a
// time (a chain a warp reading ys[(t dy + k) B + b] would touch a sector a
// word).  Warp u of the block forms step u of the next group of kStaged
// steps at the start of a group, into shared memory, which the chains read
// after the block's barrier at the group's end; the group's means are
// staged in shared memory the same way and written out a row of eight
// chains at a time during the next group.  The block's warps meet once a
// group.
//
// What bounds it: at path A's (B, T, d, dy) = (10,000, 200, 16, 16) the
// bytes are 0.27 GB (ys in, means out), 0.08 ms at the HBM rate; the
// operations of the plain step, 0.69 ms at the float32 rate, or 0.36 ms
// with F P F^T + Q, both inverses' top-level Schur block products and the
// evidence at the 3xTF32 rate (chip_smoke.filter_bound).  10,000 chains are
// 10,000 warps, kMinBlocks blocks of eight resident an SM: the issue of the
// step's instructions, not one warp's latency chain, is the limit (the two
// inverses issue most of them).  A chain index past B runs on the last
// chain's inputs and stores nothing, so every lane reaches every shuffle
// and barrier.  (d <= 8 with dy > 8 runs here too, doing the padded
// 16-wide work.)

#include <cuda_runtime.h>

#include <stdint.h>

#include "wide_step.cuh"

namespace {

constexpr int kWarps = 8;           // chains a block, a chain a warp
constexpr int kThreads = kWarps * kLanes;
constexpr int kMinBlocks = 3;       // blocks an SM: 80 registers a thread
constexpr int kStaged = 8;          // steps staged between the block's barriers
constexpr bool kPairs = false;      // the inverses' leaves by pivot pairs
constexpr int kSW = kWarps + 1;     // a staged row's floats
constexpr int kStep = kW * kSW;     // a staged step's 16 rows

// F, Q and W padded to 16: F and W with zeros, Q with the identity on the
// padded diagonal.  Read in place (__grid_constant__).
struct FilterParams {
  float F[kW * kW];
  float Q[kW * kW];
  float W[kW * kW];
};

// The block's shared floats: F's parts, each chain's m, m_pred and h, two
// groups of staged evidence and two of staged means.
constexpr int kFloats = 3 * kFMat + kWarps * 3 * kW + 4 * kStaged * kStep;
constexpr int kSmemBytes = 4 * kFloats;
static_assert(kSmemBytes <= 48 * 1024,
              "a block's shared memory within the default 48 KB");

__global__ void __launch_bounds__(kThreads, kMinBlocks)
wide_filter_tc_kernel(const float* __restrict__ ys,
                      const float* __restrict__ m0,
                      const float* __restrict__ p0,
                      const float* __restrict__ hr_t,
                      float* __restrict__ means, float* __restrict__ mf,
                      float* __restrict__ pf, int64_t T, int64_t B, int d,
                      int dy, const __grid_constant__ FilterParams prm) {
  constexpr int S = kStaged;
  extern __shared__ __align__(16) float smem[];
  float* ft = smem;
  float* fh = ft + kFMat;
  float* fl = fh + kFMat;
  float* v_s = fl + kFMat;                  // per chain: m, m_pred, h
  float* xi_s = v_s + kWarps * 3 * kW;      // two groups of S steps
  float* out_s = xi_s + 2 * S * kStep;      // two groups of S steps
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int g = lane >> 2, t = lane & 3;
  load_f(ft, fh, fl, prm.F);
  const int my_row = g + 8 * (t & 1);   // the row of m v this lane keeps
  const bool writer = t < 2;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * kWarps;
  const int64_t b_raw = b0 + warp;
  const bool valid = b_raw < B;
  const int64_t b = valid ? b_raw : B - 1;
  float* mv = v_s + warp * 3 * kW;
  float* mp = mv + kW;
  float* hv = mp + kW;

  // XI = HR Y of step s for the block's chains into its staged rows (row
  // r, column chain): lane (g, t) holds HR's rows g, g + 8 and chain g's
  // observations at k = t, t + 4 of a k tile, and gets XI's rows g, g + 8
  // at chains 2t, 2t + 1.  Chains past B read the last chain's
  // observations; steps past T are not formed.
  const int64_t bg = b0 + g < B ? b0 + g : B - 1;
  auto evidence = [&](int64_t s, float* dst) {
    if (s >= T) return;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const float* yt = ys + s * dy * B + bg;
    for (int k0 = 0; k0 < dy; k0 += 8) {
      const int k1 = k0 + t, k2 = k1 + 4;
      const float a[4] = {
          k1 < dy && g < d ? hr_t[k1 * d + g] : 0.0f,
          k1 < dy && g + 8 < d ? hr_t[k1 * d + g + 8] : 0.0f,
          k2 < dy && g < d ? hr_t[k2 * d + g] : 0.0f,
          k2 < dy && g + 8 < d ? hr_t[k2 * d + g + 8] : 0.0f};
      const float y1 = k1 < dy ? yt[k1 * B] : 0.0f;
      const float y2 = k2 < dy ? yt[k2 * B] : 0.0f;
      uint32_t ah[4], al[4], bh[2], bl[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) tc::split(a[i], ah[i], al[i]);
      tc::split(y1, bh[0], bl[0]);
      tc::split(y2, bh[1], bl[1]);
      tc::mma3(acc, ah, al, bh, bl);
    }
    dst[g * kSW + 2 * t] = acc[0];
    dst[g * kSW + 2 * t + 1] = acc[1];
    dst[(g + 8) * kSW + 2 * t] = acc[2];
    dst[(g + 8) * kSW + 2 * t + 1] = acc[3];
  };
  // a group's staged means out, a row of the block's chains at a time
  const int col = threadIdx.x % kWarps, row = threadIdx.x / kWarps;
  auto flush_group = [&](int64_t grp) {
    if (b0 + col >= B || row >= d) return;
#pragma unroll
    for (int u = 0; u < S; ++u) {
      const int64_t s = grp * S + u;
      if (s < T)
        means[(s * d + row) * B + b0 + col] =
            out_s[((grp & 1) * S + u) * kStep + row * kSW + col];
    }
  };

  // the state handed in: the posterior of the step before the stream, read
  // from its upper triangle; the padding an identity block
  if (lane < kW) mv[lane] = lane < d ? m0[lane * B + b] : 0.0f;
  Blk p, q, w;
  load_dense(q, prm.Q, g, t);
  load_dense(w, prm.W, g, t);
#pragma unroll
  for (int nj = 0; nj < 2; ++nj)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = frag_row(g, r), j = frag_col(t, nj, r);
      const int lo = i < j ? i : j, hi = i < j ? j : i;
      p[nj][r] = i < d && j < d ? p0[sym_slot(lo, hi, d) * B + b]
                                : (i == j ? 1.0f : 0.0f);
    }
  for (int u = warp; u < S; u += kWarps) evidence(u, xi_s + u * kStep);
  __syncthreads();

  for (int64_t step = 0; step < T; ++step) {
    const int64_t grp = step / S;
    const int sl = static_cast<int>(step - grp * S);
    if (sl == 0) {
      // the last group's means out and the next group's evidence in, while
      // this one is formed
      if (step > 0) flush_group(grp - 1);
      for (int u = warp; u < S; u += kWarps)
        evidence((grp + 1) * S + u,
                 xi_s + (((grp + 1) & 1) * S + u) * kStep);
    }
    const float* xst = xi_s + ((grp & 1) * S + sl) * kStep + warp;
    float* st = out_s + ((grp & 1) * S + sl) * kStep + warp;
    // m_pred = F m ; P_pred = (F P) F^T + Q
    if (lane < kW) mp[lane] = f_row_dot(ft, mv, lane);
    {
      Blk x;
      mul_f_m(x, fh, fl, p, g, t);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
#pragma unroll
        for (int r = 0; r < 4; ++r) p[nj][r] = q[nj][r];
      mul_a_ft<true>(p, x, fh, fl, g, t);
    }
    // L = P_pred^-1
    sym_inv_scaled<kPairs>(p, d, g, t, lane);
    __syncwarp();  // m_pred is in place
    // h = L m_pred + xi (a row a lane) ; L + W
    {
      float s[2];
      mat_vec(p, mp, t, s);
      const float x_row = my_row < d ? xst[my_row * kSW] : 0.0f;
      const float h_row = (t & 1 ? s[1] : s[0]) + x_row;
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
#pragma unroll
        for (int r = 0; r < 4; ++r) p[nj][r] += w[nj][r];
      if (writer) hv[my_row] = h_row;
    }
    // P = (L + W)^-1, its lower triangle the mirror of its upper ; m = P h
    sym_inv_scaled<kPairs>(p, d, g, t, lane);
    mirror_upper(p, g, t);
    __syncwarp();  // h is in place
    {
      float s[2];
      mat_vec(p, hv, t, s);
      const float m_row = t & 1 ? s[1] : s[0];
      if (writer) {
        mv[my_row] = m_row;
        if (my_row < d) st[my_row * kSW] = m_row;
      }
    }
    if (sl == S - 1 || step == T - 1) {
      __syncthreads();  // m, the staged means and evidence are in place
    } else {
      __syncwarp();     // m is in place
    }
  }
  flush_group((T - 1) / S);

  if (valid) {
    if (lane < d) mf[lane * B + b] = mv[lane];
#pragma unroll
    for (int nj = 0; nj < 2; ++nj)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = frag_row(g, r), j = frag_col(t, nj, r);
        if (i <= j && j < d) pf[sym_slot(i, j, d) * B + b] = p[nj][r];
      }
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
  const unsigned blocks = static_cast<unsigned>((B + kWarps - 1) / kWarps);
  wide_filter_tc_kernel<<<blocks, kThreads, kSmemBytes,
                          static_cast<cudaStream_t>(stream)>>>(
      ys, m0, p0, hr_t, means, mf, pf, T, B, d, dy, prm);
  return static_cast<int>(cudaGetLastError());
}

// The widest state the kernel takes (the padded dim).
int rxt_wide_filter_max_dim() { return kW; }

// The kernel's shape: chains a block (a chain a warp), steps staged
// between the block's barriers, whether the leaves sweep pivot pairs,
// shared bytes a block.
void rxt_wide_filter_shape(int* out) {
  out[0] = kWarps;
  out[1] = kStaged;
  out[2] = kPairs ? 1 : 0;
  out[3] = kSmemBytes;
}

// Blocks an SM holds of the kernel, or -1.
int rxt_wide_filter_blocks_per_sm() {
  int n = 0;
  const cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, wide_filter_tc_kernel, kThreads, kSmemBytes);
  return rc == cudaSuccess ? n : -1;
}

const char* rxt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

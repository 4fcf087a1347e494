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
// Design: a chain on a whole warp.  Its two d x d matrices (P and a work
// matrix) live in memory, not in registers: rows at a padded stride S
// (the dim padded to dp, a multiple of 8, and S = dp + 4, so a row is whole
// float4s and a column read spreads over 8 banks), the padding zero.  Lane
// l owns columns l, l + 32, ... (ceil(d / 32) of them; the matrices of the
// step are symmetric, so a column is a row).  A product C = A B has lane l
// accumulate column j of C for 8 rows at a time: A's rows are read as
// float4 broadcasts, B's row k as 32 neighbouring floats (no bank
// conflict); a symmetric product computes the upper triangle and writes
// each entry to (i, j) and (j, i).  The inverses are the scaled
// Gauss-Jordan sweep of the wide kernels (wide_rows.cuh
// sym_inv_scaled_rows: scale by the mean |diagonal|, d unpivoted pivots in
// series, the upper triangle kept and mirrored), column by column: the
// pivot's column is copied to a vector first, then each lane updates its
// own columns with the pivot row's entry of that column.  While a lane has
// one column of at most 32 rows (d <= 32) and the parameters are shared,
// the inverses hold that column in registers instead and the pivot's lane
// stores its column for the others to read (same arithmetic, same bits).
// The plain version inverts by a Schur recursion, so the two differ in
// rounding only.
// F, F^T, Q and W, shared by every chain, come from one device tensor (4
// padded matrices); they are copied to the block's shared memory while they
// fit beside one chain, else read from device memory through L1.  A
// chain's two matrices sit in shared memory while one chain fits a block,
// else in a device-memory scratch (a slot a warp), so no d has a cap.  The
// host-side rule that picks the tier and the chains a block is
// ops/fused_filter.py `warp_plan`; the launcher recomputes the shared bytes
// from it (rxt_warp_filter_smem_bytes) and refuses more than the device's
// opt-in limit.  The evidence is formed here as in fused_filter_wide.cu:
// lane l sums xi_j = HR[j][0] y[0] + HR[j][1] y[1] + ... in k order,
// reading HR's row j as column j of HR^T (dy, d) from device memory, the
// step's observations staged in shared memory kYChunk at a time: dy has no
// cap.
//
// What bounds it: at path A's (B, T, d, dy) = (10,000, 200, 32, 32) the
// operations of the plain step (3.49e11, counted on stand-ins) take 5.21 ms
// at the float32 rate and the bytes (0.557 GB) 0.17 ms, so on paper the
// operations.  This kernel is bound by its shared-memory instructions
// instead: the sweep in memory loads and stores an entry for each
// multiply-add (with the column in registers, two instructions for four),
// the products load 0.375 words a multiply-add, and a warp of one chain
// has one dependent chain of d pivots.  Tensor cores for the d^3 products,
// and registers for the inverses past d = 32, are later work (ROADMAP).
//
// A chain index past B runs on the last chain's inputs and stores nothing,
// so every lane reaches every __syncwarp.

#include <cuda_runtime.h>

#include <stdint.h>

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

// sym_inv_scaled with a lane's column in registers, for dp <= 32 (a column
// a lane): the same arithmetic in the same order, so the same bits.  At
// each pivot k lane k stores its column to `v` (dp floats) and every lane
// reads it back as float4 broadcasts: two shared-memory instructions for
// four rows, where the sweep in memory loads and stores each entry.  The
// pivots are unrolled so that a column's entries stay registers.
__device__ __forceinline__ void sym_inv_scaled_reg(float* m, float* v, int d,
                                                   int dp, int s, int lane) {
  const float inv_s = inverse_scale(m, d, s, lane);
  const bool col = lane < d;
  float a[kLanes];
#pragma unroll
  for (int i = 0; i < kLanes; ++i)
    a[i] = col && i < d ? m[i * s + lane] * inv_s : 0.0f;
#pragma unroll
  for (int k = 0; k < kLanes; ++k) {
    if (k >= d) break;
    __syncwarp();  // every lane is done with the last pivot's column
    if (lane == k) {
#pragma unroll
      for (int q = 0; q < kLanes / 4; ++q)
        if (4 * q < dp)
          reinterpret_cast<float4*>(v)[q] =
              make_float4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]);
    }
    __syncwarp();
    const float p = 1.0f / v[k];
    const bool pc = lane == k;
    const float qj = a[k] * p;
#pragma unroll
    for (int q = 0; q < kLanes / 4; ++q) {
      if (4 * q >= dp) break;
      const float4 fv = reinterpret_cast<const float4*>(v)[q];
      const float f[4] = {fv.x, fv.y, fv.z, fv.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = 4 * q + u;
        a[i] = i == k ? (pc ? p : qj)
                      : (pc ? -f[u] * p : fmaf(-f[u], qj, a[i]));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kLanes; ++i)
    if (col && i <= lane) m[i * s + lane] = a[i] * inv_s;
  mirror_upper(m, d, s, lane);
}

// Floats of the per-chain vectors: m, m_pred, h, a pivot column, the
// observation chunk.
__host__ __device__ constexpr int vec_floats(int dp) {
  return 4 * dp + kYChunk;
}

// REG_INVERSE: the inverses with a lane's column in registers (dp <= 32).
template <bool PARAMS_SHARED, bool CHAIN_SHARED, bool REG_INVERSE>
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
    if (REG_INVERSE)
      sym_inv_scaled_reg(pm, cv, d, dp, s, lane);
    else
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
    if (REG_INVERSE)
      sym_inv_scaled_reg(xm, cv, d, dp, s, lane);
    else
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

template <bool PS, bool CS, bool RI>
int launch(const float* ys, const float* m0, const float* p0,
           const float* hr_t, const float* params, float* means, float* mf,
           float* pf, float* scratch, int64_t T, int64_t B, int d, int dy,
           int dp, int s, int chains, int64_t bytes, cudaStream_t stream) {
  if (bytes > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        warp_filter_kernel<PS, CS, RI>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const unsigned blocks = static_cast<unsigned>((B + chains - 1) / chains);
  warp_filter_kernel<PS, CS, RI><<<blocks, chains * kLanes, bytes, stream>>>(
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
// rest device pointers.  dp a multiple of 8 >= d, s a multiple of 4 > dp;
// reg_inverse only with the parameters shared and dp <= 32.
int rxt_warp_filter(int d, int dy, const float* ys, const float* m0,
                    const float* p0, const float* hr_t, const float* params,
                    float* means, float* mf, float* pf, float* scratch,
                    int64_t T, int64_t B, int dp, int s, int chains,
                    int params_shared, int chain_shared, int reg_inverse,
                    void* stream) {
  if (d < 1 || dy < 1 || T < 1 || B < 1 || dp < d || dp % 8 != 0 ||
      s % 4 != 0 || s <= dp || chains < 1 || chains > kMaxChains ||
      (params_shared && !chain_shared) || (!chain_shared && !scratch) ||
      (reg_inverse && (!params_shared || dp > kLanes)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t bytes =
      smem_bytes(dp, s, chains, params_shared != 0, chain_shared != 0);
  if (bytes > smem_optin()) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (reg_inverse)
    return launch<true, true, true>(ys, m0, p0, hr_t, params, means, mf, pf,
                                    scratch, T, B, d, dy, dp, s, chains,
                                    bytes, st);
  if (params_shared)
    return launch<true, true, false>(ys, m0, p0, hr_t, params, means, mf, pf,
                                     scratch, T, B, d, dy, dp, s, chains,
                                     bytes, st);
  if (chain_shared)
    return launch<false, true, false>(ys, m0, p0, hr_t, params, means, mf,
                                      pf, scratch, T, B, d, dy, dp, s, chains,
                                      bytes, st);
  return launch<false, false, false>(ys, m0, p0, hr_t, params, means, mf, pf,
                                     scratch, T, B, d, dy, dp, s, chains,
                                     bytes, st);
}

const char* rxt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

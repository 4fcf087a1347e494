// Pieces shared by the HMM forward-backward sources: fused_fb.cu (K4/K5 for
// K = 1..8, a chain on P lanes, every state index a compile-time constant)
// and fused_fb_wide.cu (K >= 9, a chain on a warp).  Both compute the plain
// versions of rxinfer_tpu_torch/ops/fused_fb.py in their order; what they
// share is that order's log-sum-exp, the cp.async copies that stage the
// evidence in shared memory, and the kernel that sums the marginal pass's
// per-tile xi partials in tile order.

#pragma once

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kTileSteps = 32;  // steps of a staged time tile
constexpr int kStages = 3;      // tiles in the shared-memory ring

// log-sum-exp of N terms in the TPU kernel's order.
template <int N>
__device__ __forceinline__ float lse(const float (&t)[N]) {
  float m = t[0];
#pragma unroll
  for (int i = 1; i < N; ++i) m = fmaxf(m, t[i]);
  float s = expf(t[0] - m);
#pragma unroll
  for (int i = 1; i < N; ++i) s += expf(t[i] - m);
  return m + logf(s);
}

// The same over the first n <= N terms (n a runtime count; the loops are
// unrolled to N and the terms past n are skipped).
template <int N>
__device__ __forceinline__ float lse(const float (&t)[N], int n) {
  float m = t[0];
#pragma unroll
  for (int i = 1; i < N; ++i)
    if (i < n) m = fmaxf(m, t[i]);
  float s = expf(t[0] - m);
#pragma unroll
  for (int i = 1; i < N; ++i)
    if (i < n) s += expf(t[i] - m);
  return m + logf(s);
}

// ---- the evidence ring's copies ----------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const float* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's most recent groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- K5 (c): xi_sum from the partials, summed in tile order ----------------
__global__ void __launch_bounds__(256)
    fb_xisum_kernel(const float* __restrict__ part, float* __restrict__ xi_sum,
                    int64_t tiles, int64_t n) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float acc = 0.0f;
  for (int64_t s = 0; s < tiles; ++s) acc += part[s * n + idx];
  xi_sum[idx] = acc;
}

inline unsigned grid_for(int64_t n, int per_block) {
  return static_cast<unsigned>((n + per_block - 1) / per_block);
}

}  // namespace

// Entry points of the register smoother kernels (fused_smoother.cuh) with
// bf16 moments: the filtered and smoothed packed covariances and the cross
// in bf16, rounded to nearest even (the JAX kernels' moment_dtype=bfloat16,
// rxinfer_tpu/ops/pallas_smoother.py:127, 194, 196, 252, 271-272).

#include "fused_smoother.cuh"

extern "C" {

// Each launcher returns the first CUDA error of its launches (0 = success).
// The time axis is cut into S blocks of L steps (the last one ragged):
// S = ceil(T / L).  scratch holds S * rows * B floats, rows = d*d + 3 d +
// 3 nsym forward and d*d + 2 d + 2 nsym backward (FwdSlot, BwdSlot), and
// may be null when S == 1.  wdyn / qdyn are the (nsym, B) per-chain tiles
// of W / Q, or null where the parameter is shared; F, b, Q, W are read for
// the parameters that are shared.  The backward pass reads Q only.  pf, ps
// and cross hold bf16 (round to nearest even).
int rxt_fused_smoother_fwd(int d, const float* xi, const float* m0,
                           const float* p0, float* mf, void* pf, int64_t T,
                           int64_t B, const float* F, const float* bvec,
                           const float* Q, const float* W,
                           const float* wdyn, const float* qdyn, int64_t L,
                           int64_t S, float* scratch, void* stream) {
  return fwd_entry<__nv_bfloat16>(d, xi, m0, p0, mf, pf, T, B, F, bvec, Q, W, wdyn,
                        qdyn, L, S, scratch, stream);
}

int rxt_fused_smoother_bwd(int d, const float* mf, const void* pf,
                           float* ms, void* ps, void* cross, int64_t T,
                           int64_t B, const float* F, const float* bvec,
                           const float* Q, const float* qdyn, int64_t L,
                           int64_t S, float* scratch, void* stream) {
  return bwd_entry<__nv_bfloat16>(d, mf, pf, ms, ps, cross, T, B, F, bvec, Q, qdyn, L,
                        S, scratch, stream);
}

// Largest d with a fold and a carry kernel; above it only S == 1 launches.
int rxt_fused_smoother_fold_max_dim() { return kFoldMaxDim; }

// Bytes of one stored moment entry: 4 (float32) or 2 (bf16).
int rxt_fused_smoother_moment_bytes() { return sizeof(__nv_bfloat16); }

const char* rxt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

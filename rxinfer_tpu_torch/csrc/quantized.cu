// Quantized observation payloads for Hopper (sm_90a): per-row int8 and
// fp8 (e4m3) quantization, and the fused dequantize + small matrix product.
//
// Replaces the TPU kernels of rxinfer_tpu/ops/quantized.py:
//   quantize_kernel<int8>   `_quantize_kernel`        (lines 50-56)
//   quantize_kernel<fp8>    `_quantize_fp8_kernel`    (lines 153-158)
//   dequant_matmul_kernel   `_dequant_matmul_kernel`  (lines 107-109)
// The arithmetic is that of the plain versions in
// rxinfer_tpu_torch/ops/quantized.py.
//
// Quantization, per row of x (R, C):
//   absmax = max_c |x[r, c]| ; scale = max(absmax, 1e-12) / M
//   int8: vals = clip(rint(x / scale), -127, 127), M = 127
//   fp8 : vals = e4m3(x / scale),                  M = 448
// Rounding is to nearest, ties to even, in both (rintf; the e4m3 conversion
// of cuda_fp8.h); x / scale is an IEEE division, never a multiplication by a
// reciprocal, so payloads agree with the plain version at ties.  A zero row
// gives scale = 1e-12 / M and a zero payload.  |x / scale| <= M by
// construction, so the saturating conversion never saturates.
//
// Design (quantize): a group of G lanes per row, G the power of two that
// covers min(C, 32): a whole warp for a wide row, 32 / G rows per warp for a
// narrow one.  Lanes stride the columns, the row maximum goes through
// __shfl_xor_sync inside the group, and a second pass over the row writes
// the payload.  Bound on the card: the bytes (4 in, 1 out per element);
// the second pass re-reads the row, from L2 when it is still there.
//
// Dequantize + product: out (R, dx) = (float(vals) * scales) @ W, W (dy, dx).
// One thread per output element, W in shared memory, the payload
// dequantized in registers, float32 multiplies and adds in index order over
// dy (each rounded on its own, as the plain version does), the store
// coalesced.  The dx threads of a row read the same payload bytes
// (served by L1).  Bound on the card: the bytes (dy + 4 in, 4 dx out per
// row).

#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

struct Int8Payload {
  using storage = int8_t;
  static constexpr float kMax = 127.0f;
  static __device__ __forceinline__ storage encode(float v) {
    const float q = fminf(fmaxf(rintf(v), -127.0f), 127.0f);
    return static_cast<int8_t>(__float2int_rn(q));
  }
  static __device__ __forceinline__ float decode(storage v) {
    return static_cast<float>(v);
  }
};

struct Fp8Payload {
  using storage = uint8_t;
  static constexpr float kMax = 448.0f;
  static __device__ __forceinline__ storage encode(float v) {
    return __nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E4M3);
  }
  static __device__ __forceinline__ float decode(storage v) {
    // e4m3 -> half -> float, both exact
    return __half2float(__half(__nv_cvt_fp8_to_halfraw(v, __NV_E4M3)));
  }
};

constexpr int kThreads = 256;

// ---- K6 / K7: per-row quantization -------------------------------------------
template <typename P>
__global__ void quantize_kernel(const float* __restrict__ x,
                                typename P::storage* __restrict__ vals,
                                float* __restrict__ scales, int64_t R,
                                int64_t C, int group) {
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int rows_per_warp = 32 / group;
  const int64_t row = warp * rows_per_warp + lane / group;
  const int gl = lane % group;
  // every lane of the warp takes part in the shuffles; lanes past the last
  // row read nothing and write nothing
  const bool live = row < R;
  const float* xr = x + row * C;

  float amax = 0.0f;
  if (live) {
#pragma unroll 4
    for (int64_t c = gl; c < C; c += group) amax = fmaxf(amax, fabsf(xr[c]));
  }
  for (int off = group >> 1; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if (!live) return;
  const float scale = fmaxf(amax, 1e-12f) / P::kMax;
  if (gl == 0) scales[row] = scale;
  typename P::storage* vr = vals + row * C;
#pragma unroll 4
  for (int64_t c = gl; c < C; c += group) vr[c] = P::encode(xr[c] / scale);
}

template <typename P>
int launch_quantize(const float* x, void* vals, float* scales, int64_t R,
                    int64_t C, cudaStream_t stream) {
  int group = 1;
  while (group < 32 && group < C) group <<= 1;
  const int64_t rows_per_block = (kThreads / 32) * (32 / group);
  const unsigned blocks =
      static_cast<unsigned>((R + rows_per_block - 1) / rows_per_block);
  quantize_kernel<P><<<blocks, kThreads, 0, stream>>>(
      x, static_cast<typename P::storage*>(vals), scales, R, C, group);
  return static_cast<int>(cudaGetLastError());
}

// ---- K8: dequantize + product ----------------------------------------------------
template <typename P>
__global__ void dequant_matmul_kernel(
    const typename P::storage* __restrict__ vals,
    const float* __restrict__ scales, const float* __restrict__ w,
    float* __restrict__ out, int64_t R, int dy, int dx) {
  extern __shared__ float w_s[];
  for (int i = threadIdx.x; i < dy * dx; i += blockDim.x) w_s[i] = w[i];
  __syncthreads();
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= R * dx) return;
  const int64_t r = idx / dx;
  const int j = static_cast<int>(idx - r * dx);
  const float s = scales[r];
  const typename P::storage* vr = vals + r * dy;
  // each product and each sum rounded on its own (no fused multiply-add), so
  // the result equals the plain version's bit for bit; the kernel is bound
  // by its bytes, so the unfused form costs no time
  float acc = __fmul_rn(__fmul_rn(P::decode(vr[0]), s), w_s[j]);
  for (int k = 1; k < dy; ++k)
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(P::decode(vr[k]), s),
                                   w_s[k * dx + j]));
  out[idx] = acc;
}

template <typename P>
int launch_dequant_matmul(const void* vals, const float* scales,
                          const float* w, float* out, int64_t R, int dy,
                          int dx, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(dy) * dx * sizeof(float);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = R * dx;
  const unsigned blocks =
      static_cast<unsigned>((total + kThreads - 1) / kThreads);
  dequant_matmul_kernel<P><<<blocks, kThreads, smem, stream>>>(
      static_cast<const typename P::storage*>(vals), scales, w, out, R, dy,
      dx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each launcher returns cudaGetLastError() after its launch (0 = success).
// `fp8` selects the payload type: 0 = int8, 1 = float8 e4m3 (as bytes).
int rxt_quantize_rows(int fp8, const float* x, void* vals, float* scales,
                      int64_t R, int64_t C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fp8 ? launch_quantize<Fp8Payload>(x, vals, scales, R, C, s)
             : launch_quantize<Int8Payload>(x, vals, scales, R, C, s);
}

int rxt_dequant_matmul(int fp8, const void* vals, const float* scales,
                       const float* w, float* out, int64_t R, int dy, int dx,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fp8 ? launch_dequant_matmul<Fp8Payload>(vals, scales, w, out, R, dy,
                                                 dx, s)
             : launch_dequant_matmul<Int8Payload>(vals, scales, w, out, R, dy,
                                                  dx, s);
}

const char* rxt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Quantized observation payloads for Hopper (sm_90a): per-row int8 and
// fp8 (e4m3) quantization, and the fused dequantize + small matrix product.
//
// Replaces the TPU kernels of rxinfer_tpu/ops/quantized.py:
//   K6  quantize_*_kernel<Int8Payload>  `_quantize_kernel`        (line 50)
//   K7  quantize_*_kernel<Fp8Payload>   `_quantize_fp8_kernel`    (line 153)
//   K8  dequant_matmul_kernel           `_dequant_matmul_kernel`  (lines 107-109)
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
// construction, so the saturating conversion never saturates.  A maximum is
// exact in any order, so every reduction tree below gives the plain
// version's scale bits.
//
// K6 / K7 are bound by their bytes: (4 + 1) per element in and out, and 4
// per row for the scale; a few operations an element are far below the
// card's rate.  So each variant is built to read every row from device
// memory once, in 16-byte loads, with enough loads in flight per SM to cover
// the memory latency, and to write the payload in packed 4-byte stores.
// The wrapper's rule (`pick_quant_layout`, ops/quantized.py) picks the
// variant before the launch:
//   narrow  (C % 4 == 0, 16-byte aligned rows, C <= 1024; the ingest rows
//           (R, 16)): G lanes a row, V float4 a lane (C <= 128: G = C/4
//           rounded up to a power of two, V = 1, 32/G rows a warp; up to
//           1024: a warp a row, V = 2, 4 or 8).  Each thread takes U row
//           groups of its warp's span (U = 4 where rows are plenty, V = 1)
//           and starts all its loads before the first reduction; the row
//           stays in registers between the maximum (log2 G shuffles) and
//           the encode, and each lane stores four payload bytes as one
//           32-bit word: at C = 16 a warp reads 512 contiguous bytes and
//           writes 128 a row group.  Offsets inside a warp's span are
//           32-bit; the span's base is one 64-bit product a warp.
//   wide    (C % 4 == 0, aligned, 1024 < C <= 16384; the engine's rows
//           (B*F, T)): one CTA of 256 threads a row, V float4 a thread held
//           in registers, the maximum by warp shuffles and one shared-memory
//           step across the 8 warps, then the encode from registers and
//           packed 4-byte stores.  Each row is read from device memory once
//           (the two-pass kernel reads it twice, and rows that outgrow the
//           50 MB L2 come from HBM both times).
//   general (any other rows: C % 4 != 0, misaligned views, C > 16384): a
//           group of G lanes a row (G the power of two covering min(C, 32)),
//           lanes striding the columns, and a second pass over the row for
//           the payload, re-reading it (from L2 where it still is).
//
// Dequantize + product: out (R, dx) = (float(vals) * scales) @ W, W (dy, dx).
// Bound on the card by its bytes: dy + 4 in and 4 dx out a row, 36 at the
// ingest rows (2^21, 16) -> 4, against dy + 2 dy dx operations.  So, as
// for K6 / K7, every payload row is read from device memory once, in
// 16-byte loads where the rows allow, by a thread that takes U rows
// (`pick_dequant_layout`, ops/quantized.py):
//   vector  (dy % 16 == 0, dx % 4 == 0, payload and output 16-byte aligned;
//           the ingest rows): 16-byte payload loads, float4 output stores,
//           U = 4 where rows are plenty, so each thread has several loads
//           in flight, else 1.
//   general (any other rows: odd dy or dx, misaligned views): a thread a
//           row, byte loads, scalar stores.
// W sits in a block's shared memory whole while it fits the device's opt-in
// limit (232,448 bytes on an H100; above 48 KB the launcher opts in), as
// the TPU kernel holds it whole in VMEM.  A larger W is staged in tiles
// (dequant_matmul_tiled_kernel): each block takes four output columns and
// walks dy in row tiles of as many rows as fit, its sums carried across
// them; the column tiles of one block of rows are neighbouring blocks, so
// they read its payload from L2, not each from device memory.  The
// host-side rule is ops/quantized.py `dequant_tiles`; the launcher computes
// the same and refuses another plan.  Row indices are 64-bit products and
// sums; no thread divides but the tiled kernel's block index, once.

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
constexpr int kWideThreads = 256;
constexpr int kWideWarps = kWideThreads / 32;

// variants, as ops/quantized.py numbers them
constexpr int kGeneral = 0;
constexpr int kNarrow = 1;
constexpr int kWide = 2;

__device__ __forceinline__ float absmax4(float m, float4 v) {
  return fmaxf(fmaxf(fmaxf(m, fabsf(v.x)), fmaxf(fabsf(v.y), fabsf(v.z))),
               fabsf(v.w));
}

// the four payload bytes of x[0..3] / scale, x[0] in the lowest byte
template <typename P>
__device__ __forceinline__ uint32_t encode4(float4 v, float scale) {
  const uint32_t b0 = static_cast<uint8_t>(P::encode(v.x / scale));
  const uint32_t b1 = static_cast<uint8_t>(P::encode(v.y / scale));
  const uint32_t b2 = static_cast<uint8_t>(P::encode(v.z / scale));
  const uint32_t b3 = static_cast<uint8_t>(P::encode(v.w / scale));
  return b0 | (b1 << 8) | (b2 << 16) | (b3 << 24);
}

// ---- K6 / K7, narrow rows: G lanes a row, V float4 a lane, U row groups ------
// a thread.  Lane gl of a row takes the float4 gl, gl + G, ..., gl + (V-1) G.
template <typename P, int G, int U, int V>
__global__ void __launch_bounds__(kThreads)
quantize_narrow_kernel(const float* __restrict__ x,
                       typename P::storage* __restrict__ vals,
                       float* __restrict__ scales, int64_t R, int C) {
  constexpr int kRowsPerWarp = 32 / G;
  constexpr int kSpan = U * kRowsPerWarp;           // rows a warp takes
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int64_t row0 = warp * kSpan;
  if (row0 >= R) return;                            // the whole warp
  const int64_t left = R - row0;
  const int rows = left < kSpan ? static_cast<int>(left) : kSpan;
  const int gl = lane % G;                          // G is a power of two
  const int sub = lane / G;
  const float* xw = x + row0 * C;
  uint8_t* vw = reinterpret_cast<uint8_t*>(vals) + row0 * C;

  float4 v[U][V];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int r = u * kRowsPerWarp + sub;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int c = 4 * (gl + k * G);
      v[u][k] = (c < C && r < rows)
                    ? *reinterpret_cast<const float4*>(xw + r * C + c)
                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int r = u * kRowsPerWarp + sub;
    float amax = 0.0f;
#pragma unroll
    for (int k = 0; k < V; ++k) amax = absmax4(amax, v[u][k]);
#pragma unroll
    for (int off = G >> 1; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    if (r < rows) {
      const float scale = fmaxf(amax, 1e-12f) / P::kMax;
      if (gl == 0) scales[row0 + r] = scale;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int c = 4 * (gl + k * G);
        if (c < C)
          *reinterpret_cast<uint32_t*>(vw + r * C + c) =
              encode4<P>(v[u][k], scale);
      }
    }
  }
}

// ---- K6 / K7, wide rows: a CTA a row, V float4 a thread ----------------------
template <typename P, int V>
__global__ void __launch_bounds__(kWideThreads)
quantize_wide_kernel(const float* __restrict__ x,
                     typename P::storage* __restrict__ vals,
                     float* __restrict__ scales, int C) {
  __shared__ float warp_max[kWideWarps];
  const int64_t row = blockIdx.x;
  const float4* xr = reinterpret_cast<const float4*>(x + row * C);
  uint32_t* vr = reinterpret_cast<uint32_t*>(
      reinterpret_cast<uint8_t*>(vals) + row * C);
  const int nv = C >> 2;

  float4 v[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int i = threadIdx.x + k * kWideThreads;
    v[k] = i < nv ? xr[i] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  float amax = 0.0f;
#pragma unroll
  for (int k = 0; k < V; ++k) amax = absmax4(amax, v[k]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = amax;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWideWarps; ++w) amax = fmaxf(amax, warp_max[w]);
  const float scale = fmaxf(amax, 1e-12f) / P::kMax;
  if (threadIdx.x == 0) scales[row] = scale;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int i = threadIdx.x + k * kWideThreads;
    if (i < nv) vr[i] = encode4<P>(v[k], scale);
  }
}

// ---- K6 / K7, any rows: G lanes a row, two passes ----------------------------
template <typename P, int G>
__global__ void __launch_bounds__(kThreads)
quantize_general_kernel(const float* __restrict__ x,
                        typename P::storage* __restrict__ vals,
                        float* __restrict__ scales, int64_t R, int64_t C) {
  constexpr int kRowsPerWarp = 32 / G;
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int64_t row = warp * kRowsPerWarp + lane / G;
  const int gl = lane % G;
  // every lane of the warp takes part in the shuffles; lanes past the last
  // row read nothing and write nothing
  const bool live = row < R;
  const float* xr = x + row * C;

  float amax = 0.0f;
  if (live) {
#pragma unroll 4
    for (int64_t c = gl; c < C; c += G) amax = fmaxf(amax, fabsf(xr[c]));
  }
#pragma unroll
  for (int off = G >> 1; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if (!live) return;
  const float scale = fmaxf(amax, 1e-12f) / P::kMax;
  if (gl == 0) scales[row] = scale;
  typename P::storage* vr = vals + row * C;
#pragma unroll 4
  for (int64_t c = gl; c < C; c += G) vr[c] = P::encode(xr[c] / scale);
}

template <typename P, int G, int U, int V>
int launch_narrow(const float* x, void* vals, float* scales, int64_t R,
                  int64_t C, cudaStream_t stream) {
  constexpr int64_t kRowsPerBlock = (kThreads / 32) * U * (32 / G);
  const unsigned blocks =
      static_cast<unsigned>((R + kRowsPerBlock - 1) / kRowsPerBlock);
  quantize_narrow_kernel<P, G, U, V><<<blocks, kThreads, 0, stream>>>(
      x, static_cast<typename P::storage*>(vals), scales, R,
      static_cast<int>(C));
  return static_cast<int>(cudaGetLastError());
}

template <typename P, int V>
int launch_wide(const float* x, void* vals, float* scales, int64_t R,
                int64_t C, cudaStream_t stream) {
  quantize_wide_kernel<P, V><<<static_cast<unsigned>(R), kWideThreads, 0,
                               stream>>>(
      x, static_cast<typename P::storage*>(vals), scales,
      static_cast<int>(C));
  return static_cast<int>(cudaGetLastError());
}

template <typename P, int G>
int launch_general(const float* x, void* vals, float* scales, int64_t R,
                   int64_t C, cudaStream_t stream) {
  constexpr int64_t kRowsPerBlock = (kThreads / 32) * (32 / G);
  const unsigned blocks =
      static_cast<unsigned>((R + kRowsPerBlock - 1) / kRowsPerBlock);
  quantize_general_kernel<P, G><<<blocks, kThreads, 0, stream>>>(
      x, static_cast<typename P::storage*>(vals), scales, R, C);
  return static_cast<int>(cudaGetLastError());
}

// The variant's instance, or cudaErrorInvalidValue for a combination the
// rule never picks (the wrapper raises on it).
template <typename P, int U>
int launch_narrow_g(int group, const float* x, void* vals, float* scales,
                    int64_t R, int64_t C, cudaStream_t s) {
  switch (group) {
    case 1: return launch_narrow<P, 1, U, 1>(x, vals, scales, R, C, s);
    case 2: return launch_narrow<P, 2, U, 1>(x, vals, scales, R, C, s);
    case 4: return launch_narrow<P, 4, U, 1>(x, vals, scales, R, C, s);
    case 8: return launch_narrow<P, 8, U, 1>(x, vals, scales, R, C, s);
    case 16: return launch_narrow<P, 16, U, 1>(x, vals, scales, R, C, s);
    case 32: return launch_narrow<P, 32, U, 1>(x, vals, scales, R, C, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename P>
int launch_quantize(int variant, int group, int rows_per_thread, int vecs,
                    const float* x, void* vals, float* scales, int64_t R,
                    int64_t C, cudaStream_t s) {
  const bool vec_ok = C % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(vals) % 16 == 0;
  if (variant == kNarrow) {
    if (!vec_ok || C > 4 * group * vecs)
      return static_cast<int>(cudaErrorInvalidValue);
    if (vecs == 1 && rows_per_thread == 1)
      return launch_narrow_g<P, 1>(group, x, vals, scales, R, C, s);
    if (vecs == 1 && rows_per_thread == 4)
      return launch_narrow_g<P, 4>(group, x, vals, scales, R, C, s);
    if (group == 32 && rows_per_thread == 1) {   // a warp a row
      switch (vecs) {
        case 2: return launch_narrow<P, 32, 1, 2>(x, vals, scales, R, C, s);
        case 4: return launch_narrow<P, 32, 1, 4>(x, vals, scales, R, C, s);
        case 8: return launch_narrow<P, 32, 1, 8>(x, vals, scales, R, C, s);
      }
    }
  } else if (variant == kWide) {
    if (!vec_ok || C > 4 * kWideThreads * vecs || R > INT32_MAX)
      return static_cast<int>(cudaErrorInvalidValue);
    switch (vecs) {
      case 2: return launch_wide<P, 2>(x, vals, scales, R, C, s);
      case 4: return launch_wide<P, 4>(x, vals, scales, R, C, s);
      case 8: return launch_wide<P, 8>(x, vals, scales, R, C, s);
      case 10: return launch_wide<P, 10>(x, vals, scales, R, C, s);
      case 12: return launch_wide<P, 12>(x, vals, scales, R, C, s);
      case 16: return launch_wide<P, 16>(x, vals, scales, R, C, s);
    }
  } else if (variant == kGeneral) {
    switch (group) {
      case 1: return launch_general<P, 1>(x, vals, scales, R, C, s);
      case 2: return launch_general<P, 2>(x, vals, scales, R, C, s);
      case 4: return launch_general<P, 4>(x, vals, scales, R, C, s);
      case 8: return launch_general<P, 8>(x, vals, scales, R, C, s);
      case 16: return launch_general<P, 16>(x, vals, scales, R, C, s);
      case 32: return launch_general<P, 32>(x, vals, scales, R, C, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---- K8: dequantize + product ---------------------------------------------
//
// A thread takes U rows of the payload, rows row0 + u * kThreads for
// u < U, so the threads of a warp read neighbouring rows: at dy = 16 a warp
// reads 512 contiguous payload bytes and 128 of scales, and writes 512 of
// output, in one instruction each.  VEC reads each row's payload in 16-byte
// loads and stores its outputs a float4 at a time; the general layout reads
// bytes and stores scalars.  A row's scale is read once, and the dx outputs
// of the row are formed in column chunks of 4 (dx = 4: one chunk, each
// payload byte read once).  W is staged once a block in shared memory and
// read as broadcasts, a float4 a chunk for VEC.  The product keeps the
// plain version's rounding: q = float(v) * s rounded, then for each column
// acc = q_0 w_0 and acc += q_k w_k in index order over k, every product and
// sum rounded on its own (__fmul_rn / __fadd_rn), so the kernel equals
// `dequant_matmul_reference` bit for bit.

// the four payload values of a 32-bit word, byte 0 first
__device__ __forceinline__ void decode4(Int8Payload, uint32_t word,
                                        float (&q)[4]) {
#pragma unroll
  for (int b = 0; b < 4; ++b)
    q[b] = static_cast<float>(static_cast<int8_t>(word >> (8 * b)));
}

__device__ __forceinline__ void decode4(Fp8Payload, uint32_t word,
                                        float (&q)[4]) {
  // e4m3 pairs -> half2 -> float2, all exact
  const __half2 lo = __half2(__nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(word & 0xffffu), __NV_E4M3));
  const __half2 hi = __half2(__nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(word >> 16), __NV_E4M3));
  const float2 a = __half22float2(lo);
  const float2 b = __half22float2(hi);
  q[0] = a.x; q[1] = a.y; q[2] = b.x; q[3] = b.y;
}

template <typename P, int U, bool VEC>
__global__ void __launch_bounds__(kThreads)
dequant_matmul_kernel(const uint8_t* __restrict__ vals,
                      const float* __restrict__ scales,
                      const float* __restrict__ w, float* __restrict__ out,
                      int64_t R, int dy, int dx) {
  constexpr int kChunk = VEC ? 16 : 1;     // payload bytes a load
  constexpr int kWords = VEC ? 4 : 1;      // 32-bit words a load
  constexpr int kPer = VEC ? 4 : 1;        // values a word holds
  extern __shared__ float w_s[];
  for (int i = threadIdx.x; i < dy * dx; i += kThreads) w_s[i] = w[i];
  __syncthreads();
  const int64_t row0 =
      static_cast<int64_t>(blockIdx.x) * (kThreads * U) + threadIdx.x;
  if (row0 >= R) return;
  float s[U];
  bool live[U];
  const uint8_t* vr[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int64_t r = row0 + u * kThreads;
    live[u] = r < R;
    s[u] = live[u] ? __ldg(scales + r) : 0.0f;
    vr[u] = vals + (live[u] ? r : row0) * dy;
  }
  for (int c = 0; c < dx; c += 4) {
    float acc[U][4] = {};
    for (int k0 = 0; k0 < dy; k0 += kChunk) {
      uint32_t ch[U][kWords];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if constexpr (VEC) {
          const uint4 v = live[u] ? __ldg(reinterpret_cast<const uint4*>(
                                        vr[u] + k0))
                                  : make_uint4(0u, 0u, 0u, 0u);
          ch[u][0] = v.x; ch[u][1] = v.y; ch[u][2] = v.z; ch[u][3] = v.w;
        } else {
          ch[u][0] = live[u] ? __ldg(vr[u] + k0) : 0u;
        }
      }
#pragma unroll
      for (int wi = 0; wi < kWords; ++wi) {
        float q[U][4];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if constexpr (VEC)
            decode4(P(), ch[u][wi], q[u]);
          else
            q[u][0] = P::decode(static_cast<typename P::storage>(ch[u][0]));
        }
#pragma unroll
        for (int b = 0; b < kPer; ++b) {
          const int k = k0 + wi * kPer + b;
          float wk[4];
          if constexpr (VEC) {
            const float4 v = *reinterpret_cast<const float4*>(w_s + k * dx + c);
            wk[0] = v.x; wk[1] = v.y; wk[2] = v.z; wk[3] = v.w;
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              wk[j] = c + j < dx ? w_s[k * dx + c + j] : 0.0f;
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const float qs = __fmul_rn(q[u][b], s[u]);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float p = __fmul_rn(qs, wk[j]);
              acc[u][j] = k == 0 ? p : __fadd_rn(acc[u][j], p);
            }
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!live[u]) continue;
      float* o = out + (row0 + u * kThreads) * dx + c;
      if constexpr (VEC) {
        *reinterpret_cast<float4*>(o) =
            make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < dx) o[j] = acc[u][j];
      }
    }
  }
}

// W in tiles: the rows of dequant_matmul_kernel's layout against output
// columns c .. c + 3 (the column tile is blockIdx.x % ceil(dx / 4), the
// block of rows blockIdx.x / ceil(dx / 4)), with dy walked in tiles of kt rows
// (a multiple of 16, so the vector layout's loads stay whole).  Each tile
// is staged in shared memory as kt rows of four floats (zero past dx) and
// read as float4 broadcasts; a thread's four sums per row are carried
// across the tiles, so every product and sum is rounded as in
// dequant_matmul_kernel and the plain version, in the same k order.  Rows
// past R run on row 0's payload and store nothing: every thread reaches
// every barrier.
constexpr int kTileCols = 4;

template <typename P, int U, bool VEC>
__global__ void __launch_bounds__(kThreads)
dequant_matmul_tiled_kernel(const uint8_t* __restrict__ vals,
                            const float* __restrict__ scales,
                            const float* __restrict__ w,
                            float* __restrict__ out, int64_t R, int dy,
                            int dx, int kt) {
  constexpr int kChunk = VEC ? 16 : 1;
  constexpr int kWords = VEC ? 4 : 1;
  constexpr int kPer = VEC ? 4 : 1;
  extern __shared__ float w_s[];
  const int ncol = (dx + kTileCols - 1) / kTileCols;
  const int c = static_cast<int>(blockIdx.x % ncol) * kTileCols;
  const int64_t row0 =
      static_cast<int64_t>(blockIdx.x / ncol) * (kThreads * U) + threadIdx.x;
  float s[U];
  bool live[U];
  const uint8_t* vr[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int64_t r = row0 + u * kThreads;
    live[u] = r < R;
    s[u] = live[u] ? __ldg(scales + r) : 0.0f;
    vr[u] = vals + (live[u] ? r : 0) * dy;
  }
  float acc[U][kTileCols] = {};
  for (int t0 = 0; t0 < dy; t0 += kt) {
    const int n = dy - t0 < kt ? dy - t0 : kt;
    __syncthreads();  // the block is done with the last tile
    for (int i = threadIdx.x; i < n * kTileCols; i += kThreads) {
      const int k = i / kTileCols, j = i % kTileCols;
      w_s[i] = c + j < dx ? w[static_cast<int64_t>(t0 + k) * dx + c + j]
                          : 0.0f;
    }
    __syncthreads();
    for (int k0 = 0; k0 < n; k0 += kChunk) {
      uint32_t ch[U][kWords];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if constexpr (VEC) {
          const uint4 v = live[u] ? __ldg(reinterpret_cast<const uint4*>(
                                        vr[u] + t0 + k0))
                                  : make_uint4(0u, 0u, 0u, 0u);
          ch[u][0] = v.x; ch[u][1] = v.y; ch[u][2] = v.z; ch[u][3] = v.w;
        } else {
          ch[u][0] = live[u] ? __ldg(vr[u] + t0 + k0) : 0u;
        }
      }
#pragma unroll
      for (int wi = 0; wi < kWords; ++wi) {
        float q[U][4];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if constexpr (VEC)
            decode4(P(), ch[u][wi], q[u]);
          else
            q[u][0] = P::decode(static_cast<typename P::storage>(ch[u][0]));
        }
#pragma unroll
        for (int b = 0; b < kPer; ++b) {
          const int k = k0 + wi * kPer + b;
          const float4 v =
              *reinterpret_cast<const float4*>(w_s + k * kTileCols);
          const float wk[kTileCols] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const float qs = __fmul_rn(q[u][b], s[u]);
#pragma unroll
            for (int j = 0; j < kTileCols; ++j) {
              const float p = __fmul_rn(qs, wk[j]);
              acc[u][j] = t0 + k == 0 ? p : __fadd_rn(acc[u][j], p);
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (!live[u]) continue;
    float* o = out + (row0 + u * kThreads) * dx + c;
    if constexpr (VEC) {
      *reinterpret_cast<float4*>(o) =
          make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
    } else {
#pragma unroll
      for (int j = 0; j < kTileCols; ++j)
        if (c + j < dx) o[j] = acc[u][j];
    }
  }
}

// layouts, as ops/quantized.py numbers them
constexpr int kDequantGeneral = 0;
constexpr int kDequantVector = 1;
constexpr int kTileRowAlign = 16;

int dequant_smem_optin() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return bytes;
}

// ops/quantized.py dequant_tiles: W whole while it fits `limit` bytes, else
// row tiles of four columns.
void dequant_tiles(int dy, int dx, int limit, int* kt, int* ct) {
  if (static_cast<int64_t>(dy) * dx * 4 <= limit) {
    *kt = dy;
    *ct = dx;
    return;
  }
  int rows = limit / (4 * kTileCols);
  rows -= rows % kTileRowAlign;
  *kt = dy < rows ? dy : rows;
  *ct = kTileCols;
}

template <class K>
int opt_in(K* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <typename P, int U, bool VEC>
int launch_dequant(const void* vals, const float* scales, const float* w,
                   float* out, int64_t R, int dy, int dx, int kt, int ct,
                   cudaStream_t stream) {
  const int64_t per_block = static_cast<int64_t>(kThreads) * U;
  const int64_t row_blocks = (R + per_block - 1) / per_block;
  const size_t smem = static_cast<size_t>(kt) * ct * sizeof(float);
  if (kt == dy && ct == dx) {  // W whole
    if (const int rc = opt_in(dequant_matmul_kernel<P, U, VEC>, smem)) return rc;
    const unsigned blocks = static_cast<unsigned>(row_blocks);
    dequant_matmul_kernel<P, U, VEC><<<blocks, kThreads, smem, stream>>>(
        static_cast<const uint8_t*>(vals), scales, w, out, R, dy, dx);
  } else {
    if (const int rc = opt_in(dequant_matmul_tiled_kernel<P, U, VEC>, smem))
      return rc;
    const int64_t all = row_blocks * ((dx + kTileCols - 1) / kTileCols);
    if (all > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    const unsigned blocks = static_cast<unsigned>(all);
    dequant_matmul_tiled_kernel<P, U, VEC><<<blocks, kThreads, smem, stream>>>(
        static_cast<const uint8_t*>(vals), scales, w, out, R, dy, dx, kt);
  }
  return static_cast<int>(cudaGetLastError());
}

// The layout's instance, or cudaErrorInvalidValue for a layout the kernel
// does not take (the wrapper raises on it): the vector layout on rows that
// are not whole 16-byte loads, dx % 4 != 0, or a payload or output that
// does not start on 16 bytes; W tiles other than dequant_tiles' at the
// device's limit; more blocks than a grid holds.
template <typename P>
int launch_dequant_matmul(int variant, int rows_per_thread, int kt, int ct,
                          const void* vals, const float* scales,
                          const float* w, float* out, int64_t R, int dy,
                          int dx, cudaStream_t s) {
  int want_kt = 0, want_ct = 0;
  dequant_tiles(dy, dx, dequant_smem_optin(), &want_kt, &want_ct);
  if (kt != want_kt || ct != want_ct || kt < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (variant == kDequantVector) {
    if (dy % 16 != 0 || dx % 4 != 0 ||
        reinterpret_cast<uintptr_t>(vals) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(out) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    if (rows_per_thread == 4)
      return launch_dequant<P, 4, true>(vals, scales, w, out, R, dy, dx, kt,
                                        ct, s);
    if (rows_per_thread == 1)
      return launch_dequant<P, 1, true>(vals, scales, w, out, R, dy, dx, kt,
                                        ct, s);
  }
  if (variant == kDequantGeneral && rows_per_thread == 1)
    return launch_dequant<P, 1, false>(vals, scales, w, out, R, dy, dx, kt, ct,
                                       s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Each launcher returns cudaGetLastError() after its launch (0 = success).
// `fp8` selects the payload type: 0 = int8, 1 = float8 e4m3 (as bytes).
// `variant` (0 general, 1 narrow, 2 wide), `group` (lanes a row),
// `rows_per_thread` (narrow: row groups a thread) and `vecs` (float4 a lane)
// are the wrapper's layout (`pick_quant_layout`); a layout the kernels do
// not take returns cudaErrorInvalidValue without a launch.
int rxt_quantize_rows(int fp8, int variant, int group, int rows_per_thread,
                      int vecs, const float* x, void* vals, float* scales,
                      int64_t R, int64_t C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fp8 ? launch_quantize<Fp8Payload>(variant, group, rows_per_thread,
                                           vecs, x, vals, scales, R, C, s)
             : launch_quantize<Int8Payload>(variant, group, rows_per_thread,
                                            vecs, x, vals, scales, R, C, s);
}

// `variant` (0 general, 1 vector) and `rows_per_thread` (U = 4 or 1 for
// vector, 1 for general) are the wrapper's layout (`pick_dequant_layout`),
// (`row_tile`, `col_tile`) its W tiles (`dequant_tiles`).
int rxt_dequant_matmul(int fp8, int variant, int rows_per_thread,
                       int row_tile, int col_tile, const void* vals,
                       const float* scales, const float* w, float* out,
                       int64_t R, int dy, int dx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fp8 ? launch_dequant_matmul<Fp8Payload>(
                   variant, rows_per_thread, row_tile, col_tile, vals, scales,
                   w, out, R, dy, dx, s)
             : launch_dequant_matmul<Int8Payload>(
                   variant, rows_per_thread, row_tile, col_tile, vals, scales,
                   w, out, R, dy, dx, s);
}

// The current device's opt-in limit of shared bytes a block.
int rxt_dequant_smem_optin() { return dequant_smem_optin(); }

const char* rxt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

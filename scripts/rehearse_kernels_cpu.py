#!/usr/bin/env python3
"""Rehearse the wide forward-backward, filter and dequantize + product
kernels on the CPU, with no card and no ``nvcc``: build
``csrc/fused_fb_wide.cu``, ``csrc/fused_fb.cu``, ``csrc/fused_filter_wide.cu``,
``csrc/fused_filter_warp.cu``, ``csrc/fused_filter_tc128.cu``,
``csrc/fused_smoother_wide.cu`` and ``csrc/quantized.cu`` with ``g++``
against a stub CUDA runtime and hold them against their plain versions.

    python3 scripts/rehearse_kernels_cpu.py [--out DIR]

Run from the root of a checkout.  The stub runs each CTA's threads as
``std::thread``s and the CTAs one after another; ``__syncwarp`` and
``__syncthreads`` are barriers, a shuffle writes a slot, waits and reads
its source lane's, and ``mma.sync`` (TF32 m16n8k8) exchanges each lane's
fragments the same way; ``__shared__`` arrays become ``static`` ones, dynamic
shared memory a per-CTA buffer filled with NaN (a read before a write
shows); ``cp.async`` is a plain copy and its commit / wait do nothing; the
launches are rewritten into loops over the grid.  It finds indexing,
masking and algebra faults (ragged edges, the ring's slots, the table's
placement, the staged observations); it says nothing about registers,
races the barriers hide, or speed.  The K > 32 passes are run again with a
small shared-memory limit, so that the table goes to device memory and the
ring's tile shrinks; the marginal kernels past 16 states run at K 17-32
and 33-64 (float4 rows at K % 4 == 0, scalar ones else, ragged tiles);
the wide
filter runs at d 9-16 and at d <= 8 with
dy > 8 (ragged blocks of chains, a staged group and a ragged last one, a
vague prior); the warp filter runs each of its tiers (the
tensor-core tier at d 17-32, a vague prior included; the tier past 32 at
d 33-64; the tier past 64 at d 65-128; the sweep with
parameters and chain matrices in shared memory, parameters in device
memory, both in device memory), forced at small d by a small limit, and
at a d past the last tier against a float64 filter; the wide K1/K2 run at
d 9-16 (a ragged block of chains, T = 1 and 2 and a ragged last round, W
and Q per chain, bf16 moments, a vague prior), K2 on K1's own outputs; K8
runs with W whole and in row tiles (forced by a small limit) on both
payloads, bit for bit.
About four minutes on eight cores, the plain K3 at d = 64, 65 and 72
most of it (the libraries in ``--out``, a temporary directory by
default).
"""

import argparse
import ctypes
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, os.getcwd())

CUDA_RUNTIME = r"""// Stub CUDA runtime for a CPU rehearsal: each CTA's threads run as
// std::threads, CTAs one after another; warp primitives through barriers.
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <vector>
#include <math.h>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __grid_constant__
#define __align__(n) alignas(n)

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
typedef void* cudaStream_t;
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(8) float2 { float x, y; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return {a, b, c, d};
}
// __ldg of a 16-byte value aborts off 16 bytes, as the card faults
template <class T> inline T __ldg(const T* p) {
  if (sizeof(T) == 16 && reinterpret_cast<uintptr_t>(p) % 16) abort();
  return *p;
}
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fdividef(float a, float b) { return a / b; }
inline float __frcp_rn(float x) { volatile float r = 1.0f / x; return r; }
inline int __float2int_rn(float x) { return static_cast<int>(rintf(x)); }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline float2 make_float2(float a, float b) { return {a, b}; }
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaDeviceAttr { cudaDevAttrMaxSharedMemoryPerBlockOptin = 97 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
                         cudaFuncAttributePreferredSharedMemoryCarveout = 9 };
enum cudaSharedCarveout { cudaSharedmemCarveoutMaxShared = 100 };

struct RxtCta {
  int nthreads;
  std::vector<std::unique_ptr<std::barrier<>>> warp_bar;
  std::unique_ptr<std::barrier<>> cta_bar;
  std::vector<float> slots;
  std::vector<uint32_t> mma_slots;
  std::vector<char> dyn;
};
inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
inline thread_local RxtCta* rxt_cta = nullptr;
inline thread_local void* rxt_dyn_smem = nullptr;
inline int rxt_smem_optin = 232448;

inline void __syncthreads() { rxt_cta->cta_bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  rxt_cta->warp_bar[threadIdx.x / 32]->arrive_and_wait();
}
inline float rxt_exchange(float v, int src) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* s = rxt_cta->slots.data() + 32 * w;
  s[lane] = v;
  __syncwarp();
  const float r = s[src];
  __syncwarp();
  return r;
}
inline float __shfl_sync(unsigned, float v, int src, int width = 32) {
  const int lane = threadIdx.x % 32;
  return rxt_exchange(v, (lane & ~(width - 1)) + (src % width));
}
inline float __shfl_xor_sync(unsigned, float v, int mask, int width = 32) {
  const int lane = threadIdx.x % 32;
  int src = lane ^ mask;
  if ((src & ~(width - 1)) != (lane & ~(width - 1))) src = lane;
  return rxt_exchange(v, src);
}

inline float __uint_as_float(uint32_t u) { float f; memcpy(&f, &u, 4); return f; }
inline uint32_t __float_as_uint(float f) { uint32_t u; memcpy(&u, &f, 4); return u; }
// mma.sync.m16n8k8 .tf32: each lane writes its fragments (a0..a3, b0, b1)
// to a slot, the warp waits, each lane forms its four accumulator entries
// from the fragments' layouts (A (row g, k t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4); B (k t, n g), (t + 4, g); D (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1)), operands cut to TF32 as the tensor cores
// read them.
inline void rxt_mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                         const uint32_t (&b)[2]) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  uint32_t* s = rxt_cta->mma_slots.data() + 256 * w;
  for (int i = 0; i < 4; ++i) s[8 * lane + i] = a[i];
  s[8 * lane + 4] = b[0];
  s[8 * lane + 5] = b[1];
  __syncwarp();
  const int g = lane >> 2, t = lane & 3;
  float r[4];
  for (int i = 0; i < 4; ++i) {
    const int row = g + 8 * (i >> 1), col = 2 * t + (i & 1);
    float acc = 0.0f;
    for (int k = 0; k < 8; ++k) {
      const uint32_t av =
          s[8 * (4 * (row & 7) + (k & 3)) + (row >> 3) + 2 * (k >> 2)];
      const uint32_t bv = s[8 * (4 * col + (k & 3)) + 4 + (k >> 2)];
      acc += __uint_as_float(av & 0xffffe000u) *
             __uint_as_float(bv & 0xffffe000u);
    }
    r[i] = acc;
  }
  __syncwarp();
  for (int i = 0; i < 4; ++i) d[i] += r[i];
}

inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "stub error"; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = rxt_smem_optin; return cudaSuccess;
}
template <class T>
inline cudaError_t cudaFuncSetAttribute(T*, cudaFuncAttribute, int bytes) {
  return bytes <= rxt_smem_optin ? cudaSuccess : cudaErrorInvalidValue;
}
template <class T>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, T*,
                                                                 int, size_t) {
  *n = 0; return cudaErrorInvalidValue;  // no occupancy without a card
}

template <class F>
void rxt_launch(dim3 grid, dim3 block, size_t smem, F fn) {
  for (unsigned by = 0; by < grid.y; ++by)
  for (unsigned bx = 0; bx < grid.x; ++bx) {
    RxtCta cta;
    cta.nthreads = block.x;
    const int warps = (block.x + 31) / 32;
    for (int w = 0; w < warps; ++w) {
      const int n = (w + 1) * 32 <= (int)block.x ? 32 : block.x - w * 32;
      cta.warp_bar.emplace_back(std::make_unique<std::barrier<>>(n));
    }
    cta.cta_bar = std::make_unique<std::barrier<>>(block.x);
    cta.slots.assign(32 * warps, 0.0f);
    cta.mma_slots.assign(256 * warps, 0u);
    cta.dyn.assign(smem + 64, 0);
    // poison the dynamic shared memory: reads before writes show up as NaN
    float nanv = std::nanf("");
    for (size_t i = 0; i + 4 <= smem; i += 4) memcpy(cta.dyn.data() + i, &nanv, 4);
    std::vector<std::thread> ts;
    for (unsigned tx = 0; tx < block.x; ++tx) {
      ts.emplace_back([&, tx, bx, by]() {
        threadIdx = dim3(tx, 0, 0); blockIdx = dim3(bx, by, 0);
        blockDim = block; gridDim = grid;
        rxt_cta = &cta; rxt_dyn_smem = cta.dyn.data();
        fn();
        // a thread that leaves early drops out of its barriers
        rxt_cta->warp_bar[tx / 32]->arrive_and_drop();
        rxt_cta->cta_bar->arrive_and_drop();
      });
    }
    for (auto& t : ts) t.join();
  }
}
"""

CUDA_BF16 = r"""#pragma once
#include <cstdint>
#include <cstring>
struct __nv_bfloat16 { uint16_t v; };
inline float __bfloat162float(__nv_bfloat16 h) { uint32_t u = uint32_t(h.v) << 16; float f; memcpy(&f, &u, 4); return f; }
inline __nv_bfloat16 __float2bfloat16(float f) { uint32_t u; memcpy(&u, &f, 4); uint32_t r = u + 0x7fff + ((u >> 16) & 1); return {uint16_t(r >> 16)}; }
inline __nv_bfloat16 __float2bfloat16_rn(float f) { return __float2bfloat16(f); }
"""

# e4m3 through a table (ties to the even code, saturating), half as float:
# exact for every e4m3 value
CUDA_FP16 = r"""#pragma once
struct __half_raw { float x; };
struct __half2_raw { float x, y; };
struct __half { float v; __half(__half_raw r) : v(r.x) {} };
struct __half2 { float x, y; __half2(__half2_raw r) : x(r.x), y(r.y) {} };
inline float2 __half22float2(__half2 h) { return {h.x, h.y}; }
inline float __half2float(__half h) { return h.v; }
"""

CUDA_FP8 = r"""#pragma once
#include <cmath>
#include <cstdint>
typedef unsigned short __nv_fp8x2_storage_t;
typedef unsigned char __nv_fp8_storage_t;
enum __nv_fp8_interpretation_t { __NV_E4M3, __NV_E5M2 };
enum __nv_saturation_t { __NV_NOSAT, __NV_SATFINITE };
inline float rxt_e4m3(unsigned c) {
  const int e = (c >> 3) & 15, m = c & 7;
  const float v = e ? std::ldexp(1.0f + m / 8.0f, e - 7) : std::ldexp(m / 8.0f, -6);
  return c & 0x80 ? -v : v;
}
inline __half_raw __nv_cvt_fp8_to_halfraw(__nv_fp8_storage_t c,
                                          __nv_fp8_interpretation_t) {
  return {rxt_e4m3(c)};
}
inline __half2_raw __nv_cvt_fp8x2_to_halfraw2(__nv_fp8x2_storage_t c,
                                              __nv_fp8_interpretation_t) {
  return {rxt_e4m3(c & 0xff), rxt_e4m3(c >> 8)};
}
inline __nv_fp8_storage_t __nv_cvt_float_to_fp8(float x, __nv_saturation_t,
                                                __nv_fp8_interpretation_t) {
  unsigned best = 0;
  float err = INFINITY;
  for (unsigned c = 0; c < 0x7f; ++c) {
    const float e = std::fabs(std::fabs(x) - rxt_e4m3(c));
    if (e < err || (e == err && (c & 1) == 0)) { best = c; err = e; }
  }
  return static_cast<__nv_fp8_storage_t>(best | (std::signbit(x) ? 0x80 : 0));
}
"""

LAUNCH_CFG = """#pragma once
#include <cuda_runtime.h>
template <class F>
void rxt_launch_cfg(dim3 g, dim3 b, size_t s, cudaStream_t, F fn) {
  rxt_launch(g, b, s, fn);
}
"""

LAUNCH = re.compile(r"([A-Za-z_]\w*(?:<[^<>;]*>)?)<<<(.*?)>>>\(([^;]*)\);",
                    re.S)


def rewrite(text: str) -> str:
    """A CUDA source as the stub runtime builds it."""
    text = LAUNCH.sub(lambda m: f"rxt_launch_cfg({m.group(2)}, [&]() "
                      f"{{ {m.group(1)}({m.group(3)}); }});", text)
    text = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?float (\w+)\[\];",
                  r"float* \1 = (float*)rxt_dyn_smem;", text)
    text = re.sub(r"__shared__ (?:__align__\(16\) )?float", "static float",
                  text)
    text = re.sub(r'asm volatile\("cp\.async\.ca\.shared\.global.*?\);',
                  "*dst = *src;", text, flags=re.S)
    text = re.sub(r'asm volatile\("cp\.async\.(?:commit|wait)_group.*?\);', "",
                  text, flags=re.S)
    text = re.sub(r'asm\("mma\.sync\.aligned\.m16n8k8\.row\.col\.f32\.tf32.*?\);',
                  "rxt_mma_tf32(d, a, b);", text, flags=re.S)
    return text.replace(
        "static_cast<unsigned>(__cvta_generic_to_shared(p))", "0u")


def build(out: Path, names) -> dict:
    from rxinfer_tpu_torch import kernels

    src = out / "src"
    src.mkdir(parents=True, exist_ok=True)
    for p in list(kernels.CSRC.glob("*.cu")) + list(kernels.CSRC.glob("*.cuh")):
        (src / p.name).write_text(rewrite(p.read_text()))
    (out / "cuda_runtime.h").write_text(CUDA_RUNTIME)
    (out / "cuda_bf16.h").write_text(CUDA_BF16)
    (out / "cuda_fp16.h").write_text(CUDA_FP16)
    (out / "cuda_fp8.h").write_text(CUDA_FP8)
    (out / "rxt_launch.h").write_text(LAUNCH_CFG)
    procs = {}
    for n in names:
        cmd = ["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-shared",
               "-fPIC", "-w", "-pthread", "-include", "cuda_runtime.h",
               "-include", str(out / "rxt_launch.h"), "-I", str(out), "-I",
               str(src), "-x", "c++", "-o", str(out / f"lib{n}.so"),
               str(src / f"{n}.cu")]
        procs[n] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
    libs = {}
    for n, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"g++ failed for {n}:\n{log[:4000]}")
        libs[n] = ctypes.CDLL(str(out / f"lib{n}.so"))
    return libs


def _err(got, want) -> float:
    return float((got - want).abs().max()) if got.numel() else 0.0


def _fb_inputs(b, t, k, seed):
    import torch

    rng = np.random.default_rng(seed)
    return (torch.as_tensor(a.astype(np.float32)) for a in (
        rng.standard_normal((b, k)), 2 * rng.standard_normal((b, k, k)),
        2 * rng.standard_normal((t, b, k))))


def check_fb_wide(lib, b, t, k, tile, smem=None, seed=0) -> bool:
    """One (B, T, K) through the wide launchers against the plain versions:
    the serial kernel with both recursions (and each alone, which must give
    the same bits), then the marginal kernel on its alphas and betas with
    and without the per-step xi (xi_sum at ``tile``)."""
    import torch

    from rxinfer_tpu_torch.ops import fused_fb as ffb

    vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.rxt_fb_wide_serial.argtypes = [ci, ci, vp, vp, vp, vp, vp, vp, i64,
                                       i64, vp]
    lib.rxt_fb_wide_marg.argtypes = [ci, ci, vp, vp, vp, vp, vp, vp, vp, vp,
                                     i64, i64, i64, i64, vp]
    ctypes.c_int.in_dll(lib, "rxt_smem_optin").value = smem or 232_448
    lp, lt, le = _fb_inputs(b, t, k, seed)
    nan = float("nan")

    def serial(roles):
        alphas, logz = torch.full_like(le, nan), torch.full((b,), nan)
        betas = torch.full_like(le, nan)
        assert lib.rxt_fb_wide_serial(
            k, roles, lp.data_ptr(), lt.data_ptr(), le.data_ptr(),
            alphas.data_ptr(), logz.data_ptr(), betas.data_ptr(), t, b,
            None) == 0
        return alphas, logz, betas

    alphas, logz, betas = serial(3)
    a1, z1, _ = serial(1)
    _, _, b2 = serial(2)
    alone = (torch.equal(alphas, a1) and torch.equal(logz, z1)
             and torch.equal(betas, b2))
    a_r, z_r = ffb.fb_forward_reference(lp, lt, le)
    errs = {"alphas": _err(alphas, a_r), "logz": _err(logz, z_r),
            "betas": _err(betas, ffb.beta_pass_reference(lt, le))}
    tiles = -(-t // tile)
    g_r, x_r, s_r = ffb.marginals_reference(lt, le, alphas, betas, True,
                                            tile=tile)
    # the marginal kernels at the card's limit (the small one is for the
    # serial kernel's table)
    ctypes.c_int.in_dll(lib, "rxt_smem_optin").value = 232_448
    for steps in (1, 0):
        gammas, xi_sum = torch.full_like(le, nan), torch.full((b, k, k), nan)
        part = torch.full((tiles, b, k, k), nan) if tiles > 1 else xi_sum
        xis = torch.full((t - 1, b, k, k), nan) if steps else None
        assert lib.rxt_fb_wide_marg(
            k, steps, lt.data_ptr(), le.data_ptr(), alphas.data_ptr(),
            betas.data_ptr(), gammas.data_ptr(), part.data_ptr(),
            xi_sum.data_ptr(), xis.data_ptr() if steps else None, t, b, tile,
            tiles, None) == 0
        sfx = "" if steps else "(no steps)"
        errs["gammas" + sfx] = _err(gammas, g_r)
        errs["xi_sum" + sfx] = _err(xi_sum, x_r)
        if steps:
            errs["xi_steps"] = _err(xis, s_r)
    ok = alone and all(e <= 2e-5 for e in errs.values())
    print(f"wide K4/K5 (B,T,K)=({b},{t},{k}) tile {tile}"
          f"{'' if smem is None else f' shared memory {smem} B'}: "
          + ", ".join(f"{n} {e:.2g}" for n, e in errs.items())
          + ("; each recursion alone gives the same bits" if alone else
             "; a recursion alone differs")
          + ("" if ok else "  FAIL"), flush=True)
    return ok


def check_fb(lib, b, t, k, tile, seed=0) -> bool:
    """One (B, T, K) through the register kernels' launchers against the
    plain versions (both per-step variants, xi_sum at ``tile``)."""
    import torch

    from rxinfer_tpu_torch.ops import fused_fb as ffb

    vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fwd, bwd = lib.rxt_fb_fwd, lib.rxt_fb_bwd
    fwd.argtypes = [ci, vp, vp, vp, vp, vp, i64, i64, vp]
    bwd.argtypes = [ci, ci, vp, vp, vp, vp, vp, vp, vp, vp, i64, i64, i64,
                    i64, vp]
    lp, lt, le = _fb_inputs(b, t, k, seed)
    nan = float("nan")
    alphas, logz = torch.full_like(le, nan), torch.full((b,), nan)
    assert fwd(k, lp.data_ptr(), lt.data_ptr(), le.data_ptr(),
               alphas.data_ptr(), logz.data_ptr(), t, b, None) == 0
    a_r, z_r = ffb.fb_forward_reference(lp, lt, le)
    errs = {"alphas": _err(alphas, a_r), "logz": _err(logz, z_r)}
    tiles = -(-t // tile)
    g_r, x_r, s_r = ffb.fb_backward_reference(lt, le, alphas, True, tile=tile)
    for steps in (1, 0):
        gammas, xi_sum = torch.full_like(le, nan), torch.full((b, k, k), nan)
        part = torch.full((tiles, b, k, k), nan) if tiles > 1 else xi_sum
        xis = torch.full((t - 1, b, k, k), nan) if steps else None
        betas = torch.empty_like(le)
        assert bwd(k, steps, lt.data_ptr(), le.data_ptr(), alphas.data_ptr(),
                   betas.data_ptr(), gammas.data_ptr(),
                   part.data_ptr(), xi_sum.data_ptr(),
                   xis.data_ptr() if steps else None, t, b, tile, tiles,
                   None) == 0
        sfx = "" if steps else "(no steps)"
        errs["gammas" + sfx] = _err(gammas, g_r)
        errs["xi_sum" + sfx] = _err(xi_sum, x_r)
        if steps:
            errs["xi_steps"] = _err(xis, s_r)
    ok = all(e <= 2e-5 for e in errs.values())
    print(f"K4/K5 (B,T,K)=({b},{t},{k}) tile {tile}: "
          + ", ".join(f"{n} {e:.2g}" for n, e in errs.items())
          + ("" if ok else "  FAIL"), flush=True)
    return ok


def check_filter(lib, b, t, d, dy, seed=0, p0_scale=9.0) -> bool:
    """One (B, T, d, dy) through the wide filter's launcher against the
    plain version, P0 = ``p0_scale`` I."""
    import torch

    from rxinfer_tpu_torch.ops import fused_filter as ff
    from rxinfer_tpu_torch.ops.fused_smoother import _host_ptr, sym_fold

    vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.rxt_wide_filter.argtypes = [ci, ci, vp, vp, vp, vp, vp, vp, vp, i64,
                                    i64, vp, vp, vp, vp]
    rng = np.random.default_rng(seed)
    qm, _ = np.linalg.qr(rng.standard_normal((d, d)))
    f = (0.98 * qm).astype(np.float32)
    q = (0.4 * np.eye(d)).astype(np.float32)
    h = (1.2 * np.eye(dy, d) + 0.2 * rng.standard_normal((dy, d))).astype(
        np.float32)
    r = (0.8 * np.eye(dy) + 0.1 * np.ones((dy, dy))).astype(np.float32)
    w_obs, hr = ff.evidence_operators(h, r)
    ys = torch.as_tensor(rng.standard_normal((t, dy, b)).astype(np.float32))
    m0 = torch.as_tensor(rng.standard_normal((d, b)).astype(np.float32))
    p0 = sym_fold(torch.as_tensor(np.broadcast_to(
        p0_scale * np.eye(d, dtype=np.float32), (b, d, d)).copy())).contiguous()
    fh, qh, hrh, wh = ff._host_params(f, q, hr, w_obs, d, dy)
    hr_t = torch.from_numpy(np.ascontiguousarray(hrh.T))
    nan = float("nan")
    out = (torch.full((t, d, b), nan), torch.full((d, b), nan),
           torch.full((d * (d + 1) // 2, b), nan))
    assert lib.rxt_wide_filter(d, dy, ys.data_ptr(), m0.data_ptr(),
                               p0.data_ptr(), hr_t.data_ptr(),
                               *(o.data_ptr() for o in out), t, b,
                               _host_ptr(fh), _host_ptr(qh), _host_ptr(wh),
                               None) == 0
    want = ff.fused_filter_reference(m0, p0, ys, f, q, hr, w_obs)
    errs = [_err(g, w) for g, w in zip(out, want)]
    ok = max(errs) <= 3e-4
    print(f"wide K3 (B,T,d,dy)=({b},{t},{d},{dy}), P0 = {p0_scale:g} I: "
          f"means {errs[0]:.2g}, "
          f"final m {errs[1]:.2g}, final P {errs[2]:.2g}"
          + ("" if ok else "  FAIL"), flush=True)
    return ok


def _filter_inputs(b, t, d, dy, seed, p0_scale=9.0):
    import torch

    from rxinfer_tpu_torch.ops import fused_filter as ff
    from rxinfer_tpu_torch.ops.fused_smoother import sym_fold

    rng = np.random.default_rng(seed)
    qm, _ = np.linalg.qr(rng.standard_normal((d, d)))
    f = (0.98 * qm).astype(np.float32)
    q = (0.4 * np.eye(d)).astype(np.float32)
    h = (1.2 * np.eye(dy, d) + 0.2 * rng.standard_normal((dy, d))).astype(
        np.float32)
    r = (0.8 * np.eye(dy) + 0.1 * np.ones((dy, dy))).astype(np.float32)
    w_obs, hr = ff.evidence_operators(h, r)
    ys = torch.as_tensor(rng.standard_normal((t, dy, b)).astype(np.float32))
    m0 = torch.as_tensor(rng.standard_normal((d, b)).astype(np.float32))
    p0 = sym_fold(torch.as_tensor(np.broadcast_to(
        p0_scale * np.eye(d, dtype=np.float32), (b, d, d)).copy())).contiguous()
    return (f, q, h, r, w_obs, hr), (m0, p0, ys)


def _filter64(m0, p0, ys, f, q, h, r):
    """Means (T, d, B), final m (d, B) and packed P (nsym, B) of the
    information-form filter in float64, batch-minor as the kernel's."""
    import torch

    from rxinfer_tpu_torch.ops.fused_smoother import sym_idx

    f, q, h, r = (np.asarray(a, np.float64) for a in (f, q, h, r))
    hr = h.T @ np.linalg.inv(r)
    w = hr @ h
    d = f.shape[0]
    m = m0.numpy().T.astype(np.float64)
    iu = sym_idx(d)
    p = np.zeros((m.shape[0], d, d))
    for k, (i, j) in enumerate(iu):
        p[:, i, j] = p[:, j, i] = p0[k].numpy()
    means = []
    for yt in ys.numpy().astype(np.float64):
        m = m @ f.T
        p = f @ p @ f.T + q
        lam = np.linalg.inv(p)
        p = np.linalg.inv(lam + w)
        m = np.einsum("nij,nj->ni", p, np.einsum("nij,nj->ni", lam, m)
                      + yt.T @ hr.T)
        means.append(m.T)
    as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a))
    return (as_t(np.stack(means)), as_t(m.T),
            as_t(np.stack([p[:, i, j] for i, j in iu])))


def check_warp_filter(lib, b, t, d, dy, smem=232_448, oracle=False,
                      seed=0, sweep=False, p0_scale=9.0, lib128=None) -> bool:
    """One (B, T, d, dy) through the warp filter's launchers on the plan
    ``warp_plan(d, smem)`` (``sweep_warp_plan`` with ``sweep``; the stub's
    shared-memory limit set to ``smem``; the tier past 64 through
    ``lib128``, ``fused_filter_tc128``'s library) against the plain
    version, or the float64 filter."""
    import torch

    from rxinfer_tpu_torch.ops import fused_filter as ff

    vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.rxt_warp_filter.argtypes = [ci, ci, vp, vp, vp, vp, vp, vp, vp, vp,
                                    vp, i64, i64, ci, ci, ci, ci, ci, vp]
    lib.rxt_warp_filter_smem_bytes.argtypes = [ci] * 5
    lib.rxt_warp_filter_smem_bytes.restype = i64
    lib.rxt_warp_filter_tc.argtypes = [ci, ci, vp, vp, vp, vp, vp, vp, vp, vp,
                                       i64, i64, ci, ci, vp]
    lib.rxt_warp_filter_tc_smem_bytes.argtypes = [ci]
    lib.rxt_warp_filter_tc_smem_bytes.restype = i64
    lib.rxt_warp_filter_tc64.argtypes = [ci, ci, vp, vp, vp, vp, vp, vp, vp,
                                         vp, i64, i64, ci, vp]
    lib.rxt_warp_filter_tc64_smem_bytes.argtypes = [ci]
    lib.rxt_warp_filter_tc64_smem_bytes.restype = i64
    ctypes.c_int.in_dll(lib, "rxt_smem_optin").value = smem
    if lib128 is not None:
        lib128.rxt_warp_filter_tc128.argtypes = [ci, ci, vp, vp, vp, vp, vp,
                                                 vp, vp, vp, i64, i64, ci, vp]
        lib128.rxt_warp_filter_tc128_smem_bytes.restype = i64
        ctypes.c_int.in_dll(lib128, "rxt_smem_optin").value = smem
    (f, q, h, r, w_obs, hr), (m0, p0, ys) = _filter_inputs(
        b, t, d, dy, seed, p0_scale)
    plan = (ff.sweep_warp_plan if sweep else ff.warp_plan)(d, smem)
    dp, stride, chains = (plan["padded_dim"], plan["stride"],
                          plan["chains_per_block"])
    tc = plan["tier"] == "tensor_cores"
    tc64 = plan["tier"] == "tensor_cores_64"
    tc128 = plan["tier"] == "tensor_cores_128"
    ps, cs = plan["params"] == "shared", plan["chain_matrices"] == "shared"
    assert (lib.rxt_warp_filter_tc_smem_bytes(chains) if tc else
            lib.rxt_warp_filter_tc64_smem_bytes(d) if tc64 else
            lib128.rxt_warp_filter_tc128_smem_bytes() if tc128 else
            lib.rxt_warp_filter_smem_bytes(dp, stride, chains, ps, cs)) == \
        plan["smem_bytes"], plan
    fh, qh, hrh, wh = ff._host_params(f, q, hr, w_obs, d, dy)
    prm = np.zeros((4, dp, stride), np.float32)
    for k, a in enumerate((fh, fh.T, qh, wh)):
        prm[k, :d, :d] = a
    prm = torch.from_numpy(prm)
    hr_t = torch.from_numpy(np.ascontiguousarray(hrh.T))
    nan = float("nan")

    def run():
        out = (torch.full((t, d, b), nan), torch.full((d, b), nan),
               torch.full((d * (d + 1) // 2, b), nan))
        if tc:
            assert lib.rxt_warp_filter_tc(
                d, dy, ys.data_ptr(), m0.data_ptr(), p0.data_ptr(),
                hr_t.data_ptr(), prm.data_ptr(), *(o.data_ptr() for o in out),
                t, b, stride, chains, None) == 0
            return out
        if tc128:
            assert lib128.rxt_warp_filter_tc128(
                d, dy, ys.data_ptr(), m0.data_ptr(), p0.data_ptr(),
                hr_t.data_ptr(), prm.data_ptr(), *(o.data_ptr() for o in out),
                t, b, stride, None) == 0
            return out
        if tc64:
            assert lib.rxt_warp_filter_tc64(
                d, dy, ys.data_ptr(), m0.data_ptr(), p0.data_ptr(),
                hr_t.data_ptr(), prm.data_ptr(), *(o.data_ptr() for o in out),
                t, b, stride, None) == 0
            return out
        scratch = None if cs else torch.full(
            (-(-b // chains) * chains * 2 * dp * stride,), nan)
        assert lib.rxt_warp_filter(
            d, dy, ys.data_ptr(), m0.data_ptr(), p0.data_ptr(),
            hr_t.data_ptr(), prm.data_ptr(), *(o.data_ptr() for o in out),
            None if scratch is None else scratch.data_ptr(), t, b, dp,
            stride, chains, ps, cs, None) == 0
        return out

    out = run()
    want = (_filter64(m0, p0, ys, f, q, h, r) if oracle else
            ff.fused_filter_reference(m0, p0, ys, f, q, hr, w_obs))
    errs = [_err(g.double(), w.double()) for g, w in zip(out, want)]
    ok = max(errs) <= 3e-4
    print(f"warp K3 (B,T,d,dy)=({b},{t},{d},{dy}) {plan['tier']} tier, "
          f"P0 = {p0_scale:g} I, params {plan['params']}, "
          f"chain matrices {plan['chain_matrices']}, {chains} chains a "
          f"block, against the {'float64 filter' if oracle else 'plain version'}"
          f": means {errs[0]:.2g}, final m {errs[1]:.2g}, final P "
          f"{errs[2]:.2g}" + ("" if ok else "  FAIL"), flush=True)
    return ok


def check_smoother_wide(lib, b, t, d, dyn=False, bf16=False, p0_scale=9.0,
                        seed=0) -> bool:
    """The wide K1 and K2 launchers at (B, T, d) (W and Q per chain with
    ``dyn``, bf16 moments with ``bf16``; K2 on K1's own outputs) against
    the plain versions on the same inputs."""
    import torch

    from chip_smoke import _smoother_params, _spd_batch
    from rxinfer_tpu_torch.ops import fused_smoother as fs

    vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.rxt_wide_smoother_fwd.argtypes = [ci, vp, vp, vp, vp, vp, i64, i64,
                                          vp, vp, vp, vp, vp, vp, ci, vp]
    lib.rxt_wide_smoother_bwd.argtypes = [ci, vp, vp, vp, vp, vp, i64, i64,
                                          vp, vp, vp, vp, ci, vp]
    # the card's limit (K2's ring takes more than 48 KB a block)
    ctypes.c_int.in_dll(lib, "rxt_smem_optin").value = 232_448
    f, bv, q, w = _smoother_params(d, seed=seed)
    rng = np.random.default_rng(seed)
    xi = torch.as_tensor(rng.standard_normal((t, b, d)).astype(np.float32))
    m0 = torch.as_tensor(rng.standard_normal((b, d)).astype(np.float32))
    p0 = torch.as_tensor(np.broadcast_to(
        p0_scale * np.eye(d, dtype=np.float32), (b, d, d)).copy())
    wb = torch.as_tensor(_spd_batch(rng, b, d, 0.8)) if dyn else None
    qb = torch.as_tensor(_spd_batch(rng, b, d, 0.4)) if dyn else None
    q_sh, w_sh = (None, None) if dyn else (q, w)
    md = torch.bfloat16 if bf16 else torch.float32
    fh, bh, qh, wh = fs._host_params(f, bv, q_sh, w_sh, d)
    tile = lambda x: None if x is None else fs.sym_fold(x).contiguous()
    w_tile, q_tile = tile(wb), tile(qb)
    nsym = d * (d + 1) // 2
    nan = float("nan")
    mf = torch.full((t, d, b), nan)
    pf = torch.full((t, nsym, b), nan).to(md)
    assert lib.rxt_wide_smoother_fwd(
        d, xi.data_ptr(), m0.data_ptr(), p0.data_ptr(), mf.data_ptr(),
        pf.data_ptr(), t, b, fs._host_ptr(fh), fs._host_ptr(bh),
        fs._host_ptr(qh), fs._host_ptr(wh), fs._ptr(w_tile), fs._ptr(q_tile),
        int(bf16), None) == 0
    ms, ps = torch.full_like(mf, nan), torch.full_like(pf, nan)
    cross = torch.full((t - 1, d * d, b), nan).to(md)
    assert lib.rxt_wide_smoother_bwd(
        d, mf.data_ptr(), pf.data_ptr(), ms.data_ptr(), ps.data_ptr(),
        cross.data_ptr(), t, b, fs._host_ptr(fh), fs._host_ptr(bh),
        fs._host_ptr(qh), fs._ptr(q_tile), int(bf16), None) == 0
    mf_r, pf_r = fs.fused_forward_reference(m0, p0, xi, f, bv, q_sh, w_sh,
                                            wb, qb, md)
    ms_r, ps_r, cr_r = fs.fused_backward_reference(mf, pf, f, bv, q_sh, qb)
    got = {"mf": mf, "pf": pf, "ms": ms, "ps": ps, "cross": cross}
    want = {"mf": mf_r, "pf": pf_r, "ms": ms_r, "ps": ps_r, "cross": cr_r}
    ok, parts = True, []
    for k, g in got.items():
        wt = want[k]
        g, wt = g.double(), wt.double()
        err = _err(g, wt)
        moment = bf16 and k in ("pf", "ps", "cross")
        # bf16 moments: chip_smoke's BF16_RTOL / BF16_ATOL, else 3e-4
        rtol, atol = (1.6e-2, 3e-4) if moment else (3e-4, 3e-4)
        good = bool(torch.isfinite(g).all()) and bool(
            ((g - wt).abs() <= atol + rtol * wt.abs()).all())
        ok &= good
        parts.append(f"{k} {err:.2g}" + ("" if good else " FAIL"))
    print(f"wide K1/K2 (B,T,d)=({b},{t},{d}) "
          f"{'W, Q per chain' if dyn else 'static'} "
          f"{'bf16' if bf16 else 'float32'}, P0 = {p0_scale:g} I, against "
          "the plain versions: " + ", ".join(parts)
          + ("" if ok else "  FAIL"), flush=True)
    return ok


def check_dequant(lib, rows, dy, dx, smem, fp8=False, variant="general",
                  rows_per_thread=1) -> bool:
    """K8 through its launcher on the tiles ``dequant_tiles(dy, dx, smem)``
    (the stub's shared-memory limit set to ``smem``) against the plain
    version, bit for bit; the launcher must refuse other tiles."""
    import torch

    from rxinfer_tpu_torch.ops import quantized as tq

    vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.rxt_dequant_matmul.argtypes = [ci, ci, ci, ci, ci, vp, vp, vp, vp,
                                       i64, ci, ci, vp]
    ctypes.c_int.in_dll(lib, "rxt_smem_optin").value = smem
    rng = np.random.default_rng(rows + dy + dx)
    x = torch.as_tensor((rng.standard_normal((rows, dy))
                         * np.exp(rng.uniform(-3, 3, (rows, 1)))).astype(
                             np.float32))
    vals, scales = (tq.quantize_rows_fp8_reference if fp8
                    else tq.quantize_rows_reference)(x)
    w = torch.as_tensor(rng.standard_normal((dy, dx)).astype(np.float32))
    tiles = tq.dequant_tiles(dy, dx, smem)

    def run(kt, ct):
        out = torch.full((rows, dx), float("nan"))
        rc = lib.rxt_dequant_matmul(
            int(fp8), tq.DEQUANT_VARIANTS[variant], rows_per_thread, kt, ct,
            vals.data_ptr(), scales.data_ptr(), w.data_ptr(), out.data_ptr(),
            rows, dy, dx, None)
        return rc, out

    rc, out = run(*tiles)
    equal = rc == 0 and torch.equal(
        out.view(torch.int32),
        tq.dequant_matmul_reference(vals, scales, w).view(torch.int32))
    refused = run(tiles[0] + 16, tiles[1])[0] != 0 and run(0, 4)[0] != 0
    ok = equal and refused
    print(f"K8 (R,dy,dx)=({rows},{dy},{dx}) {'fp8' if fp8 else 'int8'} "
          f"{variant} U={rows_per_thread}, shared memory {smem} B: W tiles "
          f"{tiles}, " + ("equal to the plain version" if equal else
                          "DIFFERS") + ("" if refused else ", other tiles "
                                        "taken") + ("" if ok else "  FAIL"),
          flush=True)
    return ok


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    import torch

    torch.set_num_threads(1)
    out = Path(args.out or tempfile.mkdtemp(prefix="rehearse_"))
    libs = build(out, ["fused_fb_wide", "fused_fb", "fused_filter_wide",
                       "fused_filter_warp", "fused_filter_tc128",
                       "quantized", "fused_smoother_wide"])
    print(f"built with g++ into {out}", flush=True)
    ok = True
    # K = 9..16 on the half-warp design (odd B: a warp's two halves on two
    # tiles; ragged tiles; K = 16 the float4 stores; T past three staged
    # tiles: the ring refilled, its last tile short), then 32, 33, 64 (T
    # past three tiles at 32 and 33 too); past 32 states the two-thread
    # rows at 33, 63 (scalar rows), 40, 48, 64 (float4 rows), ragged tiles
    for b, t, k, tile in [(5, 37, 9, 4), (6, 70, 16, 70), (3, 33, 16, 8),
                          (7, 45, 16, 6), (3, 20, 13, 3), (3, 150, 16, 8),
                          (2, 131, 11, 5), (5, 40, 32, 4), (2, 130, 32, 8),
                          (2, 100, 33, 8), (3, 37, 17, 8), (5, 11, 20, 4),
                          (2, 9, 24, 3), (3, 13, 31, 5), (3, 9, 28, 9),
                          (2, 2, 32, 1), (1, 1, 18, 1),
                          (2, 11, 33, 4), (3, 17, 64, 4), (1, 1, 12, 1),
                          (3, 13, 48, 5), (2, 9, 63, 4),
                          (1, 2, 16, 1), (2, 2, 40, 1)]:
        ok &= check_fb_wide(libs["fused_fb_wide"], b, t, k, tile)
    ok &= check_fb_wide(libs["fused_fb_wide"], 3, 17, 64, 4, smem=20_000)
    ok &= check_fb_wide(libs["fused_fb_wide"], 2, 9, 40, 3, smem=4000)
    for b, t, k, tile in [(5, 70, 3, 4), (9, 40, 8, 40), (3, 33, 1, 4)]:
        ok &= check_fb(libs["fused_fb"], b, t, k, tile)
    # the wide K1/K2 (d 9-16): a ragged block of chains (11 = 8 + 3), T = 1,
    # 2 and a ragged last round; W and Q per chain; bf16 moments; a vague
    # prior
    for b, t, d, dyn, bf16, p0s in [(11, 6, 16, False, False, 9.0),
                                    (9, 5, 9, False, False, 9.0),
                                    (3, 1, 12, False, False, 9.0),
                                    (3, 2, 13, True, False, 9.0),
                                    (10, 7, 12, True, False, 9.0),
                                    (9, 4, 16, False, True, 9.0),
                                    (5, 5, 10, True, True, 9.0),
                                    (9, 4, 16, True, False, 1e6)]:
        ok &= check_smoother_wide(libs["fused_smoother_wide"], b, t, d, dyn,
                                  bf16, p0s, seed=b + t + d)
    # the wide K3: d = 9, 12, 16 at dy = 1, 9, 16, 40 (past one k tile of
    # the evidence's product, and a ragged last one), d = 4 at dy = 12, d = 1
    # at dy = 70; ragged blocks of chains (11, 17: one and two blocks of
    # eight and a few), T past a staged group (17 = 2 x 8 + 1) and T = 1; one
    # observation of 16 states over 40 steps (P kept symmetric); a vague
    # prior
    for b, t, d, dy in [(11, 9, 9, 1), (9, 6, 9, 9), (5, 3, 9, 16),
                        (5, 3, 9, 40), (3, 4, 12, 1), (9, 6, 12, 9),
                        (5, 3, 12, 16), (5, 3, 12, 40), (3, 4, 16, 1),
                        (5, 3, 16, 9), (17, 17, 16, 16), (9, 4, 16, 40),
                        (10, 5, 4, 12), (3, 3, 1, 70), (5, 1, 16, 33),
                        (3, 40, 16, 1)]:
        ok &= check_filter(libs["fused_filter_wide"], b, t, d, dy)
    ok &= check_filter(libs["fused_filter_wide"], 9, 4, 16, 40,
                       p0_scale=1e6)
    warp = libs["fused_filter_warp"]
    # d 17-32 on the tensor-core tier (padded to 24: a ragged block at 17,
    # 20, 24; padded to 32: 25, two observation chunks at 32; a vague P0 on
    # each), then the sweep tiers: the same d on the sweep, and past 32
    for b, t, d, dy in [(11, 4, 17, 1), (7, 3, 20, 5), (9, 3, 24, 24),
                        (9, 3, 25, 25), (9, 3, 32, 40)]:
        ok &= check_warp_filter(warp, b, t, d, dy)
    ok &= check_warp_filter(warp, 5, 3, 24, 30, oracle=True, p0_scale=1e6)
    ok &= check_warp_filter(warp, 5, 3, 29, 29, p0_scale=1e6)
    ok &= check_warp_filter(warp, 5, 3, 32, 40, oracle=True, p0_scale=1e6)
    for b, t, d, dy in [(11, 4, 17, 1), (9, 3, 32, 40), (5, 3, 33, 5),
                        (3, 2, 40, 33), (2, 1, 64, 8)]:
        ok &= check_warp_filter(warp, b, t, d, dy, sweep=True)
    # d 33-64 on the tensor-core tier past 32: a ragged block at each
    # padding (48: 9 = 8 + 1 chains; 64: 5 = 4 + 1), dy = 1 and four staged
    # chunks, a vague prior on a well-conditioned W (twice the
    # observations) against the float64 filter
    for b, t, d, dy in [(9, 2, 33, 5), (9, 2, 48, 7), (5, 2, 64, 1),
                        (5, 1, 64, 100)]:
        ok &= check_warp_filter(warp, b, t, d, dy)
    ok &= check_warp_filter(warp, 3, 2, 64, 100, oracle=True, p0_scale=1e6)
    # d 65-128 on the tier past 64 (a chain a block): d = 65 (a ragged
    # 16-block, one observation), d = 72 over three staged chunks, d = 128
    # against the float64 filter (the plain step is about a minute there)
    # and a vague prior on a well-conditioned W
    lib128 = libs["fused_filter_tc128"]
    for b, t, d, dy in [(3, 1, 65, 1), (2, 1, 72, 70)]:
        ok &= check_warp_filter(warp, b, t, d, dy, lib128=lib128)
    ok &= check_warp_filter(warp, 2, 2, 128, 128, oracle=True, lib128=lib128)
    ok &= check_warp_filter(warp, 2, 2, 100, 200, oracle=True, p0_scale=1e6,
                            lib128=lib128)
    # few observations (W of rank 7): the Newton step on the second inverse
    ok &= check_warp_filter(warp, 3, 3, 100, 7, oracle=True, lib128=lib128)
    # the tiers past the shared parameters, forced by a small limit, and
    # the device-memory scratch at its own d
    ok &= check_warp_filter(warp, 9, 3, 20, 3, smem=10_000, sweep=True)
    ok &= check_warp_filter(warp, 5, 3, 33, 5, smem=2_000, sweep=True)
    ok &= check_warp_filter(warp, 2, 2, 168, 3, oracle=True)
    # K8: W whole, whole past the default 48 KB, and in row tiles (forced by
    # a small limit; the last tile short; column tiles past dx; four rows a
    # thread), on both payloads
    for fp8 in (False, True):
        for rows, dy, dx, smem, variant, u in [
                (300, 16, 4, 232_448, "vector", 1),
                (2100, 32, 8, 232_448, "vector", 4),
                (257, 40, 9, 232_448, "general", 1),
                (700, 64, 4, 512, "vector", 1),
                (2100, 48, 8, 256, "vector", 4),
                (300, 37, 5, 300, "general", 1),
                (600, 16, 12, 256, "vector", 1)]:
            ok &= check_dequant(libs["quantized"], rows, dy, dx, smem, fp8,
                                variant, u)
    print("all within tolerance" if ok else "FAILURES")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

#!/usr/bin/env python3
"""Time the warp filter kernels (K3 for d > 16, ``csrc/fused_filter_warp.cu``)
alone with parts of their step taken out, the tensor-core tier against the
sweep tier at the same d, and the card's ``mma.sync`` TF32 issue rate.

    python3 scripts/warp_filter_variants.py [BxTxD ...]

Run from the root of a checkout on a machine with a CUDA device and
``nvcc``.  Default shapes: 10000x200x32, 10000x200x17, 10000x200x24,
10000x200x25 and 2000x50x64, dy = d, the system of ``chip_smoke._filter_system`` and P0 =
9 I.  Each variant is the source with one part of the step replaced,
built with the package's flags (all ``nvcc`` runs started together) and
launched through its ``extern "C"`` launcher.

At d <= 32, the tensor-core tier (``warp_filter_tc_kernel``, the plan of
``ops/fused_filter.py`` ``device_warp_plan``):

- ``tensor cores``: the source as it is;
- ``FMA products``: each ``mma.sync`` replaced by 32 FMAs a lane on the
  lane's own operands (the arithmetic of an m16n8k8 product without the
  operand exchange: a floor for products on the FMA pipe);
- ``no split``: one TF32 product for each of the three (plain TF32: about
  three decimal digits; the max difference from ``tensor cores`` is printed);
- ``leaf inverses alone``: every product taken out, the 8-pivot leaf
  sweeps (eight a step at d > 24, six to d = 24) and the vector work left;
- ``no leaf inverses``: the leaf sweeps taken out;
- ``16-pivot leaves``: each 16 x 16 inverse one 16-pivot Gauss-Jordan sweep,
  as before the Schur split at 8;
- ``3 blocks an SM``: launch bounds for three blocks of eight warps (at most
  80 registers a thread) instead of two;
- ``cvt.rna rounding``: the high parts rounded by ``cvt.rna.tf32.f32`` in
  place of the source's add and mask (the same bits for finite operands);
- ``IEEE reciprocals``: the leaves' pivots inverted by an IEEE division in
  place of the hardware reciprocal;
- ``sweep tier``: the same library's ``warp_filter_kernel`` on
  ``sweep_warp_plan`` (the tier past d = 32, and at these d before the
  tensor-core tier; the max difference between the two tiers' outputs is
  printed).

At every d, the sweep tier (``full`` past d = 32) and its variants: ``no
pivot sweeps``, ``no inverses``, ``no products`` (the two pivot sweeps of
the inverses, the two inverses, or the two products F P and (F P) F^T
taken out).
Outputs of variants that take parts out are wrong by construction.

Last, ``mma.sync`` m16n8k8 TF32 throughput: a kernel of eight warps a
block, four blocks an SM, each warp issuing 8 independent accumulator
chains, timed by CUDA events: the card's mma.sync a second an SM.

The card's name and power limit head the output; then each variant's
``ptxas`` registers and spills, each shape's median ms of 3 rounds (CUDA
events, one launch a round, after 2 launches of warm-up), with the blocks
an SM the tensor-core tier's variants reach.  Run it from a ``git
archive`` of another tree to compare the two (``cd other && python3
../scripts/warp_filter_variants.py``).
"""

import ctypes
import os
import re
import subprocess
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.getcwd())

DEFAULT_SHAPES = ["10000x200x32", "10000x200x17", "10000x200x24",
                  "10000x200x25", "2000x50x64"]
INV_PM = "sym_inv_scaled(pm, cv, d, s, lane);"
INV_XM = "sym_inv_scaled(xm, cv, d, s, lane);"
MUL_FP = "mat_mul<false, false>(f, pm, nullptr, xm, d, d4, s, lane);"
MUL_FPF = "mat_mul<true, true>(xm, ft, q, pm, d, d4, s, lane);"
SWEEP_START = "  for (int k = 0; k < d; ++k) {\n    for (int i = lane"
SWEEP_END = "  for (int j = lane; j < d; j += kLanes) {\n    for (int i0 = 0; i0 <= j;"
# the tensor-core tier's parts
MMA_BODY = ('  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "',
            '"r"(b[0]), "r"(b[1]));\n')
FMA_BODY = """#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 8; ++k)
      d[i] = fmaf(__uint_as_float(a[(i + k) & 3]),
                  __uint_as_float(b[k & 1]), d[i]);
"""
MMA3 = ("  mma_tf32(d, al, bh);\n  mma_tf32(d, ah, bl);\n"
        "  mma_tf32(d, ah, bh);\n")
LEAF_CALLS = ("leaf8(m[0][0], m[0][1], g, t, lane);",
              "leaf8(m[1][2], m[1][3], g, t, lane);")
INV16_CALLS = ("inv16<false>(a, g, t, lane);",
               "inv16<DP != 32>(dd, g, t, lane);")
INV16_AT = "// In place: the inverse of the symmetric m (identity past d)"
# the 16 x 16 inverses as one 16-pivot Gauss-Jordan sweep each, the leaf
# before they were split at 8
LEAF16 = """__device__ __forceinline__ void leaf_inv(Blk& a, int g, int t, int lane) {
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int kn = k >> 3, kt = (k & 7) >> 1, ke = k & 1, kg = k & 7;
    const int kh = k >> 3;
    const int src_c = (lane & ~3) | kt;
    const float f0 = __shfl_sync(kFull, a[kn][ke], src_c);
    const float f1 = __shfl_sync(kFull, a[kn][2 + ke], src_c);
    float rk[2][2];
#pragma unroll
    for (int nj = 0; nj < 2; ++nj)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        rk[nj][e] = __shfl_sync(kFull, a[nj][2 * kh + e], 4 * kg + t);
    const float p = 1.0f / __shfl_sync(kFull, a[kn][2 * kh + ke], 4 * kg + kt);
    const bool tk = t == kt;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool rowk = h == kh && g == kg;
      const float f = h ? f1 : f0;
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool colk = nj == kn && e == ke && tk;
          const float qj = rk[nj][e] * p;
          float& x = a[nj][2 * h + e];
          x = rowk ? (colk ? p : qj) : (colk ? -f * p : fmaf(-f, qj, x));
        }
    }
  }
}

"""
PREDICT_CALL = "predict_cov<DP>(pm, fh, fl, q, park, g, t, lane);"
PRODUCTS = re.compile(r"(?:blk_mul|mul8)<[^;]*;")
MIN_BLOCKS = "constexpr int kMinBlocks = 2;"
INT_RNA = "return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;"
# the high parts rounded by cvt.rna.tf32.f32 itself (the same bits)
CVT_RNA = """uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;"""
FAST_RCP = "__fdividef(1.0f, __shfl_sync(kFull, ke ? x1 : x0, 4 * k + kt))"
IEEE_RCP = "1.0f / __shfl_sync(kFull, ke ? x1 : x0, 4 * k + kt)"
TC_NAMES = ("tensor cores", "FMA products", "no split", "leaf inverses alone",
            "no leaf inverses", "16-pivot leaves", "3 blocks an SM",
            "cvt.rna rounding", "IEEE reciprocals")

MMA_PROBE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
// Each warp issues `iters` rounds of 8 independent m16n8k8 TF32 products.
__global__ void __launch_bounds__(256) mma_probe(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = 0x3f800000u + threadIdx.x + i;
  for (int i = 0; i < 2; ++i) b[i] = 0x3f000000u + threadIdx.x + i;
  float d[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < 8; ++c)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
          : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
  }
  float s = 0.0f;
  for (int c = 0; c < 8; ++c)
    for (int i = 0; i < 4; ++i) s += d[c][i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int rxt_mma_probe(float* out, int blocks, int iters, void* s) {
  mma_probe<<<blocks, 256, 0, static_cast<cudaStream_t>(s)>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}
"""


def _cut(src: str, start: str, end: str) -> tuple[int, int]:
    i = src.index(start)
    return i, src.index(end, i) + len(end)


def variants(src: str) -> dict:
    """Variant name -> source text (the tensor-core tier's variants run on
    its launcher, the sweep tier's on the sweep launcher)."""
    for text in (INV_PM, INV_XM, MUL_FP, MUL_FPF, SWEEP_START, SWEEP_END,
                 *MMA_BODY, MMA3, *LEAF_CALLS, PREDICT_CALL, *INV16_CALLS,
                 INV16_AT, MIN_BLOCKS, INT_RNA, FAST_RCP):
        if text not in src:
            raise SystemExit(f"csrc/fused_filter_warp.cu has no {text!r}")
    sweep = src[src.index(SWEEP_START):src.index(SWEEP_END)]
    i, j = _cut(src, *MMA_BODY)
    no_products = PRODUCTS.sub("", src.replace(PREDICT_CALL, ""))
    no_leaves = src
    for call in LEAF_CALLS:
        no_leaves = no_leaves.replace(call, "")
    leaf16 = src.replace(INV16_AT, LEAF16 + INV16_AT)
    for call in INV16_CALLS:
        leaf16 = leaf16.replace(call, "leaf_inv" + call[call.index("("):])
    return {
        "tensor cores": src,
        "FMA products": src[:i] + FMA_BODY + src[j:],
        "no split": src.replace(MMA3, "  mma_tf32(d, ah, bh);\n"),
        "leaf inverses alone": no_products,
        "no leaf inverses": no_leaves,
        "16-pivot leaves": leaf16,
        "3 blocks an SM": src.replace(MIN_BLOCKS,
                                      "constexpr int kMinBlocks = 3;"),
        "cvt.rna rounding": src.replace(INT_RNA, CVT_RNA),
        "IEEE reciprocals": src.replace(FAST_RCP, IEEE_RCP),
        "no pivot sweeps": src.replace(sweep, ""),
        "no inverses": src.replace(INV_PM, "").replace(
            INV_XM, "mirror_upper(xm, d, s, lane);"),
        "no products": src.replace(MUL_FP, "").replace(MUL_FPF, ""),
    }


def build(texts: dict, out: str) -> dict:
    from rxinfer_tpu_torch import kernels

    texts = dict(texts, **{"mma probe": MMA_PROBE})
    procs = {}
    for i, (name, text) in enumerate(texts.items()):
        path = os.path.join(out, f"v{i}.cu")
        with open(path, "w") as fh:
            fh.write(text)
        procs[name] = (subprocess.Popen(
            [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o",
             os.path.join(out, f"libv{i}.so"), path], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), os.path.join(
            out, f"libv{i}.so"))
    libs = {}
    p, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for name, (proc, lib_path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(lib_path)
        if name == "mma probe":
            lib.rxt_mma_probe.argtypes = [p, ci, ci, p]
        else:
            lib.rxt_warp_filter.argtypes = [ci, ci, p, p, p, p, p, p, p, p, p,
                                            i64, i64, ci, ci, ci, ci, ci, p]
            lib.rxt_warp_filter_tc.argtypes = [ci, ci, p, p, p, p, p, p, p,
                                               p, i64, i64, ci, ci, p]
            lib.rxt_warp_filter_tc_blocks_per_sm.argtypes = [ci, ci]
        libs[name] = lib
        kernel = ""
        for line in log.splitlines():
            if "Compiling entry" in line:
                mangled = line.split("'")[1]
                kernel = ("tensor-core tier" if "warp_filter_tc_kernel"
                          in mangled else mangled.split("_kernel")[0][-11:]
                          + "_kernel" + mangled.split("_kernel")[-1][:12])
            elif "registers" in line or "spill" in line:
                print(f"[ptxas] {name}, {kernel}: {line.strip()}")
    return libs


def mma_rate(lib, dev) -> None:
    """mma.sync m16n8k8 TF32 products a second an SM, from a kernel that
    keeps 8 independent products in flight a warp, 32 warps an SM."""
    import torch

    from chip_smoke import _cuda_ms

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks, iters = 4 * sms, 4096
    out = torch.empty(blocks * 256, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        if lib.rxt_mma_probe(out.data_ptr(), blocks, iters, stream):
            raise RuntimeError("mma probe: CUDA error")

    ms = _cuda_ms(launch, 5)
    per_sm = blocks * 8 * iters * 8 / sms / (ms / 1e3)
    print(f"mma.sync m16n8k8 tf32: {ms:.4f} ms for {blocks * 8 * iters * 8} "
          f"products on {sms} SMs: {per_sm:.4g} a second an SM "
          f"({per_sm * sms * 2048 / 1e12:.1f} TFLOP/s)", flush=True)


def main(argv) -> int:
    import torch

    from chip_smoke import _cuda_ms, _filter_system
    from rxinfer_tpu_torch import kernels
    from rxinfer_tpu_torch.ops import fused_filter as ff
    from rxinfer_tpu_torch.ops.fused_smoother import sym_fold

    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"tree {os.getcwd()}; {smi}", flush=True)
    # the tier's 16 x 16 primitives inlined: the variants patch them too
    src = (kernels.CSRC / "fused_filter_warp.cu").read_text().replace(
        '#include "tc16.cuh"', (kernels.CSRC / "tc16.cuh").read_text())
    with tempfile.TemporaryDirectory() as out:
        libs = build(variants(src), out)
        mma_rate(libs.pop("mma probe"), dev)
        shapes = [tuple(int(x) for x in a.split("x"))
                  for a in (argv or DEFAULT_SHAPES)]
        stream = torch.cuda.current_stream().cuda_stream
        for b, t_len, d in shapes:
            f, q, h, r = _filter_system(d, d, seed=1)
            w_obs, hr = ff.evidence_operators(h, r)
            fh, qh, hrh, wh = ff._host_params(f, q, hr, w_obs, d, d)
            ys = torch.randn((t_len, d, b), device=dev,
                             generator=torch.Generator(dev).manual_seed(0))
            m0 = torch.zeros((d, b), device=dev)
            p0 = sym_fold((9 * torch.eye(d, device=dev)).expand(
                (b, d, d)).contiguous()).contiguous()
            hr_t = torch.as_tensor(np.ascontiguousarray(hrh.T), device=dev)
            limit = ff._smem_optin(torch.cuda.current_device())
            sweep = ff.sweep_warp_plan(d, limit)
            runs = []     # (name, library, tier)
            if d <= ff.TC_DIM:
                runs += [(n, n, "tc") for n in TC_NAMES]
            runs += [("sweep tier" if d <= ff.TC_DIM else "full",
                      "tensor cores", "sweep")]
            runs += [(n, n, "sweep") for n in
                     ("no pivot sweeps", "no inverses", "no products")]
            dp, stride = sweep["padded_dim"], sweep["stride"]
            prm = np.zeros((4, dp, stride), np.float32)
            for k, a in enumerate((fh, fh.T, qh, wh)):
                prm[k, :d, :d] = a
            params = torch.as_tensor(prm, device=dev)
            tc_prm = np.zeros((4, ff.TC_DIM, ff.TC_DIM + 4), np.float32)
            for k, a in enumerate((fh, fh.T, qh, wh)):
                tc_prm[k, :d, :d] = a
            tc_params = torch.as_tensor(tc_prm, device=dev)
            ps = sweep["params"] == "shared"
            cs = sweep["chain_matrices"] == "shared"
            chains = sweep["chains_per_block"]
            scratch = None if cs else torch.empty(
                (-(-b // chains) * chains * 2 * dp * stride,), device=dev)
            outs = {}
            for name, lib_name, tier in runs:
                lib = libs[lib_name]
                out = (torch.empty((t_len, d, b), device=dev),
                       torch.empty((d, b), device=dev), torch.empty_like(p0))

                def launch():
                    if tier == "tc":
                        rc = lib.rxt_warp_filter_tc(
                            d, d, ys.data_ptr(), m0.data_ptr(),
                            p0.data_ptr(), hr_t.data_ptr(),
                            tc_params.data_ptr(),
                            *(o.data_ptr() for o in out), t_len, b,
                            ff.TC_DIM + 4, ff.WARP_MAX_CHAINS, stream)
                    else:
                        rc = lib.rxt_warp_filter(
                            d, d, ys.data_ptr(), m0.data_ptr(),
                            p0.data_ptr(), hr_t.data_ptr(), params.data_ptr(),
                            *(o.data_ptr() for o in out),
                            None if scratch is None else scratch.data_ptr(),
                            t_len, b, dp, stride, chains, ps, cs, stream)
                    if rc:
                        raise RuntimeError(f"{name}: CUDA error {rc}")

                launch()
                torch.cuda.synchronize()
                outs[name] = out
                extra = ""
                if tier == "tc":
                    extra = (f", {lib.rxt_warp_filter_tc_blocks_per_sm(d, 8)} "
                             "blocks of 8 warps an SM")
                    if name != "tensor cores":
                        diff = float((out[0] - outs["tensor cores"][0]).abs()
                                     .max())
                        extra += f", means differ by up to {diff:.3g}"
                print(f"(B,T,d)=({b},{t_len},{d}) {name}: "
                      f"{_cuda_ms(launch, 3):.3f} ms{extra}", flush=True)
            if d <= ff.TC_DIM:
                diff = max(float((a - c).abs().max()) for a, c in zip(
                    outs["tensor cores"], outs["sweep tier"]))
                print(f"(B,T,d)=({b},{t_len},{d}) tensor-core and sweep tiers"
                      f" differ by up to {diff:.3g}", flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

#!/usr/bin/env python3
"""Where a step of the streaming filter kernel K3 spends its cycles: time
``csrc/fused_filter.cu`` at d = dy = 4 with parts of its step taken out.

    python3 scripts/filter_step_variants.py 10000x200 2500x200

Run from the root of a checkout; needs a CUDA device and ``nvcc``.  Each
variant is the source (beside ``csrc/smallmat.cuh``) under one set of
textual changes, cut at its C interface and given one launcher for the d = dy = 4
instances, built side by side under ``rxinfer_tpu_torch/_build/variants/``
with the package's nvcc flags:

  * ``base``: the source as it is;
  * ``fastrcp``: every reciprocal of the scaled Schur inverses an
    approximate ``__fdividef`` (no IEEE refinement, no slow-path check);
  * ``l2pf``: each thread also asks L2 (``prefetch.global.L2``) for its
    observations four steps ahead;
  * ``noload``: no observation loads, y made from the step index;
  * ``oneinv``: the first inverse (P_pred^-1) replaced by a copy;
  * ``noinv``: both inverses replaced by copies;
  * ``nostore``: the means are not written.

All but ``base`` compute wrong numbers: this measures, it checks nothing.
For each BxT it prints the least of two medians (CUDA events over 20
launches back to back, 9 repeats, variants in turns) and the cycles a step
at the SM clock ``nvidia-smi`` reads after the shape, under the card's name
and power limit.
"""

import ctypes
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, os.getcwd())

COPY = """
template <int D>
__device__ __forceinline__ void rxt_copy(const float (&a)[D][D],
                                         float (&b)[D][D]) {
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) b[i][j] = a[i][j];
}
"""
LAUNCHER = """
extern "C" int rxt_variant(const float* ys, const float* m0,
                           const float* p0, float* means, float* mf,
                           float* pf, int64_t T, int64_t B, const float* F,
                           const float* Q, const float* W, const float* HR,
                           void* stream) {
  return launch<4, 4>(ys, m0, p0, means, mf, pf, T, B, F, Q, W, HR,
                      static_cast<cudaStream_t>(stream));
}
"""
LOAD = "for (int k = 0; k < DY; ++k) ynext[k] = ys[((t + 1) * DY + k) * B + b];"
L2PF = [(LOAD, "for (int k = 0; k < DY; ++k) { ynext[k] = ys[((t + 1) * DY"
               " + k) * B + b]; if (t + 4 < T) asm volatile(\"prefetch."
               "global.L2 [%0];\" :: \"l\"(ys + ((t + 4) * DY + k) * B + b)"
               "); }")]
NO_LOAD = [(LOAD, "for (int k = 0; k < DY; ++k) ynext[k] = 0.25f * "
                  "static_cast<float>(t & 7) + k;")]
FAST = [("1.0f / m[0][0]", "__fdividef(1.0f, m[0][0])"),
        ("1.0f / det;", "__fdividef(1.0f, det);"),
        ("1.0f / scale;", "__fdividef(1.0f, scale);")]
ONE_INV = [("sym_inv_scaled<D>(p_pred, lam);", "rxt_copy<D>(p_pred, lam);")]
NO_INV = ONE_INV + [("sym_inv_scaled<D>(w_post, p);",
                     "rxt_copy<D>(w_post, p);")]
NO_STORE = [("means[(t * D + i) * B + b] = m[i];", "(void)0;")]
# variant -> (edits of fused_filter.cu, edits of smallmat.cuh)
EDITS = {"base": ([], []), "fastrcp": ([], FAST), "l2pf": (L2PF, []),
         "noload": (NO_LOAD, []), "oneinv": (ONE_INV, []),
         "noinv": (NO_INV, []), "nostore": (NO_STORE, [])}


def _edit(text: str, pairs) -> str:
    for old, new in pairs:
        if old not in text:
            raise ValueError(f"variant pattern not found: {old!r}")
        text = text.replace(old, new)
    return text


def build(root: Path) -> dict:
    from rxinfer_tpu_torch import kernels

    src = (kernels.CSRC / "fused_filter.cu").read_text()
    src = src[:src.index('extern "C" {')]
    header = (kernels.CSRC / "smallmat.cuh").read_text()
    procs = {}
    for name, (cu_edits, h_edits) in EDITS.items():
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "smallmat.cuh").write_text(_edit(header, h_edits))
        text = _edit(src, cu_edits).replace(
            "using namespace rxt;", "using namespace rxt;\n" + COPY, 1)
        (d / "fused_filter.cu").write_text(text + LAUNCHER)
        lib = d / "libvariant.so"
        cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", str(lib),
               str(d / "fused_filter.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        libs[name] = lib
    return libs


def _ms(fn, reps=9, inner=20):
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def main(argv) -> int:
    import torch

    from rxinfer_tpu_torch.ops import fused_filter as ff
    from rxinfer_tpu_torch.ops.fused_smoother import _host_ptr, sym_fold

    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"tree {os.getcwd()}; {smi}")
    t_build = time.perf_counter()
    paths = build(Path("rxinfer_tpu_torch/_build/variants/filter"))
    print(f"built {len(paths)} variants in "
          f"{time.perf_counter() - t_build:.1f} s")
    vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    libs = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(str(path.resolve()))
        lib.rxt_variant.argtypes = [vp] * 6 + [i64, i64] + [vp] * 5
        lib.rxt_variant.restype = ci
        libs[name] = lib
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    d = dy = 4
    rng = np.random.default_rng(7)
    qm, _ = np.linalg.qr(rng.standard_normal((d, d)))
    f = (0.98 * qm).astype(np.float32)
    q = (0.4 * np.eye(d)).astype(np.float32)
    h = (1.2 * np.eye(dy, d) + 0.2 * rng.standard_normal((dy, d))).astype(
        np.float32)
    r = (0.8 * np.eye(dy) + 0.1 * np.ones((dy, dy))).astype(np.float32)
    w_obs, hr = ff.evidence_operators(h, r)
    fh, qh, hrh, wh = ff._host_params(f, q, hr, w_obs, d, dy)
    for spec in argv:
        b, t = (int(x) for x in spec.split("x"))
        ys = torch.as_tensor(rng.standard_normal((t, dy, b), dtype=np.float32),
                             device=dev)
        m0 = torch.zeros((d, b), device=dev)
        p0 = sym_fold(torch.eye(d, device=dev).expand(b, d, d) * 9.0
                      ).contiguous()
        means = torch.empty((t, d, b), device=dev)
        mf = torch.empty((d, b), device=dev)
        pf = torch.empty((d * (d + 1) // 2, b), device=dev)
        res = {}
        for _ in range(2):
            for name, lib in libs.items():
                def launch(lib=lib):
                    rc = lib.rxt_variant(
                        ys.data_ptr(), m0.data_ptr(), p0.data_ptr(),
                        means.data_ptr(), mf.data_ptr(), pf.data_ptr(), t, b,
                        _host_ptr(fh), _host_ptr(qh), _host_ptr(wh),
                        _host_ptr(hrh), stream)
                    if rc:
                        raise RuntimeError(f"launch failed: {rc}")
                res.setdefault(name, []).append(_ms(launch))
        mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True).stdout.split()[0])
        print(f"(B,T,d,dy)=({b},{t},4,4) at {mhz:.0f} MHz: "
              + "; ".join(f"{n} {min(res[n]):.4f} ms "
                          f"({min(res[n]) * mhz * 1e3 / t:.0f} cycles a step)"
                          for n in EDITS), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

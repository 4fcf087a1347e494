#!/usr/bin/env python3
"""Where a step of the forward kernel K4 spends its cycles: time
``csrc/fused_fb.cu``'s forward kernel with parts of its step taken out.

    python3 scripts/fb_step_variants.py 256x200x3 4096x1000x3 64x10000x8

Run from the root of a checkout; needs a CUDA device and ``nvcc``.  Each
variant is the source (with its header ``fused_fb.cuh``, which holds the
log-sum-exp) with one textual change, built side by side under
``rxinfer_tpu_torch/_build/variants/<variant>/`` with the package's nvcc
flags:

  * ``base``: the source as it is;
  * ``fast``: ``__expf`` / ``__logf`` in the log-sum-exp (fast math);
  * ``noshfl``: no warp shuffles, each lane takes its own value for every
    state;
  * ``noring``: no evidence ring, the step adds a constant instead of its
    staged evidence (no prologue, barriers, copies or shared loads);
  * ``nostore``: the alphas are not written;
  * ``floor``: all four at once, the log-sum-exp chain alone.

All but ``base`` compute wrong numbers: this measures, it checks nothing.
For each BxTxK it prints the least of two medians (CUDA events over 20
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


def _segment(src: str, start: str, end: str) -> tuple[int, int]:
    a = src.index(start)
    return a, src.index(end, a)


def _sub(src: str, seg: tuple[str, str], pairs) -> str:
    """Replace each (old, new) inside the segment [seg[0], seg[1])."""
    a, b = _segment(src, *seg)
    body = src[a:b]
    for old, new in pairs:
        if old not in body:
            raise ValueError(f"variant pattern not found: {old!r}")
        body = body.replace(old, new)
    return src[:a] + body + src[b:]


LSE = ("__device__ __forceinline__ float lse(", "// ---- the evidence ring")
GATHER = ("__device__ __forceinline__ void gather(", "// ---- the evidence ring")
FWD = ("fb_fwd_kernel(const float*", "// ---- K5 (a)")
EDITS = {
    "fast": [(LSE, [("expf(", "__expf("), ("logf(", "__logf(")])],
    "noshfl": [(GATHER, [("__shfl_sync(kFullMask, mine, j, lanes_per_chain<K>())",
                          "mine")])],
    "noring": [(FWD, [("r.prologue();", ""), ("r.acquire(tile)", "ring"),
                      ("fill.step(r.refills(t));", ""), ("r.commit();", ""),
                      ("prior + *ev", "prior + 0.5f"),
                      ("lse<K>(terms) + *ev", "lse<K>(terms) + 0.5f")])],
    "nostore": [(FWD, [("if (me.owner) *out = mine - m;", "")])],
}
EDITS["floor"] = [e for name in ("fast", "noshfl", "noring", "nostore")
                  for e in EDITS[name]]
VARIANTS = ("base", "fast", "noshfl", "noring", "nostore", "floor")


def build(root: Path) -> dict:
    from rxinfer_tpu_torch import kernels

    files = {n: (kernels.CSRC / n).read_text()
             for n in ("fused_fb.cu", "fused_fb.cuh")}
    procs = {}
    for name in VARIANTS:
        texts = dict(files)
        for seg, pairs in EDITS.get(name, []):
            fname = "fused_fb.cuh" if seg is LSE else "fused_fb.cu"
            texts[fname] = _sub(texts[fname], seg, pairs)
        vdir = root / name
        vdir.mkdir(parents=True, exist_ok=True)
        for fname, text in texts.items():
            (vdir / fname).write_text(text)
        lib = vdir / "fused_fb.so"
        cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", str(lib),
               str(vdir / "fused_fb.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), lib)
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

    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"tree {os.getcwd()}; {smi}")
    t_build = time.perf_counter()
    paths = build(Path("rxinfer_tpu_torch/_build/variants"))
    print(f"built {len(paths)} variants in {time.perf_counter() - t_build:.1f} s")
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    libs = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(str(path.resolve()))
        lib.rxt_fb_fwd.argtypes = [ctypes.c_int, vp, vp, vp, vp, vp, i64, i64, vp]
        lib.rxt_fb_fwd.restype = ctypes.c_int
        libs[name] = lib
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    for spec in argv:
        b, t, k = (int(x) for x in spec.split("x"))
        rng = np.random.default_rng(7)
        lp, lt, le = (torch.as_tensor(a.astype(np.float32), device=dev) for a in (
            rng.standard_normal((b, k)), 2.0 * rng.standard_normal((b, k, k)),
            2.0 * rng.standard_normal((t, b, k))))
        alphas = torch.empty_like(le)
        logz = torch.empty((b,), device=dev)
        res = {}
        for _ in range(2):
            for name, lib in libs.items():
                def launch(lib=lib):
                    rc = lib.rxt_fb_fwd(k, lp.data_ptr(), lt.data_ptr(),
                                        le.data_ptr(), alphas.data_ptr(),
                                        logz.data_ptr(), t, b, stream)
                    if rc:
                        raise RuntimeError(f"launch failed: {rc}")
                res.setdefault(name, []).append(_ms(launch))
        mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True).stdout.split()[0])
        print(f"(B,T,K)=({b},{t},{k}) at {mhz:.0f} MHz: " + "; ".join(
            f"{n} {min(v):.4f} ms ({min(v) * mhz * 1e3 / t:.0f} cycles a step)"
            for n, v in res.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

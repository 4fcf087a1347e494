#!/usr/bin/env python3
"""Where the wide forward-backward's time goes at K <= 16: time the serial
launch and the marginal launch of ``csrc/fused_fb_wide.cu`` with parts of
their step taken out.

    python3 scripts/fb_wide_variants.py 1024x1000x16

Run from the root of a checkout; needs a CUDA device and ``nvcc``.  Each
variant is the source with textual changes, built side by side under
``rxinfer_tpu_torch/_build/fb_wide_variants/<variant>/`` with the
package's nvcc flags, all builds started together.  A variant changes the
serial kernel and the marginal kernel at once (their edits do not touch
each other), so one build serves one question about each:

  serial launch (both recursions; and each alone)  |  marginal launch
  ``base``     the source as it is                 |  the source as it is
  ``fast``     ``__expf`` / ``__logf`` in the       |  ``blocks6``: six CTAs an
               half-warp log-sum-exp               |  SM (80 registers)
  ``noxhalf``  no shuffle across the half-warps    |  ``blocks8``: eight (64)
  ``nomax``    no state maximum (no normalising    |  ``nodiv``: a multiply in
               shuffles)                           |  place of the IEEE division
  ``noring``   no evidence refill                   |  ``fastexp``: ``__expf``
  ``floor``    all four at once                    |  ``nostore``: no per-step
                                                   |  xi stored

All but ``base`` compute wrong numbers: this measures, it checks nothing.
The marginal launch of each variant runs at the tile ``pick_tile_wide``
gives for the warps an SM its launch bounds allow.  For each BxTxK it
prints the least of two medians (CUDA events over 20 launches back to
back, 9 repeats, variants in turns), the cycles a step at the SM clock
``nvidia-smi`` reads after the shape, and the marginal launch's GB/s
beside a device copy of as many bytes (read and written), under the
card's name and power limit.
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

LSE = ("__device__ __forceinline__ float lse_halves(",
       "__host__ __device__ inline int64_t round4")
FWD = ("__device__ void forward_halves(", "// K > 16: lane i state i")
BETA = ("__device__ void beta_halves(", "// K > 16: lane j computes")
MARG = ("fb_wide_marg_half_kernel(const float*", "// K > 16: a warp a unit")
TOP = ("constexpr int kChainWarps", "__device__ __forceinline__ float warp_max")

SERIAL_EDITS = {
    "fast": [(LSE, [("expf(", "__expf("), ("logf(", "__logf(")])],
    "noxhalf": [(LSE, [("fmaxf(m, __shfl_xor_sync(kFullMask, m, kHalf))", "m"),
                       ("s + __shfl_xor_sync(kFullMask, s, kHalf)", "s")])],
    "nomax": [(FWD, [("const float m = half_max(raw);",
                      "const float m = 0.0f;")]),
              (BETA, [("beta = raw - half_max(raw);", "beta = raw;")])],
    "noring": [(FWD, [("r.copy<false>(feed, static_cast<int>(t - t0));",
                       "")]),
               (BETA, [("r.copy<false>(feed, static_cast<int>(t1 - 1 - t));",
                        "")])],
}
SERIAL_EDITS["floor"] = [e for n in ("fast", "noxhalf", "nomax", "noring")
                         for e in SERIAL_EDITS[n]]
MARG_EDITS = {
    "blocks6": [(TOP, [("kMargBlocksPerSM = 5;", "kMargBlocksPerSM = 6;")])],
    "blocks8": [(TOP, [("kMargBlocksPerSM = 5;", "kMargBlocksPerSM = 8;")])],
    "nodiv": [(MARG, [("x[m][k] = x[m][k] / tot;",
                       "x[m][k] = x[m][k] * tot;")])],
    "fastexp": [(MARG, [("expf(", "__expf(")])],
    "nostore": [(MARG, [("if constexpr (STEPS) {", "if constexpr (false) {")])],
}
# (serial edit, marginal edit) of each build
VARIANTS = {"base": (None, None), "fast": ("fast", "blocks6"),
            "noxhalf": ("noxhalf", "blocks8"), "nomax": ("nomax", "nodiv"),
            "noring": ("noring", "fastexp"), "floor": ("floor", "nostore")}


def _sub(src: str, seg: tuple[str, str], pairs) -> str:
    """Replace each (old, new) inside the segment [seg[0], seg[1])."""
    a = src.index(seg[0])
    b = src.index(seg[1], a)
    body = src[a:b]
    for old, new in pairs:
        if old not in body:
            raise ValueError(f"variant pattern not found: {old!r}")
        body = body.replace(old, new)
    return src[:a] + body + src[b:]


def build(root: Path) -> dict:
    from rxinfer_tpu_torch import kernels

    files = {n: (kernels.CSRC / n).read_text()
             for n in ("fused_fb_wide.cu", "fused_fb.cuh")}
    procs = {}
    for name, (serial, marg) in VARIANTS.items():
        text = files["fused_fb_wide.cu"]
        for seg, pairs in (SERIAL_EDITS.get(serial, [])
                           + MARG_EDITS.get(marg, [])):
            text = _sub(text, seg, pairs)
        vdir = root / name
        vdir.mkdir(parents=True, exist_ok=True)
        (vdir / "fused_fb_wide.cu").write_text(text)
        (vdir / "fused_fb.cuh").write_text(files["fused_fb.cuh"])
        lib = vdir / "fused_fb_wide.so"
        cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", str(lib),
               str(vdir / "fused_fb_wide.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        spills = [line.split(":", 1)[-1].strip() for line in log.splitlines()
                  if "spill" in line and " 0 bytes spill stores" not in line]
        print(f"[ptxas] {name}: " + ("; ".join(spills) if spills
                                     else "no spill"))
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


def _tile(b: int, t: int, sms: int, warps_per_sm: int) -> int:
    """``pick_tile_wide`` at ``warps_per_sm`` marginal warps an SM."""
    n = max(1, sms * warps_per_sm * 2 // max(b, 1))
    return max(1, min(t, max(4, -(-t // n))))


def main(argv) -> int:
    import torch

    from rxinfer_tpu_torch import kernels

    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"tree {os.getcwd()}; {smi}")
    t_build = time.perf_counter()
    paths = build(Path("rxinfer_tpu_torch/_build/fb_wide_variants"))
    print(f"built {len(paths)} variants in {time.perf_counter() - t_build:.1f} s")
    vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    libs = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(str(path.resolve()))
        lib.rxt_fb_wide_serial.argtypes = [ci, ci, vp, vp, vp, vp, vp, vp,
                                           i64, i64, vp]
        lib.rxt_fb_wide_marg.argtypes = [ci, ci, vp, vp, vp, vp, vp, vp, vp,
                                         vp, i64, i64, i64, i64, vp]
        libs[name] = lib
    dev = torch.device("cuda")
    sms = kernels.sm_count(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for spec in argv:
        b, t, k = (int(x) for x in spec.split("x"))
        rng = np.random.default_rng(7)
        lp, lt, le = (torch.as_tensor(a.astype(np.float32), device=dev)
                      for a in (rng.standard_normal((b, k)),
                                2.0 * rng.standard_normal((b, k, k)),
                                2.0 * rng.standard_normal((t, b, k))))
        alphas, betas, gammas = (torch.empty_like(le) for _ in range(3))
        logz = torch.empty((b,), device=dev)
        xi_sum = torch.empty((b, k, k), device=dev)
        xis = torch.empty((t - 1, b, k, k), device=dev)
        libs["base"].rxt_fb_wide_serial(
            k, 3, lp.data_ptr(), lt.data_ptr(), le.data_ptr(),
            alphas.data_ptr(), logz.data_ptr(), betas.data_ptr(), t, b,
            stream)
        runs = {}
        for name, lib in libs.items():
            warps = lib.rxt_fb_wide_marg_warps_per_sm()
            tile = _tile(b, t, sms, warps)
            tiles = -(-t // tile)
            part = torch.empty((tiles, b, k, k), device=dev)
            for roles, what in ((3, "serial"), (1, "forward"), (2, "beta")):
                def serial(lib=lib, roles=roles):
                    rc = lib.rxt_fb_wide_serial(
                        k, roles, lp.data_ptr(), lt.data_ptr(),
                        le.data_ptr(), alphas.data_ptr(), logz.data_ptr(),
                        betas.data_ptr(), t, b, stream)
                    if rc:
                        raise RuntimeError(f"{name}: serial launch {rc}")
                runs[(name, what)] = serial

            def marg(lib=lib, tile=tile, tiles=tiles, part=part):
                rc = lib.rxt_fb_wide_marg(
                    k, 1, lt.data_ptr(), le.data_ptr(), alphas.data_ptr(),
                    betas.data_ptr(), gammas.data_ptr(),
                    (part if tiles > 1 else xi_sum).data_ptr(),
                    xi_sum.data_ptr(), xis.data_ptr(), t, b, tile, tiles,
                    stream)
                if rc:
                    raise RuntimeError(f"{name}: marginal launch {rc}")
            runs[(name, f"marginals (tile {tile})")] = marg
        marg_bytes = 4 * (2 * b * k * k + 4 * t * b * k + (t - 1) * b * k * k)
        src = torch.empty(marg_bytes // 8, device=dev)   # read and written
        dst = torch.empty_like(src)
        runs[("copy", "device copy")] = lambda: dst.copy_(src)
        res = {}
        for _ in range(2):
            for key, fn in runs.items():
                res.setdefault(key, []).append(_ms(fn))
        mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True).stdout.split()[0])
        copy_ms = min(res[("copy", "device copy")])
        print(f"(B,T,K)=({b},{t},{k}) at {mhz:.0f} MHz; device copy of "
              f"{2 * src.numel() * 4 / 1e9:.3f} GB {copy_ms:.4f} ms "
              f"({2 * src.numel() * 4 / copy_ms / 1e6:.0f} GB/s); {smi}")
        for name, (serial, margv) in VARIANTS.items():
            parts = []
            for (n, what), v in res.items():
                if n != name:
                    continue
                ms = min(v)
                extra = (f", {marg_bytes / ms / 1e6:.0f} GB/s"
                         if what.startswith("marginals") else "")
                parts.append(f"{what} {ms:.4f} ms ({ms * mhz * 1e3 / t:.0f} "
                             f"cycles a step{extra})")
            print(f"  {name} (serial {serial or 'base'}, marginal "
                  f"{margv or 'base'}): " + "; ".join(parts), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

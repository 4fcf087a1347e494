#!/usr/bin/env python3
"""Where the wide K5's marginal kernel past 32 states
(``fb_wide_marg_rows2_kernel`` of ``csrc/fused_fb_wide.cu``) spends its
time: time it with parts of its step changed, on random inputs and on the
64-state path's last-sweep inputs.

    python3 scripts/marg_rows2_variants.py [BxTxK]    (default 512x1000x64)

Run from the root of a checkout; needs a CUDA device and ``nvcc``.  Each
variant is the source with textual changes inside the kernel, built side
by side under ``rxinfer_tpu_torch/_build/marg_rows2_variants/<variant>/``
with the package's nvcc flags, all builds started together:

  ``base``      the source as it is
  ``fastexp``   ``__expf`` in place of ``expf``
  ``nodiv``     a multiply by the sum's reciprocal in place of the
                quotient
  ``ieeediv``   the IEEE division by the sum (the same bits as the
                source's quotient by the hoisted reciprocal)
  ``nostore``   no per-step xi staged or stored

All but ``base`` and ``ieeediv`` compute wrong numbers: this measures, it
checks nothing.
Two input sets: ``random`` (log A and the log-evidence 2 N(0, 1), as
``scripts/time_fb_kernels.py``) and ``path`` (``chip_smoke.py`` phase 27
(b)'s program at B x T with K states and K categories, 20 sweeps, the
chain's last-sweep inputs, as ``chip_smoke.hmm16_path`` takes them).  For
each it prints the share of the per-step xi entries that are subnormal
and zero (``base``'s output), then each variant's median of 9 repeats of
5 launches back to back (CUDA events, after a warm-up), with the card's
name, power limit and the SM clock ``nvidia-smi`` reads after the set.
"""

import ctypes
import os
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, os.getcwd())

SEG = ("fb_wide_marg_rows2_kernel(const float*", "// K > 64 (it takes any K)")
VARIANTS = {
    "base": [],
    "fastexp": [("expf(", "__expf(")],
    "nodiv": [("x[j] = quot_by_sum(x[j], xs, rx);", "x[j] = x[j] * rx;")],
    "ieeediv": [("x[j] = quot_by_sum(x[j], xs, rx);", "x[j] = x[j] / xs;")],
    "nostore": [("if constexpr (STEPS) {", "if constexpr (false) {")],
}


def _sub(src: str, pairs) -> str:
    a = src.index(SEG[0])
    b = src.index(SEG[1], a)
    body = src[a:b]
    for old, new in pairs:
        if old not in body:
            raise SystemExit(f"variant pattern not found: {old!r}")
        body = body.replace(old, new)
    return src[:a] + body + src[b:]


def build(root: Path) -> dict:
    from rxinfer_tpu_torch import kernels

    files = {n: (kernels.CSRC / n).read_text()
             for n in ("fused_fb_wide.cu", "fused_fb.cuh")}
    procs = {}
    for name, pairs in VARIANTS.items():
        vdir = root / name
        vdir.mkdir(parents=True, exist_ok=True)
        (vdir / "fused_fb_wide.cu").write_text(
            _sub(files["fused_fb_wide.cu"], pairs))
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
        libs[name] = ctypes.CDLL(str(lib))
        p, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        libs[name].rxt_fb_wide_marg.argtypes = [ci, ci, p, p, p, p, p, p, p,
                                                p, i64, i64, i64, i64, p]
    return libs


def _ms(fn, reps=9, inner=5):
    import torch

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


def path_inputs(b: int, t: int, k: int, device):
    """Phase 27 (b)'s program at (B, T, K), K categories, 20 sweeps: the
    chain's last-sweep inputs (log prior, E[log A], log-evidence)."""
    import torch

    import chip_smoke as cs
    import rxinfer_tpu_torch as rt
    from rxinfer_tpu_torch.engine.blocks import BatchContext
    from rxinfer_tpu_torch.models import zoo

    y = torch.as_tensor(cs.hmm16_y(b, t, k, k), device=device)
    a0, b0 = cs.hmm_k_init(k, k)
    init = {"A": rt.DirichletCollection(a0), "B": rt.DirichletCollection(b0)}
    compiled, prog = rt.batched_program(zoo.hmm(k, k), {"y": y},
                                        iterations=20, initialization=init,
                                        device=device)
    state, _, _ = prog({"y": y})
    block = next(blk for kind, blk in compiled.blocks if blk.var.name == "s")
    return block._inputs(state, {"y": y}, {}, BatchContext(device, b, {}))


def main(argv) -> int:
    import torch

    from rxinfer_tpu_torch import kernels
    from rxinfer_tpu_torch.ops import fused_fb as ffb

    b, t, k = (int(x) for x in (argv[0] if argv else "512x1000x64").split(
        "x"))
    dev = torch.device("cuda")
    smi = lambda q: subprocess.run(
        ["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(f"{smi('name,power.limit')}; (B, T, K) = ({b}, {t}, {k})",
          flush=True)
    libs = build(kernels.BUILD_DIR / "marg_rows2_variants")
    rng = np.random.default_rng(7)
    sets = {"random": tuple(torch.as_tensor(a.astype(np.float32), device=dev)
                            for a in (rng.standard_normal((b, k)),
                                      2 * rng.standard_normal((b, k, k)),
                                      2 * rng.standard_normal((t, b, k)))),
            "path": path_inputs(b, t, k, dev)}
    tile = ffb.pick_tile_wide(b, t, kernels.sm_count(dev), k)
    tiles = -(-t // tile)
    stream = torch.cuda.current_stream().cuda_stream
    for label, (lp, lt, le) in sets.items():
        alphas, _, betas = ffb.fb_serial_wide(lp, lt, le)
        gammas = torch.empty_like(alphas)
        xi_sum = torch.empty((b, k, k), device=dev)
        part = torch.empty((tiles, b, k, k), device=dev) if tiles > 1 \
            else xi_sum
        xis = torch.empty((t - 1, b, k, k), device=dev)
        times = {}
        for name, lib in libs.items():
            def run(lib=lib):
                rc = lib.rxt_fb_wide_marg(
                    k, 1, lt.data_ptr(), le.data_ptr(), alphas.data_ptr(),
                    betas.data_ptr(), gammas.data_ptr(), part.data_ptr(),
                    xi_sum.data_ptr(), xis.data_ptr(), t, b, tile, tiles,
                    stream)
                if rc:
                    raise RuntimeError(f"{name}: CUDA error {rc}")
            if name == "base":
                run()
                torch.cuda.synchronize()
                tiny = float(((xis > 0) & (xis < 1.1754944e-38)).float()
                             .mean())
                zero = float((xis == 0).float().mean())
                print(f"{label}: per-step xi subnormal {tiny:.4f}, zero "
                      f"{zero:.4f}", flush=True)
            times[name] = _ms(run)
        print(f"{label}: " + ", ".join(f"{n} {ms:.4f} ms"
                                       for n, ms in times.items())
              + f" (tile {tile}); SM clock {smi('clocks.sm')}", flush=True)
        del gammas, xis, part, xi_sum
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

#!/usr/bin/env python3
"""Time the port's HMM forward-backward kernels K4 and K5 alone at given
shapes.

    python3 scripts/time_fb_kernels.py 256x200x3 4096x1000x3 64x10000x8
    python3 scripts/time_fb_kernels.py --ptxas 256x200x3

Run from the root of a checkout (the package is imported from the current
directory, so two checkouts can be timed in turns inside one job on one
card).  Needs a CUDA device and ``nvcc``.  For each BxTxK it prints the
median milliseconds of ``fb_forward`` and of ``fb_backward`` (per-step xi
on, as the HMM path calls it) over CUDA events, launches back to back
(random inputs, seed 7), after half a second of launches that brings the
clock up, and the cycles a step at the SM clock that ``nvidia-smi`` sampled
meanwhile.  The card's name and power
limit head the output.  ``--ptxas`` first prints the ``-Xptxas -v`` lines
of ``csrc/fused_fb.cu``.  It checks nothing: ``chip_smoke.py`` holds the
kernels against their plain versions.
"""

import os
import statistics
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.getcwd())


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


class ClockSampler:
    """``nvidia-smi`` sampling the SM clock every 50 ms while it is open."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
             "-lms", "50"], stdout=subprocess.PIPE, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate()
        mhz = [float(x) for x in out.split() if x.replace(".", "").isdigit()]
        self.mhz = statistics.median(mhz) if mhz else float("nan")
        return False


def main(argv) -> int:
    import torch

    from rxinfer_tpu_torch import kernels
    from rxinfer_tpu_torch.ops import fused_fb as ffb

    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"tree {os.getcwd()}; {smi}")
    if argv and argv[0] == "--ptxas":
        argv = argv[1:]
        kernels.load("fused_fb")
        for line in kernels.ptxas_report("fused_fb").splitlines():
            if any(k in line for k in ("Compiling entry", "registers", "spill",
                                       "smem")):
                print(f"[ptxas] {line.strip()}")
    for spec in argv:
        b, t, k = (int(x) for x in spec.split("x"))
        rng = np.random.default_rng(7)
        lp, lt, le = (torch.as_tensor(a.astype(np.float32), device=dev) for a in (
            rng.standard_normal((b, k)), 2.0 * rng.standard_normal((b, k, k)),
            2.0 * rng.standard_normal((t, b, k))))
        alphas, _ = ffb.fb_forward(lp, lt, le)
        fwd_fn = lambda: ffb.fb_forward(lp, lt, le)
        bwd_fn = lambda: ffb.fb_backward(lt, le, alphas, per_step_xi=True)
        with ClockSampler() as clk:
            end = time.perf_counter() + 0.5   # launches that bring the clock up
            while time.perf_counter() < end:
                fwd_fn()
                bwd_fn()
            torch.cuda.synchronize()
            fwd = _ms(fwd_fn)
            bwd = _ms(bwd_fn)
        cyc = lambda ms: ms * 1e-3 * clk.mhz * 1e6 / t
        print(f"(B,T,K)=({b},{t},{k}): K4 {fwd:.4f} ms ({cyc(fwd):.0f} cycles "
              f"a step), K5 {bwd:.4f} ms ({cyc(bwd):.0f} cycles a step) at "
              f"{clk.mhz:.0f} MHz")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

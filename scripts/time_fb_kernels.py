#!/usr/bin/env python3
"""Time the port's HMM forward-backward kernels K4 and K5 alone at given
shapes.

    python3 scripts/time_fb_kernels.py 256x200x3 4096x1000x3 64x10000x8
    python3 scripts/time_fb_kernels.py --ptxas 256x200x3
    python3 scripts/time_fb_kernels.py --ptxas --check 1024x1000x16

Run from the root of a checkout (the package is imported from the current
directory, so two checkouts can be timed in turns inside one job on one
card).  Needs a CUDA device and ``nvcc``.  For each BxTxK it prints the
median milliseconds of ``fb_forward`` and of ``fb_backward`` (per-step xi
on, as the HMM path calls it) over CUDA events, launches back to back
(random inputs, seed 7), after half a second of launches that brings the
clock up, and the cycles a step at the SM clock that ``nvidia-smi`` sampled
meanwhile.  Above eight states, where the tree has them, it also times the
two calls of ``fused_fb_batched``: ``fb_serial_wide`` (both recursions in
one launch; the beta recursion alone) and ``fb_marginals_wide`` (the marginal kernel and
xi_sum's), with the marginal pass's GB/s.  The card's name and power
limit head the output.  ``--ptxas`` first prints the ``-Xptxas -v`` lines
of ``csrc/fused_fb.cu`` (and of ``csrc/fused_fb_wide.cu`` when a shape has
K > 8).  ``--check`` holds each call's outputs against the plain versions
(max abs error, and whether the bits are equal); otherwise it checks
nothing, and ``chip_smoke.py`` holds the kernels against their plain
versions.
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
    flags = {a for a in argv if a.startswith("--")}
    argv = [a for a in argv if not a.startswith("--")]
    if "--ptxas" in flags:
        names = ["fused_fb"] + (["fused_fb_wide"] if any(
            int(a.split("x")[2]) > ffb.REG_MAX_STATES for a in argv) else [])
        for name in names:
            kernels.load(name)
            for line in kernels.ptxas_report(name).splitlines():
                if any(k in line for k in ("Compiling entry", "registers",
                                           "spill", "smem")):
                    print(f"[ptxas] {name}: {line.strip()}")
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
        if "--check" in flags:
            _check(ffb, (lp, lt, le), "K4/K5", ffb.fb_forward(lp, lt, le)
                   + ffb.fb_backward(lt, le, alphas, per_step_xi=True))
        if k > ffb.REG_MAX_STATES and hasattr(ffb, "fb_serial_wide"):
            _time_wide(ffb, lp, lt, le, "--check" in flags)
    return 0


def _check(ffb, inputs, what, got):
    """Max abs error of (alphas, logz, gammas, xi_sum, xi_steps) against the
    plain versions at the card's tile, and whether every bit is equal."""
    import torch

    lp, lt, le = inputs
    t, b, k = le.shape
    a_r, z_r = ffb.fb_forward_reference(lp, lt, le)
    ref = (a_r, z_r) + ffb.fb_backward_reference(
        lt, le, got[0], True, tile=ffb.device_tile(b, t, le.device, k))
    errs = [float((g - r).abs().max()) for g, r in zip(got, ref)]
    equal = all(torch.equal(g, r) for g, r in zip(got, ref))
    print(f"  {what} against the plain versions: max abs alphas, logz, "
          f"gammas, xi_sum, xi_steps {[f'{e:.3g}' for e in errs]}; "
          f"bit-equal {equal}")


def _time_wide(ffb, lp, lt, le, check: bool):
    """The two calls of ``fused_fb_batched`` above eight states, alone."""
    t, b, k = le.shape
    alphas, logz, betas = ffb.fb_serial_wide(lp, lt, le)
    runs = {
        "serial (both)": lambda: ffb.fb_serial_wide(lp, lt, le),
        # the forward recursion alone is fb_forward's launch, timed above
        "serial (beta alone)": lambda: ffb._serial_cuda(
            None, lt, le, forward=False, beta=True),
        "marginals": lambda: ffb.fb_marginals_wide(lt, le, alphas, betas,
                                                   per_step_xi=True),
    }
    with ClockSampler() as clk:
        end = time.perf_counter() + 0.3
        while time.perf_counter() < end:
            for fn in runs.values():
                fn()
        ms = {name: _ms(fn) for name, fn in runs.items()}
    marg_bytes = 4 * (b * k * k + 4 * t * b * k + (t - 1) * b * k * k
                      + b * k * k)
    tile = ffb.device_tile(b, t, le.device, k)
    print(f"  wide calls at {clk.mhz:.0f} MHz: " + "; ".join(
        f"{n} {v:.4f} ms ({v * 1e-3 * clk.mhz * 1e6 / t:.0f} cycles a step)"
        for n, v in ms.items())
        + f"; marginals {marg_bytes / (ms['marginals'] * 1e-3) / 1e9:.0f} "
        f"GB/s over {marg_bytes / 1e9:.3f} GB, tile {tile} "
        f"({-(-t // tile)} tiles)")
    if check:
        g, xs, steps = ffb.fb_marginals_wide(lt, le, alphas, betas, True)
        _check(ffb, (lp, lt, le), "fb_serial_wide + fb_marginals_wide",
               (alphas, logz, g, xs, steps))


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

#!/usr/bin/env python3
"""Time the port's streaming filter kernel K3 alone at given shapes.

    python3 scripts/time_filter_kernels.py
    python3 scripts/time_filter_kernels.py --ptxas 10000x200x4x4 2500x200x4x4

Run from the root of a checkout (the package is imported from the current
directory, so two checkouts can be timed in turns inside one job on one
card: ``cd parent && python3 ../scripts/time_filter_kernels.py ...``).
Needs a CUDA device and ``nvcc``.  Each BxTxDxDY (default: B = 2,500,
10,000, 20,000, 40,000 and 80,000 at T = 200, d = dy = 4, and
(10,000, 200, 2, 2), (10,000, 200, 8, 8)) gets random inputs of a stable
system from a numpy seed, and the script prints the device time per launch
of ``fused_filter`` (``torch.profiler``, device rows only), the median
milliseconds between CUDA events over launches back to back (after half a
second of launches that brings the clock up), the cycles a step at the SM
clock that ``nvidia-smi`` sampled meanwhile, the share of the bound the
device time reaches (``chip_smoke.filter_bound``: observations and state
read once, means and state written once over 3.35 TB/s, against the step's
float32 operations over 67 TFLOP/s; at 16 < d <= 32 its products over the
3xTF32 rate, 495 / 3 TFLOP/s).  The card's name and power limit
head the output.  ``--ptxas`` first prints the ``-Xptxas -v`` lines of
``csrc/fused_filter.cu`` for the instances of the shapes timed.
``--path`` last times path A's call, ``make_sharded_filtering(None, ...,
fused=True)`` on 10,000 chains, T = 200, d = 4 with the JAX package's bench
constants (``chip_smoke.lgssm_constants``): CUDA events, the device busy
time a call and K3's device time in it.  It checks nothing:
``chip_smoke.py`` holds the kernel against its plain version.
"""

import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.getcwd())

DEFAULT_SHAPES = ["2500x200x4x4", "10000x200x4x4", "20000x200x4x4",
                  "40000x200x4x4", "80000x200x4x4", "10000x200x2x2",
                  "10000x200x8x8"]


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


def _device_ms(fn, name, calls=20):
    """Device ms per launch of the kernels whose name holds ``name`` over
    ``calls`` calls under ``torch.profiler``; per event found, since the
    profiler can lose a launch's event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ev = [e.device_time_total for e in prof.events()
          if e.device_type == DeviceType.CUDA and name in e.name]
    return sum(ev) / 1e3 / len(ev) if ev else float("nan")


class ClockSampler:
    """``nvidia-smi`` sampling the SM clock every 50 ms while it is open."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm",
             "--format=csv,noheader,nounits", "-lms", "50"],
            stdout=subprocess.PIPE, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate()
        mhz = [float(x) for x in out.split() if x.replace(".", "").isdigit()]
        self.mhz = statistics.median(mhz) if mhz else float("nan")
        return False


def bound_ms(b: int, t: int, d: int, dy: int) -> tuple[float, str]:
    """The least time of K3 at (B, T, d, dy), as ``chip_smoke.py`` counts
    it."""
    from chip_smoke import filter_bound

    bnd = filter_bound(b, t, d, dy)
    return bnd["bound_ms"], bnd["bound_by"]


def _inputs(b, t, d, dy, dev):
    import torch

    from rxinfer_tpu_torch.ops import fused_filter as ff
    from rxinfer_tpu_torch.ops.fused_smoother import sym_fold

    rng = np.random.default_rng(7)
    qm, _ = np.linalg.qr(rng.standard_normal((d, d)))
    f = (0.98 * qm).astype(np.float32)
    q = (0.4 * np.eye(d)).astype(np.float32)
    h = (1.2 * np.eye(dy, d) + 0.2 * rng.standard_normal((dy, d))).astype(
        np.float32)
    r = (0.8 * np.eye(dy) + 0.1 * np.ones((dy, dy))).astype(np.float32)
    w_obs, hr = ff.evidence_operators(h, r)
    ys = torch.as_tensor(rng.standard_normal((t, dy, b), dtype=np.float32),
                         device=dev)
    m0 = torch.as_tensor(rng.standard_normal((d, b), dtype=np.float32),
                         device=dev)
    p = torch.as_tensor(np.broadcast_to(9.0 * np.eye(d, dtype=np.float32),
                                        (b, d, d)).copy(), device=dev)
    return m0, sym_fold(p).contiguous(), ys, f, q, hr, w_obs


def time_path(dev, b=10_000, t_len=200, d=4):
    """Path A's call: ms between events, device busy ms a call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import lgssm_constants
    from rxinfer_tpu_torch.parallel.filtering import (
        FilterState,
        make_sharded_filtering,
    )

    f, q, h, r, _, p0 = lgssm_constants(d)
    ys = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (t_len, b, d), dtype=np.float32), device=dev)
    state = FilterState(torch.zeros((b, d), device=dev), torch.as_tensor(
        p0, device=dev).expand((b, d, d)).contiguous())
    fn = make_sharded_filtering(None, f, q, h, r, fused=True)
    call = lambda: fn(state, ys)
    ev = _ms(call, reps=9, inner=10)
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            call()
        torch.cuda.synchronize()
    dev_ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.device_time_total for e in dev_ev) / 1e3 / 10
    k3 = [e.device_time_total for e in dev_ev if "filter_" in e.name]
    return ev, busy, sum(k3) / 1e3 / len(k3) if k3 else float("nan")


def main(argv) -> int:
    import torch

    from rxinfer_tpu_torch import kernels
    from rxinfer_tpu_torch.ops import fused_filter as ff

    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"tree {os.getcwd()}; {smi}")
    ptxas = "--ptxas" in argv
    path = "--path" in argv
    specs = [a for a in argv if not a.startswith("--")] or DEFAULT_SHAPES
    shapes = [tuple(int(x) for x in s.split("x")) for s in specs]
    if ptxas:
        kernels.load("fused_filter")
        wanted = {(d, dy) for _, _, d, dy in shapes}
        entry = None
        for line in kernels.ptxas_report("fused_filter").splitlines():
            if "Compiling entry" in line:
                m = re.search(r"filter_kernelILi(\d)ELi(\d)E", line)
                entry = (int(m.group(1)), int(m.group(2))) if m else None
                if entry in wanted:
                    print(f"[ptxas] {line.strip()}")
            elif entry in wanted and any(k in line for k in ("registers",
                                                              "spill")):
                print(f"[ptxas] {line.strip()}")
    with ClockSampler() as clk:
        rows = []
        for b, t, d, dy in shapes:
            args = _inputs(b, t, d, dy, dev)
            fn = lambda: ff.fused_filter(*args)
            end = time.perf_counter() + 0.5   # bring the clock up
            while time.perf_counter() < end:
                fn()
            torch.cuda.synchronize()
            ev = _ms(fn)
            dv = _device_ms(fn, "filter_")
            bnd, by = bound_ms(b, t, d, dy)
            rows.append((b, t, d, dy, dv, ev, bnd, by))
            del args
    for b, t, d, dy, dv, ev, bnd, by in rows:
        print(f"(B,T,d,dy)=({b},{t},{d},{dy}): device ms {dv:.4f} "
              f"({dv * 1e-3 * clk.mhz * 1e6 / t:.0f} cycles a step, "
              f"{100 * bnd / dv:.1f}% of the {bnd:.4f} ms bound by {by}); "
              f"between events {ev:.4f}")
    if path:
        ev, busy, k3 = time_path(dev)
        print(f"path A call (B=10000, T=200, d=4): {ev:.4f} ms between "
              f"events, device busy {busy:.4f} ms a call, K3 in it {k3:.4f}")
    print(f"SM clock {clk.mhz:.0f} MHz (median while timing); {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

#!/usr/bin/env python3
"""Time the port's quantize kernels K6 (int8) and K7 (fp8 e4m3) alone at
given shapes, beside a device copy of the same rows as a yardstick of the
bandwidth the card reaches.

    python3 scripts/time_quant_kernels.py 2097152x16 4096x10000 4096x200
    python3 scripts/time_quant_kernels.py --ptxas --program 2097152x16
    python3 scripts/time_quant_kernels.py --dequant 2097152x16x4 100001x16x4

Run from the root of a checkout (the package is imported from the current
directory, so two checkouts can be timed in turns inside one job on one
card: ``cd parent && python3 ../scripts/time_quant_kernels.py ...``).
Needs a CUDA device and ``nvcc``.  For each RxC it prints the median
milliseconds of ``quantize_rows`` and ``quantize_rows_fp8`` over CUDA
events, launches back to back (rows from a numpy seed, scales spread over
e^-3 .. e^3), after half a second of launches that brings the clock up,
and their device time per launch (``torch.profiler``: where the wrapper's
Python takes longer than the kernel, the events time the host); the share
of the byte bound ((4 + 1) bytes an element and 4 a row over 3.35 TB/s)
the device time reaches; the layout the wrapper's rule picked, where the
tree has one; and ``torch.empty_like(x).copy_(x)`` on the rows as GB/s
(read and write counted, device time).  Rows that fit the 50 MB L2 are
served from it by launches back to back.  The card's name, power limit
and the SM clock that ``nvidia-smi`` sampled meanwhile head and close the
output.
``--ptxas`` first prints the ``-Xptxas -v`` lines of ``csrc/quantized.cu``;
``--program`` last times the LGSSM program that quantizes its observations
once a call (``batched_program`` on ``zoo.lgssm``, B=1024, T=10,000, d=4,
the JAX package's bench constants, 1 iteration) on float32, int8 and fp8
observations, over CUDA events.  ``--dequant`` times the dequantize +
product kernel K8 instead, at each RxDYxDX: an int8 and an fp8 payload of
such rows (made by the quantize wrappers) against a (DY, DX) W, device time
and events as above, the share of its bound (the larger of (DY + 4 + 4 DX)
bytes a row over 3.35 TB/s and DY + 2 DY DX operations a row over 67
TFLOP/s, as ``chip_smoke.dequant_bound``), the layout and the W tiles the
wrapper's rules picked where the tree has them, and a device copy of the
payload and of the (R, DX) output as GB/s (read and write counted); with
``--evidence`` also the calls ``quantized_evidence`` and
``quantized_evidence_fp8`` on such rows (CUDA events).  It checks nothing:
``chip_smoke.py`` holds the kernels against their plain versions.
"""

import os
import statistics
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.getcwd())

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, 80 GB HBM3 (data sheet)
FP32_FLOPS = 67e12             # H100 SXM float32 outside the tensor cores


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


def _device_ms(fn, name=None, calls=20):
    """Device ms per launch of the kernels whose name holds ``name`` (every
    device event when None) over ``calls`` calls under ``torch.profiler``;
    per event found, since the profiler can lose a launch's event."""
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
          if e.device_type == DeviceType.CUDA
          and (name is None or name in e.name)]
    if not ev:
        return float("nan")
    return sum(ev) / 1e3 / (len(ev) if name else calls)


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


def _layout(tq, x, vals):
    """The wrapper's layout for x, or None in a tree without the rule."""
    import torch

    pick = getattr(tq, "device_quant_layout", None)
    if pick is None:
        return None
    return pick(x, vals if vals is not None else torch.empty_like(
        x, dtype=torch.int8))


def time_programs(dev, b=1024, t_len=10_000, d=4):
    """Milliseconds per call of the 1-iteration LGSSM program on float32,
    int8 and fp8 observations."""
    import torch

    import rxinfer_tpu_torch as rt
    from rxinfer_tpu_torch.models import zoo

    theta = np.pi / 35
    rot = np.array([[np.cos(theta), -np.sin(theta)],
                    [np.sin(theta), np.cos(theta)]], dtype=np.float32)
    eye = np.eye(d, dtype=np.float32)
    model = zoo.lgssm(np.kron(np.eye(d // 2, dtype=np.float32), rot), eye,
                      1.3 * eye, eye, np.zeros(d, np.float32), 25.0 * eye)
    y = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (b, t_len, d), dtype=np.float32), device=dev)
    out = {}
    for dtype in (None, "int8", "float8_e4m3fn"):
        _, prog = rt.batched_program(
            model, {"y": y}, iterations=1, device=dev,
            options={"observation_dtype": dtype} if dtype else None)
        out[dtype or "float32"] = _ms(lambda: prog({"y": y}), reps=9, inner=5)
    return out


def time_dequant(tq, dev, specs, evidence=False):
    """K8 at each RxDYxDX, int8 and fp8 payloads."""
    import torch

    for spec in specs:
        r, dy, dx = (int(x) for x in spec.split("x"))
        rng = np.random.default_rng(7)
        y = torch.as_tensor(
            (rng.standard_normal((r, dy), dtype=np.float32)
             * np.exp(rng.uniform(-3, 3, (r, 1))).astype(np.float32)),
            device=dev)
        w = torch.as_tensor(rng.standard_normal((dy, dx), dtype=np.float32),
                            device=dev)
        bound = max((r * (dy + 4 + 4 * dx) + dy * dx * 4) / HBM_BYTES_PER_S,
                    r * (dy + 2 * dy * dx) / FP32_FLOPS) * 1e3
        tiles = getattr(tq, "device_dequant_tiles", None)
        tiles = tiles(dy, dx, dev) if tiles else None
        parts = []
        for label, quant in (("int8", tq.quantize_rows),
                             ("fp8", tq.quantize_rows_fp8)):
            vals, scales = quant(y)
            k8 = lambda: tq.dequant_matmul(vals, scales, w)
            end = time.perf_counter() + 0.5   # launches that bring the clock up
            while time.perf_counter() < end:
                k8()
            torch.cuda.synchronize()
            ev = _ms(k8)
            dv = _device_ms(k8, "dequant")
            pick = getattr(tq, "device_dequant_layout", None)
            layout = pick(vals, k8()) if pick else None
            parts.append(f"{label} device ms {dv:.4f} ({100 * bound / dv:.1f}%"
                         f" of the {bound:.4f} ms bound), between events "
                         f"{ev:.4f}, layout {layout}, W tiles {tiles}")
        if evidence:
            for label, fn in (("int8", tq.quantized_evidence),
                              ("fp8", tq.quantized_evidence_fp8)):
                parts.append(f"{label} evidence call "
                             f"{_ms(lambda: fn(y, w), reps=9, inner=10):.4f}")
        out = torch.empty((r, dx), device=dev)
        tv = _device_ms(lambda: torch.empty_like(vals).copy_(vals))
        to = _device_ms(lambda: torch.empty_like(out).copy_(out))
        print(f"(R,dy,dx)=({r},{dy},{dx}): " + "; ".join(parts)
              + f"; copy of the payload {tv:.4f} ms = "
              f"{2 * r * dy / (tv * 1e-3) / 1e9:.0f} GB/s, of the output "
              f"{to:.4f} ms = {2 * r * dx * 4 / (to * 1e-3) / 1e9:.0f} GB/s")
        del y, vals, scales, out


def main(argv) -> int:
    import torch

    from rxinfer_tpu_torch import kernels
    from rxinfer_tpu_torch.ops import quantized as tq

    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"tree {os.getcwd()}; {smi}")
    program = "--program" in argv
    ptxas = "--ptxas" in argv
    dequant = "--dequant" in argv
    evidence = "--evidence" in argv
    argv = [a for a in argv
            if a not in ("--program", "--ptxas", "--dequant", "--evidence")]
    if ptxas:
        kernels.load("quantized")
        for line in kernels.ptxas_report("quantized").splitlines():
            if any(k in line for k in ("Compiling entry", "registers", "spill",
                                       "smem")):
                print(f"[ptxas] {line.strip()}")
    with ClockSampler() as clk:
        if dequant:
            time_dequant(tq, dev, argv, evidence)
            argv = []
        for spec in argv:
            r, c = (int(x) for x in spec.split("x"))
            rng = np.random.default_rng(7)
            x = torch.as_tensor(
                (rng.standard_normal((r, c), dtype=np.float32)
                 * np.exp(rng.uniform(-3, 3, (r, 1))).astype(np.float32)),
                device=dev)
            k6 = lambda: tq.quantize_rows(x)
            k7 = lambda: tq.quantize_rows_fp8(x)
            cp = lambda: torch.empty_like(x).copy_(x)
            end = time.perf_counter() + 0.5   # launches that bring the clock up
            while time.perf_counter() < end:
                k6()
                k7()
            torch.cuda.synchronize()
            t6, t7 = _ms(k6), _ms(k7)
            d6, d7 = _device_ms(k6, "quantize"), _device_ms(k7, "quantize")
            tc = _device_ms(cp)
            bound = (r * c * 5 + r * 4) / HBM_BYTES_PER_S * 1e3
            copy_gbs = 2 * r * c * 4 / (tc * 1e-3) / 1e9
            layout = _layout(tq, x, None)
            print(f"(R,C)=({r},{c}): device ms K6 {d6:.4f} "
                  f"({100 * bound / d6:.1f}% of the {bound:.4f} ms bound), "
                  f"K7 {d7:.4f} ({100 * bound / d7:.1f}%); between events "
                  f"K6 {t6:.4f}, K7 {t7:.4f}; copy {tc:.4f} ms = "
                  f"{copy_gbs:.0f} GB/s; layout {layout}")
            del x
        if program:
            ms = time_programs(dev)
            print("LGSSM program (B=1024, T=10000, d=4, 1 iteration), ms: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()))
    print(f"SM clock {clk.mhz:.0f} MHz (median while timing)")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

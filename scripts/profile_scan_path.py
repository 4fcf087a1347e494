#!/usr/bin/env python3
"""Where the time of the port's scan path goes on one CUDA device.

    python3 scripts/profile_scan_path.py [--batch 1024] [--steps 10000]

Runs from the root of a checkout.  The path is the torch code that solves a
chain without a kernel: ``infer`` on one dataset and a batched program with
``options={"fused_kernels": False}`` (``ops/kalman.py`` over
``ops/scan.py``).  For the LGSSM of ``chip_smoke.lgssm_constants`` (d = 4)
it prints, CUDA events, median of 3 calls after a warm-up:

* ``infer`` on one dataset of T steps and the unfused batched program on B
  chains of T steps, each with one call under ``torch.profiler``: device
  busy time and idle share, device kernels launched, and the CUDA kernels
  that take the most device time;
* the stages of the batched smoother alone on the program's own inputs:
  the evidence assembly, the filter elements, the filter scan, the RTS
  elements and the RTS scan.

It checks nothing: ``chip_smoke.py`` holds the path against the float64
oracles and the fused program.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys

import numpy as np


def _ms(fn, reps: int = 3) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _profile(fn, top: int = 6) -> dict:
    """One call under the profiler after a warm-up: device busy ms (device
    events only), device kernels launched, the ``top`` kernels by device
    time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict = {}
    for e in dev:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.device_time_total / 1e3)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {"busy_ms": sum(e.device_time_total for e in dev) / 1e3,
            "launches": len(dev),
            "top": [(name[:60], n, round(ms, 3)) for name, (n, ms) in ranked]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_scan_path: no CUDA device available", file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=1024)
    parser.add_argument("--steps", type=int, default=10_000)
    args = parser.parse_args()
    sys.path.insert(0, os.getcwd())
    import rxinfer_tpu_torch as rt
    from chip_smoke import lgssm_constants
    from rxinfer_tpu_torch.engine.blocks import BatchContext
    from rxinfer_tpu_torch.models import zoo
    from rxinfer_tpu_torch.ops import kalman
    from rxinfer_tpu_torch.ops.scan import associative_scan

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    dev = torch.device("cuda")
    d, t_len, b = 4, args.steps, args.batch
    model = zoo.lgssm(*lgssm_constants(d))
    rng = np.random.default_rng(0)
    y1 = torch.as_tensor(rng.standard_normal((t_len, d), dtype=np.float32),
                         device=dev)
    yb = torch.as_tensor(rng.standard_normal((b, t_len, d),
                                             dtype=np.float32), device=dev)

    one = lambda: rt.infer(model, data={"y": y1}, device=dev)
    ms = _ms(one)
    prof = _profile(one)
    print(f"[infer] T={t_len}: {ms:.3f} ms a call, device busy "
          f"{prof['busy_ms']:.3f} ms (idle "
          f"{100 * (1 - prof['busy_ms'] / ms):.1f}%), {prof['launches']} "
          f"device kernels; top {prof['top']}")

    compiled, prog = rt.batched_program(model, {"y": yb}, device=dev,
                                        options={"fused_kernels": False})
    call = lambda: prog({"y": yb})
    ms = _ms(call)
    prof = _profile(call)
    print(f"[unfused] B={b} T={t_len}: {ms:.3f} ms a call, device busy "
          f"{prof['busy_ms']:.3f} ms (idle "
          f"{100 * (1 - prof['busy_ms'] / ms):.1f}%), {prof['launches']} "
          f"device kernels; top {prof['top']}")

    # the batched smoother's stages alone, on the program's own inputs
    block = compiled.blocks[0][1]
    data, masks = compiled._device_data({"y": yb}, True, dev)
    ctx = BatchContext(dev, b, {}, masks)
    xi, w = block._evidence_batch({}, data, ctx)
    m0, p0 = block._prior_moments({}, data, ctx)
    a, bb, q = block._transition_params({}, data, t_len, ctx)
    p = kalman.ChainParams(m0.expand(b, d), p0.expand(b, d, d), a, bb, q,
                           xi, w)
    elems = kalman.make_filter_elements(*p)
    fm, fc = kalman.parallel_filter(p)
    selems = kalman.make_smoother_elements(fm, fc, a, bb, q)
    stages = {
        "evidence": lambda: block._evidence_batch({}, data, ctx),
        "filter_elements": lambda: kalman.make_filter_elements(*p),
        "filter_scan": lambda: associative_scan(kalman.filter_compose, elems,
                                                dim=1),
        "rts_elements": lambda: kalman.make_smoother_elements(fm, fc, a, bb,
                                                              q),
        "rts_scan": lambda: associative_scan(kalman.smooth_compose, selems,
                                             dim=1, reverse=True),
    }
    times = {k: round(_ms(fn), 3) for k, fn in stages.items()}
    print(f"[unfused] stages alone, ms: {times}")
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())

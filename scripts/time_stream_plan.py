#!/usr/bin/env python3
"""Time the streaming engine's fused stream plan on one GPU.

    python3 scripts/time_stream_plan.py [BxTxD]      (default 10000x200x4)

Runs ``chip_smoke.py``'s phase 14 (a) cell (the tick model and autoupdates
of bench.py:446-460 through ``infer(autoupdates=..., batched=True)``) and
prints, on ``[plan]`` lines: the ``run_offline`` call (CUDA events, median
of 10), the device busy time and the most expensive device kernels of one
profiled call, and the candidate operations of one tick alone on the
tick's (B, d, d) tensors, each as the wall time of 50 back-to-back calls
(the host's cost when it exceeds the device's) and the device time of one
(``torch.profiler``): ``linalg.inv_ex`` (the plan's inverse) beside
``linalg.inv`` (which reads its error flags back to the host), a
``linalg.solve_ex`` of one (d, d + 1) system (the one-inverse form
G = (I + P W)^-1, P' = G P, m' = G (m + P xi)), ``linalg.cholesky_ex``, the
closed-form ``small_inv`` of ``ops/smallmat.py`` and a batched (B, d, d)
product.  Run from the root of a checkout.
"""

from __future__ import annotations

import os
import statistics
import sys
import time

import numpy as np


def _wall_ms(fn, n: int = 50) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def _device(fn) -> tuple[float, list]:
    """Device ms of one ``fn()`` call and its top device kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    by_name: dict = {}
    for e in dev:
        by_name.setdefault(e.name[:60], []).append(e.device_time_total)
    top = sorted(((sum(v) / 1e3, len(v), k) for k, v in by_name.items()),
                 reverse=True)[:8]
    return sum(e.device_time_total for e in dev) / 1e3, top, len(dev)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("time_stream_plan: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs
    from rxinfer_tpu_torch.ops.smallmat import small_inv

    shape = sys.argv[1] if len(sys.argv) > 1 else "10000x200x4"
    b, t_len, d = (int(v) for v in shape.split("x"))
    device = torch.device("cuda")
    import rxinfer_tpu_torch as rt

    f, q, _, r, _, p0 = cs.lgssm_constants(d)
    ys = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (t_len, b, d)).astype(np.float32), device=device)
    eng = rt.infer(model=cs._stream_tick_model(r), datastream=None,
                   autoupdates=cs._stream_autoupdates(f, q, p0, b, device),
                   batched=True, device=device)
    eng.run_offline({"y": ys})
    if not eng._stream_plan:
        raise AssertionError("the fused stream plan did not engage")
    call = lambda: eng.run_offline({"y": ys})
    ms = cs._cuda_ms(call, 10)
    busy, top, n_dev = _device(call)
    print(f"[plan] (B,T,d)=({b},{t_len},{d}): run_offline {ms:.3f} ms "
          f"({b * t_len / ms * 1e3:.4g} updates/s), {ms / t_len * 1e3:.1f} us "
          f"a tick; device busy {busy:.3f} ms in {n_dev} device kernels "
          f"({n_dev / t_len:.1f} a tick)")
    for tot, n, name in top:
        print(f"[plan]   {tot:8.3f} ms {n:6d}x {name}")

    gen = torch.Generator(device=device).manual_seed(0)
    a = torch.randn((b, d, d), generator=gen, device=device)
    p = a @ a.transpose(-1, -2) + d * torch.eye(d, device=device)
    w = torch.eye(d, device=device)
    rhs = torch.randn((b, d, d + 1), generator=gen, device=device)
    fm = torch.as_tensor(f, device=device)
    ops = {
        "linalg.inv_ex": lambda: torch.linalg.inv_ex(p),
        "linalg.inv (reads its error flags)": lambda: torch.linalg.inv(p),
        "linalg.solve_ex (d, d+1)": lambda: torch.linalg.solve_ex(
            torch.eye(d, device=device) + p @ w, rhs),
        "linalg.cholesky_ex": lambda: torch.linalg.cholesky_ex(p),
        "small_inv": lambda: small_inv(p),
        "F P F^T (two products)": lambda: fm @ p @ fm.T,
    }
    for name, fn in ops.items():
        wall = statistics.median(_wall_ms(fn) for _ in range(3))
        dev_ms, _, n = _device(fn)
        print(f"[plan] {name}: {wall * 1e3:.1f} us a call back to back, "
              f"device {dev_ms * 1e3:.1f} us in {n} device kernels")
    return 0


if __name__ == "__main__":
    sys.exit(main())

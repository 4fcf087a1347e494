#!/usr/bin/env python3
"""Where the free energy's time goes on the card.

    python3 scripts/profile_free_energy.py [--b 1024] [--t 10000] [--d 4]
                                           [--linalg]

Run from the root of a checkout on a machine with a CUDA device.  Builds
the LGSSM cell of ``chip_smoke.py`` (``zoo.lgssm``, its constants, y from
a numpy seed) with ``free_energy=True``, takes one call's marginals and
K2's cross, and times the free-energy stage alone and each of its terms
alone (CUDA events, median of 5): the variables' entropy term, then every
factor's ``FactorFE``.  Then one call of the stage under ``torch.profiler``:
its device busy time and the device kernels that take the most of it
(name, launches, ms).  The same for the HMM cell (``zoo.hmm(3, 3)``,
256 x 200) at its final state.  Prints the card's name and power limit
first.  ``--linalg`` first times the small-matrix forms the terms could
take on N = B (T - 1) matrices: a product of (N, d, d) batches through
``@`` (cuBLAS) and as a broadcast multiply-and-sum, and the
log-determinant of the (N, 2d, 2d) pair joints by ``small_logdet``, by
``torch.linalg.cholesky`` and by ``torch.linalg.slogdet``.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys

import numpy as np


def _ms(fn, reps=5):
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def _profile(fn, top=15):
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
    busy = sum(e.device_time_total for e in dev) / 1e3
    by_name: dict = {}
    for e in dev:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.device_time_total / 1e3)
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return busy, len(dev), rows


def _terms(compiled, state, cross, data, ctx):
    """(label, fn) of the stage and each of its terms."""
    from rxinfer_tpu_torch.engine.bethe import variable_entropy_term

    out = [("stage", lambda: compiled._free_energy(state, cross, data, ctx)),
           ("variables", lambda: variable_entropy_term(
               compiled.graph, state, compiled.degrees, ctx.batch))]
    for ffe in compiled.fe_factors:
        f = ffe.factor
        label = f"{f.fform}{' (chain)' if ffe.is_chain_transition else ''}"
        out.append((label, lambda _f=ffe: _f(state, data, cross, ctx)))
    return out


def _report(name, terms):
    for label, fn in terms:
        print(f"[{name}] {label}: {_ms(fn):.3f} ms alone")
    busy, n, rows = _profile(terms[0][1])
    print(f"[{name}] stage under the profiler: device busy {busy:.3f} ms in "
          f"{n} device events; top kernels:")
    for kname, (cnt, ms) in rows:
        print(f"[{name}]   {ms:9.3f} ms  {cnt:5d} x  {kname[:110]}")


def _linalg(n: int, d: int, dev) -> None:
    import torch

    from rxinfer_tpu_torch.ops.smallmat import small_logdet

    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((n, d, d), device=dev, generator=g)
    b = torch.randn((n, d, d), device=dev, generator=g)
    j = torch.randn((n, 2 * d, 2 * d), device=dev, generator=g)
    j = j @ j.transpose(-1, -2) + 2 * d * torch.eye(2 * d, device=dev)
    forms = {
        f"matmul @ ({n}, {d}, {d})": lambda: a @ b,
        f"broadcast multiply-sum ({n}, {d}, {d})":
            lambda: (a[..., :, :, None] * b[..., None, :, :]).sum(-2),
        f"small_logdet ({n}, {2 * d}, {2 * d})": lambda: small_logdet(j),
        f"cholesky + log diag ({n}, {2 * d}, {2 * d})": lambda: 2.0 * torch.log(
            torch.diagonal(torch.linalg.cholesky(j), dim1=-2,
                           dim2=-1)).sum(-1),
        f"slogdet ({n}, {2 * d}, {2 * d})":
            lambda: torch.linalg.slogdet(j)[1],
    }
    for label, fn in forms.items():
        print(f"[linalg] {label}: {_ms(fn):.3f} ms")
    del a, b, j
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--b", type=int, default=1024)
    ap.add_argument("--t", type=int, default=10_000)
    ap.add_argument("--d", type=int, default=4)
    ap.add_argument("--linalg", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_free_energy: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import rxinfer_tpu_torch as rt
    from rxinfer_tpu_torch.engine import batched as eb
    from rxinfer_tpu_torch.engine.blocks import BatchContext
    from rxinfer_tpu_torch.models import zoo

    import chip_smoke as cs

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda")
    b, t_len, d = args.b, args.t, args.d
    if args.linalg:
        _linalg(b * (t_len - 1), d, dev)
    model = zoo.lgssm(*cs.lgssm_constants(d))
    y_host = np.random.default_rng(0).standard_normal((b, t_len, d),
                                                      dtype=np.float32)
    data = {"y": torch.as_tensor(y_host, device=dev)}
    compiled, prog = rt.batched_program(model, data, free_energy=True,
                                        device=dev)
    plan = eb.build_plans(compiled, {"y": y_host[0]}, device=dev)["x"]
    block = next(blk for _, blk in compiled.blocks)
    marg, cross = eb._fused_gaussian_update(block, plan, data, b)
    ctx = BatchContext(dev, b, {})
    print(f"[lgssm] B={b} T={t_len} d={d}: program with FE "
          f"{_ms(lambda: prog(data)):.3f} ms")
    _report("lgssm", _terms(compiled, {"x": marg}, {"x": cross}, data, ctx))
    del marg, cross
    torch.cuda.empty_cache()

    y = torch.as_tensor(cs.simulate_hmm(256, 200, seed=0), device=dev)
    init = {"A": rt.DirichletCollection(np.ones((3, 3), np.float32)),
            "B": rt.DirichletCollection(np.float32(np.eye(3) * 5.0 + 1.0))}
    compiled, prog = rt.batched_program(zoo.hmm(3, 3), {"y": y},
                                        iterations=20, free_energy=True,
                                        initialization=init, device=dev)
    state, _, _ = prog({"y": y})
    ctx = BatchContext(dev, 256, {})
    block = next(blk for _, blk in compiled.blocks if blk.var.name == "s")
    _, xis = eb._fused_discrete_update(block, state, {"y": y}, {}, ctx)
    print(f"[hmm] B=256 T=200, 20 iterations: program with FE "
          f"{_ms(lambda: prog({'y': y})):.3f} ms")
    _report("hmm", _terms(compiled, state, {"s": xis}, {"y": y}, ctx))
    return 0


if __name__ == "__main__":
    sys.exit(main())

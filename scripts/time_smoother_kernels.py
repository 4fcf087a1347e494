#!/usr/bin/env python3
"""Time the port's smoother kernels K1 and K2 alone at given shapes.

    python3 scripts/time_smoother_kernels.py 1024x10000x4 4096x200x8
    python3 scripts/time_smoother_kernels.py --bf16 1024x10000x4 1024x2048x16
    python3 scripts/time_smoother_kernels.py --blocks 1,8,16,32,64,128 1024x10000x4

Run from the root of a checkout (the package is imported from the current
directory, so two checkouts can be timed in turns inside one job on one
card).  Needs a CUDA device and ``nvcc``.  For each BxTxd it prints the
median milliseconds of ``fused_forward`` and of ``fused_backward`` over
CUDA events (random stable system, seed 7) and the card's name and power
limit; d in 9..16 takes the wide kernels.  ``--bf16`` times the bf16-moment
instantiations as well, beside the float32 ones.  ``--blocks`` times both kernels at each given number of time
blocks instead of the wrapper's own (``pick_blocks``), with each launch's
max |difference| to the launch with the fewest blocks of the list.  It checks nothing:
``chip_smoke.py`` holds the kernels against their plain versions.
"""

import os
import statistics
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.getcwd())


def _ms(fn, reps=7, inner=3):
    import torch

    for _ in range(2):
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

    from rxinfer_tpu_torch.ops import fused_smoother as fs

    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"tree {os.getcwd()}; {smi}")
    sweep = None
    dtypes = [torch.float32]
    if argv and argv[0] == "--bf16":
        dtypes.append(torch.bfloat16)
        argv = argv[1:]
    if argv and argv[0] == "--blocks":
        sweep = sorted(int(x) for x in argv[1].split(","))
        argv = argv[2:]
    for spec in argv:
        b, t, d = (int(x) for x in spec.split("x"))
        rng = np.random.default_rng(7)
        qm, _ = np.linalg.qr(rng.standard_normal((d, d)))
        f = (0.98 * qm).astype(np.float32)
        bias = (0.1 * np.arange(d)).astype(np.float32)
        q = (0.4 * np.eye(d)).astype(np.float32)
        w = (0.8 * np.eye(d)).astype(np.float32)
        xi = torch.randn((t, b, d), device=dev,
                         generator=torch.Generator(dev).manual_seed(7))
        m0 = torch.zeros((b, d), device=dev)
        p0 = (9.0 * torch.eye(d, device=dev)).expand(b, d, d).contiguous()
        mf, pf = fs.fused_forward(m0, p0, xi, f, bias, q, w)
        if sweep is None:
            for md in dtypes:
                mf, pf = fs.fused_forward(m0, p0, xi, f, bias, q, w,
                                          moment_dtype=md)
                fwd = _ms(lambda: fs.fused_forward(m0, p0, xi, f, bias, q, w,
                                                   moment_dtype=md))
                bwd = _ms(lambda: fs.fused_backward(mf, pf, f, bias, q))
                print(f"(B,T,d)=({b},{t},{d}) moments {md}: K1 {fwd:.4f} ms, "
                      f"K2 {bwd:.4f} ms")
            continue
        one = None
        for blocks in sweep:
            blocks = len(fs.time_blocks(t, blocks))
            if blocks > 1 and d > fs.FOLD_MAX_DIM:
                continue
            run_f = lambda: fs._forward_cuda(m0, p0, xi, f, bias, q, w,
                                             blocks)
            run_b = lambda: fs._backward_cuda(mf, pf, f, bias, q, blocks)
            got = run_f() + run_b()
            one = one or got
            diff = max(float((g - o).abs().max()) for g, o in zip(got, one))
            print(f"(B,T,d)=({b},{t},{d}) {blocks} time blocks: K1 "
                  f"{_ms(run_f):.4f} ms, K2 {_ms(run_b):.4f} ms, max |diff| "
                  f"to {sweep[0]} block(s) {diff:.3g}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

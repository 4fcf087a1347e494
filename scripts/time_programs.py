#!/usr/bin/env python3
"""Time the port's batched programs on their main cells in the tree it runs
from.

    python3 scripts/time_programs.py [--reps 20] [--hmm16]

Run from the root of a checkout (the package is imported from the current
directory, so two checkouts can be timed in turns inside one job on one
card: ``cd parent && python3 ../scripts/time_programs.py``).  Needs a CUDA
device and ``nvcc``.  It times, CUDA events, median of ``--reps`` calls
after a warm-up, with the inputs of ``chip_smoke.py``: the LGSSM program
(``zoo.lgssm``, B=1024, T=10,000, d=4, one iteration) and the HMM program
(``zoo.hmm(3, 3)``, B=256, T=200, 20 iterations), and with ``--hmm16``
the 16-state HMM program (``zoo.hmm(16, 8)``, B=1024, T=1000, 20
iterations, phase 16 (b)'s data), and prints each beside the card's name
and power limit.  It checks nothing: ``chip_smoke.py`` holds the programs
against their float64 oracles.
"""

import argparse
import os
import statistics
import subprocess
import sys

import numpy as np


def _ms(fn, reps: int) -> float:
    import torch

    for _ in range(2):
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("time_programs: no CUDA device available", file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser()
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--hmm16", action="store_true")
    args = parser.parse_args()
    sys.path.insert(0, os.getcwd())
    import rxinfer_tpu_torch as rt
    from chip_smoke import lgssm_constants, simulate_hmm
    from rxinfer_tpu_torch.models import zoo

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    y = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (1024, 10_000, 4), dtype=np.float32), device=dev)
    _, lgssm = rt.batched_program(zoo.lgssm(*lgssm_constants(4)), {"y": y},
                                  iterations=1, device=dev)
    yh = torch.as_tensor(simulate_hmm(256, 200, seed=0), device=dev)
    init = {"A": rt.DirichletCollection(np.ones((3, 3), np.float32)),
            "B": rt.DirichletCollection(np.float32(np.eye(3) * 5.0 + 1.0))}
    _, hmm = rt.batched_program(zoo.hmm(3, 3), {"y": yh}, iterations=20,
                                initialization=init, device=dev)
    print(f"tree {os.getcwd()}: LGSSM program "
          f"{_ms(lambda: lgssm({'y': y}), args.reps):.4f} ms, HMM program "
          f"{_ms(lambda: hmm({'y': yh}), args.reps):.4f} ms; {smi}")
    if args.hmm16:
        from chip_smoke import hmm_k_init, simulate_hmm_k

        y16 = torch.as_tensor(simulate_hmm_k(1024, 1000, 16, 8, seed=16),
                              device=dev)
        a0, b0 = hmm_k_init(16, 8)
        _, hmm16 = rt.batched_program(
            zoo.hmm(16, 8), {"y": y16}, iterations=20,
            initialization={"A": rt.DirichletCollection(a0),
                            "B": rt.DirichletCollection(b0)}, device=dev)
        ms = _ms(lambda: hmm16({"y": y16}), max(3, args.reps // 4))
        print(f"tree {os.getcwd()}: 16-state HMM program {ms:.4f} ms "
              f"({1024 * 20 * 1002 / (ms / 1e3):.6g} updates/s); {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

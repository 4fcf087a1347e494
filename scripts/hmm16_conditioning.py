#!/usr/bin/env python3
"""How far float32 VMP on a 16-state HMM drifts from the float64 VMP, on the
CPU: the data of ``chip_smoke.py`` phase 16 (b) against the same size with
two states a category.

    python3 scripts/hmm16_conditioning.py [--iterations 1,5,20] [--states K]
        [--categories M] [--chains B]

Run from the root of a checkout; needs no card (the port runs its plain
versions with ``device="cpu"``; on the card the wide K4/K5 give the same
bits as those plain versions).  For each emission model it takes the
sampled rows of phase 16 (b) (B = 1024, T = 1000, K = 16, m = 8, seed 16;
``--states 32 --categories 32``: phase 26 (b)'s K and m; ``--states 64
--categories 64 --chains 512``: phase 27 (b)'s K, m and B),
runs ``batched_program`` on them in float32 and ``chip_smoke``'s float64
structured VMP at each number of sweeps, and prints the largest difference
of the state probabilities (absolute) and of the A and B concentrations
(relative), the largest relative difference of the free energy from the
float64 structured VMP's (``free_energy=True``, every sweep), and how far
the float64 VMP itself moves after 20 sweeps when its initial B
concentrations move by 1e-7 relative.  ``aliased``: state s
emits category s % 8 with 0.8 (s and s + 8 alike), B's initial
concentrations lean to it with a slope of 0.1 over the states;
``distinct``: ``chip_smoke.hmm_k_emission``.  About a minute (two at
K = 32, five at K = 64).
"""

import argparse
import importlib.util
import os
import sys

import numpy as np

sys.path.insert(0, os.getcwd())

B, T, K, M = 1024, 1000, 16, 8


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def aliased(seed: int):
    """Observations and initial concentrations with K / M states a
    category."""
    rng = np.random.default_rng(seed)
    s = rng.integers(K, size=B)
    ys = np.empty((B, T), np.int64)
    for t in range(T):
        s = np.where(rng.random(B) < 0.1, rng.integers(K, size=B), s)
        ys[:, t] = np.where(rng.random(B) < 0.2, rng.integers(M, size=B),
                            s % M)
    b0 = (np.ones((M, K)) + 4.0 * (np.arange(M)[:, None] == np.arange(K) % M)
          + 0.1 * np.arange(K) / K).astype(np.float32)
    return np.eye(M, dtype=np.float32)[ys], np.ones((K, K), np.float32), b0


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--iterations", default="1,5,20")
    parser.add_argument("--states", type=int, default=K)
    parser.add_argument("--categories", type=int, default=M)
    parser.add_argument("--chains", type=int, default=B)
    args = parser.parse_args(argv)
    globals()["K"], globals()["M"] = args.states, args.categories
    globals()["B"] = args.chains
    import torch

    import rxinfer_tpu_torch as rt
    from rxinfer_tpu_torch.models import zoo

    torch.set_num_threads(4)
    cs = _chip_smoke()
    rows = sorted({0, 1, B // 2, B - 1})
    models = {"aliased": aliased(16),
              "distinct": (cs.simulate_hmm_k(B, T, K, M, seed=16),
                           *cs.hmm_k_init(K, M))}
    for name, (y, a0, b0) in models.items():
        y = y[rows]
        init = {"A": rt.DirichletCollection(a0),
                "B": rt.DirichletCollection(b0)}
        for its in (int(x) for x in args.iterations.split(",")):
            _, prog = rt.batched_program(zoo.hmm(K, M), {"y": y},
                                         iterations=its, initialization=init,
                                         device="cpu")
            state, _, _ = prog({"y": y})
            g, a, b = cs.hmm_vmp_float64(y, a0, b0, its)
            print(f"{name} {its} sweeps, rows {rows}: gammas "
                  f"{np.abs(state['s'].probs().numpy() - g).max():.3g}, A "
                  f"{np.max(np.abs(state['A'].alpha.numpy() - a) / a):.3g}, "
                  f"B {np.max(np.abs(state['B'].alpha.numpy() - b) / b):.3g}"
                  " (relative)", flush=True)
        its = max(int(x) for x in args.iterations.split(","))
        _, prog = rt.batched_program(zoo.hmm(K, M), {"y": y}, iterations=its,
                                     initialization=init, free_energy=True,
                                     device="cpu")
        _, fe, _ = prog({"y": y})
        fe64 = cs.hmm_vmp_fe_float64(y, a0, b0, its)
        print(f"{name} {its} sweeps: the free energy "
              f"{np.max(np.abs(fe.numpy() - fe64) / np.abs(fe64)):.3g} "
              "(relative) from the float64 one", flush=True)
        _, a, b = cs.hmm_vmp_float64(y, a0, b0, 20)
        rng = np.random.default_rng(0)
        moved = b0.astype(np.float64) * (1 + 1e-7 * rng.standard_normal(
            b0.shape))
        _, pa, pb = cs.hmm_vmp_float64(y, a0, moved, 20)
        print(f"{name}: the float64 VMP after 20 sweeps with B0 moved 1e-7: "
              f"A {np.max(np.abs(pa - a) / a):.3g}, B "
              f"{np.max(np.abs(pb - b) / b):.3g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

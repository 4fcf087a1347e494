#!/usr/bin/env python3
"""The JAX package's float32 gap of ``zoo.latent_ar`` to the float64
structured VMP, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/lar_oracle_gap.py [T ORDER SWEEPS]

Runs ``chip_smoke.py`` phase 19 (a)'s sampled series (rows LAR_ROWS of
``chip_smoke.lar_data(LAR_B, T, ORDER, seed=19)``: at T = LAR_T the very
series the card's check compares) through the JAX package's
``infer_batched`` and prints, for the means of s, theta and gamma and the
free energy after every sweep, each one's largest error relative to the
largest value of ``chip_smoke.lar_vmp_float64``.  The JAX free energy is
compared after its closed-form ROADMAP C8 offset, (T - 1) (H[q(theta)] +
H[q(gamma)] + (k - 1) log(2 pi e) / 2) a sweep, from its own posteriors.
Phase 19 (a)'s LAR_TOL is twice the largest of these gaps, capped at
1e-3.  Defaults: LAR_T, LAR_K, LAR_IT (about a minute, the JAX program's
compile included).  A script of the JAX package: it runs on the CPU."""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
import rxinfer_tpu as jrx  # noqa: E402
from rxinfer_tpu import dists as jd  # noqa: E402
from rxinfer_tpu.models import zoo as jzoo  # noqa: E402


def main(t_len=cs.LAR_T, k=cs.LAR_K, sweeps=cs.LAR_IT):
    y, coef = cs.lar_data(cs.LAR_B, t_len, k, seed=19)
    y = y[list(cs.LAR_ROWS)]
    o_s, o_th, o_g, o_fe = cs.lar_vmp_float64(y, k, sweeps)
    init = {"theta": jd.MvNormalMeanCovariance(jnp.zeros(k), jnp.eye(k)),
            "gamma": jd.GammaShapeRate(1.0, 1.0)}
    post, fe = jrx.infer_batched(jzoo.latent_ar(k), {"y": y},
                                 iterations=sweeps, free_energy=True,
                                 initialization=init,
                                 returnvars=jrx.KeepEach(),
                                 options={"warn": False})
    ent = lambda d: np.asarray(d.entropy(), np.float64)
    off = np.stack([(t_len - 1) * (ent(th) + ent(g)
                                    + 0.5 * (k - 1) * np.log(2 * np.pi * np.e))
                    for th, g in zip(post["theta"], post["gamma"])])
    gaps = {"s": cs._rel_max(post["s"][-1].mean(), o_s),
            "theta": cs._rel_max(post["theta"][-1].mean(), o_th),
            "gamma": cs._rel_max(post["gamma"][-1].mean(), o_g),
            "fe": cs._rel_max(np.asarray(fe, np.float64) - off, o_fe)}
    print(f"AR({k}) coefficients {np.round(coef, 4).tolist()}, rows "
          f"{list(cs.LAR_ROWS)} of B={cs.LAR_B}, T={t_len}, {sweeps} sweeps; "
          "the JAX package against the float64 VMP: "
          + ", ".join(f"{n} {v:.3e}" for n, v in gaps.items()))
    print(f"twice the largest gap, capped at 1e-3: "
          f"{min(2 * max(gaps.values()), 1e-3):.4e}")


if __name__ == "__main__":
    main(*map(int, sys.argv[1:]))

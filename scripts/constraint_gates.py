#!/usr/bin/env python3
"""The JAX package's results on ``chip_smoke.py`` phase 21's cells, on the
CPU: where its gates come from.

    JAX_PLATFORMS=cpu python3 scripts/constraint_gates.py [STREAMS DATASETS]

(a) The online HGF of phase 21 (a) (``chip_smoke.hgfs_model``, the
reference constraint q(xt, zt, xt_min) = q(xt, xt_min)q(zt)) over STREAMS
streams of ``chip_smoke.hgfs_data(STREAMS, HGFS_T)`` through the JAX
engine's ``run_offline`` with ``batched=True``: the shares of (tick,
stream) states within 3 and 6 sd for x and z (phase 21 (a1)'s fleet gate
is what the JAX package reaches here, where it misses 0.95 / 0.999), and
stream 0's reference checks (``chip_smoke.hgfs_reference_checks``).

(b) ``ProjectedTo("beta", n_samples=PROJ_SAMPLES)`` over the first
DATASETS datasets of ``chip_smoke.proj_data(PROJ_B)`` through
``infer_batched``, PROJ_IT sweeps: the worst gaps to the quadrature
posteriors (``chip_smoke.proj_gaps``); phase 21 (b)'s PROJ_TOL is twice
them, never looser than the JAX test's (mean 0.02, variance 50% + 1e-4).

Defaults: 64 and 64 (a few minutes, the JAX programs' compiles included).
A script of the JAX package: it runs on the CPU and imports no port."""

import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
import rxinfer_tpu as jrx  # noqa: E402
from rxinfer_tpu import dists as jd  # noqa: E402


def hgf_shares(streams: int) -> None:
    t0 = time.perf_counter()
    z, x, y = cs.hgfs_data(streams, cs.HGFS_T)
    dist = lambda m, v: jd.NormalMeanVariance(np.float32(m), np.float32(v))
    eng = jrx.infer(model=cs.hgfs_model(jrx), datastream=None,
                    **cs.hgfs_engine_kw(jrx, streams, dist))
    posts, fes = eng.run_offline({"y": y})
    post = {n: (np.asarray(posts[n].mean(), np.float64),
                np.asarray(posts[n].var(), np.float64))
            for n in ("xt", "zt")}
    fe = np.asarray(fes, np.float64)
    shares = cs.hgfs_shares(z, x, post)
    ref = cs.hgfs_reference_checks(
        z[:, 0], x[:, 0], {n: (p[0][:, 0], p[1][:, 0])
                           for n, p in post.items()}, fe[:, 0])
    print(f"(a) online HGF, {streams} streams x {cs.HGFS_T} ticks, "
          f"{cs.HGFS_IT} sweeps a tick: shares within 3 / 6 sd {shares}; "
          f"stream 0 {ref}; {time.perf_counter() - t0:.1f} s")


def projection_gaps(datasets: int) -> None:
    t0 = time.perf_counter()
    _, y = cs.proj_data(cs.PROJ_B)
    y = y[:datasets]
    cons = jrx.constraints(forms={"theta": jrx.ProjectedTo(
        "beta", n_samples=cs.PROJ_SAMPLES)})
    post, _ = jrx.infer_batched(cs.proj_model(jrx), {"y": y},
                                iterations=cs.PROJ_IT, constraints=cons,
                                initialization={"theta": jd.Beta(2.0, 2.0)})
    q = post["theta"]
    mean, var = np.asarray(q.mean()), np.asarray(q.var())
    q_mean, q_var = cs.proj_quadrature(y)
    theta, _ = cs.proj_data(cs.PROJ_B)
    bad = np.flatnonzero(~(np.isfinite(mean) & np.isfinite(var)))
    ok = np.setdiff1d(np.arange(datasets), bad)
    gaps = cs.proj_gaps(mean, var, q_mean, q_var)
    finite = cs.proj_gaps(mean[ok], var[ok], q_mean[ok], q_var[ok])
    print(f"(b) ProjectedTo('beta', n_samples={cs.PROJ_SAMPLES}), "
          f"{datasets} datasets, {cs.PROJ_IT} sweeps: worst gaps to the "
          f"quadrature {gaps}; non-finite posteriors on {len(bad)} datasets "
          f"(theta_true {np.round(theta[bad], 3).tolist()}); over the "
          f"{len(ok)} others {finite}, twice: mean "
          f"{2 * finite['mean']:.6g}, variance {2 * finite['var_rel']:.6g} "
          f"relative; {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:]]
    streams = args[0] if args else 64
    datasets = args[1] if len(args) > 1 else 64
    hgf_shares(streams)
    projection_gaps(datasets)

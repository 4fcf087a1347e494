"""``shared=`` pooling on one device (ROADMAP A7a) through both packages on
the CPU: the cases of ``tests/parallel/test_infer_batched_shared.py`` that
need no mesh and ``tests/engine/test_fused_dynamic.py::
test_dyn_w_shared_tau_pooled``.  A pooled variable's per-dataset messages
are summed over the batch in natural parameters every sweep and its prior
counted once; the free energy is the pooled model's, (iterations,).  Held
against the JAX package's ``infer_batched(shared=)``, against the explicit
pooled model through ``rx.infer``, chunked against unchunked (a partial last
chunk too), on the dynamic tier's fused plan against
``fused_kernels=False``; the validation errors' types and messages; the
pooled evidence under ``annotations=``.  Inputs come from numpy seeds; the
port runs with ``device="cpu"``."""

import warnings

import numpy as np
import pytest
import torch

import rxinfer_tpu as jrx
import rxinfer_tpu_torch as trx
from rxinfer_tpu import dists as jd
from rxinfer_tpu_torch import dists as td

CPU = torch.device("cpu")
B, T = 4, 64
TAU_TRUE = 4.0
# the JAX package's own tolerances for these cases
# (tests/parallel/test_infer_batched_shared.py): the pooled posterior and
# the latents rtol 1e-4, the pooled free energy rtol 1e-4 / atol 1e-2;
# the port against JAX is held to the same (float32 in two libraries, the
# fused smoother's plain version against the JAX one)
POOL_TOL = dict(rtol=1e-4, atol=1e-4)
FE_TOL = dict(rtol=1e-4, atol=1e-2)
# chunked against unchunked in one package: the same arithmetic summed in
# another order (the JAX test's 1e-5)
CHUNK_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def walk_data(seed=0, b=B):
    rng = np.random.default_rng(seed)
    ys = []
    for _ in range(b):
        x = np.cumsum(0.5 * rng.standard_normal(T)).astype(np.float32)
        ys.append(x + rng.standard_normal(T).astype(np.float32)
                  / np.sqrt(TAU_TRUE))
    return np.stack(ys).astype(np.float32)


def walk_tau(rx):
    @rx.model
    def walk_tau(y):
        T = len(y)
        tau = rx.Gamma(shape=2.0, rate=2.0)
        x = rx.latent(T, name="x")
        x[0] = rx.Normal(mean=0.0, var=100.0)
        for t in rx.plate(1, T):
            x[t] = rx.Normal(mean=x[t - 1], var=0.25)
        for t in rx.plate(T):
            y[t] = rx.Normal(mean=x[t], precision=tau)
        return {"x": x, "tau": tau}

    return walk_tau


def tau_init(dists):
    t = (lambda x: x) if dists is jd else torch.tensor
    return {"tau": dists.GammaShapeRate(t(2.0), t(2.0))}


def pooled_model(rx):
    """The pooled model written out: four chains, one tau."""
    @rx.model
    def pooled(y0, y1, y2, y3):
        tau = rx.Gamma(shape=2.0, rate=2.0)
        for name, y in (("x0", y0), ("x1", y1), ("x2", y2), ("x3", y3)):
            T = len(y)
            x = rx.latent(T, name=name)
            x[0] = rx.Normal(mean=0.0, var=100.0)
            for t in rx.plate(1, T):
                x[t] = rx.Normal(mean=x[t - 1], var=0.25)
            for t in rx.plate(T):
                y[t] = rx.Normal(mean=x[t], precision=tau)
        return {"tau": tau}

    return pooled


def port(model_fn, data, **kw):
    return trx.infer_batched(model_fn(trx), data, device=CPU, **kw)


def test_shared_matches_jax_and_the_pooled_model():
    y = walk_data()
    kw = dict(iterations=10, free_energy=True, shared=("tau",),
              returnvars=jrx.KeepLast())
    jres = jrx.infer_batched(walk_tau(jrx), {"y": y},
                             initialization=tau_init(jd), **kw)
    kw["returnvars"] = trx.KeepLast()
    tres = port(walk_tau, {"y": y}, initialization=tau_init(td), **kw)
    pooled = jrx.infer(model=pooled_model(jrx),
                       data={f"y{b}": y[b] for b in range(B)}, iterations=10,
                       free_energy=True, initialization=tau_init(jd),
                       returnvars=jrx.KeepLast())
    tau = tres.posteriors["tau"].mean().numpy()
    assert tau.shape == (B,)
    np.testing.assert_array_equal(tau, tau[0])
    np.testing.assert_allclose(tau, np.asarray(jres[0]["tau"].mean()),
                               **POOL_TOL)
    np.testing.assert_allclose(tau[0], float(pooled.posteriors["tau"].mean()),
                               **POOL_TOL)
    xs = tres.posteriors["x"].mean().numpy()
    np.testing.assert_allclose(xs, np.asarray(jres[0]["x"].mean()),
                               **POOL_TOL)
    for b in range(B):
        np.testing.assert_allclose(
            xs[b], np.asarray(pooled.posteriors[f"x{b}"].mean()), **POOL_TOL)
    fe = tres.free_energy.numpy()
    assert fe.shape == (10,)
    np.testing.assert_allclose(fe, np.asarray(jres[1]), **FE_TOL)
    np.testing.assert_allclose(fe, np.asarray(pooled.free_energy), **FE_TOL)


def hier(rx, d, a, r, nu0):
    @rx.model
    def hier(y):
        T = len(y)
        W = rx.Wishart(nu0, np.eye(d, dtype=np.float32))
        x = rx.latent(T, name="x")
        x[0] = rx.MvNormal(mean=np.zeros(d, np.float32),
                           cov=(10.0 * np.eye(d)).astype(np.float32))
        for t in rx.plate(1, T):
            x[t] = rx.MvNormal(mean=a @ x[t - 1], precision=W)
        for t in rx.plate(T):
            y[t] = rx.MvNormal(mean=x[t], cov=r)
        return {"x": x, "W": W}

    return hier


def hier_data(d, b, t_len, seed=2):
    rng = np.random.default_rng(seed)
    w_true = np.array([[2.0, 0.3], [0.3, 1.5]], np.float32)
    q_true = np.linalg.inv(w_true)
    ys = np.zeros((b, t_len, d), np.float32)
    for i in range(b):
        x = np.zeros(d)
        for t in range(t_len):
            x = 0.9 * x + rng.multivariate_normal(np.zeros(d), q_true)
            ys[i, t] = x + 0.3 * rng.standard_normal(d)
    return ys


def test_shared_wishart_process_noise():
    """B chains with one pooled process-noise precision W ~ Wishart:
    nu = nu0 + B (T - 1), the posterior and the pooled free energy as the
    JAX package's, the free energy non-increasing.  The JAX package's free
    energy of a chain with a random process-noise precision misses the
    (T - 1) copies of H[q(W)] (ROADMAP C6), B (T - 1) H[q(W)] over the pooled
    batch: the port's equals the JAX one minus that, sweep by sweep."""
    d, bw, tw = 2, 4, 48
    a = (0.9 * np.eye(d)).astype(np.float32)
    r = (0.09 * np.eye(d)).astype(np.float32)
    nu0 = float(d) + 1.0
    ys = hier_data(d, bw, tw)
    init = lambda dists: {"W": dists.Wishart(
        *((nu0, np.eye(d, dtype=np.float32)) if dists is jd else
          (torch.tensor(nu0), torch.eye(d))))}
    kw = dict(iterations=10, shared=("W",), free_energy=True)
    jres = jrx.infer_batched(hier(jrx, d, a, r, nu0), {"y": ys},
                             initialization=init(jd), **kw)
    tres = trx.infer_batched(hier(trx, d, a, r, nu0), {"y": ys},
                             initialization=init(td), device=CPU,
                             returnvars=trx.KeepEach(), **kw)
    entropies = np.array([float(q.entropy()[0])
                          for q in tres.posteriors["W"]])
    q_w = tres.posteriors["W"][-1]
    nu = q_w.nu.numpy()
    np.testing.assert_array_equal(nu, nu[0])
    assert float(nu[0]) == pytest.approx(nu0 + bw * (tw - 1), abs=1e-2)
    np.testing.assert_allclose(q_w.s.numpy(), np.asarray(jres[0]["W"].s),
                               **POOL_TOL)
    fe = tres.free_energy.numpy()
    assert fe.shape == (10,) and np.isfinite(fe).all()
    assert (np.diff(fe) <= 1e-3 * np.abs(fe[:-1])).all()
    np.testing.assert_allclose(
        fe, np.asarray(jres[1]) - bw * (tw - 1) * entropies, **FE_TOL)


@pytest.mark.parametrize("shared,err,match", [
    (("nope",), ValueError, "unknown"),
    (("x",), ValueError, "a chain block"),
    (("tau", "u"), ValueError, "no per-dataset factors"),
    (("p", "z"), NotImplementedError, "plated replicated factor"),
])
def test_shared_validation_errors(shared, err, match):
    """The JAX package's validation, its types and messages: an unknown
    name, a chain, a variable with no per-dataset factor, a shared variable
    whose replicated factor is plated (the Categorical between two shared
    variables, p and z)."""
    def odd(rx):
        @rx.model
        def odd(y, v):
            T = len(y)
            tau = rx.Gamma(shape=2.0, rate=2.0)
            u = rx.Gamma(shape=2.0, rate=1.0)   # noqa: F841 (prior only)
            p = rx.Dirichlet(np.ones(2, np.float32))
            z = rx.latent(3, name="z")
            for k in rx.plate(3):
                z[k] = rx.Categorical(p)
                v[k] = rx.NormalMixture(z[k], (-1.0, 1.0), (1.0, 1.0))
            x = rx.latent(T, name="x")
            x[0] = rx.Normal(mean=0.0, var=100.0)
            for t in rx.plate(1, T):
                x[t] = rx.Normal(mean=x[t - 1], var=0.25)
            for t in rx.plate(T):
                y[t] = rx.Normal(mean=x[t], precision=tau)
            return {"x": x}

        return odd

    model = walk_tau if shared[0] in ("nope", "x") else odd
    t = lambda v: torch.tensor(v)
    init, jinit = tau_init(td), tau_init(jd)
    data = {"y": walk_data()[:, :8]}
    if model is odd:
        init.update(u=td.GammaShapeRate(t(2.0), t(1.0)),
                    p=td.Dirichlet(torch.ones(2)))
        jinit.update(u=jd.GammaShapeRate(2.0, 1.0),
                     p=jd.Dirichlet(np.ones(2, np.float32)))
        data["v"] = walk_data(seed=1)[:, :3]
    with pytest.raises(err, match=match) as got:
        port(model, data, shared=shared, initialization=init,
             options={"warn": False})
    with pytest.raises(err) as want:
        jrx.infer_batched(model(jrx), data, shared=shared,
                          initialization=jinit, options={"warn": False})
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("b,iterations", [(4, 4), (3, 3)])
def test_chunked_matches_unchunked(b, iterations):
    """Beyond the device budget the pooled sum accumulates over sequential
    chunks (of two here; with B = 3 the last chunk is edge-padded and its
    copy must not count), and matches the unchunked pooled run."""
    y = walk_data()[:b]
    kw = dict(iterations=iterations, shared=("tau",), free_energy=True,
              initialization=tau_init(td))
    ref = port(walk_tau, {"y": y}, **kw)
    # per-element chain moments with the free energy: 7,168 bytes at T = 64
    # (batched.chain_hbm_bytes_per_element); 15 kB holds two
    with pytest.warns(UserWarning, match="sequential chunks of 2"):
        res = port(walk_tau, {"y": y}, options={"hbm_budget_bytes": 15_000},
                   **kw)
    for stat in ("mean", "var"):
        np.testing.assert_allclose(
            getattr(res.posteriors["tau"], stat)().numpy(),
            getattr(ref.posteriors["tau"], stat)().numpy(), **CHUNK_TOL)
    np.testing.assert_allclose(res.posteriors["x"].mean().numpy(),
                               ref.posteriors["x"].mean().numpy(),
                               **CHUNK_TOL)
    np.testing.assert_allclose(res.free_energy.numpy(),
                               ref.free_energy.numpy(), rtol=1e-5, atol=1e-3)
    jref = jrx.infer_batched(walk_tau(jrx), {"y": y}, iterations=iterations,
                             shared=("tau",), free_energy=True,
                             initialization=tau_init(jd))
    np.testing.assert_allclose(res.free_energy.numpy(), np.asarray(jref[1]),
                               **FE_TOL)


def test_chunked_refuses_keep_each():
    with pytest.raises(NotImplementedError, match="KeepEach"):
        port(walk_tau, {"y": walk_data()}, shared=("tau",),
             initialization=tau_init(td), returnvars=trx.KeepEach(),
             options={"hbm_budget_bytes": 7_000})


@pytest.mark.parametrize("fused", [True, False])
def test_dynamic_tier_with_a_shared_tau(fused):
    """``test_dyn_w_shared_tau_pooled``: the pooled tau reaches the dynamic
    tier's per-chain W (the plan reports ``dynamic == ["W"]``), fused and
    on ``fused_kernels=False``, against the JAX package's fused program and
    against each other; the pooled free energy is (iterations,)."""
    rng = np.random.default_rng(4)
    y = np.cumsum(rng.standard_normal((4, 16)), axis=1).astype(np.float32)
    opts = {} if fused else {"options": {"fused_kernels": False,
                                         "warn": False}}
    kw = dict(iterations=4, free_energy=True, shared=("tau",))
    tres = port(walk_tau, {"y": y}, initialization=tau_init(td), **kw,
                **opts)
    jres = jrx.infer_batched(walk_tau(jrx), {"y": y},
                             initialization=tau_init(jd), **kw)
    compiled, _ = trx.batched_program(walk_tau(trx), {"y": y}, iterations=4,
                                      free_energy=True, shared=("tau",),
                                      initialization=tau_init(td),
                                      device=CPU, **opts)
    report = compiled.plan_report()["x"]
    assert report.get("dynamic") == (["W"] if fused else None)
    assert tres.free_energy.shape == (4,)
    for name in ("x", "tau"):
        np.testing.assert_allclose(tres.posteriors[name].mean().numpy(),
                                   np.asarray(jres[0][name].mean()),
                                   rtol=1e-4, atol=5e-5)
    np.testing.assert_allclose(tres.free_energy.numpy(), np.asarray(jres[1]),
                               rtol=1e-4, atol=1e-3)


def test_shared_with_annotations_carries_the_pooled_evidence():
    """``annotations=`` with ``shared=``: every posterior carries the
    pooled model's one evidence, -FE."""
    y = walk_data(seed=3)
    res = port(walk_tau, {"y": y}, iterations=4, shared=("tau",),
               free_energy=True, annotations=trx.LogScaleAnnotations(),
               initialization=tau_init(td))
    for name in ("tau", "x"):
        assert float(trx.getlogscale(res.posteriors[name])) == pytest.approx(
            -float(res.free_energy[-1]), rel=1e-6)


def test_batched_program_caches_by_shared_and_refuses_a_mesh():
    """The program cache tells pooled from unpooled programs; ``psum_axis``
    and ``mesh=`` (the pooled sum over devices) raise naming A7b."""
    y = walk_data()
    model = walk_tau(trx)
    kw = dict(iterations=2, initialization=tau_init(td), device=CPU)
    pooled = trx.batched_program(model, {"y": y}, shared=("tau",), **kw)
    plain = trx.batched_program(model, {"y": y}, **kw)
    assert pooled[1] is not plain[1]
    assert trx.batched_program(model, {"y": y}, shared=("tau",),
                               **kw)[1] is pooled[1]
    with pytest.raises(NotImplementedError, match="ROADMAP A7b"):
        trx.batched_program(model, {"y": y}, shared=("tau",),
                            psum_axis="dp", **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP A7b"):
        trx.infer_batched(model, {"y": y}, shared=("tau",), mesh=object(),
                          initialization=tau_init(td), device=CPU)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        state, fe, _ = pooled[1]({"y": y})
    assert fe.shape == (0,) or fe.numel() == 0

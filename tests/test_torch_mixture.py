"""Generic mixtures and log-scale annotations (ROADMAP A4b) through both
packages on the CPU: the generic ``Mixture`` node (a Categorical and a
Bernoulli switch), ``GammaMixture``, ``LogScaleAnnotations`` (the
per-component Bayes factors next to a mixture, -FE elsewhere), the free
energy composed from exact mixture evidences and its plan-time refusal, and
the postprocess strategies; the cases of
``tests/models/test_generic_mixture.py``,
``tests/inference/test_mixture_logscale.py`` and
``tests/inference/test_annotations.py``.  Each model is written once for
both packages; inputs come from numpy seeds.  The port runs with
``device="cpu"``."""

import numpy as np
import pytest
import torch
from scipy.special import betaln

import rxinfer_tpu as jrx
import rxinfer_tpu_torch as trx
from rxinfer_tpu import dists as jd
from rxinfer_tpu_torch import dists as td

CPU = torch.device("cpu")
# the port against the JAX package: float32 in two libraries on one
# algebra (message products, log-partitions, lgamma)
TOL = dict(rtol=1e-5, atol=1e-5)
# against the float64 closed-form evidence: float32 sums of about n terms
EXACT_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def beta_init(dists, *pairs):
    t = (lambda x: x) if dists is jd else (lambda x: torch.tensor(x))
    return [dists.Beta(t(a), t(b)) for a, b in pairs]


def mixture_init(dists):
    in1, in2, theta = beta_init(dists, (4.0, 8.0), (8.0, 4.0), (1.0, 1.0))
    return {"in1": in1, "in2": in2, "theta": theta}


def coin_flips(n, p=0.75, seed=42, batch=None):
    rng = np.random.default_rng(seed)
    shape = (n,) if batch is None else (batch, n)
    return (rng.uniform(size=shape) < p).astype(np.float32)


def mixture_model(rx, n, switch="categorical", weights=(0.3, 0.7)):
    """theta ~ Mixture(selector, (Beta(4, 8), Beta(8, 4))), n Bernoulli
    observations of theta (``mixture_tests.jl:60-109``)."""
    @rx.model
    def mix(y):
        if switch == "categorical":
            selector = rx.Categorical(np.array(weights, np.float32))
        else:
            selector = rx.Bernoulli(float(weights[1]))
        in1 = rx.Beta(4.0, 8.0)
        in2 = rx.Beta(8.0, 4.0)
        theta = rx.Mixture(selector, (in1, in2))
        for i in rx.plate(n):
            y[i] = rx.Bernoulli(theta)
        return {"selector": selector, "in1": in1, "in2": in2,
                "theta": theta}

    return mix


def coin_model(rx, a=4.0, b=8.0):
    @rx.model
    def coin(y):
        theta = rx.Beta(a, b)
        for i in rx.plate(len(y)):
            y[i] = rx.Bernoulli(theta)
        return {"theta": theta}

    return coin


def log_z(a, b, n, s):
    """log of the Beta-Bernoulli evidence B(a + s, b + n - s) / B(a, b),
    float64."""
    return betaln(a + s, b + n - s) - betaln(a, b)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), **tol)


@pytest.mark.parametrize("switch", ["categorical", "bernoulli"])
def test_mixture_components_weights_and_bayes_factors(switch):
    """The mixture posterior's components are the standalone models'
    posteriors, its weights the selector's posterior, and the log-scales the
    per-component Bayes factors, as the JAX package gives them and as the
    closed forms say."""
    y = coin_flips(20)
    n, s = len(y), float(y.sum())
    run = lambda rx, dists: rx.infer(
        model=mixture_model(rx, n, switch), data={"y": y}, iterations=5,
        annotations=rx.LogScaleAnnotations(), returnvars=rx.KeepLast(),
        initialization=mixture_init(dists),
        **({} if rx is jrx else {"device": CPU}))
    jres, tres = run(jrx, jd), run(trx, td)
    theta = trx.getdata(tres.posteriors["theta"])
    assert isinstance(theta, td.MixtureDist) and theta.k == 2
    jtheta = jrx.getdata(jres.posteriors["theta"])
    close(theta.weights, jtheta.weights)
    for k, (a, b) in enumerate(((4.0, 8.0), (8.0, 4.0))):
        comp = theta.component(k)
        close([comp.a, comp.b], [a + s, b + n - s], dict(rtol=0, atol=1e-4))
        close([comp.a, comp.b], [jtheta.component(k).a,
                                 jtheta.component(k).b])
    sel = trx.getdata(tres.posteriors["selector"]).mean()
    if switch == "bernoulli":
        sel = torch.stack([1.0 - sel, sel])
    close(sel, theta.weights, dict(rtol=0, atol=1e-5))
    lj = np.array([np.log(0.3) + log_z(4.0, 8.0, n, s),
                   np.log(0.7) + log_z(8.0, 4.0, n, s)])
    want = {"in1": lj[0], "in2": lj[1], "theta": np.logaddexp(*lj),
            "selector": np.logaddexp(*lj)}
    for name, exact in want.items():
        got = float(trx.getlogscale(tres.posteriors[name]))
        close(got, float(jrx.getlogscale(jres.posteriors[name])))
        assert abs(got - exact) < EXACT_TOL, (name, got, exact)


def test_mixture_free_energy_is_the_exact_evidence():
    """``free_energy=True`` on a mixture: -log Z composed from the exact
    mixture evidence, as the JAX package composes it."""
    y = coin_flips(6)
    n, s = len(y), float(y.sum())
    run = lambda rx, dists: rx.infer(
        model=mixture_model(rx, n, weights=(0.5, 0.5)), data={"y": y},
        free_energy=True, returnvars=rx.KeepLast(),
        initialization=mixture_init(dists),
        **({} if rx is jrx else {"device": CPU}))
    jres, tres = run(jrx, jd), run(trx, td)
    assert tres.free_energy.shape == (1,)
    close(tres.free_energy.numpy(), np.asarray(jres.free_energy))
    lz = np.logaddexp(np.log(0.5) + log_z(4.0, 8.0, n, s),
                      np.log(0.5) + log_z(8.0, 4.0, n, s))
    assert abs(float(tres.log_evidence) - lz) < EXACT_TOL


def _mixture_plus(rx, n, m_w):
    """A mixture beside a plain part: a Gaussian observed m_w times (an
    unobserved Gaussian pair, the JAX test's other plain part, needs the
    Gaussian nodes' cavity stores: ROADMAP A6)."""
    @rx.model
    def mix(y, w):
        selector = rx.Categorical(np.array([0.5, 0.5], np.float32))
        in1 = rx.Beta(4.0, 8.0)
        in2 = rx.Beta(8.0, 4.0)
        theta = rx.Mixture(selector, (in1, in2))
        x = rx.Normal(mean=0.0, var=1.0)
        for i in rx.plate(m_w):
            w[i] = rx.Normal(mean=x, var=1.0)
        for i in rx.plate(n):
            y[i] = rx.Bernoulli(theta)
        return {"theta": theta, "x": x}

    return mix


def test_mixture_plus_plain_parts_free_energy_composes():
    """FE = -log Z_mix + the Bethe FE of the plain part (an observed
    Gaussian), against the JAX package and against the closed
    forms (the observed Gaussian's evidence by ``scipy``)."""
    from scipy.stats import multivariate_normal

    y = coin_flips(6)
    n, s = len(y), float(y.sum())
    rng = np.random.default_rng(3)
    w = (0.7 + 0.5 * rng.standard_normal(5)).astype(np.float32)
    run = lambda rx, dists: rx.infer(
        model=_mixture_plus(rx, n, len(w)), data={"y": y, "w": w},
        free_energy=True, returnvars=rx.KeepLast(),
        initialization=mixture_init(dists),
        **({} if rx is jrx else {"device": CPU}))
    jres, tres = run(jrx, jd), run(trx, td)
    close(tres.free_energy.numpy(), np.asarray(jres.free_energy),
          dict(rtol=1e-5, atol=1e-4))
    lz_mix = np.logaddexp(np.log(0.5) + log_z(4.0, 8.0, n, s),
                          np.log(0.5) + log_z(8.0, 4.0, n, s))
    m = len(w)
    lz_w = multivariate_normal(np.zeros(m), np.eye(m) + np.ones((m, m))
                               ).logpdf(w.astype(np.float64))
    assert abs(float(tres.free_energy[-1]) + lz_mix + lz_w) < EXACT_TOL


def test_mixture_free_energy_refuses_entangled_structure_when_planned():
    """A factor joining a mixture variable to another random variable is
    refused before any sweep runs, with the JAX package's error."""
    n = 6

    def entangled(rx):
        @rx.model
        def mix(y, z):
            selector = rx.Categorical(np.array([0.5, 0.5], np.float32))
            in1 = rx.Normal(mean=-1.0, var=1.0)
            in2 = rx.Normal(mean=1.0, var=1.0)
            theta = rx.Mixture(selector, (in1, in2))
            tau = rx.Gamma(shape=2.0, rate=2.0)
            for i in rx.plate(n):
                y[i] = rx.Normal(mean=theta, precision=tau)
            for i in rx.plate(3):
                z[i] = rx.Normal(mean=0.0, precision=tau)
            return {"theta": theta, "tau": tau}

        return mix

    t = lambda *a: [torch.tensor(x) for x in a]
    init = {"in1": td.NormalMeanVariance(*t(-1.0, 1.0)),
            "in2": td.NormalMeanVariance(*t(1.0, 1.0)),
            "theta": td.NormalMeanVariance(*t(0.0, 10.0)),
            "tau": td.GammaShapeRate(*t(2.0, 2.0))}
    data = {"y": coin_flips(n), "z": np.zeros(3, np.float32)}
    with pytest.raises(NotImplementedError, match="mixture variable"):
        trx.infer(model=entangled(trx), data=data, free_energy=True,
                  initialization=init, device=CPU)


def test_batched_mixture_annotations_and_free_energy():
    """``infer_batched(annotations=, free_energy=True)`` over datasets: each
    dataset's log-scale and -FE equal its exact evidence, and the log-scales
    the JAX package's (which gives no free energy for a mixture)."""
    n = 6
    ys = coin_flips(n, p=0.6, seed=5, batch=7)
    tres = trx.infer_batched(mixture_model(trx, n, weights=(0.5, 0.5)),
                             {"y": ys}, iterations=3, free_energy=True,
                             annotations=trx.LogScaleAnnotations(),
                             initialization=mixture_init(td), device=CPU)
    jres = jrx.infer_batched(mixture_model(jrx, n, weights=(0.5, 0.5)),
                             {"y": ys}, iterations=3,
                             annotations=jrx.LogScaleAnnotations(),
                             initialization=mixture_init(jd))
    s = ys.sum(1).astype(np.float64)
    lz = np.logaddexp(np.log(0.5) + log_z(4.0, 8.0, n, s),
                      np.log(0.5) + log_z(8.0, 4.0, n, s))
    assert tres.free_energy.shape == (1, 7)
    np.testing.assert_allclose(-tres.free_energy[-1].numpy(), lz, rtol=0,
                               atol=EXACT_TOL)
    for name in ("theta", "in1", "in2", "selector"):
        close(trx.getlogscale(tres.posteriors[name]),
              jrx.getlogscale(jres.posteriors[name]))
    np.testing.assert_allclose(trx.getlogscale(
        tres.posteriors["theta"]).numpy(), lz, rtol=0, atol=EXACT_TOL)


def test_gamma_mixture_matches_jax():
    """``GammaMixture`` with per-point selectors (``gamma_mixture_tests.jl
    :33-41``' model, 80 points): posteriors and the free-energy trace
    against the JAX package, the trace non-increasing."""
    rng = np.random.default_rng(43)
    n = 80
    mixing = np.array([0.8, 0.2])
    z = rng.uniform(size=n) < mixing[1]
    y = np.where(z, rng.gamma(90.0, 1.0 / 270.0, size=n),
                 rng.gamma(9.0, 1.0 / 27.0, size=n)).astype(np.float32)

    def gmix(rx):
        @rx.model
        def g(y):
            s = rx.Dirichlet((1e3 * mixing).astype(np.float32))
            b0 = rx.Gamma(shape=10.0, rate=10.0 / 27.0)
            b1 = rx.Gamma(shape=10.0, rate=10.0 / 270.0)
            zz = rx.latent(n, name="z")
            for i in rx.plate(n):
                zz[i] = rx.Categorical(s)
                y[i] = rx.GammaMixture(zz[i], (9.0, 90.0), (b0, b1))
            return {"s": s, "b0": b0, "b1": b1}

        return g

    def init(dists):
        t = (lambda x: x) if dists is jd else (
            lambda x: torch.as_tensor(np.float32(x)))
        return {"s": dists.Dirichlet(t((1e3 * mixing).astype(np.float32))),
                "b0": dists.GammaShapeRate(t(10.0), t(10.0 / 27.0)),
                "b1": dists.GammaShapeRate(t(10.0), t(10.0 / 270.0))}

    run = lambda rx, dists: rx.infer(
        model=gmix(rx), data={"y": y}, iterations=8, free_energy=True,
        returnvars=rx.KeepLast(), initialization=init(dists),
        **({} if rx is jrx else {"device": CPU}))
    jres, tres = run(jrx, jd), run(trx, td)
    tol = dict(rtol=1e-4, atol=1e-5)
    for name in ("s", "b0", "b1"):
        close(tres.posteriors[name].mean(),
              np.asarray(jres.posteriors[name].mean()), tol)
    fe = tres.free_energy.numpy()
    close(fe, np.asarray(jres.free_energy), dict(rtol=1e-4, atol=1e-2))
    assert (fe[1:] - fe[:-1] <= 5e-5 * np.abs(fe[:-1]) + 1e-3).all()


def test_logscale_is_the_evidence_on_a_tree_and_per_iteration():
    """On a tree the log-scale is -FE = log Z, after every sweep under
    ``KeepEach`` and as the JAX package gives it; a Bayes factor is a
    difference of two."""
    y = np.array([1, 0, 1, 1, 0, 1, 1, 1, 0, 1], np.float32)
    runs = {}
    for rx in (jrx, trx):
        runs[rx] = rx.infer(model=coin_model(rx), data={"y": y},
                            iterations=3, returnvars=rx.KeepEach(),
                            annotations=rx.LogScaleAnnotations(),
                            **({} if rx is jrx else {"device": CPU}))
    posts = runs[trx].posteriors["theta"]
    assert isinstance(posts, list) and len(posts) == 3
    exact = log_z(4.0, 8.0, len(y), float(y.sum()))
    for p, jp in zip(posts, runs[jrx].posteriors["theta"]):
        assert isinstance(p, trx.Marginal)
        close(float(trx.getlogscale(p)), float(jrx.getlogscale(jp)))
        assert abs(float(trx.getlogscale(p)) - exact) < EXACT_TOL
    assert abs(float(posts[-1].mean()) - 11.0 / 22.0) < 1e-5
    ls = [float(trx.getlogscale(trx.infer(
        model=coin_model(trx, a, b), data={"y": y}, device=CPU,
        annotations=trx.LogScaleAnnotations()).posteriors["theta"]))
        for a, b in ((8.0, 2.0), (2.0, 8.0))]
    n, s = len(y), float(y.sum())
    assert abs((ls[0] - ls[1]) - (log_z(8.0, 2.0, n, s)
                                  - log_z(2.0, 8.0, n, s))) < EXACT_TOL


def test_postprocess_strategies():
    """Without annotations posteriors are bare (and carry none); an explicit
    ``NoopPostprocess`` keeps a bare posterior bare; a callable is a
    strategy; ``UnpackMarginalPostprocess`` strips annotations; a missing
    log-scale raises, as in the JAX package."""
    y = np.array([1, 0, 1], np.float32)
    run = lambda **kw: trx.infer(model=coin_model(trx), data={"y": y},
                                 device=CPU, **kw).posteriors["theta"]
    bare = run()
    assert isinstance(bare, td.Beta) and trx.getannotations(bare) == {}
    assert isinstance(run(postprocess=trx.NoopPostprocess()), td.Beta)
    assert isinstance(run(postprocess=lambda m: str(trx.getdata(m))), str)
    assert isinstance(run(annotations=trx.LogScaleAnnotations(),
                          postprocess=trx.UnpackMarginalPostprocess()),
                      td.Beta)
    with pytest.raises(ValueError, match="LogScaleAnnotations"):
        trx.getlogscale(bare)


def test_batched_logscales_match_single_dataset_runs():
    """``infer_batched(annotations=)`` on a tree: each dataset's (B,)
    log-scale is its exact evidence and ``infer``'s on that dataset;
    ``infer_batched(postprocess=)`` applies the strategy."""
    ys = coin_flips(10, p=0.7, seed=0, batch=4)
    res = trx.infer_batched(coin_model(trx), {"y": ys}, iterations=2,
                            annotations=trx.LogScaleAnnotations(),
                            device=CPU)
    ls = trx.getlogscale(res.posteriors["theta"])
    assert ls.shape == (4,)
    for b in range(4):
        exact = log_z(4.0, 8.0, 10, float(ys[b].sum()))
        single = trx.infer(model=coin_model(trx), data={"y": ys[b]},
                           iterations=2, returnvars=trx.KeepLast(),
                           annotations=trx.LogScaleAnnotations(),
                           device=CPU)
        assert abs(float(ls[b]) - exact) < EXACT_TOL
        close(float(ls[b]), float(trx.getlogscale(
            single.posteriors["theta"])))
    unpacked = trx.infer_batched(
        coin_model(trx), {"y": ys}, iterations=2, device=CPU,
        annotations=trx.LogScaleAnnotations(),
        postprocess=trx.UnpackMarginalPostprocess())
    assert isinstance(unpacked.posteriors["theta"], td.Beta)

"""The rest of the node library (ROADMAP A6d) through both packages: the
new distributions (moments, log-densities, products and natural views),
every new node's messages and average energy through ``call_rule``, the
count, noise-level and covariance models of ``chip_smoke.py`` phase 22
(a)-(c) at small shapes, ``ProjectedTo("poisson")`` / ``("binomial")`` on
exact tilts, ``where(dependencies=RequireMessage(...))`` with an EP probit
written in torch, and the DSL's new statements.  Inputs come from numpy
seeds; the port runs on the CPU, the JAX package as its own tests run it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import betaln, gammaln
from scipy.stats import norm as sp_norm

import rxinfer_tpu as jrx
import rxinfer_tpu_torch as trx
from rxinfer_tpu import dists as jd
from rxinfer_tpu.dists import natural as jnat
from rxinfer_tpu.rules.registry import call_rule as jcall
from rxinfer_tpu_torch import convert
from rxinfer_tpu_torch import dists as td
from rxinfer_tpu_torch.dists import natural as tnat
from rxinfer_tpu_torch.dists import sampling as tsamp
from rxinfer_tpu_torch.engine.projection import project_logpdf
from rxinfer_tpu_torch.rules.registry import call_rule as tcall

CPU = torch.device("cpu")
# one float32 closed-form expression in each library
RULE_TOL = dict(rtol=1e-5, atol=1e-6)
# a whole model's posteriors and free energy, float32 sums over a plate in
# each library's order
MODEL_TOL = dict(rtol=2e-5, atol=1e-5)
# a float32 free energy (a plate's sum of log-gamma terms) against its
# float64 closed form
FE_RTOL = 2e-5


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _f32(x):
    return np.asarray(x, np.float32)


def both(family: str, *params):
    """The same distribution in both packages from numpy parameters."""
    return (convert.dist_from_numpy(family, [_f32(p) for p in params]),
            getattr(jd, family)(*[jnp.asarray(_f32(p)) for p in params]))


def pm(x):
    return td.PointMass(torch.as_tensor(_f32(x))), jd.PointMass(
        jnp.asarray(_f32(x)))


def close(t, j, **tol):
    np.testing.assert_allclose(np.asarray(t.detach()), np.asarray(j),
                               **(tol or RULE_TOL))


def same_dist(t, j, **tol):
    """Two distributions agree: field by field when the classes match,
    else by their natural parameters."""
    if type(t).__name__ == type(j).__name__:
        for name in t.__dataclass_fields__:
            close(getattr(t, name), getattr(j, name), **tol)
        return
    for a, b in zip(tnat.to_natural(t), jnat.to_natural(j)):
        close(a, b, **tol)


def _spd(rng, lead, d, scale=1.0):
    a = rng.standard_normal(lead + (d, d))
    return scale * (a @ np.swapaxes(a, -1, -2) / d + np.eye(d))


# -- the distributions ----------------------------------------------------------------

def _family_cases():
    rng = np.random.default_rng(0)
    u = lambda lo, hi, *s: rng.uniform(lo, hi, s)
    d = 3
    return {
        "GammaShapeScale": ((u(0.5, 4, 4), u(0.2, 3, 4)),
                            ("mean", "var", "mean_log", "entropy"),
                            u(0.1, 5, 4)),
        "InverseGamma": ((u(2.5, 6, 4), u(0.5, 3, 4)),
                         ("mean", "var", "mean_log", "mean_inverse",
                          "entropy"), u(0.1, 5, 4)),
        "Poisson": ((u(0.5, 20, 4),), ("mean", "var", "entropy"),
                    rng.integers(0, 30, 4)),
        "Binomial": ((rng.integers(1, 40, 4), u(0.05, 0.95, 4)),
                     ("mean", "var"), rng.integers(0, 2, 4)),
        "Uniform": ((u(-3, 0, 4), u(0.5, 3, 4)), ("mean", "var", "entropy"),
                    None),
        # the entropy is pinned apart (ROADMAP C13)
        "InverseWishart": ((u(d + 2, d + 9, 2), _spd(rng, (2,), d)),
                           ("mean", "mean_inverse", "mean_logdet"), None),
        "Multinomial": ((rng.integers(5, 30, 2), rng.standard_normal((2, 4))),
                        ("mean", "var"), rng.multinomial(10, [0.25] * 4, 2)),
        "MvNormalMeanScalePrecision": ((rng.standard_normal((2, d)),
                                        u(0.3, 4, 2)),
                                       ("mean", "cov", "var", "precision",
                                        "weightedmean", "entropy"), None),
    }


@pytest.mark.parametrize("family", sorted(_family_cases()))
def test_distribution_moments_and_logpdf_match_jax(family):
    params, methods, points = _family_cases()[family]
    t, j = both(family, *params)
    for m in methods:
        close(getattr(t, m)(), getattr(j, m)(), rtol=2e-5, atol=1e-5)
    if points is not None:
        x = _f32(points)
        close(tsamp.logpdf(t, torch.as_tensor(x)), j.logpdf(jnp.asarray(x)),
              rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("family,other", [
    ("GammaShapeScale", "GammaShapeRate"), ("InverseGamma", "InverseGamma"),
    ("Poisson", "Poisson"), ("InverseWishart", "InverseWishart"),
    ("MvNormalMeanScalePrecision", "MvNormalMeanCovariance")])
def test_products_and_natural_views_match_jax(family, other):
    params, _, _ = _family_cases()[family]
    t1, j1 = both(family, *params)
    rng = np.random.default_rng(1)
    if other == family:
        t2, j2 = both(other, *[p[::-1].copy() for p in params])
    elif other == "GammaShapeRate":
        t2, j2 = both(other, rng.uniform(1, 3, 4), rng.uniform(0.5, 2, 4))
    else:
        t2, j2 = both(other, rng.standard_normal((2, 3)),
                      _spd(rng, (2,), 3))
    tp, jp = td.prod(t1, t2), jd.prod(j1, j2)
    same_dist(tp, jp, rtol=2e-5, atol=1e-5)
    # a product is the sum of natural parameters; the view round-trips
    key = tnat.family_key(t1)
    assert key == jnat.family_key(j1)
    same_dist(tnat.prod_all([t1, t2]), jnat.prod_all([j1, j2]),
              rtol=2e-5, atol=1e-5)
    back = tnat.from_natural(key, tnat.to_natural(t1))
    for a, b in zip(tnat.to_natural(back), jnat.to_natural(j1)):
        close(a, b, rtol=2e-5, atol=1e-5)


def test_c13_inverse_wishart_entropy_is_the_jax_one_less_d_d1_log2():
    """ROADMAP C13, a reference fault: the JAX InverseWishart entropy adds
    d (d + 1)/2 log 2 where -E[log p(X)] subtracts it.  The port's equals
    the float64 closed form (and a Monte-Carlo estimate from scipy's
    draws: 50k draws, within 0.04) and the JAX one less d (d + 1) log 2."""
    from scipy.special import multigammaln, psi
    from scipy.stats import invwishart

    rng = np.random.default_rng(12)
    for d in (1, 3, 8):
        nu, s = d + 4.5, _spd(rng, (), d)
        t, j = both("InverseWishart", nu, s)
        mv_psi = sum(psi(0.5 * (nu + 1 - k)) for k in range(1, d + 1))
        h = (0.5 * (d + 1) * np.linalg.slogdet(s)[1]
             - 0.5 * d * (d + 1) * np.log(2.0) + multigammaln(0.5 * nu, d)
             - 0.5 * (nu + d + 1) * mv_psi + 0.5 * nu * d)
        close(t.entropy(), h, rtol=2e-5, atol=2e-5)
        close(t.entropy(), float(j.entropy()) - d * (d + 1) * np.log(2.0),
              rtol=2e-5, atol=2e-5)
        if d == 3:
            dist = invwishart(df=nu, scale=s)
            x = dist.rvs(50_000, random_state=0)
            mc = -dist.logpdf(np.moveaxis(x, 0, -1)).mean()
            assert abs(float(t.entropy()) - mc) < 0.04, (float(t.entropy()),
                                                         mc)


def test_plate_reduction_keeps_the_improper_messages_in_natural_form():
    """1e5 conjugate messages to a variance (InverseGamma, a = -1/2) summed
    over a plate: the product with a proper prior is the closed form,
    (a0 + N/2, b0 + sum C/2), because ``prod_reduce`` sums natural
    parameters (a + 1 = 1/2 each) rather than shapes."""
    n = 100_000
    c = torch.as_tensor(np.random.default_rng(2).uniform(0.1, 2.0, (1, n))
                        .astype(np.float32))
    msg = td.InverseGamma(torch.full_like(c, -0.5), 0.5 * c)
    total = tnat.prod_all([tnat.prod_reduce(msg, n, batch_ndim=1),
                           td.InverseGamma(torch.tensor([2.0]),
                                           torch.tensor([1.0]))])
    close(total.a, [2.0 + n / 2], rtol=1e-7)
    close(total.b, [1.0 + 0.5 * float(c.double().sum())], rtol=1e-6)


def test_sampling_and_modes_of_the_count_families():
    g = tsamp.generator(3, CPU)
    lam = torch.tensor([0.5, 4.0, 30.0])
    x = tsamp.sample(td.Poisson(lam), 20000, g)
    assert x.shape == (20000, 3) and bool((x == torch.round(x)).all())
    close(x.mean(0), lam, rtol=0.03)
    n, p = torch.tensor([12.0, 40.0]), torch.tensor([0.35, 0.8])
    xb = tsamp.sample(td.Binomial(n, p), 20000, g)
    assert bool((xb <= n).all()) and bool((xb >= 0).all())
    close(xb.mean(0), n * p, rtol=0.02)
    close(tsamp.mode(td.Poisson(lam)), [0.0, 4.0, 30.0])
    close(tsamp.mode(td.Binomial(n, p)), [4.0, 32.0])


# -- the nodes through call_rule ------------------------------------------------------

def _rule_cases():
    rng = np.random.default_rng(5)
    u = lambda lo, hi, *s: rng.uniform(lo, hi, s)
    d = 3
    gauss = lambda: both("NormalMeanVariance", rng.standard_normal(4),
                         u(0.2, 2, 4))
    mvg = lambda: both("MvNormalMeanCovariance", rng.standard_normal((2, d)),
                       _spd(rng, (2,), d))
    counts = rng.integers(0, 20, 4).astype(np.float32)
    trials = counts + rng.integers(0, 10, 4)
    mcounts = rng.multinomial(12, [0.1, 0.2, 0.3, 0.4], 2)
    cases = {
        ("NormalMeanVariance", "var"): dict(out=gauss(), mean=gauss()),
        ("NormalMeanVariance", "average_energy"): dict(
            out=gauss(), mean=gauss(),
            var=both("InverseGamma", u(2.5, 5, 4), u(0.5, 2, 4))),
        ("MvNormalMeanCovariance", "cov"): dict(out=mvg(), mean=mvg()),
        ("MvNormalMeanCovariance", "average_energy"): dict(
            out=mvg(), mean=mvg(),
            cov=both("InverseWishart", u(d + 2, d + 8, 2),
                     _spd(rng, (2,), d))),
        ("Binomial", "p"): dict(out=pm(counts), n=pm(trials)),
        ("Binomial", "average_energy"): dict(
            out=pm(counts), n=pm(trials),
            p=both("Beta", u(0.5, 5, 4), u(0.5, 5, 4))),
        ("Poisson", "out"): dict(rate=both("GammaShapeRate", u(1, 5, 4),
                                           u(0.2, 2, 4))),
        ("Poisson", "rate"): dict(out=pm(counts)),
        ("Poisson", "average_energy"): dict(
            out=pm(counts), rate=both("GammaShapeScale", u(1, 5, 4),
                                      u(0.2, 2, 4))),
        ("Multinomial", "p"): dict(out=pm(mcounts), n=pm(mcounts.sum(-1))),
        ("Multinomial", "average_energy"): dict(
            out=pm(mcounts), n=pm(mcounts.sum(-1)),
            p=both("Dirichlet", u(0.5, 4, 2, 4))),
        ("GammaShapeScale", "out"): dict(shape=pm(u(1, 4, 4)),
                                         scale=pm(u(0.5, 3, 4))),
        ("GammaShapeScale", "average_energy"): dict(
            shape=pm(u(1, 4, 4)), scale=pm(u(0.5, 3, 4)),
            out=both("GammaShapeRate", u(1, 5, 4), u(0.2, 2, 4))),
        ("GammaShapeRate", "rate"): dict(
            shape=pm(u(1, 4, 4)),
            out=both("GammaShapeRate", u(1, 5, 4), u(0.2, 2, 4))),
        ("InverseGamma", "out"): dict(shape=pm(u(2, 4, 4)),
                                      scale=pm(u(0.5, 3, 4))),
        ("InverseGamma", "average_energy"): dict(
            shape=pm(u(2, 4, 4)), scale=pm(u(0.5, 3, 4)),
            out=both("InverseGamma", u(2.5, 6, 4), u(0.5, 2, 4))),
        ("InverseWishart", "out"): dict(nu=pm(u(d + 2, d + 6, 2)),
                                        Psi=pm(_spd(rng, (2,), d))),
        ("InverseWishart", "average_energy"): dict(
            nu=pm(u(d + 2, d + 6, 2)), Psi=pm(_spd(rng, (2,), d)),
            out=both("InverseWishart", u(d + 2, d + 8, 2),
                     _spd(rng, (2,), d))),
        ("Uniform", "out"): dict(lo=pm(u(-2, 0, 4)), hi=pm(u(0.5, 2, 4))),
        ("Uniform", "average_energy"): dict(
            lo=pm(u(-2, 0, 4)), hi=pm(u(0.5, 2, 4)), out=gauss()),
        ("MvNormalMeanScalePrecision", "out"): dict(
            mean=mvg(), gamma=both("GammaShapeRate", u(1, 5, 2),
                                   u(0.2, 2, 2))),
        ("MvNormalMeanScalePrecision", "mean"): dict(
            out=pm(rng.standard_normal((2, d))),
            gamma=both("GammaShapeRate", u(1, 5, 2), u(0.2, 2, 2))),
        ("MvNormalMeanScalePrecision", "gamma"): dict(out=mvg(), mean=mvg()),
        ("MvNormalMeanScalePrecision", "average_energy"): dict(
            out=mvg(), mean=mvg(),
            gamma=both("GammaShapeRate", u(1, 5, 2), u(0.2, 2, 2))),
    }
    return cases


@pytest.mark.parametrize("fform,iface", sorted(_rule_cases()),
                         ids=lambda v: str(v))
def test_node_rules_and_average_energy_match_jax(fform, iface):
    q = _rule_cases()[(fform, iface)]
    t = tcall(fform, iface, **{k: v[0] for k, v in q.items()})
    j = jcall(fform, iface, **{k: v[1] for k, v in q.items()})
    if iface == "average_energy":
        close(t, j, rtol=1e-5, atol=1e-5)
    else:
        same_dist(t, j)


def test_uninformative_is_the_flat_gaussian():
    t = tcall("Uninformative", "out")
    j = jcall("Uninformative", "out")
    same_dist(t, j)
    out = td.NormalMeanVariance(torch.zeros(3), torch.ones(3))
    assert torch.equal(tcall("Uninformative", "average_energy", out=out),
                       torch.zeros(3))


# -- phase 22 (a)-(c) at small shapes ----------------------------------------------

def _poisson_gamma(rx):
    @rx.model
    def counts(y):
        rate = rx.Gamma(shape=2.0, scale=5.0)
        for i in rx.plate(len(y)):
            y[i] = rx.Poisson(rate)
        return {"rate": rate}
    return counts


def _beta_binomial(rx):
    @rx.model
    def ctr(y, n):
        p = rx.Beta(1.0, 1.0)
        for i in rx.plate(len(y)):
            y[i] = rx.Binomial(n[i], p)
        return {"p": p}
    return ctr


def _dirichlet_multinomial(rx, k):
    @rx.model
    def sessions(y, n):
        p = rx.Dirichlet(np.ones(k, np.float32))
        for i in rx.plate(len(y)):
            y[i] = rx.Multinomial(n[i], p)
        return {"p": p}
    return sessions


def _run_both(source, data, t_kwargs=None, j_kwargs=None, **kwargs):
    tpost, tfe = trx.infer_batched(source(trx), data, free_energy=True,
                                   device=CPU, **(t_kwargs or {}), **kwargs)
    jpost, jfe = jrx.infer_batched(source(jrx), data, free_energy=True,
                                   **(j_kwargs or {}), **kwargs)
    return tpost, tfe.numpy(), jpost, np.asarray(jfe)


def test_poisson_gamma_counts_match_jax_and_the_closed_form():
    """rate ~ Gamma(shape=2, scale=5), y[i] ~ Poisson(rate): the posterior
    is Gamma(2 + sum y, 1/5 + N) and the free energy -log p(y) exactly."""
    y = np.random.default_rng(6).poisson(4.0, (3, 40)).astype(np.float32)
    tpost, tfe, jpost, jfe = _run_both(_poisson_gamma, {"y": y},
                                       iterations=2)
    y = y.astype(np.float64)
    a, b = 2.0 + y.sum(1), 0.2 + y.shape[1]
    close(tpost["rate"].a, a, rtol=1e-6)
    close(tpost["rate"].b, np.full(3, b), rtol=1e-6)
    close(tpost["rate"].mean(), np.asarray(jpost["rate"].mean()), **MODEL_TOL)
    log_z = (gammaln(a) - a * np.log(b) - (gammaln(2.0) - 2.0 * np.log(0.2))
             - gammaln(y + 1.0).sum(1))
    np.testing.assert_allclose(tfe[-1], -log_z, rtol=FE_RTOL)
    np.testing.assert_allclose(tfe, jfe, **MODEL_TOL)


def test_beta_binomial_and_dirichlet_multinomial_match_jax():
    rng = np.random.default_rng(7)
    n = rng.integers(5, 60, (3, 30)).astype(np.float32)
    y = rng.binomial(n.astype(int), 0.3).astype(np.float32)
    tpost, tfe, jpost, jfe = _run_both(_beta_binomial, {"y": y, "n": n},
                                       iterations=2)
    close(tpost["p"].a, 1.0 + y.sum(1), rtol=1e-6)
    close(tpost["p"].b, 1.0 + (n - y).sum(1), rtol=1e-6)
    n, y = n.astype(np.float64), y.astype(np.float64)
    log_z = (betaln(1 + y.sum(1), 1 + (n - y).sum(1))
             + (gammaln(n + 1) - gammaln(y + 1) - gammaln(n - y + 1)).sum(1))
    np.testing.assert_allclose(tfe[-1], -log_z, rtol=FE_RTOL)
    np.testing.assert_allclose(tfe, jfe, **MODEL_TOL)

    k = 5
    cnt = rng.multinomial(20, np.arange(1, k + 1) / 15.0, (2, 25)).astype(
        np.float32)
    tot = cnt.sum(-1)
    tpost, tfe, jpost, jfe = _run_both(
        lambda rx: _dirichlet_multinomial(rx, k), {"y": cnt, "n": tot},
        iterations=2)
    alpha = 1.0 + cnt.sum(1)
    close(tpost["p"].alpha, alpha, rtol=1e-6)
    cnt, tot, alpha = (a.astype(np.float64) for a in (cnt, tot, alpha))
    log_z = (gammaln(alpha).sum(-1) - gammaln(alpha.sum(-1)) + gammaln(k)
             + (gammaln(tot + 1) - gammaln(cnt + 1).sum(-1)).sum(1))
    np.testing.assert_allclose(tfe[-1], -log_z, rtol=FE_RTOL)
    np.testing.assert_allclose(tfe, jfe, **MODEL_TOL)


def _noise_level(rx):
    @rx.model
    def sensor(y):
        mu = rx.Normal(mean=0.0, var=100.0)
        v = rx.InverseGamma(2.0, 1.0)
        for i in rx.plate(len(y)):
            y[i] = rx.Normal(mean=mu, var=v)
        return {"mu": mu, "v": v}
    return sensor


def test_noise_level_vmp_matches_jax():
    """The variance form of ``test_conjugate_vmp``: mu and an
    InverseGamma variance, v initialized, 10 iterations; the messages to v
    are the improper a = -1/2 carriers."""
    y = (1.0 + 0.7 * np.random.default_rng(8).standard_normal((3, 50))) \
        .astype(np.float32)
    tpost, tfe, jpost, jfe = _run_both(
        _noise_level, {"y": y}, iterations=10,
        t_kwargs={"initialization": {"v": td.InverseGamma(
            torch.tensor(2.0), torch.tensor(1.0))}},
        j_kwargs={"initialization": {"v": jd.InverseGamma(
            jnp.asarray(2.0), jnp.asarray(1.0))}})
    for name in ("mu", "v"):
        close(tpost[name].mean(), np.asarray(jpost[name].mean()),
              **MODEL_TOL)
    close(tpost["v"].a, 2.0 + 0.5 * y.shape[1], rtol=1e-6)
    np.testing.assert_allclose(tfe, jfe, **MODEL_TOL)
    assert np.all(np.diff(tfe, axis=0) <= 1e-4 * np.abs(tfe[1:]))


def _covariance(rx, d, known_mean):
    eye = np.eye(d, dtype=np.float32)

    @rx.model
    def array(y):
        sig = rx.InverseWishart(d + 3.0, eye)
        m = (np.zeros(d, np.float32) if known_mean
             else rx.MvNormal(mean=np.zeros(d, np.float32), cov=100.0 * eye))
        for i in rx.plate(len(y)):
            y[i] = rx.MvNormal(mean=m, cov=sig)
        return {"sig": sig} if known_mean else {"sig": sig, "m": m}
    return array


def _scale_precision(rx, d):
    @rx.model
    def array(y):
        m = rx.MvNormal(mean=np.zeros(d, np.float32),
                        cov=100.0 * np.eye(d, dtype=np.float32))
        g = rx.Gamma(shape=1.0, rate=1.0)
        for i in rx.plate(len(y)):
            y[i] = rx.MvNormal(mean=m, gamma=g)
        return {"m": m, "g": g}
    return array


def test_covariance_models_match_jax():
    """(c) at d = 4: an InverseWishart covariance with a known mean (closed
    form IW(nu + N, Psi + S)), with a random mean (5 sweeps of VMP), and
    the scale-precision form MvNormal(mean=m, gamma=g)."""
    d = 4
    rng = np.random.default_rng(9)
    y = (rng.standard_normal((2, 30, d)) @ np.linalg.cholesky(
        _spd(rng, (), d)).T + 0.5).astype(np.float32)
    tpost, tfe, jpost, jfe = _run_both(lambda rx: _covariance(rx, d, True),
                                       {"y": y}, iterations=2)
    close(tpost["sig"].nu, np.full(2, d + 3.0 + 30), rtol=1e-6)
    psi = np.eye(d) + np.einsum("bni,bnj->bij", y.astype(np.float64),
                                y.astype(np.float64))
    close(tpost["sig"].psi, psi, rtol=1e-5)
    # the conjugate model's free energy is -log p(y), a matrix-t: the
    # port's; the JAX package's less d (d + 1) log 2 (C13)
    from scipy.special import multigammaln

    nu0, nu = d + 3.0, d + 3.0 + 30
    log_z = (-0.5 * 30 * d * np.log(np.pi) + multigammaln(0.5 * nu, d)
             - multigammaln(0.5 * nu0, d) - 0.5 * nu
             * np.linalg.slogdet(psi)[1])
    np.testing.assert_allclose(tfe[-1], -log_z, rtol=FE_RTOL)
    c13 = d * (d + 1) * np.log(2.0)
    np.testing.assert_allclose(tfe, jfe + c13, **MODEL_TOL)

    eye = np.eye(d, dtype=np.float32)
    tpost, tfe, jpost, jfe = _run_both(
        lambda rx: _covariance(rx, d, False), {"y": y}, iterations=5,
        t_kwargs={"initialization": {"sig": td.InverseWishart(
            torch.tensor(d + 3.0), torch.as_tensor(eye))}},
        j_kwargs={"initialization": {"sig": jd.InverseWishart(
            jnp.asarray(d + 3.0), jnp.asarray(eye))}})
    close(tpost["m"].mean(), np.asarray(jpost["m"].mean()), **MODEL_TOL)
    close(tpost["sig"].mean(), np.asarray(jpost["sig"].mean()), **MODEL_TOL)
    np.testing.assert_allclose(tfe, jfe + c13, **MODEL_TOL)

    tpost, tfe, jpost, jfe = _run_both(
        lambda rx: _scale_precision(rx, d), {"y": y}, iterations=5,
        t_kwargs={"initialization": {"g": td.GammaShapeRate(
            torch.tensor(1.0), torch.tensor(1.0))}},
        j_kwargs={"initialization": {"g": jd.GammaShapeRate(
            jnp.asarray(1.0), jnp.asarray(1.0))}})
    for name in ("m", "g"):
        close(tpost[name].mean(), np.asarray(jpost[name].mean()),
              **MODEL_TOL)
    np.testing.assert_allclose(tfe, jfe, **MODEL_TOL)


# -- ProjectedTo("poisson") / ("binomial") on exact tilts ------------------------------

def test_project_poisson_exact_tilt():
    """Target proportional to Poisson(lam) exp(eps x) is Poisson(lam
    e^eps): recovered within 5%, the JAX test's bound."""
    lam, eps = 3.0, 0.4
    base = td.Poisson(torch.tensor(lam))
    q = project_logpdf("poisson",
                       lambda x: tsamp.logpdf(base, x) + eps * x,
                       td.Poisson(torch.ones(())), n_iters=40,
                       n_samples=4096, seed=1)
    target = lam * np.exp(eps)
    assert abs(float(q.lam) - target) / target < 0.05, float(q.lam)


def test_project_binomial_exact_tilt():
    """Target proportional to Binomial(n, p) exp(eps x) is Binomial(n,
    sigmoid(logit p + eps)): within 0.03, the JAX test's bound; the trial
    count rides beside the natural parameter."""
    n, p, eps = 12.0, 0.35, 0.8
    base = td.Binomial(torch.tensor(n), torch.tensor(p))
    q = project_logpdf("binomial",
                       lambda x: tsamp.logpdf(base, x) + eps * x,
                       td.Binomial(torch.tensor(n), torch.full((), 0.5)),
                       n_iters=40, n_samples=4096, seed=2, n_trials=n)
    target = 1.0 / (1.0 + np.exp(-(np.log(p / (1 - p)) + eps)))
    assert abs(float(q.p) - target) < 0.03, float(q.p)
    assert float(q.n) == n
    # the form constraint: a product of such messages, projected over a batch
    pt = trx.ProjectedTo("binomial", n=n, n_iters=40, n_samples=4096, seed=2)
    tilt = td.LogPdfMessage(lambda x: eps * x, batch_shape=(2,))
    out = pt.project_product([td.Binomial(torch.full((2,), n),
                                          torch.full((2,), p)), tilt])
    assert out.p.shape == (2,)
    assert float(torch.max(torch.abs(out.p - target))) < 0.03


# -- where(dependencies=RequireMessage(...)) -----------------------------------------

def _probit_rm_nodes():
    """The EP probit of ``tests/models/test_require_message.py``, in each
    package: its backward rule reads the inbound (cavity) message on its
    own edge."""
    from jax.scipy.special import log_ndtr
    from jax.scipy.stats import norm as jnorm
    from rxinfer_tpu.rules import expectations as jx
    from rxinfer_tpu.rules.registry import node as jnode
    from rxinfer_tpu.rules.special import _gauss_hermite as jgh
    from rxinfer_tpu_torch.rules import expectations as tx
    from rxinfer_tpu_torch.rules.registry import has_node
    from rxinfer_tpu_torch.rules.registry import node as tnode
    from rxinfer_tpu_torch.rules.special import _gauss_hermite as tgh

    def make(xp, ndtr, log_ndtr_, gh, ex, ber, nwmp):
        class ProbitRM:
            interfaces = ("out", "in")

            @staticmethod
            def message_to_out(q):
                m, v = ex.e_mean(q["in"]), ex.e_var(q["in"])
                return ber(xp.clip(ndtr(m / xp.sqrt(1.0 + v)), 1e-7,
                                   1 - 1e-7))

            @staticmethod
            def message_to_in(q):
                s = 2.0 * ex.e_mean(q["out"]) - 1.0
                m = ex.e_mean(q["in"])
                v = xp.clip(ex.e_var(q["in"]), 1e-8, 1e8)
                denom = xp.sqrt(1.0 + v)
                z = s * m / denom
                ratio = xp.exp(-0.5 * z * z - 0.9189385332046727
                               - log_ndtr_(z))
                mt = m + s * v * ratio / denom
                vt = xp.clip(v - v * v * ratio * (z + ratio) / (1.0 + v),
                             1e-10, None)
                return nwmp(mt / vt - m / v, 1.0 / vt - 1.0 / v)

            @staticmethod
            def average_energy(q):
                s = 2.0 * ex.e_mean(q["out"]) - 1.0
                return -gh(lambda x: log_ndtr_(s[..., None] * x),
                           ex.e_mean(q["in"]), ex.e_var(q["in"]))
        return ProbitRM

    if not has_node("ProbitRMTorch"):
        tnode("ProbitRMTorch")(make(torch, torch.special.ndtr,
                                    torch.special.log_ndtr, tgh, tx,
                                    td.Bernoulli,
                                    td.NormalWeightedMeanPrecision))
        jnode("ProbitRMTorch")(make(jnp, jnorm.cdf, log_ndtr, jgh, jx,
                                    jd.Bernoulli,
                                    jd.NormalWeightedMeanPrecision))


def test_require_message_probit_matches_jax_and_the_builtin_probit():
    """``where(dependencies=RequireMessage(in_=prior))``: the EP probit
    reads its cavity on its own edge (the marginal divided by its previous
    message; the user's message on the first sweep).  Its fixed point is
    the builtin Probit's (which divides the marginal itself) within 5e-3,
    and the JAX package's."""
    _probit_rm_nodes()
    rng = np.random.default_rng(4)
    n = 300
    y = (rng.uniform(size=n) < sp_norm.cdf(0.8)).astype(np.float32)

    def source(rx, dists, mk):
        @rx.model
        def probit(y):
            x = rx.Normal(mean=0.0, var=10.0)
            with rx.where(dependencies=rx.RequireMessage(
                    in_=dists.NormalMeanVariance(mk(0.0), mk(10.0)))):
                for i in rx.plate(n):
                    y[i] = rx.factor_node("ProbitRMTorch", **{"in": x})
            return {"x": x}
        return probit

    tres = trx.infer(model=source(trx, td, torch.tensor), data={"y": y},
                     iterations=25, returnvars=trx.KeepLast(),
                     initialization={"x": td.NormalMeanVariance(
                         torch.tensor(0.0), torch.tensor(10.0))},
                     free_energy=True, device=CPU)
    jres = jrx.infer(model=source(jrx, jd, jnp.asarray), data={"y": y},
                     iterations=25, returnvars=jrx.KeepLast(),
                     initialization={"x": jd.NormalMeanVariance(0.0, 10.0)},
                     free_energy=True)
    est = float(tres.posteriors["x"].mean())
    assert abs(sp_norm.cdf(est) - y.mean()) < 0.03
    assert abs(est - float(jres.posteriors["x"].mean())) < 1e-4
    fe = np.asarray(tres.free_energy)
    assert np.isfinite(fe).all()
    np.testing.assert_allclose(fe, np.asarray(jres.free_energy), rtol=1e-4)

    @trx.model
    def builtin(y):
        x = trx.Normal(mean=0.0, var=10.0)
        for i in trx.plate(n):
            y[i] = trx.Probit(x)
        return {"x": x}

    bres = trx.infer(model=builtin, data={"y": y}, iterations=25,
                     returnvars=trx.KeepLast(),
                     initialization={"x": td.NormalMeanVariance(
                         torch.tensor(0.0), torch.tensor(10.0))},
                     device=CPU)
    assert abs(est - float(bres.posteriors["x"].mean())) < 5e-3


def test_where_requires_a_model_and_merges_meta():
    with pytest.raises(RuntimeError):
        with trx.where(dependencies=trx.RequireMessage(in_=None)):
            pass

    def source(rx):
        @rx.model
        def m(y):
            x = rx.Normal(mean=0.0, var=1.0)
            with rx.where(meta={"tag": 1},
                          dependencies=rx.RequireMessage(mean=None)):
                y.observe(rx.Normal(mean=x, var=1.0))
            return {"x": x}
        return m

    for rx in (trx, jrx):
        g = source(rx).trace({"y": np.float32(0.3)})
        f = next(f for f in g.factors if f.out.var.name == "y")
        assert f.meta == {"tag": 1}
        assert set(f.dependencies.interfaces) == {"mean"}


# -- the DSL ----------------------------------------------------------------------------

def _statements(rx):
    d = 3
    A = np.eye(d, dtype=np.float32)
    B = np.ones((d, 2), np.float32)

    @rx.model
    def m(y, z, c, n):
        a = rx.Normal(mean=0.0, var=1.0)
        b = rx.Normal(mean=0.0, var=1.0)
        g = rx.Gamma(shape=1.0, scale=2.0)
        v = rx.InverseGamma(2.0, 1.0)
        x = rx.MvNormal(mean=np.zeros(d, np.float32),
                        cov=np.eye(d, dtype=np.float32))
        u = rx.MvNormal(mean=np.zeros(2, np.float32),
                        cov=np.eye(2, dtype=np.float32))
        s = rx.InverseWishart(d + 2.0, np.eye(d, dtype=np.float32))
        lam = rx.Gamma(a=1.0, b=1.0)
        p = rx.Beta(1.0, 1.0)
        w = rx.Uninformative()
        k = rx.Uniform(0.0, 1.0)
        y.observe(rx.Normal(mean=a + b, var=v))
        z.observe(rx.MvNormal(mean=A @ x + B @ u, cov=s))
        c.observe(rx.MvNormal(mean=x, gamma=g))
        for i in rx.plate(len(n)):
            n[i] = rx.Poisson(lam)
        q = rx.Normal(mean=w + k, gamma=g)
        o = rx.Normal(mean=a, gamma=g)
        t = rx.Sum(a, b, w)
        r = rx.lincomb(A @ x + B @ u)
        h = rx.Binomial(5.0, p)
        return {"q": q, "o": o, "t": t, "r": r, "h": h}
    return m


def test_model_tracing_of_the_new_statements_matches_jax():
    data = {"y": np.float32(0.1), "z": np.zeros(3, np.float32),
            "c": np.zeros(3, np.float32), "n": np.ones(4, np.float32)}
    tg = _statements(trx).trace(data)
    jg = _statements(jrx).trace(data)
    assert sorted(f.fform for f in tg.factors) == sorted(
        f.fform for f in jg.factors)
    fforms = {f.fform for f in tg.factors}
    assert {"GaussianSumCovariance", "GaussianSumPrecision", "LinComb",
            "MvNormalMeanScalePrecision", "Sum", "NormalMeanPrecision",
            "GammaShapeScale", "InverseGamma",
            "InverseWishart", "Poisson", "Uninformative", "Uniform",
            "Binomial"} <= fforms
    # outside a model the constructors are distributions
    assert isinstance(trx.Gamma(shape=2.0, scale=3.0), td.GammaShapeScale)
    assert isinstance(trx.InverseGamma(2.0, 1.0), td.InverseGamma)
    assert isinstance(trx.InverseWishart(5.0, np.eye(2)), td.InverseWishart)
    assert isinstance(trx.Poisson(2.0), td.Poisson)
    assert isinstance(trx.Binomial(3.0, 0.2), td.Binomial)
    assert isinstance(trx.Uniform(0.0, 2.0), td.Uniform)
    assert isinstance(trx.Multinomial(4.0, [0.5, 0.5]), td.Multinomial)
    assert isinstance(trx.MvNormal(mean=np.zeros(2), gamma=2.0),
                      td.MvNormalMeanScalePrecision)


def test_distribution_objects_lift_to_priors_like_jax():
    def source(rx, prior):
        @rx.model
        def m(y):
            lam = prior
            for i in rx.plate(len(y)):
                y[i] = rx.Poisson(lam)
            return {}
        return m

    y = np.ones(3, np.float32)
    tg = source(trx, td.GammaShapeScale(torch.tensor(2.0),
                                        torch.tensor(3.0))).trace({"y": y})
    jg = source(jrx, jd.GammaShapeScale(jnp.asarray(2.0),
                                        jnp.asarray(3.0))).trace({"y": y})
    assert sorted(f.fform for f in tg.factors) == sorted(
        f.fform for f in jg.factors) == ["GammaShapeScale", "Poisson"]


@pytest.mark.parametrize("what", ["grid_data", "grid_latent"])
def test_remaining_statements_raise_naming_their_roadmap_item(what):
    """The statements this file pinned as refused until ROADMAP A6e was
    ported: a concrete grid index ``y[0, 0]`` is refused by both packages
    (grid data takes symbolic plate indices only), and a grid latent
    declared outside any plate traces in both to the same graph."""
    def source(rx):
        @rx.model
        def m(y):
            if what == "grid_data":
                x = rx.Normal(mean=0.0, var=1.0)
                y[0, 0] = rx.Normal(mean=x, var=1.0)
            else:
                z = rx.latent((2, 2), name="z")
                for i in rx.plate(2):
                    for j in rx.plate(2):
                        z[i, j] = rx.Normal(mean=0.0, var=1.0)
                        y[i, j] = rx.Normal(mean=z[i, j], var=1.0)
            return {}
        return m

    y = np.zeros((2, 2), np.float32)
    if what == "grid_data":
        for rx in (trx, jrx):
            with pytest.raises(TypeError, match="symbolic plate indices"):
                source(rx).trace({"y": y})
        return
    tg, jg = source(trx).trace({"y": y}), source(jrx).trace({"y": y})
    for g in (tg, jg):
        z = next(v for v in g.variables if v.name == "z")
        assert z.grid_axes == (2, 2) and not z.is_array
        assert [len(f.plates) for f in g.factors] == [2, 2]
    assert [f.fform for f in tg.factors] == [f.fform for f in jg.factors]


# -- the streaming engine ----------------------------------------------------------

def _online_counts(rx):
    @rx.model
    def tick(y, pa, pb, va, vb):
        rate = rx.Gamma(shape=pa, rate=pb)
        v = rx.InverseGamma(va, vb)
        y.observe(rx.Poisson(rate))
        return {"rate": rate, "v": v}

    return tick


def _online_noise(rx):
    @rx.model
    def tick(y, va, vb):
        v = rx.InverseGamma(va, vb)
        y.observe(rx.Normal(mean=0.0, var=v))
        return {"v": v}

    return tick


def test_streaming_ticks_run_the_new_nodes_like_jax():
    """The streaming engine's tick program reuses the plain groups: an
    online Poisson rate (Gamma prior autoupdated from its posterior) and an
    online noise level (the InverseGamma variance, its messages the a =
    -1/2 carriers), tick by tick against the JAX engine and the closed
    forms Gamma(2 + sum y, 1 + T) and IG(3 + T/2, 1 + sum y^2 / 2)."""
    rng = np.random.default_rng(13)
    counts = rng.poisson(3.0, (20, 1)).astype(np.float32)[:, 0]
    ys = (0.7 * rng.standard_normal(20)).astype(np.float32)
    for source, au_args, data, check in (
            (_online_counts,
             dict(initial={"pa": 2.0, "pb": 1.0, "va": 3.0, "vb": 1.0},
                  pa=lambda q: q["rate"].a, pb=lambda q: q["rate"].b,
                  va=lambda q: q["v"].a, vb=lambda q: q["v"].b),
             counts, lambda p, t: (p["rate"].a, 2.0 + counts[:t].sum())),
            (_online_noise,
             dict(initial={"va": 3.0, "vb": 1.0},
                  va=lambda q: q["v"].a, vb=lambda q: q["v"].b),
             ys, lambda p, t: (p["v"].b, 1.0 + 0.5 * (ys[:t] ** 2).sum()))):
        tposts, _ = trx.RxInferenceEngine(
            source(trx), trx.autoupdates(**au_args), device=CPU).run_offline(
            {"y": data})
        jposts, _ = jrx.RxInferenceEngine(
            source(jrx), jrx.autoupdates(**au_args)).run_offline({"y": data})
        for name in jposts:
            close(tposts[name].mean(), np.asarray(jposts[name].mean()),
                  **MODEL_TOL)
        got, want = check(tposts, len(data))
        close(got[-1], want, rtol=1e-6)

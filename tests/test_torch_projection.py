"""``ProjectedTo`` and the natural-gradient projection (ROADMAP A6g) through
both packages on the CPU: ``project_logpdf`` on in-family targets, where
the control variate makes the residual vanish and both packages land on
the target to float32 precision whatever their draws; the exact
same-family path (no draws); the warm start; the Beta-prior Gaussian
likelihood of tests/models/test_projection.py, one dataset and a batch,
against quadrature; the Gamma target and the Bernoulli latent of
tests/engine/test_manifold_projection.py and
tests/models/test_projection_discrete.py.  The port draws from
``torch.Generator`` streams, never JAX's PRNG, so sampled results are held
against the exact answer at the JAX tests' tolerances, with the JAX
package's own gap beside them; ``poisson`` and ``binomial`` raise naming
ROADMAP A6d."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import integrate
from scipy.stats import gamma as sp_gamma, norm as sp_norm

import chip_smoke as cs
import rxinfer_tpu as jrx
import rxinfer_tpu_torch as trx
from rxinfer_tpu import dists as jd
from rxinfer_tpu.engine import projection as jproj
from rxinfer_tpu_torch import dists as td
from rxinfer_tpu_torch.dists.sampling import logpdf as tlogpdf
from rxinfer_tpu_torch.engine import projection as tproj

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def _targets():
    """(family, port target, JAX target, port start, JAX start, iters,
    samples) of in-family projections."""
    m = np.array([1.0, -2.0, 0.5], np.float32)
    c = np.array([[1.0, 0.3, 0.0], [0.3, 0.5, 0.1], [0.0, 0.1, 0.8]],
                 np.float32)
    alpha = np.array([3.0, 7.0, 2.0], np.float32)
    return {
        "gaussian": (td.NormalMeanVariance(_t(2.5), _t(0.49)),
                     jd.NormalMeanVariance(2.5, 0.49),
                     td.NormalMeanVariance(_t(0.0), _t(10.0)),
                     jd.NormalMeanVariance(0.0, 10.0), 60, 1024),
        "mv_gaussian": (td.MvNormalMeanCovariance(_t(m), _t(c)),
                        jd.MvNormalMeanCovariance(m, c),
                        td.MvNormalMeanCovariance(torch.zeros(3),
                                                  5.0 * torch.eye(3)),
                        jd.MvNormalMeanCovariance(
                            np.zeros(3, np.float32),
                            5.0 * np.eye(3, dtype=np.float32)), 80, 2048),
        "gamma": (td.GammaShapeRate(_t(5.0), _t(2.0)),
                  jd.GammaShapeRate(5.0, 2.0),
                  td.GammaShapeRate(_t(1.0), _t(0.5)),
                  jd.GammaShapeRate(1.0, 0.5), 80, 2048),
        "dirichlet": (td.Dirichlet(_t(alpha)), jd.Dirichlet(alpha),
                      td.Dirichlet(torch.ones(3)),
                      jd.Dirichlet(np.ones(3, np.float32)), 80, 2048),
    }


@pytest.mark.parametrize("family", ["gaussian", "mv_gaussian", "gamma",
                                    "dirichlet"])
def test_project_logpdf_recovers_an_in_family_target(family):
    """The M-projection of a member is itself: both packages' mean and
    covariance within 1e-3 of the target's (the JAX tests allow 0.03 to
    0.3; the control-variated residual vanishes in the family)."""
    tt, jt, t0, j0, iters, samples = _targets()[family]
    tq = tproj.project_logpdf(family, lambda x: tlogpdf(tt, x), t0,
                              n_iters=iters, n_samples=samples, seed=1)
    jq = jproj.project_logpdf(family, jt.logpdf, j0, n_iters=iters,
                              n_samples=samples, seed=1)
    for got, want in ((tq.mean().numpy(), np.asarray(jt.mean())),
                      (np.asarray(jq.mean()), np.asarray(jt.mean())),
                      (tq.cov().numpy(), np.asarray(jt.cov())),
                      (np.asarray(jq.cov()), np.asarray(jt.cov()))):
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_project_bernoulli_exact_tilt():
    """Bernoulli(logit0) times exp(eps x) is Bernoulli(logit0 + eps)."""
    logit0, eps = -0.4, 1.1
    tq = tproj.project_logpdf(
        "bernoulli", lambda x: tlogpdf(td.BernoulliLogits(_t(logit0)), x)
        + eps * x, td.BernoulliLogits(torch.zeros(())), n_iters=30,
        n_samples=2048, seed=0)
    jbase = jd.BernoulliLogits(jnp.asarray(logit0))
    jq = jproj.project_logpdf(
        "bernoulli", lambda x: jbase.logpdf(x) + eps * x,
        jd.BernoulliLogits(jnp.zeros(())), n_iters=30, n_samples=2048, seed=0)
    for got in (float(tq.logit), float(jq.logit)):
        assert abs(got - (logit0 + eps)) < 0.05


def test_projection_batches_its_elements():
    """Three Gaussian targets at once from one unbatched start: each
    element lands on its own target."""
    target = td.NormalMeanVariance(_t([1.0, 2.0, 3.0]), _t([0.5, 1.0, 2.0]))
    q = tproj.project_logpdf("gaussian", lambda x: tlogpdf(target, x),
                             td.NormalMeanVariance(_t(0.0), _t(10.0)),
                             n_iters=60, n_samples=1024, seed=1,
                             batch_shape=(3,))
    np.testing.assert_allclose(q.mean().numpy(), [1.0, 2.0, 3.0], atol=1e-3)
    np.testing.assert_allclose(q.var().numpy(), [0.5, 1.0, 2.0], rtol=1e-3)


def test_projection_exact_convert_and_warm_start():
    """Same-family input converts exactly (no draws), as in the JAX
    package; a product within the family is the natural-parameter sum; a
    warm start seeds the descent."""
    pt, jpt = trx.ProjectedTo("gaussian"), jrx.ProjectedTo("gaussian")
    out = pt.constrain(td.NormalMeanVariance(_t(1.0), _t(2.0)))
    assert float(out.mean()) == 1.0 and float(out.var()) == 2.0
    msgs = [td.NormalMeanVariance(_t(0.0), _t(1.0)),
            td.NormalMeanVariance(_t(1.0), _t(1.0))]
    jout = jpt.project_product([jd.NormalMeanVariance(0.0, 1.0),
                                jd.NormalMeanVariance(1.0, 1.0)])
    out = pt.project_product(msgs)
    np.testing.assert_allclose([float(out.mean()), float(out.var())],
                               [float(jout.mean()), float(jout.var())],
                               rtol=1e-6)
    q = trx.ProjectedTo("gaussian", n_iters=20, n_samples=512)\
        .project_product([td.GammaShapeRate(_t(2.0), _t(1.0)),
                          td.NormalMeanVariance(_t(3.0), _t(0.25))],
                         prev=td.NormalMeanVariance(_t(2.8), _t(0.3)))
    assert 1.5 < float(q.mean()) < 3.5


def test_unported_families_raise_with_their_roadmap_item():
    """``poisson`` and ``binomial`` raised naming ROADMAP A6d until their
    distributions were ported (``tests/test_torch_nodes_a6d.py`` holds
    their projections); the binomial needs its trial count, and a family
    the projection has no statistics for is refused."""
    assert trx.ProjectedTo("poisson").family == "poisson"
    assert trx.ProjectedTo("binomial", n=12).n == 12
    with pytest.raises(ValueError, match="n="):
        trx.ProjectedTo("binomial")
    with pytest.raises(ValueError, match="supports"):
        trx.ProjectedTo("wishart")


def _quadrature(prior_pdf, y, var, ts):
    w = prior_pdf(ts) * np.exp(
        np.sum(sp_norm(ts, np.sqrt(var)).logpdf(y[:, None]), axis=0))
    w /= integrate.trapezoid(w, ts)
    mean = integrate.trapezoid(ts * w, ts)
    return mean, integrate.trapezoid((ts - mean) ** 2 * w, ts)


def test_beta_prior_gaussian_likelihood_against_quadrature():
    """tests/models/test_projection.py: theta ~ Beta(2, 2), y_i ~ N(theta,
    0.05), ProjectedTo("beta"); both packages against quadrature at the JAX
    test's tolerance (mean 0.02, variance 50% + 1e-4), both Beta."""
    rng = np.random.default_rng(0)
    y = (0.7 + np.sqrt(0.05) * rng.standard_normal(60)).astype(np.float32)
    from scipy.stats import beta as sp_beta

    mean, var = _quadrature(sp_beta(2, 2).pdf, y, 0.05,
                            np.linspace(1e-4, 1 - 1e-4, 4001))
    for rx, dd in ((jrx, jd), (trx, td)):
        init = (dd.Beta(2.0, 2.0) if rx is jrx
                else dd.Beta(_t(2.0), _t(2.0)))
        res = rx.infer(model=cs.proj_model(rx), data={"y": y}, iterations=8,
                       constraints=rx.constraints(forms={
                           "theta": rx.ProjectedTo("beta", n_samples=4096)}),
                       initialization={"theta": init},
                       returnvars=rx.KeepLast(),
                       **({} if rx is jrx else {"device": CPU}))
        q = res.posteriors["theta"]
        assert isinstance(q, dd.Beta)
        assert abs(float(q.mean()) - mean) < 0.02
        assert abs(float(q.var()) - var) < 0.5 * var + 1e-4


def test_beta_projection_over_a_batch_against_quadrature():
    """Phase 21 (b)'s fleet at four datasets through ``infer_batched``:
    every dataset against its quadrature posterior at the JAX test's
    tolerance."""
    _, y = cs.proj_data(4)
    post, _ = trx.infer_batched(
        cs.proj_model(trx), {"y": y}, iterations=cs.PROJ_IT, device=CPU,
        constraints=trx.constraints(forms={"theta": trx.ProjectedTo(
            "beta", n_samples=2048)}),
        initialization={"theta": trx.Beta(2.0, 2.0)})
    mean, var = cs.proj_quadrature(y)
    q = post["theta"]
    assert tuple(q.mean().shape) == (4,)
    assert np.abs(q.mean().numpy() - mean).max() < 0.02
    assert np.all(np.abs(q.var().numpy() - var) < 0.5 * var + 1e-4)


def test_gamma_target_through_infer_against_quadrature():
    rng = np.random.default_rng(0)
    y = (2.0 + np.sqrt(0.2) * rng.standard_normal(50)).astype(np.float32)

    @trx.model
    def m(y):
        theta = trx.Gamma(shape=2.0, rate=1.0)
        for i in trx.plate(50):
            y[i] = trx.Normal(mean=theta, var=0.2)
        return {"theta": theta}

    res = trx.infer(model=m, data={"y": y}, iterations=6, device=CPU,
                    constraints=trx.constraints(forms={"theta": trx.ProjectedTo(
                        "gamma", n_samples=2048)}),
                    initialization={"theta": td.GammaShapeRate(_t(2.0),
                                                               _t(1.0))},
                    returnvars=trx.KeepLast())
    mean, var = _quadrature(sp_gamma(2.0, scale=1.0).pdf, y, 0.2,
                            np.linspace(1e-3, 6.0, 4001))
    q = res.posteriors["theta"]
    assert abs(float(q.mean()) - mean) < 0.05
    assert abs(float(q.var()) - var) < 0.6 * var + 1e-4


def test_bernoulli_latent_with_gaussian_evidence():
    """x ~ Bernoulli(0.5), y_i ~ N(2x, 1): the Gaussian messages have no
    closed-form product with the Bernoulli prior; ProjectedTo("bernoulli")
    against the exact p(x = 1), both packages."""
    y = (2.0 + np.random.default_rng(3).standard_normal(8)).astype(np.float32)
    p_exact = 1.0 / (1.0 + np.exp(np.sum(-0.5 * y**2)
                                  - np.sum(-0.5 * (y - 2.0) ** 2)))
    for rx, dd in ((jrx, jd), (trx, td)):
        @rx.model
        def m(y):
            x = rx.Bernoulli(0.5)
            for i in rx.plate(8):
                y[i] = rx.Normal(mean=rx.Delta(lambda b: 2.0 * b, x), var=1.0)
            return {"x": x}

        init = (dd.Bernoulli(np.float32(0.5)) if rx is jrx
                else dd.Bernoulli(_t(0.5)))
        res = rx.infer(model=m, data={"y": y}, iterations=6,
                       constraints=rx.constraints(forms={
                           "x": rx.ProjectedTo("bernoulli", n_samples=4096,
                                               n_iters=30)}),
                       returnvars=rx.KeepLast(), initialization={"x": init},
                       **({} if rx is jrx else {"device": CPU}))
        assert abs(float(res.posteriors["x"].mean()) - p_exact) < 0.05


def test_importance_sampling_initializer_fits_the_product():
    """``_is_initializer``'s one-pass fit of a Gaussian product, both
    packages within Monte-Carlo error of the exact N(1, 1/2)."""
    tq = tproj._is_initializer("gaussian", [
        td.NormalMeanVariance(_t(0.0), _t(1.0)),
        td.NormalMeanVariance(_t(2.0), _t(1.0))], 20000, 3)
    jq = jproj._is_initializer("gaussian", [
        jd.NormalMeanVariance(0.0, 1.0), jd.NormalMeanVariance(2.0, 1.0)],
        20000, 3)
    for q in (tq, jq):
        assert abs(float(q.mean()) - 1.0) < 0.05
        assert abs(float(q.var()) - 0.5) < 0.05

"""Config 2 through both packages: the Beta / Bernoulli families (products,
natural views, message rules), ``zoo.beta_bernoulli`` and
``zoo.gaussian_unknown_mean_precision`` with their free energies against
the JAX package's, the closed form and a float64 mean-field VMP, and the
reference's Beta-Bernoulli scalar.  Inputs come from numpy seeds; the port
runs on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import betaln, digamma, gammaln

import rxinfer_tpu as jrx
import rxinfer_tpu_torch as trx
from rxinfer_tpu import dists as jd
from rxinfer_tpu.models import zoo as jzoo
from rxinfer_tpu.rules.registry import get_message_rule as jrule
from rxinfer_tpu_torch import convert
from rxinfer_tpu_torch import dists as td
from rxinfer_tpu_torch.dists import natural as tnat
from rxinfer_tpu_torch.models import zoo as tzoo
from rxinfer_tpu_torch.rules.registry import get_message_rule as trule

CPU = torch.device("cpu")
# one float32 expression in each library
RULE_TOL = dict(rtol=1e-5, atol=1e-6)
# the reference's own tolerance for its scalar (beta_bernoulli_tests.jl:55,
# tests/models/test_reference_conformance.py); the port reads 2.2e-7
REF_RTOL = 1e-6
# other datasets: float32 sums of n terms against float64 and against XLA's
# order of the same sum (measured up to 1.03e-6 relative at n = 500)
SUM_RTOL = 3e-6


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def flips(b, n, seed=0, p=0.75):
    return (np.random.default_rng(seed).random((b, n)) < p).astype(
        np.float32)


# -- the families ---------------------------------------------------------------------

def test_products_and_natural_views_match_jax():
    rng = np.random.default_rng(0)
    a, b = rng.uniform(0.5, 4.0, (2, 5)).astype(np.float32)
    p = rng.uniform(0.05, 0.95, (2, 5)).astype(np.float32)
    tb1, tb2 = td.Beta(torch.as_tensor(a), torch.as_tensor(b)), \
        td.Beta(torch.as_tensor(b), torch.as_tensor(a))
    jb = jd.prod(jd.Beta(jnp.asarray(a), jnp.asarray(b)),
                 jd.Beta(jnp.asarray(b), jnp.asarray(a)))
    tb = td.prod(tb1, tb2)
    np.testing.assert_allclose(tb.a.numpy(), np.asarray(jb.a), **RULE_TOL)
    np.testing.assert_allclose(tb.b.numpy(), np.asarray(jb.b), **RULE_TOL)
    tp = td.prod(td.Bernoulli(torch.as_tensor(p[0])),
                 td.Bernoulli(torch.as_tensor(p[1])))
    jp = jd.prod(jd.Bernoulli(jnp.asarray(p[0])),
                 jd.Bernoulli(jnp.asarray(p[1])))
    np.testing.assert_allclose(tp.p.numpy(), np.asarray(jp.p), **RULE_TOL)
    # the natural views: a product is a sum of natural parameters
    for d1, d2 in ((tb1, tb2), (td.Bernoulli(torch.as_tensor(p[0])),
                                td.Bernoulli(torch.as_tensor(p[1])))):
        assert tnat.family_key(d1) in tnat.NAT_EVENT_RANKS
        both = tnat.prod_all([d1, d2])
        np.testing.assert_allclose(both.mean().numpy(),
                                   td.prod(d1, d2).mean().numpy(), rtol=1e-5)
    assert isinstance(tnat.prod_all([td.Bernoulli(torch.tensor(0.3))]),
                      td.BernoulliLogits)


def test_beta_bernoulli_rules_match_jax():
    rng = np.random.default_rng(1)
    a, b = rng.uniform(0.5, 9.0, (2, 6)).astype(np.float32)
    y = rng.integers(0, 2, 6).astype(np.float32)
    tq = {"out": td.PointMass(torch.as_tensor(y)),
          "p": td.Beta(torch.as_tensor(a), torch.as_tensor(b))}
    jq = {"out": jd.PointMass(jnp.asarray(y)),
          "p": jd.Beta(jnp.asarray(a), jnp.asarray(b))}
    for iface in ("out", "p"):
        t = trule("Bernoulli", iface)(tq)
        j = jrule("Bernoulli", iface)(jq)
        assert type(t).__name__ == type(j).__name__
        np.testing.assert_allclose(t.mean().numpy(), np.asarray(j.mean()),
                                   **RULE_TOL)
    t = trule("Beta", "out")({"a": td.PointMass(torch.tensor(2.0)),
                              "b": td.PointMass(torch.tensor(7.0))})
    assert (float(t.a), float(t.b)) == (2.0, 7.0)


def test_dist_objects_and_converted_parameters():
    assert isinstance(trx.Beta(2.0, 3.0), td.Beta)
    assert isinstance(trx.Bernoulli(0.2), td.Bernoulli)
    beta = convert.dist_from_numpy("Beta", {"a": 2.0, "b": 7.0})
    np.testing.assert_allclose(float(beta.mean()), 2.0 / 9.0, rtol=1e-6)
    bern = convert.dist_from_numpy("Bernoulli", [0.25])
    np.testing.assert_allclose(float(bern.entropy()),
                               -(0.25 * np.log(0.25) + 0.75 * np.log(0.75)),
                               rtol=1e-6)

    prior = trx.Beta(2.0, 7.0)   # a distribution object as a model's prior

    @trx.model
    def lifted(y):
        for i in trx.plate(len(y)):
            y[i] = trx.Bernoulli(prior)

    res = trx.infer(lifted, data={"y": np.array([1, 1, 0], np.float32)},
                    free_energy=True, device=CPU)
    assert [gi.family for gi in res.model.infos.values()] == ["beta"]
    np.testing.assert_allclose(float(res.free_energy[0]),
                               -(betaln(4.0, 8.0) - betaln(2.0, 7.0)),
                               rtol=REF_RTOL)


# -- Beta-Bernoulli --------------------------------------------------------------------

def test_beta_bernoulli_reference_fe_scalar():
    """FE == 2828.0533343622483 (beta_bernoulli_tests.jl:55) for 3743
    successes in 5000 trials under Beta(2, 7), 10 iterations, through the
    port's infer."""
    n, h = 5000, 3743
    y = np.zeros(n, np.float32)
    y[:h] = 1.0
    res = trx.infer(tzoo.beta_bernoulli(2.0, 7.0), data={"y": y},
                    iterations=10, free_energy=True, device=CPU)
    fe = res.free_energy.numpy().astype(np.float64)
    assert fe.shape == (10,)
    np.testing.assert_allclose(fe, 2828.0533343622483, rtol=REF_RTOL)
    np.testing.assert_allclose(-float(res.log_evidence), 2828.0533343622483,
                               rtol=REF_RTOL)
    assert abs(float(res.posteriors["theta"][-1].mean()) - 0.75) < 1e-2


def test_beta_bernoulli_batched_fe_is_the_closed_form_and_jax():
    n = 500
    y = flips(6, n, seed=3)
    post, fe = trx.infer_batched(tzoo.beta_bernoulli(2.0, 7.0), {"y": y},
                                 iterations=2, free_energy=True, device=CPU)
    jpost, jfe = jrx.infer_batched(jzoo.beta_bernoulli(2.0, 7.0), {"y": y},
                                   iterations=2, free_energy=True)
    h = y.sum(1).astype(np.float64)
    closed = -(betaln(2.0 + h, 7.0 + n - h) - betaln(2.0, 7.0))
    assert tuple(fe.shape) == (2, 6)
    np.testing.assert_allclose(fe.numpy(), np.broadcast_to(closed, (2, 6)),
                               rtol=SUM_RTOL)
    np.testing.assert_allclose(fe.numpy(), np.asarray(jfe), rtol=SUM_RTOL)
    np.testing.assert_allclose(post["theta"].a.numpy(), 2.0 + h, rtol=1e-6)
    np.testing.assert_allclose(post["theta"].b.numpy(),
                               np.asarray(jpost["theta"].b), rtol=1e-6)


def test_beta_bernoulli_missing_flips_drop_out():
    y = flips(3, 40, seed=4)
    y[0, :5] = np.nan
    y[2, 17] = np.nan
    _, fe = trx.infer_batched(tzoo.beta_bernoulli(2.0, 7.0), {"y": y},
                              free_energy=True, device=CPU)
    _, jfe = jrx.infer_batched(jzoo.beta_bernoulli(2.0, 7.0), {"y": y},
                               free_energy=True)
    np.testing.assert_allclose(fe.numpy(), np.asarray(jfe), rtol=SUM_RTOL)
    obs = ~np.isnan(y)
    h, n = np.nansum(y, 1), obs.sum(1)
    np.testing.assert_allclose(
        fe[0].numpy(), -(betaln(2.0 + h, 7.0 + n - h) - betaln(2.0, 7.0)),
        rtol=SUM_RTOL)


# -- Gaussian with unknown mean and precision -------------------------------------------

def gauss_y(b, n, seed=0):
    rng = np.random.default_rng(seed)
    loc = rng.normal(0.0, 2.0, (b, 1))
    scale = rng.uniform(0.5, 2.0, (b, 1))
    return (loc + scale * rng.standard_normal((b, n))).astype(np.float32)


def gauss_vmp_float64(y, iterations, m0=0.0, v0=100.0, a0=0.01, b0=0.01):
    """Mean-field VMP of zoo.gaussian_unknown_mean_precision in float64
    (sweep mu, tau; tau starts at Gamma(1, 1)) with its free energy after
    each sweep."""
    y = np.asarray(y, np.float64)
    n = y.shape[1]
    a, b = np.ones(len(y)), np.ones(len(y))
    fes, mus = [], []
    for _ in range(iterations):
        et = a / b
        w = 1.0 / v0 + n * et
        m = (m0 / v0 + et * y.sum(1)) / w
        v = 1.0 / w
        sq = ((y - m[:, None]) ** 2).sum(1) + n * v
        a, b = a0 + 0.5 * n, b0 + 0.5 * sq
        et, elt = a / b, digamma(a) - np.log(b)
        ae_mu = 0.5 * (np.log(2 * np.pi * v0) + ((m - m0) ** 2 + v) / v0)
        ae_tau = -((a0 - 1.0) * elt - b0 * et + a0 * np.log(b0) - gammaln(a0))
        ae_y = 0.5 * (n * np.log(2 * np.pi) - n * elt + et * sq)
        h_mu = 0.5 * np.log(2 * np.pi * np.e * v)
        h_tau = a - np.log(b) + gammaln(a) + (1.0 - a) * digamma(a)
        fes.append(ae_mu + ae_tau + ae_y - h_mu - h_tau)
        mus.append(m)
    return np.stack(fes), np.stack(mus)


# float32 FE over n = 200 likelihood terms of size ~1 that cancel against
# the entropies (measured 5.1e-7 relative against JAX and 2.7e-7 against
# the float64 VMP on a CPU)
GAUSS_FE_TOL = dict(rtol=1e-5, atol=1e-4)


def test_gaussian_unknown_mean_precision_fe_matches_jax_and_float64():
    y = gauss_y(4, 200, seed=5)
    post, fe = trx.infer_batched(
        tzoo.gaussian_unknown_mean_precision(), {"y": y}, iterations=6,
        free_energy=True, initialization={"tau": trx.Gamma(1.0, 1.0)},
        device=CPU)
    jpost, jfe = jrx.infer_batched(
        jzoo.gaussian_unknown_mean_precision(), {"y": y}, iterations=6,
        free_energy=True,
        initialization={"tau": jrx.Gamma(shape=1.0, rate=1.0)})
    np.testing.assert_allclose(fe.numpy(), np.asarray(jfe), **GAUSS_FE_TOL)
    o_fe, o_mu = gauss_vmp_float64(y, 6)
    np.testing.assert_allclose(fe.numpy(), o_fe, **GAUSS_FE_TOL)
    np.testing.assert_allclose(post["mu"].mean().numpy(), o_mu[-1],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(post["tau"].b.numpy(),
                               np.asarray(jpost["tau"].b), rtol=1e-5)
    assert (np.diff(fe.numpy(), axis=0) <= 1e-4).all()


def test_gaussian_unknown_mean_precision_infer_matches_jax():
    y = gauss_y(1, 100, seed=6)[0]
    res = trx.infer(tzoo.gaussian_unknown_mean_precision(), data={"y": y},
                    iterations=4, free_energy=True,
                    initialization={"tau": trx.Gamma(1.0, 1.0)}, device=CPU)
    jres = jrx.infer(jzoo.gaussian_unknown_mean_precision(), data={"y": y},
                     iterations=4, free_energy=True,
                     initialization={"tau": jrx.Gamma(shape=1.0, rate=1.0)})
    np.testing.assert_allclose(res.free_energy.numpy(),
                               np.asarray(jres.free_energy), **GAUSS_FE_TOL)

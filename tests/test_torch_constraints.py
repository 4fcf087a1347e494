"""Constraints (ROADMAP A6c) through both packages on the CPU: the
factorization constraints (``factorize`` pairs and ``MeanField()``, held
against a numpy coordinate-ascent oracle and the mean-field free energy's
closed form, the default structured pair against -log Z), the structured
single-step GCV pair and its mean-field split, the point-mass, sample-list,
fixed and composed form constraints, message-form constraints, the
``NodeFunctionRuleFallback``, the point-mass gamma mixture, and the program
caches keyed on constraint values.  The cases of
tests/models/test_factorization_constraints.py,
tests/engine/test_form_constraints.py, tests/models/test_rule_fallback.py,
tests/models/test_joint_pairs.py and tests/models/test_probit_mixtures.py;
inputs come from numpy seeds, the port runs with ``device="cpu"``.

The port's draws come from ``torch.Generator`` streams, never JAX's PRNG:
where a result samples, both packages are held against the exact answer
(quadrature, closed forms) at the JAX test's tolerance, not against each
other."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import integrate
from scipy.stats import gamma as sp_gamma, norm

import rxinfer_tpu as jrx
import rxinfer_tpu_torch as trx
from rxinfer_tpu import dists as jd
from rxinfer_tpu.rules.registry import node as jnode
from rxinfer_tpu_torch import dists as td
from rxinfer_tpu_torch.rules.registry import node as tnode

CPU = torch.device("cpu")
# deterministic paths (no draws): float32 expressions in two libraries
TOL = dict(rtol=1e-4, atol=1e-5)
V0, V1, V2, Y = 4.0, 1.0, 1.0, 1.5


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(x):
    return torch.tensor(np.float32(x))


def _dev(rx):
    return {} if rx is jrx else {"device": CPU}


def _nmv(rx, m, v):
    return (jd.NormalMeanVariance(np.float32(m), np.float32(v)) if rx is jrx
            else td.NormalMeanVariance(_t(m), _t(v)))


def _pair(rx):
    @rx.model
    def pair(y):
        a = rx.Normal(mean=0.0, var=V0)
        b = rx.Normal(mean=a, var=V1)
        y.observe(rx.Normal(mean=b, variance=V2))
        return {"a": a, "b": b}

    return pair


def _mean_field_oracle(iters, ma=0.0):
    """Coordinate ascent under q(a)q(b)."""
    for _ in range(iters):
        wb = 1.0 / V1 + 1.0 / V2
        mb = (ma / V1 + Y / V2) / wb
        vb = 1.0 / wb
        wa = 1.0 / V0 + 1.0 / V1
        ma = (mb / V1) / wa
        va = 1.0 / wa
    return ma, va, mb, vb


def _mean_field_fe(ma, va, mb, vb):
    """The mean-field Bethe free energy in closed form."""
    l2pi = np.log(2 * np.pi)
    h = lambda v: 0.5 * np.log(2 * np.pi * np.e * v)
    ae_prior = 0.5 * (l2pi + np.log(V0) + (ma**2 + va) / V0)
    ae_link = 0.5 * (l2pi + np.log(V1) + ((mb - ma) ** 2 + va + vb) / V1)
    ae_lik = 0.5 * (l2pi + np.log(V2) + ((Y - mb) ** 2 + vb) / V2)
    return ae_prior + ae_link + ae_lik - h(va) - h(vb)


NEG_LOG_Z = (0.5 * np.log(2 * np.pi * (V0 + V1 + V2))
             + Y**2 / (2 * (V0 + V1 + V2)))


def _run_pair(rx, iterations, factorization=None):
    cons = (None if factorization is None
            else rx.constraints(factorization=factorization))
    return rx.infer(model=_pair(rx), data={"y": np.asarray(Y, np.float32)},
                    iterations=iterations, constraints=cons,
                    initialization={"a": _nmv(rx, 0.0, 1e6)},
                    free_energy=True, returnvars=rx.KeepLast(), **_dev(rx))


@pytest.mark.parametrize("split", ["pair", "mean_field"])
def test_factorization_matches_jax_and_the_vmp_oracle(split):
    """q(a, b) = q(a)q(b) (or MeanField()): the mean-field rules and free
    energy, against the JAX package and the numpy oracle (1e-4), above
    -log Z."""
    fac = {"pair": lambda rx: rx.factorize(("a", "b")),
           "mean_field": lambda rx: rx.MeanField()}[split]
    tres = _run_pair(trx, 30, fac(trx))
    jres = _run_pair(jrx, 30, fac(jrx))
    ma, va, mb, vb = _mean_field_oracle(30)
    for name, m, v in (("a", ma, va), ("b", mb, vb)):
        tq, jq = tres.posteriors[name], jres.posteriors[name]
        np.testing.assert_allclose(float(tq.mean()), m, rtol=1e-4)
        np.testing.assert_allclose(float(tq.var()), v, rtol=1e-4)
        np.testing.assert_allclose(tq.mean().numpy(), np.asarray(jq.mean()),
                                   **TOL)
    fe = tres.free_energy.numpy().astype(np.float64)
    assert abs(fe[-1] - _mean_field_fe(ma, va, mb, vb)) < 1e-4
    np.testing.assert_allclose(fe, np.asarray(jres.free_energy), **TOL)
    assert fe[-1] > NEG_LOG_Z + 1e-3


def test_default_structured_pair_free_energy_is_minus_log_z():
    """Without a constraint the (out, mean) pair of the link factor is
    structured: the Gaussian nodes' cavity stores and ``gaussian_pair_fe``
    give FE == -log Z and the exact posterior, as in the JAX package."""
    tres = _run_pair(trx, 10)
    jres = _run_pair(jrx, 10)
    fe = tres.free_energy.numpy().astype(np.float64)
    assert abs(fe[-1] - NEG_LOG_Z) < 1e-4
    np.testing.assert_allclose(fe, np.asarray(jres.free_energy), **TOL)
    np.testing.assert_allclose(float(tres.posteriors["a"].mean()),
                               V0 * Y / (V0 + V1 + V2), rtol=1e-4)


def test_unknown_variables_and_slots_on_a_chain_raise():
    for rx in (jrx, trx):
        with pytest.raises(ValueError, match="unknown"):
            rx.infer(model=_pair(rx), data={"y": np.asarray(Y, np.float32)},
                     iterations=2, initialization={"a": _nmv(rx, 0.0, 1.0)},
                     constraints=rx.constraints(
                         factorization=rx.factorize(("a", "zz"))),
                     **_dev(rx))
    from rxinfer_tpu_torch.models import zoo as tzoo

    a = np.eye(2, dtype=np.float32)
    c = (a, a, a, a, np.zeros(2, np.float32), a)
    with pytest.raises(NotImplementedError, match="slot factorization"):
        trx.infer(tzoo.lgssm(*c), data={"y": np.zeros((5, 2), np.float32)},
                  constraints=trx.constraints(
                      slot_factorized=trx.factorize_slots("x")), device=CPU)


def _single_step_gcv(rx, v_noise=0.5, y_var=0.1):
    """x0 -> x1 by a GCV of constant volatility, observed: a tree."""
    omega = float(np.log(v_noise))

    @rx.model
    def m(y):
        x0 = rx.Normal(mean=0.0, var=1.0)
        x1 = rx.GCV(x0, 0.0, kappa=1.0, omega=omega)
        y.observe(rx.Normal(mean=x1, var=y_var))
        return {"x0": x0, "x1": x1}

    return m


@pytest.mark.parametrize("split", [False, True])
def test_gcv_joint_pair_free_energy_is_minus_log_z_and_beats_mean_field(split):
    """The structured single-step GCV pair (``attach_gcv_pair_cross``):
    FE == -log Z within 2e-3; splitting x1 from x0 gives the mean-field
    FE, strictly above it.  Both runs against the JAX package's."""
    yv = np.float32(1.3)
    fes = {}
    for rx in (jrx, trx):
        cons = (rx.constraints(factorization=rx.factorize(("x1", "x0")))
                if split else None)
        res = rx.infer(model=_single_step_gcv(rx), data={"y": yv},
                       iterations=40 if split else 20, free_energy=True,
                       returnvars=rx.KeepLast(), constraints=cons,
                       initialization={n: _nmv(rx, 0.0, 1.0)
                                       for n in ("x0", "x1")}, **_dev(rx))
        fes[rx] = np.asarray(res.free_energy, np.float64)
    np.testing.assert_allclose(fes[trx], fes[jrx], rtol=1e-5, atol=1e-5)
    log_z = float(norm(0.0, np.sqrt(1.0 + 0.5 + 0.1)).logpdf(float(yv)))
    if split:
        assert fes[trx][-1] > -log_z + 1e-3
    else:
        assert abs(fes[trx][-1] + log_z) < 2e-3


def test_reference_hgf_constraint_is_the_engine_default():
    """q(xt, zt, xt_min) = q(xt, xt_min)q(zt) splits only across the GCV
    cluster's boundary: the same free energy, bit for bit, with and without
    it, equal to the JAX package's."""
    def m(rx):
        @rx.model
        def hgf1(y):
            zt = rx.Normal(mean=0.0, var=0.5)
            x0 = rx.Normal(mean=0.0, var=1.0)
            x1 = rx.GCV(x0, zt, kappa=1.0, omega=-1.0)
            y.observe(rx.Normal(mean=x1, var=0.1))
            return {"zt": zt, "x0": x0, "x1": x1}

        return hgf1

    out = {}
    for rx in (jrx, trx):
        init = {"x0": _nmv(rx, 0.0, 1.0), "x1": _nmv(rx, 0.0, 1.0),
                "zt": _nmv(rx, 0.0, 0.5)}
        for cons in (None, rx.constraints(factorization=rx.factorize(
                ("x1", "zt"), ("x0", "zt")))):
            res = rx.infer(model=m(rx), data={"y": np.float32(-0.7)},
                           iterations=10, free_energy=True,
                           returnvars=rx.KeepLast(), initialization=init,
                           constraints=cons, **_dev(rx))
            out[(rx, cons is None)] = np.asarray(res.free_energy)
    np.testing.assert_array_equal(out[(trx, True)], out[(trx, False)])
    np.testing.assert_allclose(out[(trx, True)], out[(jrx, True)], **TOL)


def test_two_chains_linked_by_a_prior_mean_match_jax():
    """A chain whose prior mean is a slot of another chain (refused in the
    free energy until ROADMAP A6c): the other chain stores its evidence
    message there and the free energy takes the mean-field terms, as the
    JAX package's."""
    def make(rx):
        @rx.model
        def two_chains(y, u):
            T = len(y)
            z = rx.latent(T, name="z")
            z[0] = rx.Normal(mean=0.0, var=1.0)
            for t in rx.plate(1, T):
                z[t] = rx.Normal(mean=z[t - 1], var=1.0)
            for t in rx.plate(T):
                u[t] = rx.Normal(mean=z[t], var=1.0)
            x = rx.latent(T, name="x")
            x[0] = rx.Normal(mean=z[T - 1], var=1.0)
            for t in rx.plate(1, T):
                x[t] = rx.Normal(mean=x[t - 1], var=1.0)
            for t in rx.plate(T):
                y[t] = rx.Normal(mean=x[t], var=1.0)
            return {"x": x, "z": z}

        return two_chains

    rng = np.random.default_rng(8)
    data = {"y": rng.standard_normal((2, 6)).astype(np.float32),
            "u": rng.standard_normal((2, 6)).astype(np.float32)}
    tpost, tfe = trx.infer_batched(
        make(trx), data, iterations=3, free_energy=True,
        initialization={"x": trx.Normal(mean=0.0, var=1.0)}, device=CPU,
        options={"warn": False})
    jpost, jfe = jrx.infer_batched(
        make(jrx), data, iterations=3, free_energy=True,
        initialization={"x": jd.NormalMeanVariance(0.0, 1.0)},
        options={"warn": False})
    np.testing.assert_allclose(tfe.numpy(), np.asarray(jfe), **TOL)
    for n in ("x", "z"):
        np.testing.assert_allclose(tpost[n].mean().numpy(),
                                   np.asarray(jpost[n].mean()), **TOL)


# -- form constraints -----------------------------------------------------------------

def test_pointmass_closed_form_mode_and_boundaries():
    out = trx.PointMassFormConstraint().constrain(td.Beta(_t(5.0), _t(3.0)))
    assert isinstance(out, td.PointMass)
    assert abs(float(out.point) - 4.0 / 6.0) < 1e-6
    boxed = trx.PointMassFormConstraint(boundaries=(0.0, 2.0)).constrain(
        td.NormalMeanVariance(_t(5.0), _t(1.0)))
    assert abs(float(boxed.point) - 2.0) < 1e-3


def test_pointmass_newton_matches_brute_force_and_jax_lbfgs():
    """A density without an analytic mode: the port's Newton steps and the
    JAX package's LBFGS land on the grid's argmax within 1e-3."""
    def target(x, lib):
        return -0.5 * (x - 1.3) ** 2 / 0.04 + 0.3 * lib.sin(3.0 * x)

    xs = np.linspace(-2.0, 4.0, 200001)
    brute = xs[np.argmax(target(xs, np))]
    t_out = trx.PointMassFormConstraint(
        starting_point=np.float32(0.0), n_iters=50).project_product(
        [td.LogPdfMessage(lambda x: target(x, torch))])
    j_out = jrx.PointMassFormConstraint(
        starting_point=np.float32(0.0), n_iters=50).project_product(
        [jd.LogPdfMessage(lambda x: target(x, jnp))])
    assert abs(float(t_out.point) - brute) < 1e-3
    assert abs(float(t_out.point) - float(j_out.point)) < 1e-3


def test_pointmass_custom_optimizer_and_optax_refusal():
    seen = {}

    def my_opt(neg_logpdf, x0):
        seen["called"] = True
        xs = torch.linspace(-3.0, 3.0, 4001)
        return xs[torch.argmin(neg_logpdf(xs))]

    out = trx.PointMassFormConstraint(optimizer=my_opt).constrain(
        td.NormalMeanVariance(_t(1.25), _t(0.3)))
    assert seen.get("called") and abs(float(out.point) - 1.25) < 2e-3
    import optax

    with pytest.raises(TypeError, match="optax"):
        trx.PointMassFormConstraint(optimizer=optax.lbfgs())


def _coin(rx, a0):
    @rx.model
    def coin(y):
        p = rx.Beta(a0, a0)
        for i in rx.plate(len(y)):
            y[i] = rx.Bernoulli(p)
        return {"p": p}

    return coin


def test_pointmass_map_through_infer_matches_jax():
    y = (np.random.default_rng(0).uniform(size=100) < 0.7).astype(np.float32)
    out = {}
    for rx in (jrx, trx):
        cs = rx.constraints(forms={"p": rx.PointMassFormConstraint(
            starting_point=np.float32(0.5), boundaries=(1e-3, 1 - 1e-3))})
        res = rx.infer(model=_coin(rx, 3.0), data={"y": y}, iterations=4,
                       constraints=cs, returnvars=rx.KeepLast(), **_dev(rx))
        out[rx] = float(res.posteriors["p"].point)
    map_exact = (2.0 + y.sum()) / (4.0 + len(y))
    assert abs(out[trx] - map_exact) < 2e-3
    assert abs(out[trx] - out[jrx]) < 1e-4


def test_stacked_form_constraints():
    """q(p) :: Fixed(Beta(5, 5)) :: PointMass, over a batch of two."""
    y = (np.random.default_rng(3).uniform(size=(2, 200)) < 0.7).astype(
        np.float32)
    cs = trx.constraints(forms={"p": (
        trx.FixedMarginalFormConstraint(td.Beta(_t(5.0), _t(5.0))),
        trx.PointMassFormConstraint())})
    post, _ = trx.infer_batched(_coin(trx, 2.0), {"y": y}, iterations=4,
                                constraints=cs, device=CPU)
    assert isinstance(post["p"], td.PointMass)
    np.testing.assert_allclose(post["p"].point.numpy(), [0.5, 0.5],
                               atol=1e-6)


def test_samplelist_passthrough_and_proposals():
    sl = trx.SampleListFormConstraint(n_samples=64)
    d = td.Beta(_t(4.0), _t(2.0))
    assert sl.constrain(d) is d
    out = sl.project_product([td.NormalMeanVariance(_t(0.0), _t(1.0)),
                              td.NormalMeanVariance(_t(2.0), _t(1.0))])
    assert not isinstance(out, td.SampleList)
    assert abs(float(out.mean()) - 1.0) < 1e-6
    g = td.NormalMeanVariance(_t(1.0), _t(2.0))
    fb = td.LogPdfMessage(lambda x: -0.5 * (x - 1.0) ** 2)
    for strategy, msgs in ((trx.LeftProposal(), [g, fb]),
                           (trx.RightProposal(), [fb, g])):
        out = trx.SampleListFormConstraint(
            n_samples=1000, strategy=strategy).project_product(msgs)
        assert isinstance(out, td.SampleList)
    with pytest.raises(ValueError, match="LeftProposal or"):
        trx.SampleListFormConstraint(n_samples=10).project_product([fb, fb])


def test_samplelist_importance_samples_the_product():
    """N(0, 1) proposal times N(2, 1) as a log-density: the weighted
    moments against the product's (mean 1, variance 1/2), both packages."""
    for rx, dd, lib in ((jrx, jd, jnp), (trx, td, torch)):
        g1 = (dd.NormalMeanVariance(0.0, 1.0) if rx is jrx
              else dd.NormalMeanVariance(_t(0.0), _t(1.0)))
        fb = dd.LogPdfMessage(lambda x: -0.5 * (x - 2.0) ** 2)
        out = rx.SampleListFormConstraint(
            n_samples=40000, seed=1).project_product([g1, fb])
        assert isinstance(out, dd.SampleList)
        assert abs(float(out.mean()) - 1.0) < 0.03
        assert abs(float(out.var()) - 0.5) < 0.05


def test_samplelist_nonconjugate_inference_against_quadrature():
    y = (2.0 + 0.5 * np.random.default_rng(1).standard_normal(40)).astype(
        np.float32)

    def make(rx):
        @rx.model
        def m(y):
            theta = rx.Gamma(shape=2.0, rate=1.0)
            for i in rx.plate(len(y)):
                y[i] = rx.Normal(mean=theta, var=0.25)
            return {"theta": theta}

        return m

    ts = np.linspace(1e-3, 5.0, 4001)
    w = sp_gamma(2.0, scale=1.0).pdf(ts) * np.exp(
        -0.5 * np.sum((y[:, None] - ts) ** 2, axis=0) / 0.25)
    mean_exact = integrate.trapezoid(ts * w, ts) / integrate.trapezoid(w, ts)
    for rx in (jrx, trx):
        init = (jd.GammaShapeRate(2.0, 1.0) if rx is jrx
                else td.GammaShapeRate(_t(2.0), _t(1.0)))
        res = rx.infer(model=make(rx), data={"y": y}, iterations=4,
                       constraints=rx.constraints(forms={
                           "theta": rx.SampleListFormConstraint(
                               n_samples=20000, seed=2)}),
                       initialization={"theta": init},
                       returnvars=rx.KeepLast(), **_dev(rx))
        assert abs(float(res.posteriors["theta"].mean()) - mean_exact) < 0.05


# -- the rule fallback ----------------------------------------------------------------

@jnode("LogpdfBernoulliC")
class _JLogpdfBernoulli:
    interfaces = ("out", "p")

    @staticmethod
    def logpdf(values):
        y, p = values["out"], jnp.clip(values["p"], 1e-6, 1.0 - 1e-6)
        return y * jnp.log(p) + (1.0 - y) * jnp.log1p(-p)


@tnode("LogpdfBernoulliC")
class _TLogpdfBernoulli:
    interfaces = ("out", "p")

    @staticmethod
    def logpdf(values):
        y, p = values["out"], torch.clamp(values["p"], 1e-6, 1.0 - 1e-6)
        return y * torch.log(p) + (1.0 - y) * torch.log1p(-p)


def _fallback_model(rx):
    @rx.model
    def simple_model(y):
        p = rx.Beta(1.0, 1.0)
        for i in rx.plate(len(y)):
            y[i] = rx.factor_node("LogpdfBernoulliC", p=p)
        return {"p": p}

    return simple_model


@pytest.mark.parametrize("where", ["forms", "message_forms"])
def test_rule_fallback_with_projection(where):
    """A node defined only by its logpdf: the fallback's function-form
    messages, projected onto the Beta family as a marginal form (q(p)) or a
    message form (mu(p)); both packages within 0.02 of the exact mean."""
    y = (np.random.default_rng(7).uniform(size=400) < 0.3).astype(np.float32)
    exact = (1.0 + y.sum()) / (2.0 + len(y))
    # the JAX package's message-form run (7 s of tracing on a CPU) is its
    # own suite's; here the port's is held against the exact mean
    for rx in ((jrx, trx) if where == "forms" else (trx,)):
        init = (jd.Beta(1.0, 1.0) if rx is jrx
                else td.Beta(_t(1.0), _t(1.0)))
        res = rx.infer(
            model=_fallback_model(rx), data={"y": y}, iterations=5,
            constraints=rx.constraints(**{where: {"p": rx.ProjectedTo(
                "beta", n_samples=1024, n_iters=20)}}),
            initialization={"p": init}, returnvars=rx.KeepLast(),
            options={"rulefallback": rx.NodeFunctionRuleFallback()},
            **_dev(rx))
        assert abs(float(res.posteriors["p"].mean()) - exact) < 0.02


def test_rule_fallback_requires_a_form_constraint_and_a_missing_rule_raises():
    y = np.asarray([1.0, 0.0, 1.0], np.float32)
    init = {"p": td.Beta(_t(1.0), _t(1.0))}
    with pytest.raises(td.ProductError, match="ProjectedTo"):
        trx.infer(model=_fallback_model(trx), data={"y": y}, iterations=2,
                  initialization=init, device=CPU,
                  options={"rulefallback": trx.NodeFunctionRuleFallback()})
    with pytest.raises(KeyError, match="Rule not found"):
        trx.infer(model=_fallback_model(trx), data={"y": y}, iterations=1,
                  initialization=init, device=CPU)


def test_gamma_mixture_with_point_mass_rates_matches_jax():
    """tests/models/test_probit_mixtures.py:36-92: the gamma mixture with
    q(b0), q(b1) :: PointMass (closed-form Gamma modes)."""
    rng = np.random.default_rng(5)
    n = 600
    comp = rng.uniform(size=n) < 0.5
    y = np.where(comp, rng.gamma(9.0, 1 / 27.0, size=n),
                 rng.gamma(60.0, 1 / 20.0, size=n)).astype(np.float32)

    def make(rx):
        @rx.model
        def gmix(y):
            pi = rx.Dirichlet(np.ones(2, dtype=np.float32))
            b0 = rx.Gamma(shape=10.0, rate=3.0)
            b1 = rx.Gamma(shape=10.0, rate=1.0)
            z = rx.latent(n, name="z")
            for i in rx.plate(n):
                z[i] = rx.Categorical(pi)
                y[i] = rx.GammaMixture(z[i], (9.0, 60.0), (b0, b1))
            return {"pi": pi, "b0": b0, "b1": b1}

        return gmix

    out = {}
    for rx, dd in ((jrx, jd), (trx, td)):
        f = (lambda v: np.float32(v)) if rx is jrx else _t
        init = {"b0": dd.GammaShapeRate(f(10.0), f(3.0)),
                "b1": dd.GammaShapeRate(f(10.0), f(1.0)),
                "pi": dd.Dirichlet(np.ones(2, np.float32) if rx is jrx
                                   else torch.ones(2))}
        res = rx.infer(model=make(rx), data={"y": y}, iterations=40,
                       constraints=rx.constraints(forms={
                           "b0": rx.PointMassFormConstraint(),
                           "b1": rx.PointMassFormConstraint()}),
                       initialization=init, returnvars=rx.KeepLast(),
                       **_dev(rx))
        assert isinstance(res.posteriors["b0"], dd.PointMass)
        out[rx] = np.array([float(res.posteriors[k].point)
                            for k in ("b0", "b1")])
    np.testing.assert_allclose(out[trx], out[jrx], rtol=1e-4)
    means = sorted([9.0 / out[trx][0], 60.0 / out[trx][1]])
    assert abs(means[0] - 1 / 3) < 0.1 and abs(means[1] - 3.0) < 0.4


# -- caches, batches and refusals -----------------------------------------------------

def test_batched_program_cache_keys_constraints_by_value():
    """Two calls that differ only in a constraint's value get different
    programs; equal values in fresh objects share one."""
    y = (np.random.default_rng(2).uniform(size=(2, 30)) < 0.6).astype(
        np.float32)
    kw = dict(iterations=2, device=CPU)

    def forms(lo):
        return trx.constraints(forms={"p": trx.PointMassFormConstraint(
            starting_point=np.float32(0.5), boundaries=(lo, 1 - lo))})

    coin = _coin(trx, 2.0)
    c1, p1 = trx.batched_program(coin, {"y": y}, constraints=forms(1e-3),
                                 **kw)
    c2, p2 = trx.batched_program(coin, {"y": y}, constraints=forms(1e-3),
                                 **kw)
    c3, p3 = trx.batched_program(coin, {"y": y}, constraints=forms(0.4),
                                 **kw)
    c4, _ = trx.batched_program(coin, {"y": y}, constraints=trx.constraints(
        factorization=trx.MeanField()), **kw)
    assert p1 is p2 and c1 is c2
    assert p3 is not p1 and c4 is not c1
    # the boxed MAP sits on the box's edge: the new value was taken
    assert float(p3({"y": y})[0]["p"].point.max()) <= 0.6 + 1e-6


def test_mean_field_batched_matches_jax():
    """MeanField() on infer_batched: every factor's mean-field rules and
    free energy over a batch of three, against the JAX package's."""
    y = np.random.default_rng(6).standard_normal((3, 1)).astype(np.float32)

    @trx.model
    def tpair(y):
        a = trx.Normal(mean=0.0, var=V0)
        b = trx.Normal(mean=a, var=V1)
        y[0] = trx.Normal(mean=b, var=V2)
        return {"a": a, "b": b}

    @jrx.model
    def jpair(y):
        a = jrx.Normal(mean=0.0, var=V0)
        b = jrx.Normal(mean=a, var=V1)
        y[0] = jrx.Normal(mean=b, var=V2)
        return {"a": a, "b": b}

    tpost, tfe = trx.infer_batched(
        tpair, {"y": y}, iterations=5, free_energy=True, device=CPU,
        initialization={"a": trx.Normal(mean=0.0, var=1e6)},
        constraints=trx.constraints(factorization=trx.MeanField()))
    jpost, jfe = jrx.infer_batched(
        jpair, {"y": y}, iterations=5, free_energy=True,
        initialization={"a": jd.NormalMeanVariance(0.0, 1e6)},
        constraints=jrx.constraints(factorization=jrx.MeanField()))
    np.testing.assert_allclose(tfe.numpy(), np.asarray(jfe), **TOL)
    for n in ("a", "b"):
        np.testing.assert_allclose(tpost[n].mean().numpy(),
                                   np.asarray(jpost[n].mean()), **TOL)
        np.testing.assert_allclose(tpost[n].var().numpy(),
                                   np.asarray(jpost[n].var()), **TOL)


def test_submodel_constraints_and_shared_projection_are_refused():
    """A submodel block naming no scope of the model raises ``ValueError``
    as in the JAX package (submodel-scoped blocks themselves are ported:
    tests/test_torch_submodels.py); a pooled projection is refused."""
    for rx, dev in ((jrx, {}), (trx, {"device": CPU})):
        with pytest.raises(ValueError, match="'walk' matches no scope"):
            rx.infer(model=_coin(rx, 2.0),
                     data={"y": np.ones(3, np.float32)},
                     constraints=rx.constraints(
                         submodel={"walk": rx.constraints()}), **dev)
    with pytest.raises(NotImplementedError, match="projection form"):
        trx.infer_batched(
            _coin(trx, 2.0), {"y": np.ones((2, 3), np.float32)},
            shared=("p",), device=CPU, constraints=trx.constraints(
                forms={"p": trx.ProjectedTo("beta")}))


def test_mean_field_on_config_2_is_one_rounding_from_the_default():
    """``zoo.gaussian_unknown_mean_precision`` under ``MeanField()``: the
    mean-field rule forms the message to mu in precision form, the default
    in variance form (1/(1/w) is not w in float32), so in both packages the
    two runs differ by float32 roundings, not by bits alone; the
    mean-field runs agree across the packages."""
    from rxinfer_tpu.models import zoo as jzoo
    from rxinfer_tpu_torch.models import zoo as tzoo

    rng = np.random.default_rng(42)
    y = (rng.normal(0.0, 2.0, (8, 1)) + rng.uniform(0.5, 2.0, (8, 1))
         * rng.standard_normal((8, 200))).astype(np.float32)
    out = {}
    for rx, zoo, init in ((jrx, jzoo, jd.GammaShapeRate(1.0, 1.0)),
                          (trx, tzoo, td.GammaShapeRate(_t(1.0), _t(1.0)))):
        for mf in (False, True):
            cons = (rx.constraints(factorization=rx.MeanField()) if mf
                    else None)
            post, fe = rx.infer_batched(
                zoo.gaussian_unknown_mean_precision(), {"y": y},
                iterations=10, free_energy=True, constraints=cons,
                initialization={"tau": init}, **_dev(rx))
            out[(rx, mf)] = (np.asarray(post["mu"].mean()),
                             np.asarray(post["tau"].mean()), np.asarray(fe))
    for rx in (jrx, trx):
        a, b = out[(rx, False)], out[(rx, True)]
        assert not all(np.array_equal(x, z) for x, z in zip(a, b))
        for x, z in zip(a, b):
            np.testing.assert_allclose(z, x, rtol=1e-5, atol=1e-6)
    for x, z in zip(out[(trx, True)], out[(jrx, True)]):
        np.testing.assert_allclose(x, z, **TOL)

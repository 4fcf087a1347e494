"""Sums of random variables (ROADMAP A6d) through both packages: the
deterministic ``Sum`` and ``LinComb`` nodes (natural-form BP messages, their
cavity stores and Bethe terms) and the contracted ``GaussianSum*`` /
``MvGaussianSum*`` factors, their rules against the JAX package's
``call_rule`` (the JAX rules run one copy at a time, the port's over a
batch), the models of ``chip_smoke.py`` phase 22 (d) at small shapes,
``tests/models/test_reference_conformance.py``'s Gamma-aliases model held
to RxInfer.jl's own scalars and its normal-aliases tree (exact BP: the free
energy is -log Z), and ``Uninformative``.  Inputs come from numpy seeds; the
port runs on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rxinfer_tpu as jrx
import rxinfer_tpu_torch as trx
from rxinfer_tpu import dists as jd
from rxinfer_tpu.dists import natural as jnat
from rxinfer_tpu.rules.registry import RuleNotFoundError as JaxRuleNotFound
from rxinfer_tpu.rules.registry import call_rule as jcall
from rxinfer_tpu.rules.registry import get_node as jnode
from rxinfer_tpu_torch import convert
from rxinfer_tpu_torch import dists as td
from rxinfer_tpu_torch.dists import natural as tnat
from rxinfer_tpu_torch.rules.registry import call_rule as tcall
from rxinfer_tpu_torch.rules.registry import get_node as tnode

CPU = torch.device("cpu")
# closed forms in float32 on each side (a convolution solves a d x d system:
# LAPACK's LU in JAX, the cofactor inverse of ops/smallmat.py in the port)
RULE_TOL = dict(rtol=2e-5, atol=2e-6)
# whole models: float32 sweeps in each library's order
MODEL_TOL = dict(rtol=5e-5, atol=2e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _f32(x):
    return np.asarray(x, np.float32)


def both(family, *params):
    return (convert.dist_from_numpy(family, [_f32(p) for p in params]),
            getattr(jd, family)(*[jnp.asarray(_f32(p)) for p in params]))


def pm(x):
    return (td.PointMass(torch.as_tensor(_f32(x))),
            jd.PointMass(jnp.asarray(_f32(x))))


def _spd(rng, lead, d):
    a = rng.standard_normal(lead + (d, d))
    return a @ np.swapaxes(a, -1, -2) / d + np.eye(d)


def moments(d, mv):
    """(mean, var or cov) of a Gaussian or a point mass, as numpy."""
    if isinstance(d, (td.PointMass, jd.PointMass)):
        return np.asarray(d.point), None
    return np.asarray(d.mean()), np.asarray(d.cov() if mv else d.var())


def same(t, j, mv, **tol):
    """Two messages agree: a point mass by its point, a Gaussian by its
    natural parameters (a backward message through a tall map has a
    rank-deficient precision, so no moments)."""
    if isinstance(t, td.PointMass) or isinstance(j, jd.PointMass):
        np.testing.assert_allclose(moments(t, mv)[0], moments(j, mv)[0],
                                   **(tol or RULE_TOL))
        return
    for a, b in zip(tnat.to_natural(t), jnat.to_natural(j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   **(tol or RULE_TOL))


def _take(d, b):
    """Copy b of a batched JAX distribution."""
    if isinstance(d, jd.PointMass):
        return jd.PointMass(d.point[b])
    return type(d)(*[getattr(d, f)[b] for f in d.__dataclass_fields__])


def per_copy(fform, iface, q, batch, const=()):
    """The JAX rule copy by copy (its LinComb and multivariate Sum algebra
    takes one copy); ``const`` names interfaces without the batch axis."""
    return [jcall(fform, iface, **{k: (v if k in const else _take(v, b))
                                   for k, v in q.items()})
            for b in range(batch)]


# -- the Sum node -------------------------------------------------------------------

def _sum_inputs(rng, mv, out_kind):
    b, d = 3, 3
    if mv:
        g = lambda: both("MvNormalMeanCovariance",
                         rng.standard_normal((b, d)), _spd(rng, (b,), d))
        shift = pm(rng.standard_normal((b, d)))
    else:
        g = lambda: both("NormalMeanVariance", rng.standard_normal(b),
                         rng.uniform(0.3, 2.0, b))
        shift = pm(rng.standard_normal(b))
    q = {"in0": g(), "in1": g(), "in2": shift}
    if out_kind == "gaussian":
        q["out"] = g()
    elif out_kind == "point":
        q["out"] = pm(rng.standard_normal((b, d) if mv else b))
    return q, b


@pytest.mark.parametrize("mv", [False, True], ids=["scalar", "vector"])
@pytest.mark.parametrize("iface,out_kind", [
    ("out", None), ("in0", "gaussian"), ("in1", "point"),
    ("in2", "gaussian")])
def test_sum_messages_match_jax(mv, iface, out_kind):
    rng = np.random.default_rng(10 + mv)
    q, b = _sum_inputs(rng, mv, out_kind)
    q.pop(iface, None)
    t = tcall("Sum", iface, **{k: v[0] for k, v in q.items()})
    for i, j in enumerate(per_copy("Sum", iface, {k: v[1] for k, v in
                                                  q.items()}, b)):
        tb = type(t)(*[getattr(t, f)[i] for f in t.__dataclass_fields__])
        same(tb, j, mv)


@pytest.mark.parametrize("mv", [False, True], ids=["scalar", "vector"])
@pytest.mark.parametrize("out_kind", ["gaussian", "point"])
def test_sum_bethe_term_matches_jax(mv, out_kind):
    rng = np.random.default_rng(20 + mv)
    q, b = _sum_inputs(rng, mv, out_kind)
    t = tnode("Sum").bethe_term({k: v[0] for k, v in q.items()})
    for i in range(b):
        j = jnode("Sum").bethe_term({k: _take(v[1], i) for k, v in
                                     q.items()})
        np.testing.assert_allclose(float(t[i]), float(j), rtol=1e-5,
                                   atol=1e-5)


# -- the LinComb node ---------------------------------------------------------------

def _lincomb_inputs(rng, kind, out_kind):
    """Maps: ``matrix`` (A (3, 3) on x, B (3, 2) on u), ``scalar`` (2.0 on
    x, the identity on u, all in R^3), ``row`` (a row vector into a scalar
    out), ``column`` (a column lifting a scalar input)."""
    b = 3
    mvg = lambda d: both("MvNormalMeanCovariance",
                         rng.standard_normal((b, d)), _spd(rng, (b,), d))
    sg = lambda: both("NormalMeanVariance", rng.standard_normal(b),
                      rng.uniform(0.3, 2.0, b))
    if kind == "matrix":
        q = {"in0": mvg(3), "A0": pm(rng.standard_normal((3, 3))),
             "in1": mvg(2), "A1": pm(rng.standard_normal((3, 2))),
             "b": pm(rng.standard_normal(3))}
        d_out = 3
    elif kind == "scalar":
        q = {"in0": mvg(3), "A0": pm(2.0), "in1": mvg(3), "A1": pm(1.0)}
        d_out = 3
    elif kind == "row":
        q = {"in0": mvg(3), "A0": pm(rng.standard_normal(3)),
             "in1": sg(), "A1": pm(0.5), "b": pm(0.3)}
        d_out = 1
    else:
        # the out's dimension comes from the first map, as in the JAX node
        q = {"in0": mvg(3), "A0": pm(np.eye(3)),
             "in1": sg(), "A1": pm(rng.standard_normal(3))}
        d_out = 3
    if out_kind == "gaussian":
        q["out"] = mvg(d_out) if d_out > 1 else sg()
    elif out_kind == "point":
        q["out"] = pm(rng.standard_normal((b, d_out) if d_out > 1 else b))
    return q, b


@pytest.mark.parametrize("kind", ["matrix", "scalar", "row", "column"])
@pytest.mark.parametrize("iface,out_kind", [
    ("out", None), ("in0", "gaussian"), ("in1", "gaussian"),
    ("in1", "point")])
def test_lincomb_messages_match_jax(kind, iface, out_kind):
    rng = np.random.default_rng(30)
    q, b = _lincomb_inputs(rng, kind, out_kind)
    q.pop(iface, None)
    consts = tuple(k for k in q if k.startswith("A") or k == "b")
    t = tcall("LinComb", iface, **{k: v[0] for k, v in q.items()})
    js = per_copy("LinComb", iface, {k: v[1] for k, v in q.items()}, b,
                  const=consts)
    mv = isinstance(t, td.AbstractMvNormal)
    for i, j in enumerate(js):
        tb = type(t)(*[getattr(t, f)[i] for f in t.__dataclass_fields__])
        same(tb, j, mv, rtol=1e-4, atol=1e-5)


# -- the contracted GaussianSum factors --------------------------------------------

_GSUM = ("GaussianSumCovariance", "GaussianSumPrecision",
         "MvGaussianSumCovariance", "MvGaussianSumPrecision")


@pytest.mark.parametrize("fform,iface", [
    (f, i) for f in _GSUM for i in ("out", "in1", "prec", "average_energy")
    if i != "prec" or f.endswith("Precision")])
def test_gaussian_sum_rules_match_jax(fform, iface):
    mv = fform.startswith("Mv")
    rng = np.random.default_rng(40)
    b, d = 3, 3
    if mv:
        g = lambda: both("MvNormalMeanCovariance",
                         rng.standard_normal((b, d)), _spd(rng, (b,), d))
        noise = (both("Wishart", rng.uniform(d + 2, d + 6, b),
                      _spd(rng, (b,), d) / d)
                 if fform.endswith("Precision") else pm(_spd(rng, (), d)))
    else:
        g = lambda: both("NormalMeanVariance", rng.standard_normal(b),
                         rng.uniform(0.3, 2.0, b))
        noise = (both("GammaShapeRate", rng.uniform(1, 4, b),
                      rng.uniform(0.5, 2, b))
                 if fform.endswith("Precision") else pm(0.7))
    key = "prec" if fform.endswith("Precision") else (
        "cov" if mv else "var")
    q = {"out": g(), "in0": g(), "in1": g(), key: noise}
    q.pop(iface, None)
    t = tcall(fform, iface, **{k: v[0] for k, v in q.items()})
    j = jcall(fform, iface, **{k: v[1] for k, v in q.items()})
    if iface == "average_energy":
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **RULE_TOL)
    elif iface == "prec":
        for name in t.__dataclass_fields__:
            np.testing.assert_allclose(getattr(t, name).numpy(),
                                       np.asarray(getattr(j, name)),
                                       **RULE_TOL)
    else:
        same(t, j, mv)


# -- phase 22 (d) at small shapes -----------------------------------------------

def _offset_bias(rx):
    @rx.model
    def m(y):
        a = rx.Normal(mean=0.0, var=1.0)
        b = rx.Normal(mean=0.0, var=1.0)
        for i in rx.plate(len(y)):
            y[i] = rx.Normal(mean=a + b, var=0.25)
        return {"a": a, "b": b}
    return m


def _init(dists, mk):
    return {"a": dists.NormalMeanVariance(mk(0.0), mk(1.0)),
            "b": dists.NormalMeanVariance(mk(0.0), mk(1.0))}


def _run_both(source, data, iterations, init=True, fe=True):
    tpost, tfe = trx.infer_batched(
        source(trx), data, iterations=iterations, free_energy=fe,
        initialization=_init(td, torch.tensor) if init else None,
        device=CPU)
    jpost, jfe = jrx.infer_batched(
        source(jrx), data, iterations=iterations, free_energy=fe,
        initialization=_init(jd, jnp.asarray) if init else None)
    return tpost, tfe, jpost, jfe


def test_offset_plus_bias_tree_matches_jax_and_the_closed_form():
    """y ~ N(a + b, 0.25) once per dataset: a tree, so BP with the cavity
    store gives the joint Gaussian posterior's marginals exactly."""
    rng = np.random.default_rng(50)
    y = (1.5 + 0.5 * rng.standard_normal((3, 1))).astype(np.float32)
    tpost, tfe, jpost, jfe = _run_both(_offset_bias, {"y": y}, 10)
    h = np.ones((1, 2))
    lam = np.eye(2) + h.T @ h / 0.25
    for i in range(3):
        mu = np.linalg.solve(lam, h[0] * y[i, 0] / 0.25)
        sig = np.linalg.inv(lam)
        for k, name in enumerate(("a", "b")):
            assert abs(float(tpost[name].mean()[i]) - mu[k]) < 1e-5
            assert abs(float(tpost[name].var()[i]) - sig[k, k]) < 1e-5
    for name in ("a", "b"):
        np.testing.assert_allclose(tpost[name].mean().numpy(),
                                   np.asarray(jpost[name].mean()),
                                   **MODEL_TOL)
    np.testing.assert_allclose(tfe.numpy(), np.asarray(jfe), **MODEL_TOL)


def test_offset_plus_bias_loopy_matches_jax():
    """Both terms shared by a plate of 50: loopy.  The identifiable a + b
    reaches the conjugate result (the JAX test's bound, 0.05), and the two
    packages agree sweep by sweep."""
    rng = np.random.default_rng(51)
    n = 50
    y = (1.5 + 0.5 * rng.standard_normal((2, n))).astype(np.float32)
    tpost, tfe, jpost, jfe = _run_both(_offset_bias, {"y": y}, 30)
    s_est = (tpost["a"].mean() + tpost["b"].mean()).numpy()
    s_exact = 4.0 * y.sum(1) / (0.5 + 4.0 * n)
    assert np.all(np.abs(s_est - s_exact) < 0.05)
    for name in ("a", "b"):
        np.testing.assert_allclose(tpost[name].mean().numpy(),
                                   np.asarray(jpost[name].mean()),
                                   **MODEL_TOL)
        np.testing.assert_allclose(tpost[name].var().numpy(),
                                   np.asarray(jpost[name].var()),
                                   **MODEL_TOL)
    np.testing.assert_allclose(tfe.numpy(), np.asarray(jfe), **MODEL_TOL)


def _lincomb_model(rx, a_mat, b_mat, r_cov):
    d = a_mat.shape[0]

    @rx.model
    def m(y):
        x = rx.MvNormal(mean=np.zeros(d, np.float32),
                        cov=np.eye(d, dtype=np.float32))
        u = rx.MvNormal(mean=np.ones(2, np.float32),
                        cov=2.0 * np.eye(2, dtype=np.float32))
        s = rx.lincomb(a_mat @ x + b_mat @ u)
        y.observe(rx.MvNormal(mean=s, cov=r_cov))
        return {"x": x, "u": u, "s": s}
    return m


def test_lincomb_model_matches_the_closed_form_and_jax():
    """s = lincomb(A x + B u), y ~ N(s, R) at d = 4: the Gaussian posterior
    of (x, u) in closed form, and the port's free energy -log p(y) (its
    LinComb Bethe term; the JAX package's LinComb has none, so its free
    energy raises)."""
    rng = np.random.default_rng(52)
    d = 4
    a_mat = (np.eye(d) + 0.2 * rng.standard_normal((d, d))).astype(np.float32)
    b_mat = rng.standard_normal((d, 2)).astype(np.float32)
    r_cov = (0.5 * np.eye(d)).astype(np.float32)
    y = rng.standard_normal((3, d)).astype(np.float32)
    init_t = {"x": td.MvNormalMeanCovariance(torch.zeros(d), torch.eye(d)),
              "u": td.MvNormalMeanCovariance(torch.ones(2),
                                             2.0 * torch.eye(2))}
    init_j = {"x": jd.MvNormalMeanCovariance(jnp.zeros(d), jnp.eye(d)),
              "u": jd.MvNormalMeanCovariance(jnp.ones(2), 2.0 * jnp.eye(2))}
    tpost, tfe = trx.infer_batched(
        _lincomb_model(trx, a_mat, b_mat, r_cov), {"y": y}, iterations=4,
        initialization=init_t, free_energy=True, device=CPU)
    jpost, _ = jrx.infer_batched(
        _lincomb_model(jrx, a_mat, b_mat, r_cov), {"y": y}, iterations=4,
        initialization=init_j)
    h = np.concatenate([a_mat, b_mat], 1).astype(np.float64)
    p0 = np.diag([1.0] * d + [2.0, 2.0])
    m0 = np.array([0.0] * d + [1.0, 1.0])
    s_cov = h @ p0 @ h.T + r_cov
    for i in range(3):
        r = y[i] - h @ m0
        gain = p0 @ h.T @ np.linalg.inv(s_cov)
        m_post = m0 + gain @ r
        v_post = p0 - gain @ h @ p0
        np.testing.assert_allclose(tpost["x"].mean()[i].numpy(), m_post[:d],
                                   atol=1e-5)
        np.testing.assert_allclose(tpost["u"].cov()[i].numpy(),
                                   v_post[d:, d:], atol=1e-5)
        log_z = -0.5 * (np.linalg.slogdet(2 * np.pi * s_cov)[1]
                        + r @ np.linalg.solve(s_cov, r))
        np.testing.assert_allclose(tfe[:, i].numpy(), -log_z, rtol=1e-5)
    for name in ("x", "u", "s"):
        np.testing.assert_allclose(tpost[name].mean().numpy(),
                                   np.asarray(jpost[name].mean()),
                                   **MODEL_TOL)
    with pytest.raises(JaxRuleNotFound, match="average_energy"):
        jrx.infer_batched(_lincomb_model(jrx, a_mat, b_mat, r_cov),
                          {"y": y}, iterations=1, initialization=init_j,
                          free_energy=True)


# -- the reference's aliases models --------------------------------------------

def _gamma_aliases(rx):
    @rx.model
    def gamma_aliases(y):
        g0 = rx.Gamma(shape=1.0, scale=1.0)
        g1 = rx.Gamma(a=1.0, scale=1.0)
        g2 = rx.Gamma(shape=1.0, scale=1.0)
        g3 = rx.Gamma(shape=1.0, rate=1.0)
        g4 = rx.Gamma(a=1.0, b=1.0)
        g5 = rx.Gamma(shape=1.0, rate=1.0)
        gs = [g0, g1, g2, g3, g4, g5]
        xs = [rx.Normal(mean=1.0, precision=g) for g in gs]
        s = rx.Sum(*xs)
        y.observe(rx.Normal(mean=s, var=1.0))
        out = {f"g{i}": g for i, g in enumerate(gs)}
        out.update({f"x{i}": x for i, x in enumerate(xs)})
        out["s"] = s
        return out
    return gamma_aliases


def test_gamma_aliases_reach_the_reference_scalars():
    """RxInfer.jl's aliases_gamma_tests.jl:42-44: mean(q(s)) =
    9.468846338832027 and the final free energy 4.385584096993327, within
    1e-4 and 1e-5 as ``test_reference_conformance.py`` holds the JAX
    package.  The vague float32 initialization makes the first free
    energies infinite in both packages, so the default diagnostics are
    off, as there."""
    init_t, init_j = {}, {}
    for i in range(6):
        init_t[f"x{i}"] = td.NormalMeanVariance(torch.tensor(0.0),
                                                torch.tensor(1e12))
        init_t[f"g{i}"] = td.GammaShapeRate(torch.tensor(1.0),
                                            torch.tensor(1e-12))
        init_j[f"x{i}"] = jd.NormalMeanVariance(0.0, 1e12)
        init_j[f"g{i}"] = jd.GammaShapeRate(1.0, 1e-12)
    data = {"y": np.asarray(10.0, np.float32)}
    tres = trx.infer(model=_gamma_aliases(trx), data=data, iterations=100,
                     initialization=init_t, free_energy=True,
                     free_energy_diagnostics=None,
                     returnvars=trx.KeepLast(), device=CPU)
    fe = np.asarray(tres.free_energy, np.float64)
    assert abs(float(tres.posteriors["s"].mean()) - 9.468846338832027) < 1e-4
    assert abs(fe[-1] - 4.385584096993327) < 1e-5
    tail = np.diff(fe[-21:])
    assert (tail <= 1e-4).all()
    jres = jrx.infer(model=_gamma_aliases(jrx), data=data, iterations=100,
                     initialization=init_j, free_energy=True,
                     free_energy_diagnostics=None,
                     returnvars=jrx.KeepLast())
    jfe = np.asarray(jres.free_energy, np.float64)
    assert np.array_equal(np.isfinite(fe), np.isfinite(jfe))
    np.testing.assert_allclose(fe[-30:], jfe[-30:], rtol=1e-5)


def _normal_aliases(rx):
    z2 = np.zeros(2, np.float32)
    e2 = np.eye(2, dtype=np.float32)

    @rx.model
    def normal_aliases(d):
        x1 = rx.MvNormal(mean=z2, prec=e2)
        x2 = rx.MvNormal(mean=z2, prec=e2)
        x3 = rx.MvNormal(mean=z2, prec=e2)
        x4 = rx.MvNormal(mean=z2, prec=e2)
        x5 = rx.MvNormal(mean=z2, precision=e2)
        y1 = rx.MvNormal(mean=z2, cov=e2)
        y2 = rx.MvNormal(mean=z2, cov=e2)
        y3 = rx.MvNormal(mean=z2, cov=e2)
        y4 = rx.MvNormal(mean=z2, cov=e2)
        y5 = rx.MvNormal(mean=z2, covariance=e2)
        x = rx.Sum(x1, x2, x3, x4, x5)
        y = rx.Sum(y1, y2, y3, y4, y5)
        s = rx.Sum(x, y)
        r = rx.Normal(mean=rx.dot(np.ones(2), s), precision=1.0)
        for _ in range(6):
            r = rx.Normal(mean=r, precision=1.0)
        for _ in range(5):
            r = rx.Normal(mean=r, var=1.0)
        d.observe(rx.Normal(mean=r, variance=1.0))
        return {"x1": x1}
    return normal_aliases


def test_normal_aliases_tree_free_energy_is_exact():
    """The reference's normal-aliases model (aliases_normal_tests.jl): a
    tree with no initialization, which the tree schedule solves exactly, so
    the free energy is -log N(d; 0, 33) and E[x1] = 1/33, as
    ``test_reference_conformance.py`` holds the JAX package (whose program
    takes half a minute to trace here, so it is not run again)."""
    data = {"d": np.asarray(1.0, np.float32)}
    tres = trx.infer(model=_normal_aliases(trx), data=data, iterations=10,
                     free_energy=True, returnvars=trx.KeepLast(), device=CPU)
    v = 33.0
    fe_exact = 0.5 * np.log(2 * np.pi * v) + 1.0 / (2 * v)
    fe = np.asarray(tres.free_energy, np.float64)
    assert abs(fe[-1] - fe_exact) < 1e-4, (fe[-1], fe_exact)
    np.testing.assert_allclose(tres.posteriors["x1"].mean().numpy(), 1 / v,
                               rtol=1e-3)
    # exact from the second sweep on: the tree schedule's backward pass
    # completes the first
    np.testing.assert_allclose(fe[1:], fe_exact, rtol=1e-5)


def test_uninformative_prior_matches_jax():
    """A flat prior: the posterior of mu is the data's alone."""
    y = (3.0 + 0.5 * np.random.default_rng(4).standard_normal(100)).astype(
        np.float32)

    def source(rx):
        @rx.model
        def m(y):
            mu = rx.Uninformative()
            for i in rx.plate(len(y)):
                y[i] = rx.Normal(mean=mu, var=0.25)
            return {"mu": mu}
        return m

    tres = trx.infer(model=source(trx), data={"y": y}, iterations=1,
                     returnvars=trx.KeepLast(), free_energy=True, device=CPU)
    jres = jrx.infer(model=source(jrx), data={"y": y}, iterations=1,
                     returnvars=jrx.KeepLast(), free_energy=True)
    assert abs(float(tres.posteriors["mu"].mean()) - y.mean()) < 1e-3
    assert abs(float(tres.posteriors["mu"].var()) - 0.25 / 100) < 1e-4
    np.testing.assert_allclose(float(tres.posteriors["mu"].mean()),
                               float(jres.posteriors["mu"].mean()),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(tres.free_energy),
                               np.asarray(jres.free_energy), rtol=1e-5)

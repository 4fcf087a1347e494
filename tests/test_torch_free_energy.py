"""The Bethe free energy through both packages: every ported family's
entropy and log-expectations and every ported node's average energy against
the JAX package's on the same random marginals; the free-energy trace of
``infer``, ``batched_program`` and ``infer_batched`` against the JAX
package's on ``zoo.lgssm``, ``zoo.hmm``, the ``lgssm_wtau`` model, int8
ingest and NaN batches; FE == -log Z against a float64 Kalman filter with a
transition far from symmetric; the one-step chain (the JAX package raises,
the port gives the closed form); ``log_evidence``; the diagnostics; and the
affine custom-transition pair of a user node's lagged transition.  Inputs
come from numpy seeds.  JAX
runs as its own tests run it on the CPU (Pallas in interpret mode); the
port runs on the CPU with its kernels' plain versions."""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rxinfer_tpu as jrx
import rxinfer_tpu_torch as trx
from rxinfer_tpu import dists as jd
from rxinfer_tpu.engine import bethe as jbethe
from rxinfer_tpu.models import zoo as jzoo
from rxinfer_tpu.rules import expectations as jexp
from rxinfer_tpu.rules.registry import get_average_energy as jget_ae
from rxinfer_tpu_torch import dists as td
from rxinfer_tpu_torch.engine import bethe as tbethe
from rxinfer_tpu_torch.models import zoo as tzoo
from rxinfer_tpu_torch.rules import expectations as texp
from rxinfer_tpu_torch.rules.registry import get_average_energy as tget_ae

CPU = torch.device("cpu")
# entropies, log-expectations and average energies: one float32 expression
# each in both libraries (digamma / lgamma / small log-determinants differ
# by a few ulps)
TERM_TOL = dict(rtol=2e-5, atol=2e-5)
# free-energy traces: sums of 10^2-10^3 float32 terms that cancel (AE - H
# against (d_i - 1) H), summed in a different order by torch than by XLA;
# measured on a CPU at up to 5.7e-6 relative (the HMM against the JAX FE
# with its missing entropies added back), 6e-7 on the other models
FE_TOL = dict(rtol=1e-5, atol=1e-3)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# -- families and nodes, term by term ------------------------------------------------

B = 3


def _spd(rng, d, scale=1.0):
    m = rng.standard_normal((B, d, d))
    return (scale * (m @ np.swapaxes(m, -1, -2) + d * np.eye(d))).astype(
        np.float32)


def _pos(rng, *shape, lo=0.5, hi=3.0):
    return rng.uniform(lo, hi, (B,) + shape).astype(np.float32)


def _both(family, *params):
    """(port distribution with the batch axis, JAX distributions per
    element) of the same numpy parameters."""
    t = getattr(td, family)(*[torch.as_tensor(p) for p in params])
    j = [getattr(jd, family)(*[jnp.asarray(p[i]) for p in params])
         for i in range(B)]
    return t, j


def _point(value, batched=True):
    v = np.asarray(value, np.float32)
    return (td.PointMass(torch.as_tensor(v)),
            [jd.PointMass(jnp.asarray(v[i] if batched else v))
             for i in range(B)])


def _dists(rng):
    """name -> (port, [JAX per element]) of every ported family."""
    d = 3
    mu = rng.standard_normal((B, d)).astype(np.float32)
    alpha = _pos(rng, 3, 4)
    return {
        "NormalMeanVariance": _both("NormalMeanVariance",
                                    rng.standard_normal(B).astype(np.float32),
                                    _pos(rng)),
        "NormalMeanPrecision": _both("NormalMeanPrecision",
                                     rng.standard_normal(B).astype(
                                         np.float32), _pos(rng)),
        "NormalWeightedMeanPrecision": _both(
            "NormalWeightedMeanPrecision",
            rng.standard_normal(B).astype(np.float32), _pos(rng)),
        "MvNormalMeanCovariance": _both("MvNormalMeanCovariance", mu,
                                        _spd(rng, d)),
        "MvNormalMeanPrecision": _both("MvNormalMeanPrecision", mu,
                                       _spd(rng, d)),
        "MvNormalWeightedMeanPrecision": _both(
            "MvNormalWeightedMeanPrecision", mu, _spd(rng, d)),
        "GammaShapeRate": _both("GammaShapeRate", _pos(rng), _pos(rng)),
        "Wishart": _both("Wishart", _pos(rng, lo=4.0, hi=9.0),
                         _spd(rng, d, 0.1)),
        "Categorical": _both("Categorical",
                             rng.standard_normal((B, 4)).astype(np.float32)),
        "DirichletCollection": _both("DirichletCollection", alpha),
        "Beta": _both("Beta", _pos(rng), _pos(rng)),
        "Bernoulli": _both("Bernoulli", _pos(rng, lo=0.05, hi=0.95)),
        "BernoulliLogits": _both(
            "BernoulliLogits",
            3.0 * rng.standard_normal(B).astype(np.float32)),
    }


def _stat_cases():
    cases = [(name, "entropy") for name in (
        "NormalMeanVariance", "NormalMeanPrecision",
        "NormalWeightedMeanPrecision", "MvNormalMeanCovariance",
        "MvNormalMeanPrecision", "MvNormalWeightedMeanPrecision",
        "GammaShapeRate", "Wishart", "Categorical", "DirichletCollection",
        "Beta", "Bernoulli", "BernoulliLogits")]
    cases += [("GammaShapeRate", "e_log"), ("GammaShapeRate",
                                            "e_log_precision"),
              ("Beta", "e_log"), ("Beta", "e_mirrorlog"),
              ("DirichletCollection", "e_log"), ("Wishart", "e_logdet"),
              ("PointMass", "e_log"), ("PointMass", "e_mirrorlog"),
              ("PointMass", "e_logdet"), ("PointMass", "e_log_precision")]
    return cases


@pytest.mark.parametrize("family,stat", _stat_cases())
def test_family_statistics_match_jax(family, stat):
    rng = np.random.default_rng(zlib.crc32(f"{family}/{stat}".encode()))
    if family == "PointMass":
        value = (_spd(rng, 3) if stat == "e_logdet"
                 else _pos(rng, lo=0.1, hi=0.9))
        t, js = _point(value)
    else:
        t, js = _dists(rng)[family]
    if stat == "entropy":
        got = t.entropy()
        want = [j.entropy() for j in js]
    else:
        got = getattr(texp, stat)(t)
        want = [getattr(jexp, stat)(j) for j in js]
    want = np.stack([np.asarray(w) for w in want])
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TERM_TOL)


def _ae_cases(rng):
    """name -> (fform, port q, [JAX q per element]) on random marginals."""
    d = 3
    ds = _dists(rng)

    def q_of(**items):
        tq = {k: v[0] for k, v in items.items()}
        jq = [{k: v[1][i] for k, v in items.items()} for i in range(B)]
        return tq, jq

    a_mat = np.array([[0.9, 0.7, 0.0], [-0.3, 0.8, 0.5], [0.1, 0.0, 1.1]],
                     np.float32)       # far from symmetric
    joint = (0.3 * rng.standard_normal((B, d, d))).astype(np.float32)
    joint_s = (0.3 * rng.standard_normal(B)).astype(np.float32)
    xi_pairs = rng.dirichlet(np.ones(16), B).reshape(B, 4, 4).astype(
        np.float32)
    mvn = ds["MvNormalMeanCovariance"]
    mvn2 = _both("MvNormalMeanCovariance",
                 rng.standard_normal((B, d)).astype(np.float32),
                 _spd(rng, d))
    nmv = ds["NormalMeanVariance"]
    nmv2 = _both("NormalMeanVariance",
                 rng.standard_normal(B).astype(np.float32), _pos(rng))
    cat = ds["Categorical"]
    cat2 = _both("Categorical",
                 rng.standard_normal((B, 4)).astype(np.float32))
    dirc = _both("DirichletCollection", _pos(rng, 4, 4))
    y_scalar = _point(rng.standard_normal(B))
    y_vec = _point(rng.standard_normal((B, d)))
    const = lambda v: _point(v, batched=False)
    cases = {
        "NormalMeanVariance": ("NormalMeanVariance", q_of(
            out=y_scalar, mean=nmv, var=const(1.7))),
        "NormalMeanPrecision": ("NormalMeanPrecision", q_of(
            out=nmv2, mean=nmv, prec=ds["GammaShapeRate"])),
        "MvNormalMeanCovariance": ("MvNormalMeanCovariance", q_of(
            out=y_vec, mean=mvn, cov=const(_spd(rng, d)[0]))),
        "MvNormalMeanPrecision": ("MvNormalMeanPrecision", q_of(
            out=mvn2, mean=mvn, prec=ds["Wishart"])),
        "MvNormalMeanPrecision/point": ("MvNormalMeanPrecision", q_of(
            out=y_vec, mean=mvn, prec=const(_spd(rng, d)[0]))),
        "MvLinearGaussianCovariance": ("MvLinearGaussianCovariance", q_of(
            out=mvn2, **{"in": mvn}, A=const(a_mat), b=const(np.zeros(d)),
            cov=const(_spd(rng, d)[0]), joint=(torch.as_tensor(joint),
                                               [jnp.asarray(x)
                                                for x in joint]))),
        "MvLinearGaussianPrecision": ("MvLinearGaussianPrecision", q_of(
            out=y_vec, **{"in": mvn}, A=const(a_mat),
            b=const(0.1 * np.ones(d)), prec=ds["Wishart"])),
        "LinearGaussianCovariance": ("LinearGaussianCovariance", q_of(
            out=nmv2, **{"in": nmv}, A=const(0.8), b=const(0.1),
            var=const(0.4), joint=(torch.as_tensor(joint_s),
                                   [jnp.asarray(x) for x in joint_s]))),
        "LinearGaussianPrecision": ("LinearGaussianPrecision", q_of(
            out=y_scalar, **{"in": nmv}, A=const(1.2), b=const(0.0),
            prec=ds["GammaShapeRate"])),
        "GammaShapeRate": ("GammaShapeRate", q_of(
            out=ds["GammaShapeRate"], shape=const(2.0), rate=const(1.5))),
        "Wishart": ("Wishart", q_of(out=ds["Wishart"], nu=const(5.0),
                                    S=const(_spd(rng, d, 0.2)[0]))),
        "Categorical": ("Categorical", q_of(
            out=cat, p=const(rng.dirichlet(np.ones(4))))),
        "DirichletCollection": ("DirichletCollection", q_of(
            out=dirc, alpha=const(np.ones((4, 4)) + np.eye(4)))),
        "DiscreteTransition": ("DiscreteTransition", q_of(
            out=cat2, **{"in": cat}, matrix=dirc)),
        "DiscreteTransition/joint": ("DiscreteTransition", q_of(
            out=cat2, **{"in": cat}, matrix=dirc,
            joint=(torch.as_tensor(xi_pairs),
                   [jnp.asarray(x) for x in xi_pairs]))),
        "Beta": ("Beta", q_of(out=ds["Beta"], a=const(2.0), b=const(7.0))),
        "Bernoulli": ("Bernoulli", q_of(
            out=_point(rng.integers(0, 2, B)), p=ds["Beta"])),
    }
    return cases


AE_NAMES = sorted(_ae_cases(np.random.default_rng(0)))


@pytest.mark.parametrize("name", AE_NAMES)
def test_average_energies_match_jax(name):
    fform, (tq, jqs) = _ae_cases(np.random.default_rng(5))[name]
    got = tget_ae(fform)(tq)
    want = np.stack([np.asarray(jget_ae(fform)(jq)) for jq in jqs])
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TERM_TOL)


@pytest.mark.parametrize("scalar", [True, False])
def test_pair_entropies_match_jax(scalar):
    rng = np.random.default_rng(9)
    if scalar:
        vo, vi = _pos(rng, 5), _pos(rng, 5)
        c = (0.4 * rng.standard_normal((B, 5))).astype(np.float32)
    else:
        vo, vi = _spd(rng, 3), _spd(rng, 3)
        c = (0.5 * rng.standard_normal((B, 3, 3))).astype(np.float32)
    got = tbethe.gaussian_pair_entropy(*map(torch.as_tensor, (vo, vi, c)),
                                       scalar=scalar)
    want = np.stack([np.asarray(jbethe.gaussian_pair_entropy(
        jnp.asarray(vo[i]), jnp.asarray(vi[i]), jnp.asarray(c[i])))
        for i in range(B)])
    np.testing.assert_allclose(got.numpy(), want, **TERM_TOL)
    xis = rng.dirichlet(np.ones(9), (B, 4)).reshape(B, 4, 3, 3).astype(
        np.float32)
    np.testing.assert_allclose(
        tbethe.discrete_pair_entropy(torch.as_tensor(xis)).numpy(),
        np.asarray(jbethe.discrete_pair_entropy(jnp.asarray(xis))),
        **TERM_TOL)


# -- the models ----------------------------------------------------------------------

def lgssm_constants(d=2, shear=False):
    th = np.pi / 35
    rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]],
                   np.float32)
    a = np.kron(np.eye(d // 2, dtype=np.float32), rot)
    if shear:   # a transition far from symmetric
        a = np.array([[0.95, 0.8], [-0.05, 0.7]], np.float32)
    eye = np.eye(d, dtype=np.float32)
    h = np.array([[1.3, 0.4], [0.0, 0.9]], np.float32) if d == 2 else \
        1.3 * eye
    return a, 0.5 * eye, h, eye + 0.2, np.zeros(d, np.float32), 25.0 * eye


def lgssm_y(b, t, d=2, seed=0):
    return np.random.default_rng(seed).standard_normal((b, t, d)).astype(
        np.float32)


def _fe_pair(jmodel, tmodel, data, iterations=1, init=None, options=None):
    """(port FE (iterations, B), JAX FE (iterations, B)) of batched_program
    on the same data."""
    _, jprog = jrx.batched_program(
        jmodel, data, iterations=iterations, free_energy=True,
        initialization=init[0] if init else None, options=options)
    _, jfe, _ = jprog({k: jnp.asarray(v) for k, v in data.items()})
    _, tprog = trx.batched_program(
        tmodel, data, iterations=iterations, free_energy=True,
        initialization=init[1] if init else None, options=options,
        device=CPU)
    _, tfe, _ = tprog(data)
    return tfe.numpy(), np.asarray(jfe)


@pytest.mark.parametrize("fused", [True, False])
def test_lgssm_fe_matches_jax(fused):
    c = lgssm_constants()
    y = lgssm_y(4, 64)
    opts = None if fused else {"fused_kernels": False}
    tfe, jfe = _fe_pair(jzoo.lgssm(*c), tzoo.lgssm(*c), {"y": y},
                        iterations=2, options=opts)
    assert tfe.shape == (2, 4)
    np.testing.assert_allclose(tfe, jfe, **FE_TOL)


def _minus_log_z(y, a, q, h, r, m0, v0):
    """-log p(y) of the LGSSM in float64: the Kalman filter's
    prediction-error decomposition."""
    a, q, h, r, m0, v0 = (np.asarray(x, np.float64)
                          for x in (a, q, h, r, m0, v0))
    out = []
    for yb in np.asarray(y, np.float64):
        m, p, ll = m0, v0, 0.0
        for t, yt in enumerate(yb):
            if t:
                m, p = a @ m, a @ p @ a.T + q
            s = h @ p @ h.T + r
            e = yt - h @ m
            ll -= 0.5 * (len(yt) * np.log(2 * np.pi)
                         + np.linalg.slogdet(s)[1] + e @ np.linalg.solve(s, e))
            k = p @ h.T @ np.linalg.inv(s)
            m, p = m + k @ e, p - k @ s @ k.T
        out.append(-ll)
    return np.array(out)


# FE == -log Z: float32 smoothing over 64 steps against float64; the FE sums
# ~600 terms of size <= 10^2 (measured up to 2.4e-7 relative on a CPU)
LOGZ_TOL = dict(rtol=2e-5, atol=0)


@pytest.mark.parametrize("shear", [False, True])
def test_lgssm_fe_equals_minus_log_z(shear):
    c = lgssm_constants(shear=shear)
    y = lgssm_y(4, 64, seed=3)
    _, tprog = trx.batched_program(tzoo.lgssm(*c), {"y": y},
                                   free_energy=True, device=CPU)
    _, fe, _ = tprog({"y": y})
    np.testing.assert_allclose(fe[0].numpy(), _minus_log_z(y, *c),
                               **LOGZ_TOL)


def test_infer_fe_matches_jax_and_log_evidence():
    c = lgssm_constants()
    y = lgssm_y(1, 64, seed=4)[0]
    jres = jrx.infer(jzoo.lgssm(*c), data={"y": y}, iterations=3,
                     free_energy=True)
    tres = trx.infer(tzoo.lgssm(*c), data={"y": y}, iterations=3,
                     free_energy=True, device=CPU)
    assert tuple(tres.free_energy.shape) == (3,)
    np.testing.assert_allclose(tres.free_energy.numpy(),
                               np.asarray(jres.free_energy), **FE_TOL)
    np.testing.assert_allclose(float(tres.log_evidence),
                               float(jres.log_evidence), **FE_TOL)
    np.testing.assert_allclose(-float(tres.log_evidence),
                               _minus_log_z(y[None], *c)[0], **LOGZ_TOL)
    plain = trx.infer(tzoo.lgssm(*c), data={"y": y}, device=CPU)
    assert plain.free_energy is None
    with pytest.raises(ValueError, match="free_energy=True"):
        plain.log_evidence


def hmm_y(b, t, seed=0):
    idx = np.random.default_rng(seed).integers(0, 3, (b, t))
    return np.eye(3, dtype=np.float32)[idx]


def hmm_init(rx):
    return {"A": rx.DirichletCollection(np.ones((3, 3), np.float32)),
            "B": rx.DirichletCollection(np.float32(np.eye(3) * 5.0 + 1.0))}


def _hmm_programs(y, iterations):
    """(port FE, port history, JAX FE) of zoo.hmm(3, 3) on y."""
    _, jprog = jrx.batched_program(jzoo.hmm(3, 3), {"y": y},
                                   iterations=iterations, free_energy=True,
                                   initialization=hmm_init(jrx))
    _, jfe, _ = jprog({"y": jnp.asarray(y)})
    _, tprog = trx.batched_program(tzoo.hmm(3, 3), {"y": y},
                                   iterations=iterations, free_energy=True,
                                   keep_each=True,
                                   initialization=hmm_init(trx), device=CPU)
    _, tfe, hist = tprog({"y": y})
    return tfe.numpy(), hist, np.asarray(jfe)


@pytest.mark.parametrize("missing", [False, True])
def test_hmm_fe_is_jax_fe_with_the_matrix_entropy_per_transition(missing):
    """The JAX package subtracts a chain transition's pair entropy alone:
    the entropy of its random matrix A is missing once per transition copy
    (T - 1 of them; its variable's degree counts them).  The port counts
    it, so the two differ by exactly (T - 1) H[q(A)] at every sweep."""
    y = hmm_y(4, 20)
    if missing:
        y[1, 7] = np.nan
        y[2, 10:13] = np.nan
    tfe, hist, jfe = _hmm_programs(y, 5)
    assert tfe.shape == (5, 4)
    h_a = np.stack([h["A"].entropy().numpy() for h in hist])
    np.testing.assert_allclose(tfe, jfe - 19 * h_a, **FE_TOL)


def hmm_vmp_fe_float64(y, iterations):
    """Structured VMP on zoo.hmm(3, 3) in float64 (sweep s, A, B, as the
    port's) with its Bethe free energy after each sweep: the transition
    and emission average energies under E[log A], E[log B], the priors'
    (flat Dirichlet columns, uniform initial state), minus the chain's
    entropy sum_t H(xi_t) - sum_interior H(gamma_t) and the Dirichlet
    entropies."""
    from scipy.special import digamma, gammaln, logsumexp

    def dir_h(a):
        a0 = a.sum(-2)
        return np.sum(gammaln(a).sum(-2) - gammaln(a0)
                      + (a0 - a.shape[-2]) * digamma(a0)
                      - ((a - 1.0) * digamma(a)).sum(-2), -1)

    def elog(a):
        return digamma(a) - digamma(a.sum(-2, keepdims=True))

    y = np.asarray(y, np.float64)
    n, t_len, _ = y.shape
    ca = np.ones((n, 3, 3))
    cb = np.broadcast_to(np.eye(3) * 5.0 + 1.0, (n, 3, 3)).copy()
    lp = np.full(3, np.log(1.0 / 3.0))
    prior_ae = 3 * (3 * gammaln(1.0) - gammaln(3.0))   # flat columns
    fes = []
    for _ in range(iterations):
        la_, lb_ = elog(ca), elog(cb)
        le = np.einsum("nij,nti->ntj", lb_, y)
        fa = np.empty((n, t_len, 3))
        fa[:, 0] = lp + le[:, 0]
        for t in range(1, t_len):
            fa[:, t] = logsumexp(la_ + fa[:, t - 1, None, :], -1) + le[:, t]
        bb = np.zeros((n, t_len, 3))
        for t in range(t_len - 2, -1, -1):
            bb[:, t] = logsumexp(la_ + (le[:, t + 1] + bb[:, t + 1])[..., None],
                                 1)
        logz = logsumexp(fa[:, -1], -1)
        g = np.exp(fa + bb - logz[:, None, None])
        xi = np.exp(fa[:, :-1, None, :] + la_[:, None]
                    + (le[:, 1:] + bb[:, 1:])[..., None]
                    - logz[:, None, None, None])
        ca = 1.0 + xi.sum(1)
        cb = 1.0 + np.einsum("nti,ntj->nij", y, g)
        la_, lb_ = elog(ca), elog(cb)
        ae = (-np.einsum("ntij,nij->n", xi, la_)
              - np.einsum("nti,ntj,nij->n", y, g, lb_)
              - g[:, 0] @ lp + 2 * prior_ae)
        h_xi = -np.sum(xi * np.log(np.maximum(xi, 1e-300)), (1, 2, 3))
        h_g = -np.sum(g * np.log(np.maximum(g, 1e-300)), -1)
        h_chain = h_xi - h_g[:, 1:-1].sum(-1)
        fes.append(ae - h_chain - dir_h(ca) - dir_h(cb))
    return np.stack(fes)


# the HMM trace against float64: ~200 float32 terms of size <= 10 that
# cancel to ~30 (measured 7.8e-7 relative on a CPU)
HMM_FE_TOL = dict(rtol=2e-5, atol=0)


def test_hmm_fe_matches_a_float64_structured_vmp():
    y = hmm_y(4, 20, seed=2)
    _, tprog = trx.batched_program(tzoo.hmm(3, 3), {"y": y}, iterations=6,
                                   free_energy=True,
                                   initialization=hmm_init(trx), device=CPU)
    fe = tprog({"y": y})[1].numpy()
    np.testing.assert_allclose(fe, hmm_vmp_fe_float64(y, 6), **HMM_FE_TOL)
    assert (fe > 0).all()   # -log p(y) of discrete data is >= 0
    assert (np.diff(fe, axis=0) <= 1e-5 * np.abs(fe[1:])).all()


def test_infer_hmm_fe_matches_a_float64_structured_vmp():
    """One dataset through ``infer``: the scan forward-backward, no
    kernel's plain version."""
    y = hmm_y(1, 60, seed=4)
    res = trx.infer(tzoo.hmm(3, 3), data={"y": y[0]}, iterations=4,
                    free_energy=True, initialization=hmm_init(trx),
                    device=CPU)
    np.testing.assert_allclose(res.free_energy.numpy(),
                               hmm_vmp_fe_float64(y, 4)[:, 0], **HMM_FE_TOL)


def test_chunked_batches_give_the_same_free_energy():
    """A budget of two elements with their free energy: chunks of two."""
    from rxinfer_tpu_torch.engine.batched import chain_hbm_bytes_per_element

    c = lgssm_constants()
    y = lgssm_y(5, 40, seed=5)
    compiled, _ = trx.batched_program(tzoo.lgssm(*c), {"y": y},
                                      free_energy=True, device=CPU)
    budget = 2 * chain_hbm_bytes_per_element(compiled, free_energy=True)
    _, fe = trx.infer_batched(tzoo.lgssm(*c), {"y": y}, free_energy=True,
                              device=CPU)
    with pytest.warns(UserWarning, match="3 sequential chunks of 2"):
        _, fe_chunked = trx.infer_batched(
            tzoo.lgssm(*c), {"y": y}, free_energy=True, device=CPU,
            options={"hbm_budget_bytes": budget})
    assert tuple(fe_chunked.shape) == (1, 5)
    np.testing.assert_allclose(fe_chunked.numpy(), fe.numpy(), rtol=1e-6)


def test_lgssm_nan_batch_fe_matches_jax():
    c = lgssm_constants()
    y = lgssm_y(4, 64, seed=6)
    y[0, 5] = np.nan
    y[2, 30:34] = np.nan
    y[3, 0] = np.nan
    with pytest.warns(UserWarning, match="missing observations"):
        tfe, jfe = _fe_pair(jzoo.lgssm(*c), tzoo.lgssm(*c), {"y": y},
                            iterations=2)
    np.testing.assert_allclose(tfe, jfe, **FE_TOL)
    # a missing step removes its likelihood: -log Z of the observed steps
    ok = _minus_log_z(y[1:2], *c)
    np.testing.assert_allclose(tfe[-1, 1], ok[0], **LOGZ_TOL)


def wtau(rx, d=2):
    a, q, _, _, m0, v0 = lgssm_constants(d)
    nu0 = float(d) + 1.0
    eye = np.eye(d, dtype=np.float32)

    @rx.model
    def lgssm_wtau(y):
        Tn = len(y)
        Wr = rx.Wishart(nu0, eye)
        x = rx.latent(Tn, name="x")
        x[0] = rx.MvNormal(mean=m0, cov=v0)
        for t in rx.plate(1, Tn):
            x[t] = rx.MvNormal(mean=a @ x[t - 1], cov=q)
        for t in rx.plate(Tn):
            y[t] = rx.MvNormal(mean=x[t], precision=Wr)

    return lgssm_wtau, {"Wr": rx.Wishart(nu0, eye)}


@pytest.mark.parametrize("fused", [True, False])
def test_wtau_fe_matches_jax(fused):
    jm, jinit = wtau(jrx)
    tm, tinit = wtau(trx)
    y = np.cumsum(lgssm_y(4, 64, seed=7), axis=1).astype(np.float32)
    opts = None if fused else {"fused_kernels": False}
    tfe, jfe = _fe_pair(jm, tm, {"y": y}, iterations=3,
                        init=(jinit, tinit), options=opts)
    np.testing.assert_allclose(tfe, jfe, **FE_TOL)


def walk_q(rx):
    @rx.model
    def walk_q(y):
        T = len(y)
        tw = rx.Gamma(shape=2.0, rate=1.0)
        x = rx.latent(T, name="x")
        x[0] = rx.Normal(mean=0.0, var=25.0)
        for t in rx.plate(1, T):
            x[t] = rx.Normal(mean=x[t - 1], precision=tw)
        for t in rx.plate(T):
            y[t] = rx.Normal(mean=x[t], var=0.5)

    return walk_q


@pytest.mark.parametrize("fused,rate", [(True, 1.0), (False, 1.0),
                                        (True, 1e9)])
def test_random_process_noise_fe_counts_its_entropy_per_transition(fused,
                                                                   rate):
    """A Gaussian chain whose process-noise precision is random: as on the
    HMM, the JAX package's FE misses (T - 1) H[q(tw)].  ``rate`` 1e9 starts
    from E[tw] = 1e-9, where the first sweep's Q is the vague-precision
    guard's (E[tw] + 1e-4)^-1 in both packages."""
    y = np.cumsum(0.5 * np.random.default_rng(2).standard_normal((3, 15)),
                  axis=1).astype(np.float32)
    opts = None if fused else {"fused_kernels": False}
    _, jprog = jrx.batched_program(
        walk_q(jrx), {"y": y}, iterations=3, free_energy=True, options=opts,
        initialization={"tw": jrx.Gamma(shape=1.0, rate=rate)})
    _, jfe, _ = jprog({"y": jnp.asarray(y)})
    _, tprog = trx.batched_program(
        walk_q(trx), {"y": y}, iterations=3, free_energy=True, options=opts,
        keep_each=True, initialization={"tw": trx.Gamma(1.0, rate)},
        device=CPU)
    _, tfe, hist = tprog({"y": y})
    h_tw = np.stack([h["tw"].entropy().numpy() for h in hist])
    np.testing.assert_allclose(tfe.numpy(), np.asarray(jfe) - 14 * h_tw,
                               **FE_TOL)


@pytest.mark.parametrize("dtype", ["int8", "float8_e4m3fn"])
def test_quantized_ingest_fe_matches_jax(dtype):
    c = lgssm_constants()
    y = lgssm_y(4, 64, seed=8)
    tfe, jfe = _fe_pair(jzoo.lgssm(*c), tzoo.lgssm(*c), {"y": y},
                        options={"observation_dtype": dtype})
    np.testing.assert_allclose(tfe, jfe, **FE_TOL)
    # the terms read the dequantized observations: the float32 program on
    # them gives the same free energy
    from rxinfer_tpu_torch.engine.batched import quantize_observations

    vals, scales = quantize_observations(torch.as_tensor(y), dtype)
    deq = (vals.to(torch.float32) * scales).transpose(1, 2).numpy()
    _, prog = trx.batched_program(tzoo.lgssm(*c), {"y": deq},
                                  free_energy=True, device=CPU)
    np.testing.assert_allclose(tfe, prog({"y": deq})[1].numpy(), **FE_TOL)


# -- the one-step chain (C4) -------------------------------------------------------------

def test_jax_slot_degrees_fail_at_one_step():
    c = lgssm_constants()
    with pytest.raises(ZeroDivisionError):
        jrx.batched_program(jzoo.lgssm(*c), {"y": lgssm_y(2, 1)},
                            free_energy=True)


@pytest.mark.parametrize("fused", [True, False])
def test_one_step_fe_is_the_closed_form(fused):
    c = lgssm_constants()
    a, q, h, r, m0, v0 = c
    y = lgssm_y(3, 1, seed=2)
    opts = None if fused else {"fused_kernels": False}
    _, prog = trx.batched_program(tzoo.lgssm(*c), {"y": y}, free_energy=True,
                                  options=opts, device=CPU)
    _, fe, _ = prog({"y": y})
    s = (h @ v0 @ h.T + r).astype(np.float64)
    e = y[:, 0].astype(np.float64) - h @ m0
    want = 0.5 * (2 * np.log(2 * np.pi) + np.linalg.slogdet(s)[1]
                  + np.einsum("bi,ij,bj->b", e, np.linalg.inv(s), e))
    np.testing.assert_allclose(fe[0].numpy(), want, **LOGZ_TOL)


# -- diagnostics, refusals -----------------------------------------------------------------

def test_nan_free_energy_raises_in_both_unless_disabled():
    """An observation outside the Bernoulli support (y = 5) drives the
    Beta posterior's b below zero, and the free energy is NaN in both
    packages."""
    y = np.array([1.0, 0.0, 5.0, 1.0], np.float32)
    with pytest.raises(FloatingPointError, match="NaN"):
        jrx.infer(jzoo.beta_bernoulli(2.0, 2.0), data={"y": y},
                  free_energy=True)
    with pytest.raises(FloatingPointError, match="NaN"):
        trx.infer(tzoo.beta_bernoulli(2.0, 2.0), data={"y": y},
                  free_energy=True, device=CPU)
    res = trx.infer(tzoo.beta_bernoulli(2.0, 2.0), data={"y": y},
                    free_energy=True, free_energy_diagnostics=None,
                    device=CPU)
    jres = jrx.infer(jzoo.beta_bernoulli(2.0, 2.0), data={"y": y},
                     free_energy=True, free_energy_diagnostics=None)
    assert np.isnan(res.free_energy.numpy()).all()
    assert np.isnan(np.asarray(jres.free_energy)).all()
    # infer_batched checks nothing unless asked, as the JAX package's
    from rxinfer_tpu_torch.diagnostics import (
        DefaultObjectiveDiagnosticChecks,
    )

    _, fe = trx.infer_batched(tzoo.beta_bernoulli(2.0, 2.0), {"y": y[None]},
                              free_energy=True, device=CPU)
    assert np.isnan(fe.numpy()).all()
    with pytest.raises(FloatingPointError, match="NaN"):
        trx.infer_batched(
            tzoo.beta_bernoulli(2.0, 2.0), {"y": y[None]}, free_energy=True,
            free_energy_diagnostics=DefaultObjectiveDiagnosticChecks,
            device=CPU)


def test_check_objective_stops_a_host_driven_run():
    y = np.array([1.0, 0.0, 5.0, 1.0], np.float32)
    seen = []
    with pytest.raises(FloatingPointError, match="iteration 0"):
        trx.infer(tzoo.beta_bernoulli(2.0, 2.0), data={"y": y},
                  free_energy=True, iterations=3,
                  options={"check_objective": True},
                  callbacks={"after_iteration":
                             lambda ev: seen.append(ev)},
                  device=CPU)
    assert seen == []


def test_after_iteration_callbacks_see_the_free_energy():
    c = lgssm_constants()
    y = lgssm_y(1, 16, seed=1)[0]
    seen = []
    res = trx.infer(tzoo.lgssm(*c), data={"y": y}, iterations=2,
                    free_energy=True, device=CPU,
                    callbacks={"after_iteration": lambda ev: seen.append(
                        ev.payload["free_energy"])})
    np.testing.assert_allclose(seen, res.free_energy.numpy(), rtol=1e-6)


def test_an_unported_fe_branch_names_its_roadmap_item():
    """A lagged transition of a user node whose (out, in) is one cavity
    cluster, left to iterative message passing: out = in / 2 + N(0, 1),
    whose out rule probes affine Gaussian, so both packages take the affine
    custom-transition pair (ROADMAP A6f, refused here until it was ported).
    The port's free energy after every sweep equals the JAX package's, and
    at the fixed point the Kalman -log Z of the chain."""

    def register(rx):
        d = td if rx is trx else jd
        if rx is trx:
            from rxinfer_tpu_torch.rules.registry import node
        else:
            from rxinfer_tpu.rules.registry import node

        @node("HalfStepFE")
        class HalfStep:
            interfaces = ("out", "in")
            uses_cavity = True

            @staticmethod
            def message_to_out(q):
                return d.NormalMeanVariance(0.5 * q["in"].mean(),
                                            0.25 * q["in"].var() + 1.0)

            @staticmethod
            def message_to_in(q):
                return d.NormalMeanVariance(2.0 * q["out"].mean(),
                                            4.0 * (q["out"].var() + 1.0))

            @staticmethod
            def average_energy(q):
                return 0.0 * q["out"].mean()

    def lagged(rx):
        @rx.model
        def m(y):
            T = len(y)
            x = rx.latent(T, name="x")
            x[0] = rx.Normal(mean=0.0, var=1.0)
            for t in rx.plate(1, T):
                x[t] = rx.factor_node("HalfStepFE", **{"in": x[t - 1]})
            for t in rx.plate(T):
                y[t] = rx.Normal(mean=x[t], var=1.0)
            return {"x": x}
        return m

    y = np.random.default_rng(3).standard_normal((2, 6)).astype(np.float32)
    fes = []
    for rx in (trx, jrx):
        register(rx)
        d = td if rx is trx else jd
        init = {"x": d.NormalMeanVariance(*(
            (torch.tensor(0.0), torch.tensor(1.0)) if rx is trx
            else (jnp.float32(0.0), jnp.float32(1.0))))}
        with pytest.warns(UserWarning, match="chain solver"):
            _, fe = rx.infer_batched(
                lagged(rx), {"y": y}, iterations=40, initialization=init,
                free_energy=True, **(dict(device=CPU) if rx is trx else {}))
        fes.append(np.asarray(fe))
    np.testing.assert_allclose(fes[0], fes[1], **FE_TOL)
    for b in range(2):
        m, v, nlz = 0.0, 1.0, 0.0
        for t, yt in enumerate(y[b].astype(np.float64)):
            if t:
                m, v = 0.5 * m, 0.25 * v + 1.0
            s_ = v + 1.0
            nlz += 0.5 * (np.log(2 * np.pi * s_) + (yt - m) ** 2 / s_)
            m, v = m + v / s_ * (yt - m), v - v * v / s_
        np.testing.assert_allclose(fes[0][-1, b], nlz, rtol=1e-5)


def test_annotations_carry_the_free_energy_and_shared_refuses_a_chain():
    """``annotations=`` (refused until ROADMAP A4b was ported): on the LGSSM
    every posterior's (B,) log-scale is its dataset's -FE, as the JAX
    package's; ``shared=`` (refused until A7a) pools plain groups only, and
    names a chain with the JAX package's error."""
    c = lgssm_constants()
    y = lgssm_y(2, 8)
    tres = trx.infer_batched(tzoo.lgssm(*c), {"y": y}, free_energy=True,
                             annotations=trx.LogScaleAnnotations(),
                             device=CPU)
    jres = jrx.infer_batched(jzoo.lgssm(*c), {"y": y}, free_energy=True,
                             annotations=jrx.LogScaleAnnotations())
    ls = trx.getlogscale(tres.posteriors["x"])
    torch.testing.assert_close(ls, -tres.free_energy[-1], rtol=0, atol=0)
    np.testing.assert_allclose(ls.numpy(),
                               np.asarray(jrx.getlogscale(jres[0]["x"])),
                               rtol=1e-5, atol=1e-3)
    with pytest.raises(ValueError, match="is a chain block"):
        trx.infer_batched(tzoo.lgssm(*c), {"y": y}, free_energy=True,
                          shared=("x",), device=CPU)


def test_the_memory_budget_counts_the_free_energy():
    """The chunking estimate adds the pair entropy's working set per step
    with free_energy=True (the JAX version counts none)."""
    from rxinfer_tpu_torch.engine.batched import (
        FE_PAIR_FLOATS,
        batch_chunk_size,
        chain_hbm_bytes_per_element,
    )

    c = lgssm_constants()
    compiled, _ = trx.batched_program(tzoo.lgssm(*c), {"y": lgssm_y(2, 50)},
                                      device=CPU)
    plain = chain_hbm_bytes_per_element(compiled)
    with_fe = chain_hbm_bytes_per_element(compiled, free_energy=True)
    assert with_fe - plain == 50 * FE_PAIR_FLOATS * 4 * 2 * 2 * 4 * 2
    budget = 4 * plain
    assert batch_chunk_size(compiled, 4, budget) is None
    assert batch_chunk_size(compiled, 4, budget, free_energy=True) < 4

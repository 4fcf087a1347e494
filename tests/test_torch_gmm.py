"""BASELINE config 4 through both packages: the ``Dirichlet`` family
(product, natural view, entropy, E[log p]), the rules of ``Categorical``
towards ``p``, ``Dirichlet``, ``NormalMixture`` and ``MvNormalMixture`` with
their average energies, and the Gaussian mixture (``zoo.gmm`` at k = 2 and
3, the model of tests/models/test_gmm.py and the multivariate one of
tests/models/test_gmm_multivariate.py) through ``batched_program`` and
``infer``, posteriors and free energies against the JAX package's.  Inputs
come from numpy seeds; the port runs on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rxinfer_tpu as jrx
import rxinfer_tpu_torch as trx
from rxinfer_tpu import dists as jd
from rxinfer_tpu.dists import natural as jnat
from rxinfer_tpu.models import zoo as jzoo
from rxinfer_tpu.rules.registry import get_average_energy as jenergy
from rxinfer_tpu.rules.registry import get_message_rule as jrule
from rxinfer_tpu_torch import convert
from rxinfer_tpu_torch import dists as td
from rxinfer_tpu_torch.dists import natural as tnat
from rxinfer_tpu_torch.models import zoo as tzoo
from rxinfer_tpu_torch.rules.registry import get_average_energy as tenergy
from rxinfer_tpu_torch.rules.registry import get_message_rule as trule

CPU = torch.device("cpu")
# one float32 expression in each library
RULE_TOL = dict(rtol=1e-5, atol=1e-5)
# the program after one sweep, and the FE trace after ten (relative)
ONE_SWEEP_TOL = dict(rtol=1e-5, atol=1e-5)
TEN_SWEEP_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _leaves(d):
    if isinstance(d, torch.Tensor):
        return [d.numpy()]
    return [getattr(d, f).numpy() for f in d.__dataclass_fields__]


def _jleaves(d):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(d)]


def _assert_same(jval, tval, tol=RULE_TOL):
    assert type(jval).__name__ == type(tval).__name__
    for a, b in zip(_jleaves(jval), _leaves(tval), strict=True):
        np.testing.assert_allclose(b, a, **tol)


def _pair(family, *params):
    """The same distribution in both packages from numpy parameters."""
    jcls = getattr(jd, family)
    return (jcls(*[jnp.asarray(np.float32(p)) for p in params]),
            convert.dist_from_numpy(family, params))


# -- the Dirichlet family ---------------------------------------------------------

def _alphas(seed, shape=(4, 3)):
    return np.random.default_rng(seed).uniform(0.3, 6.0, shape).astype(
        np.float32)


@pytest.mark.parametrize("stat", ["mean", "var", "mean_log", "entropy"])
def test_dirichlet_statistics_match_jax(stat):
    a = _alphas(0)
    jdist, tdist = _pair("Dirichlet", a)
    np.testing.assert_allclose(getattr(tdist, stat)().numpy(),
                               np.asarray(getattr(jdist, stat)()), **RULE_TOL)


def test_dirichlet_product_and_natural_view_match_jax():
    a, b = _alphas(1), _alphas(2)
    (j1, t1), (j2, t2) = _pair("Dirichlet", a), _pair("Dirichlet", b)
    _assert_same(jd.prod(j1, j2), td.prod(t1, t2))
    assert tnat.family_key(t1) == jnat.family_key(j1) == "dirichlet"
    assert tnat.NAT_EVENT_RANKS["dirichlet"] == jnat.NAT_EVENT_RANKS[
        "dirichlet"]
    for x, y in zip(tnat.to_natural(t1), jnat.to_natural(j1), strict=True):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), **RULE_TOL)
    _assert_same(jnat.prod_all([j1, j2]), tnat.prod_all([t1, t2]))
    # a plate of messages reduced and padded, with and without a batch axis
    _assert_same(jnat.prod_reduce(j1, 4), tnat.prod_reduce(t1, 4))
    batched = td.Dirichlet(torch.as_tensor(np.stack([a, b])))
    red = tnat.prod_reduce(batched, 4, batch_ndim=1)
    for i, jx in enumerate((j1, j2)):
        np.testing.assert_allclose(red.alpha[i].numpy(),
                                   np.asarray(jnat.prod_reduce(jx, 4).alpha),
                                   **RULE_TOL)
    _assert_same(jnat.pad_plate(j1, 1, 5, 7), tnat.pad_plate(t1, 1, 5, 7))


def test_dirichlet_expectations_and_vague_match_jax():
    from rxinfer_tpu.rules.expectations import e_log as je_log
    from rxinfer_tpu_torch.rules.expectations import e_log as te_log

    jdist, tdist = _pair("Dirichlet", _alphas(3))
    np.testing.assert_allclose(te_log(tdist).numpy(),
                               np.asarray(je_log(jdist)), **RULE_TOL)
    _assert_same(jd.Dirichlet.vague(5), td.Dirichlet.vague(5))
    # outside a model the DSL constructor is the distribution
    d = trx.Dirichlet(np.ones(3, np.float32))
    assert isinstance(d, td.Dirichlet) and d.alpha.shape == (3,)


# -- the rules --------------------------------------------------------------------

def _scalar_mixture_q(seed, n=7, k=3):
    rng = np.random.default_rng(seed)
    pairs = {
        "out": _pair("PointMass", rng.standard_normal(n)),
        "switch": _pair("Categorical", rng.standard_normal((n, k))),
    }
    for i in range(k):
        pairs[f"mean{i}"] = _pair("NormalMeanVariance",
                                  rng.standard_normal(),
                                  rng.uniform(0.1, 2.0))
        pairs[f"prec{i}"] = _pair("GammaShapeRate", rng.uniform(1.0, 5.0),
                                  rng.uniform(0.5, 3.0))
    return pairs


def _mv_mixture_q(seed, n=6, k=2, d=3):
    rng = np.random.default_rng(seed)
    pairs = {
        "out": _pair("PointMass", rng.standard_normal((n, d))),
        "switch": _pair("Categorical", rng.standard_normal((n, k))),
    }
    for i in range(k):
        l = rng.standard_normal((d, d))
        pairs[f"mean{i}"] = _pair("MvNormalMeanCovariance",
                                  rng.standard_normal(d),
                                  l @ l.T + 0.5 * np.eye(d))
        s = rng.standard_normal((d, d))
        pairs[f"prec{i}"] = _pair("Wishart", rng.uniform(d + 1.0, d + 6.0),
                                  0.2 * (s @ s.T) + 0.3 * np.eye(d))
    return pairs


def _categorical_q(seed):
    rng = np.random.default_rng(seed)
    return {"out": _pair("Categorical", rng.standard_normal((5, 4))),
            "p": _pair("Dirichlet", _alphas(seed, (4,)))}


def _dirichlet_q(seed):
    return {"out": _pair("Dirichlet", _alphas(seed, (4,))),
            "alpha": _pair("PointMass", _alphas(seed + 1, (4,)))}


_RULES = [
    ("Categorical", "p", _categorical_q),
    ("Dirichlet", "out", _dirichlet_q),
    ("NormalMixture", "out", _scalar_mixture_q),
    ("NormalMixture", "switch", _scalar_mixture_q),
    ("NormalMixture", "mean0", _scalar_mixture_q),
    ("NormalMixture", "mean2", _scalar_mixture_q),
    ("NormalMixture", "prec1", _scalar_mixture_q),
    ("MvNormalMixture", "out", _mv_mixture_q),
    ("MvNormalMixture", "switch", _mv_mixture_q),
    ("MvNormalMixture", "mean1", _mv_mixture_q),
    ("MvNormalMixture", "prec0", _mv_mixture_q),
]


@pytest.mark.parametrize("fform,iface,make_q", _RULES,
                         ids=[f"{f}-{i}" for f, i, _ in _RULES])
def test_rules_match_jax(fform, iface, make_q):
    pairs = make_q(11)
    jq = {k: v[0] for k, v in pairs.items() if k != iface}
    tq = {k: v[1] for k, v in pairs.items() if k != iface}
    _assert_same(jrule(fform, iface)(jq), trule(fform, iface)(tq))


@pytest.mark.parametrize("fform,make_q", [
    ("Categorical", _categorical_q), ("Dirichlet", _dirichlet_q),
    ("NormalMixture", _scalar_mixture_q), ("MvNormalMixture", _mv_mixture_q)])
def test_average_energies_match_jax(fform, make_q):
    pairs = make_q(12)
    got = tenergy(fform)({k: v[1] for k, v in pairs.items()})
    want = jenergy(fform)({k: v[0] for k, v in pairs.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **RULE_TOL)


def test_component_interfaces_resolve_by_index():
    """``mean{i}`` / ``prec{i}`` resolve for any i; other names do not."""
    from rxinfer_tpu_torch.rules.registry import RuleNotFoundError

    pairs = _scalar_mixture_q(13, k=3)
    tq = {k: v[1] for k, v in pairs.items() if k != "prec2"}
    msg = trule("NormalMixture", "prec2")(tq)
    assert isinstance(msg, td.GammaShapeRate)
    with pytest.raises(RuleNotFoundError, match="means"):
        trule("NormalMixture", "means")


# -- the models -------------------------------------------------------------------

def _gmm_data(b, n, seed):
    rng = np.random.default_rng(seed)
    comp = rng.uniform(size=(b, n)) < 0.4
    return np.where(comp, 4.0 + 0.5 * rng.standard_normal((b, n)),
                    -1.0 + 0.7 * rng.standard_normal((b, n))).astype(
        np.float32)


def _gmm_init(pkg, dists, k):
    """bench.py:493-499's initialization, for k components."""
    t = ((lambda v: np.float32(v)) if pkg is jrx
         else (lambda v: torch.tensor(v, dtype=torch.float32)))
    out = {"pi": pkg.Dirichlet(np.ones(k, np.float32))}
    for i, loc in enumerate(np.linspace(-2.0, 2.0, k)):
        out[f"m{i}"] = dists.NormalMeanVariance(t(loc), t(10.0))
        out[f"w{i}"] = dists.GammaShapeRate(t(1.0), t(1.0))
    return out


def _compare_states(jstate, tstate, names, tol):
    for name in names:
        _assert_same(jstate[name], tstate[name], tol)


@pytest.mark.parametrize("k", [2, 3])
def test_batched_gmm_matches_jax(k):
    y = _gmm_data(3, 40, seed=k)
    locs = list(np.linspace(-2.0, 2.0, k))
    names = ["pi", "z"] + [f"{p}{i}" for i in range(k) for p in "mw"]
    for iterations in (1, 10):
        _, jprog = jrx.batched_program(
            jzoo.gmm(k, locs), {"y": y}, iterations=iterations,
            free_energy=True, initialization=_gmm_init(jrx, jd, k))
        tcomp, tprog = trx.batched_program(
            tzoo.gmm(k, locs), {"y": y}, iterations=iterations,
            free_energy=True, initialization=_gmm_init(trx, td, k),
            device=CPU)
        jstate, jfe, _ = jprog({"y": y})
        tstate, tfe, _ = tprog({"y": y})
        assert tcomp.sweep[0] == "z"
        jfe = np.asarray(jfe)
        if iterations == 1:
            _compare_states(jstate, tstate, names, ONE_SWEEP_TOL)
            np.testing.assert_allclose(tfe.numpy(), jfe, **ONE_SWEEP_TOL)
        else:
            _compare_states(jstate, tstate, names,
                            dict(rtol=TEN_SWEEP_RTOL, atol=1e-4))
            np.testing.assert_allclose(tfe.numpy(), jfe, rtol=TEN_SWEEP_RTOL)
            # VMP on a conjugate model: the free energy does not increase
            assert (np.diff(tfe.numpy(), axis=0)
                    <= 1e-5 * np.abs(tfe.numpy()[:-1])).all()


def _gmm_model(rx, k=2):
    """The model of tests/models/test_gmm.py, in either package."""
    @rx.model
    def gmm(y):
        n = len(y)
        pi = rx.Dirichlet(np.ones(k, dtype=np.float32))
        m0 = rx.Normal(mean=-2.0, var=100.0)
        m1 = rx.Normal(mean=2.0, var=100.0)
        w0 = rx.Gamma(shape=0.01, rate=0.01)
        w1 = rx.Gamma(shape=0.01, rate=0.01)
        z = rx.latent(n, name="z")
        for i in rx.plate(n):
            z[i] = rx.Categorical(pi)
            y[i] = rx.NormalMixture(z[i], (m0, m1), (w0, w1))
        return {"pi": pi, "m0": m0, "m1": m1, "w0": w0, "w1": w1}

    return gmm


def test_infer_gmm_matches_jax():
    y = _gmm_data(1, 120, seed=5)[0]
    jres = jrx.infer(_gmm_model(jrx), data={"y": y}, iterations=12,
                     initialization=_gmm_init(jrx, jd, 2), free_energy=True,
                     returnvars=jrx.KeepLast())
    tres = trx.infer(_gmm_model(trx), data={"y": y}, iterations=12,
                     initialization=_gmm_init(trx, td, 2), free_energy=True,
                     returnvars=trx.KeepLast(), device=CPU)
    assert set(tres.posteriors) == set(jres.posteriors)
    for name in tres.posteriors:
        _assert_same(jres.posteriors[name], tres.posteriors[name],
                     dict(rtol=TEN_SWEEP_RTOL, atol=1e-4))
    np.testing.assert_allclose(tres.free_energy.numpy(),
                               np.asarray(jres.free_energy),
                               rtol=TEN_SWEEP_RTOL)
    means = sorted(float(tres.posteriors[m].mean()) for m in ("m0", "m1"))
    assert abs(means[0] + 1.0) < 0.3 and abs(means[1] - 4.0) < 0.3


def _mv_gmm_model(rx):
    """The model of tests/models/test_gmm_multivariate.py."""
    @rx.model
    def mv_gmm(y):
        n = len(y)
        pi = rx.Dirichlet(np.ones(2, dtype=np.float32))
        m0 = rx.MvNormal(mean=np.array([-1.0, -1.0], np.float32),
                         cov=1e2 * np.eye(2, dtype=np.float32))
        m1 = rx.MvNormal(mean=np.array([1.0, 1.0], np.float32),
                         cov=1e2 * np.eye(2, dtype=np.float32))
        w0 = rx.Wishart(3.0, 1e1 * np.eye(2, dtype=np.float32))
        w1 = rx.Wishart(3.0, 1e1 * np.eye(2, dtype=np.float32))
        z = rx.latent(n, name="z")
        for i in rx.plate(n):
            z[i] = rx.Categorical(pi)
            y[i] = rx.NormalMixture(z[i], (m0, m1), (w0, w1))
        return {"pi": pi, "m0": m0, "m1": m1, "w0": w0, "w1": w1, "z": z}

    return mv_gmm


def _mv_gmm_init(pkg, dists):
    t = ((lambda a: np.asarray(a, np.float32)) if pkg is jrx
         else (lambda a: torch.as_tensor(np.asarray(a, np.float32))))
    eye = np.eye(2)
    return {
        "m0": dists.MvNormalMeanCovariance(t([-1.0, -1.0]), t(10.0 * eye)),
        "m1": dists.MvNormalMeanCovariance(t([1.0, 1.0]), t(10.0 * eye)),
        "w0": (jd.Wishart if pkg is jrx else pkg.Wishart)(t(3.0), t(eye)),
        "w1": (jd.Wishart if pkg is jrx else pkg.Wishart)(t(3.0), t(eye)),
        "pi": pkg.Dirichlet(np.ones(2, np.float32)),
    }


def _mv_gmm_data(n, seed):
    rng = np.random.default_rng(seed)
    comp = rng.uniform(size=n) < 0.45
    return np.where(
        comp[:, None],
        rng.multivariate_normal([3.0, 2.0], [[0.6, -0.15], [-0.15, 0.3]], n),
        rng.multivariate_normal([-3.0, -3.0], [[0.5, 0.1], [0.1, 0.4]], n),
    ).astype(np.float32)


def test_multivariate_gmm_matches_jax():
    y = _mv_gmm_data(60, seed=7)
    kw = dict(data={"y": y}, iterations=8, free_energy=True)
    jres = jrx.infer(_mv_gmm_model(jrx), returnvars=jrx.KeepLast(),
                     initialization=_mv_gmm_init(jrx, jd), **kw)
    tres = trx.infer(_mv_gmm_model(trx), returnvars=trx.KeepLast(),
                     initialization=_mv_gmm_init(trx, td), device=CPU, **kw)
    assert tres.model.graph.factors[-1].fform == "MvNormalMixture"
    for name in ("pi", "m0", "m1", "w0", "w1", "z"):
        _assert_same(jres.posteriors[name], tres.posteriors[name],
                     dict(rtol=TEN_SWEEP_RTOL, atol=1e-4))
    np.testing.assert_allclose(tres.free_energy.numpy(),
                               np.asarray(jres.free_energy),
                               rtol=TEN_SWEEP_RTOL)

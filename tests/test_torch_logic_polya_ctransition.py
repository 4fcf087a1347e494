"""The logic, Polya and continuous-transition nodes (ROADMAP A6e), ``tie``,
and the affine custom-transition pair of the free energy (A6f) through both
packages: each rule module's messages and average energies against the JAX
functions on the same marginals, and the models of
``tests/models/test_polya.py``, ``test_ctransition.py``,
``test_boolean_custom.py``, ``test_reference_conformance.py``
(``test_aliases_binary_reference_fe``),
``tests/inference/test_unfactorized_data.py`` and
``test_custom_transition_chain.py`` on ``infer`` (the port on the CPU),
with their closed forms and a batched run each.  Inputs come from numpy
seeds."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import expit

import rxinfer_tpu as jrx
import rxinfer_tpu_torch as trx
from rxinfer_tpu import dists as jd
from rxinfer_tpu.rules.registry import call_rule as jcall
from rxinfer_tpu.rules.registry import get_node as jnode
from rxinfer_tpu.rules.registry import node as jreg
from rxinfer_tpu_torch import dists as td
from rxinfer_tpu_torch.rules.registry import call_rule as tcall
from rxinfer_tpu_torch.rules.registry import get_node as tnode
from rxinfer_tpu_torch.rules.registry import node as treg

# one float32 closed-form expression in each library
RULE_TOL = dict(rtol=1e-5, atol=1e-6)
# a whole model's posteriors and free energy
TOL = dict(rtol=1e-5, atol=1e-6)
# the Polya models after their 30 sweeps (float32 tanh / log1p(exp) in each
# library's order, fed back through every sweep)
POLYA_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _f32(x):
    return np.asarray(x, np.float32)


def both(family, *params):
    return (getattr(td, family)(*[torch.as_tensor(_f32(p)) for p in params]),
            getattr(jd, family)(*[jnp.asarray(_f32(p)) for p in params]))


def pm(x):
    return both("PointMass", x)


def close(t, j, **tol):
    np.testing.assert_allclose(np.asarray(t.detach()), np.asarray(j),
                               **(tol or RULE_TOL))


def same_msg(t, j, **tol):
    assert type(t).__name__ == type(j).__name__
    for name in t.__dataclass_fields__:
        close(getattr(t, name), getattr(j, name), **tol)


def _spd(rng, lead, d, scale=1.0):
    a = rng.standard_normal(lead + (d, d))
    return _f32(scale * (a @ np.swapaxes(a, -1, -2) / d + np.eye(d)))


def kw(rx):
    return dict(device="cpu") if rx is trx else {}


# -- rules/boolean.py --------------------------------------------------------------------

@pytest.mark.parametrize("fform", ["OR", "AND", "IMPLY"])
def test_truth_table_rules_match_jax(fform):
    rng = np.random.default_rng(0)
    p = {k: rng.uniform(0.02, 0.98, size=(5,)) for k in ("out", "in1", "in2")}
    qt = {k: both("Bernoulli", v)[0] for k, v in p.items()}
    qj = {k: both("Bernoulli", v)[1] for k, v in p.items()}
    for iface in ("out", "in1", "in2"):
        rest_t = {k: v for k, v in qt.items() if k != iface}
        rest_j = {k: v for k, v in qj.items() if k != iface}
        same_msg(tcall(fform, iface, **rest_t), jcall(fform, iface, **rest_j))
    close(tnode(fform).bethe_term(qt), jnode(fform).bethe_term(qj))
    assert tnode(fform).uses_cavity and jnode(fform).uses_cavity


def test_not_rules_match_jax():
    rng = np.random.default_rng(1)
    po, pi = rng.uniform(0.02, 0.98, size=(2, 6))
    qt = {"out": both("Bernoulli", po)[0], "in": both("Bernoulli", pi)[0]}
    qj = {"out": both("Bernoulli", po)[1], "in": both("Bernoulli", pi)[1]}
    same_msg(tcall("NOT", "out", **{"in": qt["in"]}),
             jcall("NOT", "out", **{"in": qj["in"]}))
    same_msg(tcall("NOT", "in", out=qt["out"]),
             jcall("NOT", "in", out=qj["out"]))
    close(tnode("NOT").bethe_term(qt), jnode("NOT").bethe_term(qj))


@pytest.mark.parametrize("fform", ["OR", "AND", "IMPLY", "NOT"])
def test_logic_bethe_term_is_the_negative_joint_entropy(fform):
    """Against float64 enumeration of the joint q(out, in...) proportional
    to the truth table times the three Bernoulli messages."""
    rng = np.random.default_rng(2)
    names = ("out", "in") if fform == "NOT" else ("out", "in1", "in2")
    p = {k: rng.uniform(0.05, 0.95, size=(4,)) for k in names}
    ops = {"OR": lambda a, b: a or b, "AND": lambda a, b: a and b,
           "IMPLY": lambda a, b: (not a) or b}
    rows = ([(int(not a), a) for a in (0, 1)] if fform == "NOT" else
            [(int(ops[fform](a, b)), a, b) for a in (0, 1) for b in (0, 1)])
    w = lambda k, s: p[k] if s else 1.0 - p[k]
    joint = np.stack([np.prod([w(k, s) for k, s in zip(names, r)], axis=0)
                      for r in rows])
    joint /= joint.sum(axis=0)
    neg_h = (joint * np.log(joint)).sum(axis=0)
    q = {k: both("Bernoulli", v)[0] for k, v in p.items()}
    close(tnode(fform).bethe_term(q), neg_h, rtol=1e-5, atol=1e-6)


# -- rules/polya.py ----------------------------------------------------------------------

def _polya_q(rng, p=6, d=3, multi=False):
    x = rng.standard_normal((p, d))
    x[0] = 0.0                        # c -> 0: the n / 4 limit
    n = 20.0
    y = rng.integers(0, 21, size=(p,)).astype(np.float64)
    out = np.stack([y, n - y], -1) if multi else y
    m = rng.standard_normal(d)
    qs = {"out": pm(out), "x": pm(x), "n": pm(n),
          "beta": both("MvNormalMeanCovariance", m, _spd(rng, (), d, 0.3))}
    return ({k: v[0] for k, v in qs.items()}, {k: v[1] for k, v in qs.items()})


@pytest.mark.parametrize("fform", ["BinomialPolya", "MultinomialPolya"])
def test_polya_rules_match_jax(fform):
    qt, qj = _polya_q(np.random.default_rng(3), multi=fform != "BinomialPolya")
    same_msg(tcall(fform, "beta", **qt), jcall(fform, "beta", **qj))
    close(tcall(fform, "average_energy", **qt),
          jcall(fform, "average_energy", **qj))


def test_polya_e_omega_limit_and_bound():
    """E[omega] at c -> 0 is n / 4, and the Polya-Gamma bound lies below
    the exact expected Bernoulli-logit log-likelihood only by the Jensen
    gap: at a point-mass beta it is exact for the augmented form."""
    from rxinfer_tpu_torch.rules.polya import _e_omega

    c = torch.tensor([0.0, 1e-5, 0.5, 3.0])
    om = _e_omega(torch.tensor(20.0), c)
    assert float(om[0]) == float(om[1]) == 5.0
    np.testing.assert_allclose(om[2:].numpy(),
                               20.0 / (2 * c[2:].numpy())
                               * np.tanh(c[2:].numpy() / 2), rtol=1e-6)
    # at beta known exactly the bound equals -log Binomial(y | n, sigmoid)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((5, 3))
    beta = rng.standard_normal(3)
    y = rng.integers(0, 21, size=5)
    q = {"out": pm(y)[0], "x": pm(x)[0], "n": pm(20.0)[0],
         "beta": both("MvNormalMeanCovariance", beta,
                      1e-12 * np.eye(3))[0]}
    ae = tcall("BinomialPolya", "average_energy", **q).numpy()
    from scipy.stats import binom

    exact = -binom.logpmf(y, 20, expit(x @ beta))
    np.testing.assert_allclose(ae, exact, rtol=2e-4, atol=2e-4)


# -- rules/ctransition.py ----------------------------------------------------------------

@pytest.mark.parametrize("prec", ["point", "wishart"])
@pytest.mark.parametrize("joint", [False, True])
def test_ctransition_rules_match_jax(prec, joint):
    rng = np.random.default_rng(5)
    p, dy, dx = 4, 2, 3
    qs = {"out": both("MvNormalMeanCovariance", rng.standard_normal((p, dy)),
                      _spd(rng, (p,), dy, 0.2)),
          "in": both("MvNormalMeanCovariance", rng.standard_normal((p, dx)),
                     _spd(rng, (p,), dx, 0.3)),
          "theta": both("MvNormalMeanCovariance",
                        rng.standard_normal(dy * dx),
                        _spd(rng, (), dy * dx, 0.1))}
    qs["prec"] = (pm(_spd(rng, (), dy, 4.0)) if prec == "point" else
                  both("Wishart", 5.0, _spd(rng, (), dy, 0.5)))
    qt = {k: v[0] for k, v in qs.items()}
    qj = {k: v[1] for k, v in qs.items()}
    if joint:
        cr = _f32(0.05 * rng.standard_normal((p, dy, dx)))
        qt["joint"], qj["joint"] = torch.as_tensor(cr), jnp.asarray(cr)
    for iface in ("theta", "prec"):
        rest_t = {k: v for k, v in qt.items() if k != iface}
        rest_j = {k: v for k, v in qj.items() if k != iface}
        t = tcall("ContinuousTransition", iface, **rest_t)
        j = jcall("ContinuousTransition", iface, **rest_j)
        same_msg(t, j, rtol=2e-5, atol=2e-5)
    # the rules towards out and in read the dimensions from both marginals
    # (``_dims``), so both packages take them with every interface given
    for iface in ("out", "in"):
        same_msg(tcall("ContinuousTransition", iface, **qt),
                 jcall("ContinuousTransition", iface, **qj),
                 rtol=2e-5, atol=2e-5)
    close(tcall("ContinuousTransition", "average_energy", **qt),
          jcall("ContinuousTransition", "average_energy", **qj),
          rtol=2e-5, atol=2e-5)


# -- the models ----------------------------------------------------------------------

def run_both(source, data, init=None, **kws):
    out = []
    for rx in (trx, jrx):
        out.append(rx.infer(model=source(rx), data=data,
                            returnvars=rx.KeepLast(),
                            initialization=init(rx) if init else None,
                            **kws, **kw(rx)))
    return out


def same(t, j, names, stats=("mean", "var"), tol=TOL, fe_from=0):
    for name in names:
        for stat in stats:
            np.testing.assert_allclose(
                np.asarray(getattr(t.posteriors[name], stat)()),
                np.asarray(getattr(j.posteriors[name], stat)()), **tol)
    if j.free_energy is not None:
        np.testing.assert_allclose(np.asarray(t.free_energy)[fe_from:],
                                   np.asarray(j.free_energy)[fe_from:], **tol)


def _mvn(rx, m, c):
    d = td if rx is trx else jd
    conv = (lambda a: torch.as_tensor(_f32(a))) if rx is trx else \
        (lambda a: jnp.asarray(_f32(a)))
    return d.MvNormalMeanCovariance(conv(m), conv(c))


def _logreg(n_obs, d, trials, fform="BinomialPolya"):
    def source(rx):
        @rx.model
        def logreg(x, y):
            beta = rx.MvNormal(mean=np.zeros(d, np.float32),
                               cov=10.0 * np.eye(d, dtype=np.float32))
            for i in rx.plate(n_obs):
                y[i] = getattr(rx, fform)(x[i], float(trials), beta)
            return {"beta": beta}
        return logreg
    return source


def _polya_data(rng, n_obs, d, trials, lead=()):
    beta_true = np.array([1.2, -0.8, 0.4])[:d]
    x = rng.standard_normal(lead + (n_obs, d)).astype(np.float32)
    y = rng.binomial(trials, expit(x @ beta_true)).astype(np.float32)
    return x, y, beta_true


def test_binomial_polya_logistic_regression():
    rng = np.random.default_rng(0)
    n_obs, d, trials = 400, 3, 20
    x, y, beta_true = _polya_data(rng, n_obs, d, trials)
    init = lambda rx: {"beta": _mvn(rx, np.zeros(d), np.eye(d))}
    t, j = run_both(_logreg(n_obs, d, trials), {"x": x, "y": y}, init=init,
                    iterations=30, free_energy=True)
    same(t, j, ["beta"], stats=("mean", "cov"), tol=POLYA_TOL)
    np.testing.assert_allclose(t.posteriors["beta"].mean().numpy(),
                               beta_true, atol=0.15)
    fe = t.free_energy.numpy()
    assert np.isfinite(fe).all()
    assert (np.diff(fe) <= 5e-5 * np.abs(fe[:-1]) + 1e-3).all(), fe


def test_polya_regressions_batched_match_jax():
    """``infer_batched`` of both packages: BinomialPolya over three
    datasets and the two-class MultinomialPolya over two."""
    rng = np.random.default_rng(8)
    n_obs, d, trials = 60, 3, 20
    for fform, b in (("BinomialPolya", 3), ("MultinomialPolya", 2)):
        x, y, _ = _polya_data(rng, n_obs, d, trials, lead=(b,))
        if fform == "MultinomialPolya":
            y = np.stack([y, trials - y], -1).astype(np.float32)
        out = []
        for rx in (trx, jrx):
            out.append(rx.infer_batched(
                _logreg(n_obs, d, trials, fform)(rx), {"x": x, "y": y},
                iterations=30, free_energy=True,
                initialization={"beta": _mvn(rx, np.zeros(d), np.eye(d))},
                **kw(rx)))
        (tp, tfe), (jp, jfe) = out
        for stat in ("mean", "cov"):
            np.testing.assert_allclose(
                getattr(tp["beta"], stat)().numpy(),
                np.asarray(getattr(jp["beta"], stat)()), **POLYA_TOL)
        np.testing.assert_allclose(tfe.numpy(), np.asarray(jfe), **POLYA_TOL)


def _ct_model(n, dy, dx, w=None):
    def source(rx):
        @rx.model
        def m(x, y):
            theta = rx.MvNormal(mean=np.zeros(dy * dx, np.float32),
                                cov=10.0 * np.eye(dy * dx, dtype=np.float32))
            prec = (w if w is not None else
                    rx.Wishart(dy + 2.0, np.eye(dy, dtype=np.float32)))
            for i in rx.plate(n):
                y[i] = rx.ContinuousTransition(x[i], theta, prec)
            return {"theta": theta} if w is not None else {
                "theta": theta, "prec": prec}
        return m
    return source


def test_learn_emission_operator():
    rng = np.random.default_rng(0)
    dy, dx, n = 2, 3, 400
    a_true = rng.standard_normal((dy, dx)).astype(np.float32)
    x = rng.standard_normal((n, dx)).astype(np.float32)
    y = (x @ a_true.T + 0.1 * rng.standard_normal((n, dy))).astype(np.float32)
    w = np.float32(np.eye(dy) / 0.01)
    init = lambda rx: {"theta": _mvn(rx, np.zeros(dy * dx), np.eye(dy * dx))}
    t, j = run_both(_ct_model(n, dy, dx, w), {"x": x, "y": y}, init=init,
                    iterations=5, free_energy=True)
    same(t, j, ["theta"], stats=("mean", "cov"))
    np.testing.assert_allclose(
        t.posteriors["theta"].mean().numpy().reshape(dy, dx), a_true,
        atol=0.05)


def test_ctransition_random_precision_batched_matches_jax():
    """``prec ~ Wishart(dy + 2, I)`` over a batch of two: both packages'
    ``infer_batched``, theta and prec after every sweep's FE."""
    rng = np.random.default_rng(9)
    dy, dx, n, b = 2, 3, 50, 2
    a_true = rng.standard_normal((dy, dx))
    x = rng.standard_normal((b, n, dx)).astype(np.float32)
    y = (x @ a_true.T + 0.3 * rng.standard_normal((b, n, dy))).astype(
        np.float32)
    out = []
    for rx in (trx, jrx):
        d = td if rx is trx else jd
        conv = torch.as_tensor if rx is trx else jnp.asarray
        init = {"theta": _mvn(rx, np.zeros(dy * dx), np.eye(dy * dx)),
                "prec": d.Wishart(conv(_f32(dy + 2.0)),
                                  conv(np.eye(dy, dtype=np.float32)))}
        out.append(rx.infer_batched(_ct_model(n, dy, dx)(rx),
                                    {"x": x, "y": y}, iterations=6,
                                    initialization=init, free_energy=True,
                                    **kw(rx)))
    (tp, tfe), (jp, jfe) = out
    for name in ("theta", "prec"):
        np.testing.assert_allclose(tp[name].mean().numpy(),
                                   np.asarray(jp[name].mean()), rtol=2e-5,
                                   atol=2e-5)
    np.testing.assert_allclose(tfe.numpy(), np.asarray(jfe), rtol=2e-5)


def _hard_or(rx):
    @rx.model
    def hard_or(y):
        a = rx.Bernoulli(0.3)
        b = rx.Bernoulli(0.1)
        y.observe(rx.OR(a, b))
        return {"a": a, "b": b}
    return hard_or


def _bern(rx, p):
    return (td.Bernoulli(torch.tensor(p)) if rx is trx
            else jd.Bernoulli(jnp.float32(p)))


def test_noisy_or_inference():
    init = lambda rx: {"a": _bern(rx, 0.3), "b": _bern(rx, 0.1)}
    t, j = run_both(_hard_or, {"y": np.asarray(1.0, np.float32)}, init=init,
                    iterations=10, free_energy=True)
    same(t, j, ["a", "b"])
    p_c = 1 - 0.7 * 0.9
    np.testing.assert_allclose(float(t.posteriors["a"].mean()), 0.3 / p_c,
                               rtol=1e-5)
    np.testing.assert_allclose(float(t.posteriors["b"].mean()), 0.1 / p_c,
                               rtol=1e-5)
    # a tree: Bethe is exact, FE = -log P(y = 1)
    np.testing.assert_allclose(float(t.free_energy[-1]), -np.log(p_c),
                               rtol=1e-5)


def test_noisy_or_batched_over_both_outcomes():
    """y in {0, 1} over a batch: each dataset's posterior and -log Z
    against float64 enumeration."""
    y = np.asarray([1.0, 0.0, 1.0], np.float32)
    post, fe = trx.infer_batched(
        _hard_or(trx), {"y": y}, iterations=10, free_energy=True,
        initialization={"a": _bern(trx, 0.3), "b": _bern(trx, 0.1)},
        device="cpu")
    pa, pb = 0.3, 0.1
    joint = {(a, b): (pa if a else 1 - pa) * (pb if b else 1 - pb)
             for a in (0, 1) for b in (0, 1)}
    for k, yk in enumerate(y):
        z = sum(v for (a, b), v in joint.items() if int(a or b) == yk)
        qa = sum(v for (a, b), v in joint.items()
                 if int(a or b) == yk and a) / z
        np.testing.assert_allclose(float(post["a"].mean()[k]), qa, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(float(fe[-1, k]), -np.log(z), rtol=1e-5)


def _noisy_coin(rx):
    lib = torch if rx is trx else jnp
    d = td if rx is trx else jd
    reg = treg if rx is trx else jreg
    from rxinfer_tpu.rules.expectations import e_mean as je
    from rxinfer_tpu_torch.rules.expectations import e_mean as te
    e_mean = te if rx is trx else je

    @reg("NoisyCoinT")
    class NoisyCoinNode:
        interfaces = ("out", "p")
        needs_self_marginal = True

        @staticmethod
        def message_to_out(q):
            p = e_mean(q["p"])
            return d.Bernoulli(0.1 * (1 - p) + 0.9 * p)

        @staticmethod
        def message_to_p(q):
            y = e_mean(q["out"])
            p = e_mean(q["p"])
            heads = (y * (0.9 * p) / (0.9 * p + 0.1 * (1 - p))
                     + (1 - y) * (0.1 * p) / (0.1 * p + 0.9 * (1 - p)))
            return d.Beta(1.0 + heads, 2.0 - heads)

        @staticmethod
        def average_energy(q):
            p = e_mean(q["p"])
            y = e_mean(q["out"])
            eff = 0.1 * (1 - p) + 0.9 * p
            return -(y * lib.log(eff) + (1 - y) * lib.log(1 - eff))

    @rx.model
    def coin2(y):
        theta = rx.Beta(2.0, 2.0)
        for i in rx.plate(len(y)):
            y[i] = rx.factor_node("NoisyCoinT", p=theta)
        return {"theta": theta}
    return coin2


def test_custom_node_extension():
    rng = np.random.default_rng(0)
    eff = 0.1 * 0.2 + 0.9 * 0.8
    y = (rng.uniform(size=300) < eff).astype(np.float32)

    def init(rx):
        d = td if rx is trx else jd
        conv = torch.tensor if rx is trx else jnp.float32
        return {"theta": d.Beta(conv(2.0), conv(2.0))}

    t, j = run_both(_noisy_coin, {"y": y}, init=init, iterations=10,
                    free_energy=True)
    same(t, j, ["theta"])
    assert abs(float(t.posteriors["theta"].mean()) - 0.8) < 0.12


def _aliases(rx):
    @rx.model
    def binary_aliases(y):
        x1 = rx.Bernoulli(0.5)
        x2 = rx.Bernoulli(0.5)
        x3 = rx.Bernoulli(0.5)
        x4 = rx.Bernoulli(0.5)
        x = rx.IMPLY(x1, rx.AND(x2, rx.OR(x3, rx.NOT(x4))))
        rx.tie(x, rx.Bernoulli(y))
        return {"x1": x1, "x2": x2, "x3": x3, "x4": x4, "x": x}
    return binary_aliases


def _alias_enumeration(y):
    """float64 marginals of x1..x4, x and -log Z of the alias tree with
    the evidence factor Bernoulli(x; y)."""
    z, marg = 0.0, np.zeros(5)
    for s in range(16):
        x1, x2, x3, x4 = [(s >> k) & 1 for k in range(4)]
        x = int((not x1) or (x2 and (x3 or not x4)))
        w = 0.5 ** 4 * (y if x else 1.0 - y)
        z += w
        marg += w * np.array([x1, x2, x3, x4, x])
    return marg / z, -np.log(z)


def test_aliases_binary_reference_fe():
    init = lambda rx: {k: _bern(rx, 0.5) for k in ("x1", "x2", "x3", "x4",
                                                   "x")}
    t, j = run_both(_aliases, {"y": np.asarray(0.5, np.float32)}, init=init,
                    iterations=100, free_energy=True)
    names = ["x1", "x2", "x3", "x4", "x"]
    same(t, j, names)
    fe = t.free_energy.numpy().astype(np.float64)
    assert abs(fe[-1] - 0.6931471805599454) < 1e-5
    assert abs(fe[0] - fe[-1]) < 1e-5
    marg, nlz = _alias_enumeration(0.5)
    for k, name in enumerate(names):
        np.testing.assert_allclose(float(t.posteriors[name].mean()), marg[k],
                                   rtol=1e-5)
    assert abs(fe[-1] - nlz) < 1e-5


def test_aliases_batched_over_soft_evidence():
    """The fault tree with y per dataset from U(0.05, 0.95): each dataset's
    marginals and FE against float64 enumeration (Bethe is exact on a
    tree)."""
    rng = np.random.default_rng(12)
    y = rng.uniform(0.05, 0.95, size=(5,)).astype(np.float32)
    names = ["x1", "x2", "x3", "x4", "x"]
    post, fe = trx.infer_batched(
        _aliases(trx), {"y": y}, iterations=20, free_energy=True,
        initialization={k: _bern(trx, 0.5) for k in names}, device="cpu")
    for b, yb in enumerate(y.astype(np.float64)):
        marg, nlz = _alias_enumeration(yb)
        for k, name in enumerate(names):
            np.testing.assert_allclose(float(post[name].mean()[b]), marg[k],
                                       rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(fe[-1, b]), nlz, rtol=1e-5)


# -- tie: tests/inference/test_unfactorized_data.py --------------------------------------

def _pred_model(rx, goal):
    a_eye = np.eye(4, dtype=np.float32)
    p_s1 = np.array([0.7, 0.3, 0.0, 0.0], dtype=np.float32)

    @rx.model
    def pred_model(y):
        B = rx.DirichletCollection(np.ones((4, 4), dtype=np.float32))
        s = rx.latent(3, name="s")
        s[0] = rx.Categorical(p_s1)
        for t in rx.plate(1, 3):
            s[t] = rx.Transition(s[t - 1], B)
        for t in rx.plate(3):
            y[t] = rx.Transition(s[t], a_eye)
        rx.tie(s[2], rx.Categorical(np.asarray(goal, dtype=np.float32)))
        return {"s": s, "B": B}
    return pred_model


def _pred_data():
    y = np.full((3, 4), np.nan, dtype=np.float32)
    y[0] = [1.0, 0.0, 0.0, 0.0]
    return y


def _pred_init(rx):
    d = td if rx is trx else jd
    conv = torch.as_tensor if rx is trx else jnp.asarray
    return {"B": d.DirichletCollection(conv(np.ones((4, 4), np.float32)))}


@pytest.mark.parametrize("unfactorized", [True, False])
def test_tie_goal_prior_predictions_match_jax(unfactorized):
    """The goal prior tied to s[2]: predictions, posteriors and the FE of
    both packages.  The chain's transition matrix B is random, so the JAX
    FE leaves out (T - 1) H[q(B)] (ROADMAP C6): the port's is the JAX FE
    minus that at every sweep."""
    goal = [0.0, 0.0, 1.0, 0.0] if unfactorized else [0.0, 1.0, 0.0, 0.0]
    out = []
    for rx in (trx, jrx):
        y = _pred_data()
        out.append(rx.infer(
            model=_pred_model(rx, goal),
            data={"y": rx.UnfactorizedData(y) if unfactorized else y},
            initialization=_pred_init(rx), iterations=10, free_energy=True,
            predictvars=["y"], returnvars=rx.KeepEach(), **kw(rx)))
    t, j = out
    np.testing.assert_allclose(np.asarray(t.predictions["y"].probs()),
                               np.asarray(j.predictions["y"].probs()),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(t.posteriors["s"][-1].probs()),
                               np.asarray(j.posteriors["s"][-1].probs()),
                               rtol=1e-5, atol=1e-6)
    h_b = np.stack([q.entropy().numpy() for q in t.posteriors["B"]])
    np.testing.assert_allclose(t.free_energy.numpy(),
                               np.asarray(j.free_energy) - 2 * h_b,
                               rtol=1e-5, atol=1e-5)
    if unfactorized:
        ref = [0.25160378360439883, 0.20140807577024974,
               0.3455800648551016, 0.20140807577024974]
        np.testing.assert_allclose(t.predictions["y"].probs().numpy()[1], ref,
                                   rtol=2e-5, atol=2e-5)


# -- tests/models/test_custom_transition_chain.py (ROADMAP A6f) ---------------------------

DRIFT, QVAR = 0.5, 0.3
A_MV = np.array([[0.95, -0.2], [0.2, 0.95]], np.float32)
B_MV = np.array([0.3, -0.1], np.float32)
Q_MV = np.array([[0.3, 0.05], [0.05, 0.2]], np.float32)
R_MV = 0.04 * np.eye(2, dtype=np.float32)


def _register_walks(rx):
    """DriftWalkT (scalar) and MvDriftWalkT (d = 2) in ``rx``'s registry,
    written in that package's array library."""
    lib = torch if rx is trx else jnp
    d = td if rx is trx else jd
    reg = treg if rx is trx else jreg
    conv = ((lambda a: torch.as_tensor(a)) if rx is trx
            else (lambda a: jnp.asarray(a)))

    @reg("DriftWalkT")
    class DriftWalkT:
        interfaces = ("out", "in")
        cavity_cluster = ("out", "in")

        @staticmethod
        def message_to_out(q):
            m = q["in"]
            return d.NormalMeanVariance(m.mean() + DRIFT, m.var() + QVAR)

        @staticmethod
        def message_to_in(q):
            m = q["out"]
            return d.NormalMeanVariance(m.mean() - DRIFT, m.var() + QVAR)

        @staticmethod
        def average_energy(q):
            mo, vo = q["out"].mean(), q["out"].var()
            mi, vi = q["in"].mean(), q["in"].var()
            return 0.5 * (np.log(2 * np.pi * QVAR)
                          + ((mo - mi - DRIFT) ** 2 + vo + vi) / QVAR)

    @reg("MvDriftWalkT")
    class MvDriftWalkT:
        interfaces = ("out", "in")
        cavity_cluster = ("out", "in")

        @staticmethod
        def message_to_out(q):
            m = q["in"]
            a, b, qq = conv(A_MV), conv(B_MV), conv(Q_MV)
            return d.MvNormalMeanCovariance(
                lib.einsum("ij,...j->...i", a, m.mean()) + b,
                lib.einsum("ij,...jk,lk->...il", a, m.cov(), a) + qq)

        @staticmethod
        def message_to_in(q):
            m = q["out"]
            ainv = conv(np.linalg.inv(A_MV).astype(np.float32))
            b, qq = conv(B_MV), conv(Q_MV)
            return d.MvNormalMeanCovariance(
                lib.einsum("ij,...j->...i", ainv, m.mean() - b),
                lib.einsum("ij,...jk,lk->...il", ainv, m.cov() + qq, ainv))

        @staticmethod
        def average_energy(q):
            return 0.0 * q["out"].mean()[..., 0]


def _walk_data(t_len, seed=0):
    rng = np.random.default_rng(seed)
    x = np.cumsum(DRIFT + np.sqrt(QVAR) * rng.standard_normal(t_len))
    return (x + 0.2 * rng.standard_normal(t_len)).astype(np.float32)


def _walk_model(rx, t_len, custom=True):
    @rx.model
    def m(y):
        x = rx.latent(t_len, name="x")
        x[0] = rx.Normal(mean=DRIFT, var=0.4)
        for t in rx.plate(1, t_len):
            x[t] = (rx.factor_node("DriftWalkT", **{"in": x[t - 1]})
                    if custom else rx.Normal(mean=x[t - 1] + DRIFT, var=QVAR))
        for t in rx.plate(t_len):
            y[t] = rx.Normal(mean=x[t], var=0.04)
        return {"x": x}
    return m


def _kalman_nlz(y, m0, v0, a, b, q, r):
    """-log p(y) of a scalar linear-Gaussian chain, float64."""
    m, v, nlz = m0, v0, 0.0
    for t, yt in enumerate(np.asarray(y, np.float64)):
        if t:
            m, v = a * m + b, a * a * v + q
        s = v + r
        nlz += 0.5 * (np.log(2 * np.pi * s) + (yt - m) ** 2 / s)
        k = v / s
        m, v = m + k * (yt - m), (1 - k) * v
    return nlz


def test_custom_transition_warns_and_matches_exact_smoother():
    """The scalar custom chain: posteriors and every sweep's FE equal the
    JAX package's; at the fixed point both equal the built-in chain's and
    the Kalman -log Z."""
    t_len = 20
    y = _walk_data(t_len)
    out = []
    for rx in (trx, jrx):
        _register_walks(rx)
        d = td if rx is trx else jd
        init = {"x": d.NormalMeanVariance(*(
            (torch.tensor(0.0), torch.tensor(10.0)) if rx is trx
            else (jnp.float32(0.0), jnp.float32(10.0))))}
        with pytest.warns(UserWarning, match="chain solver"):
            out.append(rx.infer(model=_walk_model(rx, t_len), data={"y": y},
                                iterations=80, free_energy=True,
                                returnvars=rx.KeepLast(),
                                initialization=init, **kw(rx)))
    t, j = out
    # the float32 Jacobi sweeps of the two packages round differently on
    # their way in (up to 2e-5 of the FE at sweeps 4-9); from sweep 10 on
    # both sit in the same two-sweep cycle
    same(t, j, ["x"], tol=dict(rtol=1e-5, atol=1e-5), fe_from=10)
    np.testing.assert_allclose(t.free_energy.numpy(),
                               np.asarray(j.free_energy), rtol=3e-5)
    ref = trx.infer(model=_walk_model(trx, t_len, custom=False),
                    data={"y": y}, iterations=1, returnvars=trx.KeepLast(),
                    free_energy=True, device="cpu")
    for stat in ("mean", "var"):
        np.testing.assert_allclose(
            getattr(t.posteriors["x"], stat)().numpy(),
            getattr(ref.posteriors["x"], stat)().numpy(), atol=1e-4)
    fe = float(t.free_energy[-1])
    assert abs(fe - float(ref.free_energy[-1])) < 5e-4
    assert abs(fe - _kalman_nlz(y, DRIFT, 0.4, 1.0, DRIFT, QVAR, 0.04)) \
        < 5e-4


def test_custom_transition_auto_vague_init():
    t_len = 10
    y = _walk_data(t_len, seed=1)
    out = []
    for rx in (trx, jrx):
        _register_walks(rx)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            out.append(rx.infer(model=_walk_model(rx, t_len), data={"y": y},
                                iterations=60, returnvars=rx.KeepLast(),
                                **kw(rx)))
    t, j = out
    same(t, j, ["x"], tol=dict(rtol=1e-5, atol=1e-5))
    ref = trx.infer(model=_walk_model(trx, t_len, custom=False),
                    data={"y": y}, iterations=1, returnvars=trx.KeepLast(),
                    device="cpu")
    np.testing.assert_allclose(t.posteriors["x"].mean().numpy(),
                               ref.posteriors["x"].mean().numpy(), atol=1e-3)


def _mv_data(t_len=16, seed=1):
    rng = np.random.default_rng(seed)
    x, ys = np.zeros(2), []
    for _ in range(t_len):
        x = A_MV @ x + B_MV + np.linalg.cholesky(Q_MV) @ rng.standard_normal(2)
        ys.append(x + 0.2 * rng.standard_normal(2))
    return np.asarray(ys, np.float32)


def _mv_model(rx, t_len, custom=True):
    p0 = 0.4 * np.eye(2, dtype=np.float32)

    @rx.model
    def m(y):
        x = rx.latent(t_len, name="x")
        x[0] = rx.MvNormal(mean=B_MV, cov=p0)
        for t in rx.plate(1, t_len):
            x[t] = (rx.factor_node("MvDriftWalkT", **{"in": x[t - 1]})
                    if custom else
                    rx.MvNormal(mean=A_MV @ x[t - 1] + B_MV, cov=Q_MV))
        for t in rx.plate(t_len):
            y[t] = rx.MvNormal(mean=x[t], cov=R_MV)
        return {"x": x}
    return m


def test_mv_custom_transition_structured_fe_matches_builtin():
    t_len = 16
    y = _mv_data(t_len)
    out = []
    for rx in (trx, jrx):
        _register_walks(rx)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            out.append(rx.infer(
                model=_mv_model(rx, t_len), data={"y": y}, iterations=120,
                free_energy=True, returnvars=rx.KeepLast(),
                initialization={"x": _mvn(rx, np.zeros(2),
                                          10.0 * np.eye(2))}, **kw(rx)))
    t, j = out
    same(t, j, ["x"], stats=("mean", "cov"), tol=dict(rtol=1e-5, atol=1e-5))
    ref = trx.infer(model=_mv_model(trx, t_len, custom=False), data={"y": y},
                    iterations=1, returnvars=trx.KeepLast(), free_energy=True,
                    device="cpu")
    np.testing.assert_allclose(t.posteriors["x"].mean().numpy(),
                               ref.posteriors["x"].mean().numpy(), atol=2e-4)
    assert abs(float(t.free_energy[-1]) - float(ref.free_energy[-1])) < 2e-3


def test_custom_transition_batched_fe_equals_kalman():
    """``infer_batched`` of the scalar custom chain over three datasets:
    each one's FE at the fixed point is its Kalman -log Z."""
    _register_walks(trx)
    t_len = 12
    y = np.stack([_walk_data(t_len, seed=s) for s in range(3)])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, fe = trx.infer_batched(
            _walk_model(trx, t_len), {"y": y}, iterations=60,
            free_energy=True,
            initialization={"x": td.NormalMeanVariance(torch.tensor(0.0),
                                                       torch.tensor(10.0))},
            device="cpu")
    for b in range(3):
        nlz = _kalman_nlz(y[b], DRIFT, 0.4, 1.0, DRIFT, QVAR, 0.04)
        assert abs(float(fe[-1, b]) - nlz) < 5e-4


def test_affine_probe_accepts_the_same_nodes_in_both_packages():
    """The plan-time probe takes an affine Gaussian out rule and refuses a
    nonlinear one and a state-dependent variance, in both packages."""
    from rxinfer_tpu.engine.bethe import _extract_affine_transition as jprobe
    from rxinfer_tpu_torch.engine.bethe import (
        _extract_affine_transition as tprobe,
    )

    for rx, probe in ((trx, tprobe), (jrx, jprobe)):
        _register_walks(rx)
        d = td if rx is trx else jd
        reg = treg if rx is trx else jreg

        @reg("SquareWalkT")
        class SquareWalkT:
            interfaces = ("out", "in")
            cavity_cluster = ("out", "in")

            @staticmethod
            def message_to_out(q):
                m = q["in"].mean()
                return d.NormalMeanVariance(m * m, 1.0 + 0.0 * m)

        @reg("WideningWalkT")
        class WideningWalkT:
            interfaces = ("out", "in")
            cavity_cluster = ("out", "in")

            @staticmethod
            def message_to_out(q):
                m = q["in"].mean()
                return d.NormalMeanVariance(m, 1.0 + m * m)

        for fform, affine in (("DriftWalkT", True), ("SquareWalkT", False),
                              ("WideningWalkT", False)):
            @rx.model
            def m(y):
                x = rx.latent(4, name="x")
                x[0] = rx.Normal(mean=0.0, var=1.0)
                for t in rx.plate(1, 4):
                    x[t] = rx.factor_node(fform, **{"in": x[t - 1]})
                for t in rx.plate(4):
                    y[t] = rx.Normal(mean=x[t], var=1.0)
                return {"x": x}

            g = m.trace({"y": np.zeros(4, np.float32)})
            f = next(f for f in g.factors if f.fform == fform)
            got = probe(f, ())
            assert (got is not None) == affine, (rx.__name__, fform)
            if affine:
                np.testing.assert_allclose(got, (1.0, DRIFT, QVAR),
                                           rtol=1e-5)


# -- ROADMAP C14: E[(out - mean)^2] in float32 -------------------------------------------

@pytest.mark.parametrize("fform,noise", [("NormalMeanVariance", "var"),
                                         ("NormalMeanPrecision", "prec")])
def test_c14_normal_energy_far_from_zero(fform, noise):
    """C14: the JAX Normal nodes expand E[(out - mean)^2] into E[out^2] -
    2 E[out] E[mean] + E[mean^2], which cancels in float32 at levels far
    from 0; the port sums Var[out] + Var[mean] + (E[out] - E[mean])^2.  At a
    level of 1000 the JAX energy misses its float64 value by more than 1%,
    the port's holds 1e-6."""
    m_out, m_mean, v_out, v_mean, v = 1000.0, 1000.1, 0.01, 0.02, 0.04
    # float64 at the float32 inputs both packages see
    f = lambda a: float(np.float32(a))
    c = f(v_out) + f(v_mean) + (f(m_out) - f(m_mean)) ** 2
    exact = 0.5 * (np.log(2 * np.pi * f(v)) + c / f(v))
    nv = v if noise == "var" else 1.0 / v
    qt = {"out": both("NormalMeanVariance", m_out, v_out)[0],
          "mean": both("NormalMeanVariance", m_mean, v_mean)[0],
          noise: pm(nv)[0]}
    qj = {"out": both("NormalMeanVariance", m_out, v_out)[1],
          "mean": both("NormalMeanVariance", m_mean, v_mean)[1],
          noise: pm(nv)[1]}
    t = float(tcall(fform, "average_energy", **qt))
    j = float(jcall(fform, "average_energy", **qj))
    assert abs(t - exact) / abs(exact) < 1e-6, (t, exact)
    assert abs(j - exact) / abs(exact) > 1e-2, (j, exact)


def test_c14_custom_walk_fe_far_from_zero_against_kalman():
    """C14 on a model: the custom drifting walk whose level reaches ~25
    over 50 steps, observed with variance 0.04.  The port's FE at the fixed
    point is the float64 Kalman -log Z within 1e-5 relative on every
    dataset; the JAX package's misses it by more on at least one (its
    likelihood energies cancel)."""
    t_len, b = 50, 4
    y = np.stack([_walk_data(t_len, seed=40 + s) for s in range(b)])
    fes = []
    for rx in (trx, jrx):
        _register_walks(rx)
        d = td if rx is trx else jd
        init = {"x": d.NormalMeanVariance(*(
            (torch.tensor(0.0), torch.tensor(10.0)) if rx is trx
            else (jnp.float32(0.0), jnp.float32(10.0))))}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            _, fe = rx.infer_batched(_walk_model(rx, t_len), {"y": y},
                                     iterations=80, free_energy=True,
                                     initialization=init, **kw(rx))
        fes.append(np.asarray(fe, np.float64)[-1])
    nlz = np.array([_kalman_nlz(y[k], DRIFT, 0.4, 1.0, DRIFT, QVAR, 0.04)
                    for k in range(b)])
    port_gap = np.abs(fes[0] - nlz) / np.abs(nlz)
    jax_gap = np.abs(fes[1] - nlz) / np.abs(nlz)
    assert port_gap.max() < 1e-5, port_gap
    assert jax_gap.max() > 1e-5, jax_gap

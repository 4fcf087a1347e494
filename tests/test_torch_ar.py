"""The autoregressive node and its chain (ROADMAP A6a) through both
packages on the CPU: ``ARNode``'s rules (order 1 with scalar latents, order
1 and order 3 embedded, a batch of random marginals, and the port's
batch-major layout against JAX per dataset), one ``ARChainBlock`` update,
and ``zoo.latent_ar`` (order 1 and 3) and example 10's univariate model
through ``infer`` and ``infer_batched``: posteriors, ``plan_report()`` and
the free energy after every sweep.  The free energies differ by ROADMAP C8's
closed form: the JAX package leaves out H[q(theta)] + H[q(gamma)] once a
transition (C6's convention) and takes the embedded pair (out_0, in) of
dimension k + 1 with the log(2 pi e) constant of one dimension; the port's
equals a float64 structured VMP's Bethe free energy
(``chip_smoke.lar_vmp_float64``).  Inputs come from numpy seeds; the port
runs with ``device="cpu"``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import rxinfer_tpu as jrx
import rxinfer_tpu_torch as trx
from rxinfer_tpu import dists as jd
from rxinfer_tpu.engine.compile import CompiledModel as JCompiledModel
from rxinfer_tpu.models import zoo as jzoo
from rxinfer_tpu.rules import ar as jar
from rxinfer_tpu_torch import dists as td
from rxinfer_tpu_torch.engine.blocks import ARChainBlock, BatchContext
from rxinfer_tpu_torch.engine.compile import CompiledModel as TCompiledModel
from rxinfer_tpu_torch.models import zoo as tzoo
from rxinfer_tpu_torch.rules import ar as tar

CPU = torch.device("cpu")
# one rule: a few float32 einsums in two libraries
RULE_TOL = 1e-5
# posteriors after the sweeps, relative to the largest value: float32
# smoothers of the same formulas in two libraries (measured on a CPU at up
# to 5.5e-7 at order 3, T = 60, 4 sweeps)
POST_TOL = 1e-4
# free-energy traces: sums of ~10^3 float32 terms (as tests/
# test_torch_free_energy.py's FE_TOL)
FE_TOL = dict(rtol=1e-5, atol=1e-3)
# against the float64 structured VMP: float32 sweeps with the 1e-6 jitter of
# the embedded process noise (measured at order 3: 5.6e-7 for s, 3.9e-7 for
# the free energy)
ORACLE_TOL = 1e-5
B, T, ITERATIONS = 4, 60, 4
LOG2PIE = float(np.log(2 * np.pi * np.e))


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def assert_rel(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err


def ar_series(b, t_len, coef, seed, noise=0.3):
    """y (b, t_len): an AR process with coefficients ``coef`` observed with
    Gaussian noise of standard deviation ``noise``."""
    rng = np.random.default_rng(seed)
    k = len(coef)
    x = np.zeros((b, t_len + k))
    for t in range(k, t_len + k):
        x[:, t] = x[:, t - k:t][:, ::-1] @ coef + rng.standard_normal(b)
    return (x[:, k:] + noise * rng.standard_normal((b, t_len))).astype(
        np.float32)


COEF = {1: [0.8], 3: [0.5, -0.3, 0.1]}


def lar_init(dists, k):
    if dists is jd:
        return {"theta": jd.MvNormalMeanCovariance(jnp.zeros(k), jnp.eye(k)),
                "gamma": jd.GammaShapeRate(1.0, 1.0)}
    return {"theta": td.MvNormalMeanCovariance(torch.zeros(k), torch.eye(k)),
            "gamma": td.GammaShapeRate(torch.tensor(1.0), torch.tensor(1.0))}


# -- the rules --------------------------------------------------------------------

def _mv(dists, m, c):
    t = jnp.asarray if dists is jd else torch.as_tensor
    return dists.MvNormalMeanCovariance(t(m), t(c))


def _spd(rng, n, k, scale=1.0):
    a = rng.standard_normal((n, k, k)) * scale / np.sqrt(k)
    return (a @ np.swapaxes(a, -1, -2) + 0.3 * np.eye(k)).astype(np.float32)


def rule_inputs(dists, k, n, seed, scalar=False):
    """Marginals of n transition copies: out, in, theta, gamma and the pair
    cross Cov(out, in) (shift rows consistent with the embedding)."""
    t = jnp.asarray if dists is jd else torch.as_tensor
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    m_out = f32(rng.standard_normal((n, k)))
    m_in = f32(rng.standard_normal((n, k)))
    c_out, c_in = _spd(rng, n, k), _spd(rng, n, k)
    joint = f32(0.2 * rng.standard_normal((n, k, k)))
    m_th = f32(rng.standard_normal(k))
    c_th = _spd(rng, 1, k, 0.5)[0]
    a, b = f32(rng.uniform(1.0, 4.0)), f32(rng.uniform(0.5, 2.0))
    gamma = dists.GammaShapeRate(t(a), t(b))
    if scalar:
        return {"out": dists.NormalMeanVariance(t(m_out[:, 0]),
                                                t(c_out[:, 0, 0])),
                "in": dists.NormalMeanVariance(t(m_in[:, 0]),
                                               t(c_in[:, 0, 0])),
                "theta": dists.NormalMeanVariance(t(m_th[0]),
                                                  t(c_th[0, 0])),
                "gamma": gamma, "joint": t(joint[:, 0, 0])}
    return {"out": _mv(dists, m_out, c_out), "in": _mv(dists, m_in, c_in),
            "theta": _mv(dists, m_th, c_th), "gamma": gamma,
            "joint": t(joint)}


def leaves(d):
    if isinstance(d, (jnp.ndarray, np.ndarray, torch.Tensor)):
        return [np.asarray(d)]
    return [np.asarray(getattr(d, f)) for f in d.__dataclass_fields__]


RULES = ["message_to_theta", "message_to_gamma", "average_energy"]


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("case", ["scalar1", "order1", "order3"])
def test_ar_rules_match_jax(case, rule):
    k = 3 if case == "order3" else 1
    scalar = case == "scalar1"
    jq = rule_inputs(jd, k, 7, seed=11, scalar=scalar)
    tq = rule_inputs(td, k, 7, seed=11, scalar=scalar)
    jout = getattr(jar.ARNode, rule)(jq)
    tout = getattr(tar.ARNode, rule)(tq)
    if not isinstance(tout, torch.Tensor):
        assert type(tout).__name__ == type(jout).__name__
    for tl, jl in zip(leaves(tout), leaves(jout)):
        assert_rel(tl, jl, RULE_TOL)
    # without the pair cross (a mean-field split)
    jq.pop("joint")
    tq.pop("joint")
    for tl, jl in zip(leaves(getattr(tar.ARNode, rule)(tq)),
                      leaves(getattr(jar.ARNode, rule)(jq))):
        assert_rel(tl, jl, RULE_TOL)


@pytest.mark.parametrize("rule", RULES)
def test_ar_rules_batch_major_match_jax_per_dataset(rule):
    """The port's layout: theta and gamma with a batch axis and a unit
    plate axis, the copies on axis 1; the JAX rule per dataset."""
    k, n, nb = 3, 5, 3
    jqs = [rule_inputs(jd, k, n, seed=20 + i) for i in range(nb)]
    tqs = [rule_inputs(td, k, n, seed=20 + i) for i in range(nb)]

    def stacked(key, unit_plate):
        d = tqs[0][key]
        fields = [torch.stack([getattr(q[key], f) for q in tqs])
                  for f in d.__dataclass_fields__]
        return type(d)(*[a[:, None] if unit_plate else a for a in fields])

    tq = {"out": stacked("out", False), "in": stacked("in", False),
          "theta": stacked("theta", True), "gamma": stacked("gamma", True),
          "joint": torch.stack([q["joint"] for q in tqs])}
    tout = getattr(tar.ARNode, rule)(tq)
    for i, jq in enumerate(jqs):
        jout = getattr(jar.ARNode, rule)(jq)
        for tl, jl in zip(leaves(tout), leaves(jout)):
            assert_rel(tl[i], jl, RULE_TOL)


# -- one block update -------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 3])
def test_ar_chain_block_update_matches_jax(k):
    """One ``ARChainBlock.update`` from random theta / gamma marginals: the
    companion transition and Q = 1e-6 I + e_1 e_1^T / E[gamma] per chain,
    its marginals and the pair cross Cov(out, in) (B, T-1, k, k)."""
    y = ar_series(3, 30, COEF[k], seed=3)
    jc = JCompiledModel(jzoo.latent_ar(k).trace({"y": y[0]}),
                        init=lar_init(jd, k))
    tc = TCompiledModel(tzoo.latent_ar(k).trace({"y": y[0]}),
                        init=lar_init(td, k))
    jblock = next(b for kind, b in jc.blocks if kind == "chain")
    tblock = next(b for kind, b in tc.blocks if kind == "chain")
    assert isinstance(tblock, ARChainBlock)
    rng = np.random.default_rng(4)
    m_th = (0.3 * rng.standard_normal((3, k))).astype(np.float32)
    c_th = _spd(rng, 3, k, 0.3)
    ga = rng.uniform(1.0, 3.0, 3).astype(np.float32)
    gb = rng.uniform(0.5, 2.0, 3).astype(np.float32)
    tstate = {"theta": td.MvNormalMeanCovariance(torch.as_tensor(m_th),
                                                 torch.as_tensor(c_th)),
              "gamma": td.GammaShapeRate(torch.as_tensor(ga),
                                         torch.as_tensor(gb))}
    ctx = BatchContext(CPU, 3, {})
    tmarg, tcross = tblock.update(tstate, {"y": torch.as_tensor(y)}, {}, ctx)
    assert tuple(tcross.shape) == (3, 29, k, k)
    for i in range(3):
        jstate = {"theta": jd.MvNormalMeanCovariance(jnp.asarray(m_th[i]),
                                                     jnp.asarray(c_th[i])),
                  "gamma": jd.GammaShapeRate(jnp.asarray(ga[i]),
                                             jnp.asarray(gb[i]))}
        jmarg, jcross = jblock.update(jstate, {"y": jnp.asarray(y[i])}, {})
        assert_rel(tmarg.mean()[i].numpy(), jmarg.mean(), POST_TOL)
        assert_rel(tmarg.cov()[i].numpy(), jmarg.cov(), POST_TOL)
        # the engine stores Cov(out, in): the JAX block returns the
        # smoother's Cov(x_t, x_t+1), which its sweep transposes
        assert_rel(tcross[i].numpy(), np.swapaxes(np.asarray(jcross), -1, -2),
                   POST_TOL)


# -- end to end -------------------------------------------------------------------

@pytest.fixture(scope="module", params=[1, 3])
def batched_runs(request):
    """``infer_batched`` of ``zoo.latent_ar(k)`` in both packages with
    ``KeepEach`` and the free energy, once per order."""
    k = request.param
    y = ar_series(B, T, COEF[k], seed=10 + k)
    kw = dict(iterations=ITERATIONS, free_energy=True,
              returnvars=jrx.KeepEach())
    jc, _ = jrx.batched_program(jzoo.latent_ar(k), {"y": y},
                                iterations=ITERATIONS, free_energy=True,
                                initialization=lar_init(jd, k),
                                keep_each=True)
    jpost, jfe = jrx.infer_batched(jzoo.latent_ar(k), {"y": y},
                                   initialization=lar_init(jd, k), **kw)
    kw["returnvars"] = trx.KeepEach()
    tc, _ = trx.batched_program(tzoo.latent_ar(k), {"y": y},
                                iterations=ITERATIONS, free_energy=True,
                                initialization=lar_init(td, k),
                                keep_each=True, device=CPU)
    tpost, tfe = trx.infer_batched(tzoo.latent_ar(k), {"y": y},
                                   initialization=lar_init(td, k),
                                   device=CPU, **kw)
    return dict(k=k, y=y, jpost=jpost, jfe=np.asarray(jfe), jc=jc,
                tpost=tpost, tfe=tfe.numpy(), tc=tc)


def c8_offset(post_theta, post_gamma, t_len, k):
    """ROADMAP C8: the JAX free energy minus the port's, per sweep."""
    h = np.stack([p.entropy().numpy() for p in post_theta]) + np.stack(
        [p.entropy().numpy() for p in post_gamma])
    return (t_len - 1) * (h + 0.5 * (k - 1) * LOG2PIE)


def test_latent_ar_infer_batched_matches_jax(batched_runs):
    r = batched_runs
    for name in ("s", "theta", "gamma"):
        assert len(r["tpost"][name]) == ITERATIONS
        for tp, jp in zip(r["tpost"][name], r["jpost"][name]):
            assert_rel(tp.mean().numpy(), jp.mean(), POST_TOL)
    assert_rel(r["tpost"]["s"][-1].cov().numpy(), r["jpost"]["s"][-1].cov(),
               POST_TOL)
    assert_rel(r["tpost"]["theta"][-1].cov().numpy(),
               r["jpost"]["theta"][-1].cov(), POST_TOL)


def test_latent_ar_fe_is_jax_fe_with_the_c8_offset(batched_runs):
    r = batched_runs
    assert r["tfe"].shape == (ITERATIONS, B)
    off = c8_offset(r["tpost"]["theta"], r["tpost"]["gamma"], T, r["k"])
    np.testing.assert_allclose(r["tfe"], r["jfe"] - off, **FE_TOL)


def test_latent_ar_plan_report_matches_jax(batched_runs):
    report = batched_runs["tc"].plan_report()
    assert report == batched_runs["jc"].plan_report()
    assert report["s"]["fused"] is False
    assert report["s"]["reason"].startswith(
        "ARChainBlock has state-dependent transition parameters")


@pytest.mark.parametrize("k", [1, 3])
def test_latent_ar_fe_matches_a_float64_structured_vmp(k):
    """The port's posteriors and free energy after every sweep against the
    float64 structured VMP of ``chip_smoke.py`` phase 19 (a)."""
    y = ar_series(B, T, COEF[k], seed=30 + k)
    post, fe = trx.infer_batched(tzoo.latent_ar(k), {"y": y},
                                 iterations=ITERATIONS, free_energy=True,
                                 initialization=lar_init(td, k), device=CPU,
                                 options={"warn": False})
    o_s, o_th, o_g, o_fe = chip_smoke.lar_vmp_float64(y, k, ITERATIONS)
    assert_rel(post["s"].mean().numpy(), o_s, ORACLE_TOL)
    assert_rel(post["theta"].mean().numpy(), o_th, ORACLE_TOL)
    assert_rel(post["gamma"].mean().numpy(), o_g, ORACLE_TOL)
    assert_rel(fe.numpy(), o_fe, ORACLE_TOL)


def test_latent_ar_infer_matches_jax():
    """One dataset through ``infer`` at order 3 (the scans as a batch of
    one in the port, the JAX block under no vmap)."""
    k = 3
    y = ar_series(1, T, COEF[k], seed=40)[0]
    jres = jrx.infer(jzoo.latent_ar(k), data={"y": y}, iterations=3,
                     free_energy=True, initialization=lar_init(jd, k))
    tres = trx.infer(tzoo.latent_ar(k), data={"y": y}, iterations=3,
                     free_energy=True, initialization=lar_init(td, k),
                     device=CPU)
    for name in ("s", "theta", "gamma"):
        for tp, jp in zip(tres.posteriors[name], jres.posteriors[name]):
            assert_rel(tp.mean().numpy(), jp.mean(), POST_TOL)
    off = c8_offset(tres.posteriors["theta"], tres.posteriors["gamma"], T, k)
    np.testing.assert_allclose(tres.free_energy.numpy(),
                               np.asarray(jres.free_energy) - off, **FE_TOL)


def example10_model(rx, t_len):
    """Example 10's univariate AR(1): scalar latents and a scalar theta
    (the reference's ``ARMeta(Univariate, ...)``)."""
    @rx.model
    def ar1(y):
        theta = rx.Normal(mean=0.0, precision=1.0)
        gamma = rx.Gamma(shape=1.0, rate=1.0)
        s = rx.latent(t_len, name="s")
        s[0] = rx.Normal(mean=0.0, precision=1.0)
        for t in rx.plate(1, t_len):
            s[t] = rx.AR(s[t - 1], theta, gamma, meta=rx.ARMeta(1))
        for t in rx.plate(t_len):
            y[t] = rx.Normal(mean=s[t], var=0.09)
        return {"theta": theta, "gamma": gamma, "s": s}

    return ar1


def test_univariate_ar_infer_matches_jax():
    """Example 10 through ``infer``: scalar marginals throughout, the rules
    promote them to the 1-d embedding; the free energy differs by
    (T - 1) (H[q(theta)] + H[q(gamma)]) (C8 at k = 1)."""
    y = ar_series(1, T, COEF[1], seed=50)[0]
    jinit = {"theta": jd.NormalMeanVariance(0.0, 1.0),
             "gamma": jd.GammaShapeRate(1.0, 1.0)}
    tinit = {"theta": td.NormalMeanVariance(torch.tensor(0.0),
                                            torch.tensor(1.0)),
             "gamma": td.GammaShapeRate(torch.tensor(1.0),
                                        torch.tensor(1.0))}
    kw = dict(data={"y": y}, iterations=4, free_energy=True)
    jres = jrx.infer(example10_model(jrx, T), initialization=jinit, **kw)
    tres = trx.infer(example10_model(trx, T), initialization=tinit,
                     device=CPU, **kw)
    assert isinstance(tres.posteriors["s"][-1], td.NormalMeanVariance)
    for name in ("s", "theta", "gamma"):
        for tp, jp in zip(tres.posteriors[name], jres.posteriors[name]):
            assert_rel(tp.mean().numpy(), jp.mean(), POST_TOL)
            assert_rel(tp.var().numpy(), jp.var(), POST_TOL)
    off = c8_offset(tres.posteriors["theta"], tres.posteriors["gamma"], T, 1)
    np.testing.assert_allclose(tres.free_energy.numpy(),
                               np.asarray(jres.free_energy) - off, **FE_TOL)
    theta = tres.posteriors["theta"][-1]
    assert abs(float(theta.mean()) - 0.8) < 0.2


def test_ar_needs_an_order_as_in_jax():
    @trx.model
    def no_order(y):
        s = trx.latent(len(y), name="s")
        s[0] = trx.Normal(mean=0.0, var=1.0)
        for t in trx.plate(1, len(y)):
            s[t] = trx.AR(s[t - 1], trx.Normal(mean=0.0, var=1.0),
                          trx.Gamma(shape=1.0, rate=1.0))
        for t in trx.plate(len(y)):
            y[t] = trx.Normal(mean=s[t], var=1.0)

    with pytest.raises(TypeError, match="requires order"):
        trx.infer(no_order, data={"y": np.zeros(5, np.float32)}, device=CPU)
    with pytest.raises(TypeError, match="integer order"):
        trx.ARMeta("Univariate")
    assert trx.ARMeta("Multivariate", 3, trx.ARunsafe()).order == 3
    assert isinstance(trx.ARMeta(2).stability, trx.ARsafe)

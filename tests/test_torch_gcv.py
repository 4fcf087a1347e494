"""The GCV node and the hierarchical Gaussian filter (ROADMAP A6a) through
both packages on the CPU: ``GCVNode``'s rules (the structured and mean-field
messages, the message to z by max-stabilized Gauss-Hermite quadrature, at a
large expected squared step too, and the average energy), the quadrature
helper, one ``GCVChainBlock`` update, ``zoo.hgf`` through ``infer_batched``
with and without ``meta={"GCV": {"damping": 0.8}}`` and through ``infer``,
a GCV chain whose volatilities are independent a step (a plain group
whose rule reads its own marginal), ``meta=`` by neighbourhood, the program caches
keyed on the meta values, and a single-step GCV against the JAX package.  The free
energies differ by ROADMAP C8's closed form: the JAX package leaves out
H[q(z_t)] once a GCV transition.  Inputs come from numpy seeds; the port
runs with ``device="cpu"``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rxinfer_tpu as jrx
import rxinfer_tpu_torch as trx
from rxinfer_tpu import dists as jd
from rxinfer_tpu.engine.compile import CompiledModel as JCompiledModel
from rxinfer_tpu.models import zoo as jzoo
from rxinfer_tpu.rules import gcv as jgcv
from rxinfer_tpu.rules import special as jspecial
from rxinfer_tpu_torch import dists as td
from rxinfer_tpu_torch.engine.blocks import BatchContext, GCVChainBlock
from rxinfer_tpu_torch.engine.compile import CompiledModel as TCompiledModel
from rxinfer_tpu_torch.models import zoo as tzoo
from rxinfer_tpu_torch.rules import gcv as tgcv
from rxinfer_tpu_torch.rules import special as tspecial

CPU = torch.device("cpu")
# one rule: float32 expressions in two libraries (the quadrature's 31
# exponentials and sums among them)
RULE_TOL = 1e-5
# posteriors after the sweeps, relative to the largest value: the GCV
# coupling feeds each chain's float32 rounding to the other every sweep
# (measured on a CPU at up to 4.3e-6, z's variances, T = 50, 5 sweeps)
POST_TOL = 1e-4
# free-energy traces (as tests/test_torch_free_energy.py's FE_TOL)
FE_TOL = dict(rtol=1e-5, atol=1e-3)
B, T, ITERATIONS = 3, 50, 5
KAPPA, OMEGA = 1.0, -2.0


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


def simulate_hgf(t_len, seed, kappa=KAPPA, omega=OMEGA, z_std=0.155):
    """``tests/models/test_hgf.py``'s simulator."""
    rng = np.random.default_rng(seed)
    z = np.zeros(t_len)
    x = np.zeros(t_len)
    for t in range(1, t_len):
        z[t] = z[t - 1] + z_std * rng.standard_normal()
        x[t] = x[t - 1] + np.exp(0.5 * (kappa * z[t] + omega)) \
            * rng.standard_normal()
    return (x + 0.1 * rng.standard_normal(t_len)).astype(np.float32)


def hgf_y(b=B, t_len=T):
    return np.stack([simulate_hgf(t_len, seed=i) for i in range(b)])


def z_init(dists):
    if dists is jd:
        return {"z": jd.NormalMeanVariance(0.0, 5.0)}
    return {"z": td.NormalMeanVariance(torch.tensor(0.0), torch.tensor(5.0))}


def leaves(d):
    if isinstance(d, (jnp.ndarray, np.ndarray, torch.Tensor)):
        return [np.asarray(d)]
    return [np.asarray(getattr(d, f)) for f in d.__dataclass_fields__]


# -- the rules --------------------------------------------------------------------

def rule_inputs(dists, n, seed, step=0.0):
    """q of n GCV copies: out, in (means ``step`` apart on top of noise),
    z, the pair cross and the constants kappa, omega."""
    t = jnp.asarray if dists is jd else torch.as_tensor
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    v_out = f32(rng.uniform(0.05, 1.0, n))
    v_in = f32(rng.uniform(0.05, 1.0, n))
    return {
        "out": dists.NormalMeanVariance(
            t(f32(rng.standard_normal(n) + step)), t(v_out)),
        "in": dists.NormalMeanVariance(t(f32(rng.standard_normal(n))),
                                       t(v_in)),
        "z": dists.NormalMeanVariance(t(f32(rng.standard_normal(n))),
                                      t(f32(rng.uniform(0.1, 2.0, n)))),
        "kappa": dists.PointMass(t(f32(KAPPA))),
        "omega": dists.PointMass(t(f32(OMEGA))),
        # beyond the Cauchy-Schwarz bound in some copies: the clip applies
        "joint": t(f32(rng.uniform(-1.2, 1.2, n) * np.sqrt(v_out * v_in))),
    }


RULES = ["message_to_out", "message_to_in", "vmp_message_to_out",
         "vmp_message_to_in", "message_to_z", "average_energy"]


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("joint", [True, False])
def test_gcv_rules_match_jax(rule, joint):
    jq = rule_inputs(jd, 9, seed=3)
    tq = rule_inputs(td, 9, seed=3)
    if not joint:
        jq.pop("joint")
        tq.pop("joint")
    jout = getattr(jgcv.GCVNode, rule)(jq)
    tout = getattr(tgcv.GCVNode, rule)(tq)
    if not isinstance(tout, torch.Tensor):
        assert type(tout).__name__ == type(jout).__name__
    for tl, jl in zip(leaves(tout), leaves(jout)):
        assert_rel(tl, jl, RULE_TOL)
    assert_rel(tgcv.expected_precision(tq), jgcv.expected_precision(jq),
               RULE_TOL)
    assert_rel(tgcv._delta2(tq), jgcv._delta2(jq), RULE_TOL)


def test_message_to_z_at_a_large_step_matches_jax():
    """E[(out - in)^2] ~ 900: the tilted density peaks far from the mean of
    q(z), where a mean-point stabilizer overflows float32; the maximum over
    the grid keeps every message finite.  The message may be improper (a
    negative precision), as in the JAX package."""
    jq = rule_inputs(jd, 9, seed=5, step=30.0)
    tq = rule_inputs(td, 9, seed=5, step=30.0)
    assert float(tgcv._delta2(tq).min()) > 500.0
    jout = jgcv.GCVNode.message_to_z(jq)
    tout = tgcv.GCVNode.message_to_z(tq)
    for tl, jl in zip(leaves(tout), leaves(jout)):
        assert np.isfinite(tl).all()
        assert_rel(tl, jl, RULE_TOL)


def test_gauss_hermite_matches_jax_and_keeps_its_nodes():
    rng = np.random.default_rng(7)
    m = rng.standard_normal(6).astype(np.float32)
    v = rng.uniform(0.1, 2.0, 6).astype(np.float32)
    for fn_t, fn_j in ((torch.exp, jnp.exp), (torch.sin, jnp.sin),
                       (lambda x: x * x, lambda x: x * x)):
        got = tspecial._gauss_hermite(fn_t, torch.as_tensor(m),
                                      torch.as_tensor(v))
        want = jspecial._gauss_hermite(fn_j, jnp.asarray(m), jnp.asarray(v))
        assert_rel(got.numpy(), want, RULE_TOL)
    # E[x^2] = m^2 + v exactly at 31 points
    got = tspecial._gauss_hermite(lambda x: x * x, torch.as_tensor(m),
                                  torch.as_tensor(v))
    np.testing.assert_allclose(got.numpy(), m * m + v, rtol=1e-5)
    first = tspecial.gauss_hermite_nodes(31, CPU)
    assert tspecial.gauss_hermite_nodes(31, CPU) is first
    assert first[0].dtype == torch.float32 and first[0].shape == (31,)


# -- one block update -------------------------------------------------------------

def test_gcv_chain_block_update_matches_jax():
    """One ``GCVChainBlock.update`` at random q(z): Q_t = 1 / E[exp(-(kappa
    z_t + omega))] per chain and step, its marginals and pair cross."""
    y = hgf_y(3, 30)
    jc = JCompiledModel(jzoo.hgf().trace({"y": y[0]}), init=z_init(jd))
    tc = TCompiledModel(tzoo.hgf().trace({"y": y[0]}), init=z_init(td))
    jblock = next(b for kind, b in jc.blocks if b.var.name == "x")
    tblock = next(b for kind, b in tc.blocks if b.var.name == "x")
    assert isinstance(tblock, GCVChainBlock)
    rng = np.random.default_rng(8)
    mz = (0.3 * rng.standard_normal((3, 30))).astype(np.float32)
    vz = rng.uniform(0.05, 1.0, (3, 30)).astype(np.float32)
    tstate = {"z": td.NormalMeanVariance(torch.as_tensor(mz),
                                         torch.as_tensor(vz))}
    tmarg, tcross = tblock.update(tstate, {"y": torch.as_tensor(y)}, {},
                                  BatchContext(CPU, 3, {}))
    assert tuple(tcross.shape) == (3, 29)
    for i in range(3):
        jstate = {"z": jd.NormalMeanVariance(jnp.asarray(mz[i]),
                                             jnp.asarray(vz[i]))}
        jmarg, jcross = jblock.update(jstate, {"y": jnp.asarray(y[i])}, {})
        assert_rel(tmarg.mean()[i].numpy(), jmarg.mean(), POST_TOL)
        assert_rel(tmarg.var()[i].numpy(), jmarg.var(), POST_TOL)
        assert_rel(tcross[i].numpy(), jcross, POST_TOL)


# -- end to end -------------------------------------------------------------------

DAMPED = {"GCV": {"damping": 0.8}}


@pytest.fixture(scope="module", params=[None, "damped"])
def hgf_runs(request):
    meta = DAMPED if request.param else None
    y = hgf_y()
    jc, _ = jrx.batched_program(jzoo.hgf(), {"y": y}, iterations=ITERATIONS,
                                free_energy=True,
                                initialization=z_init(jd), meta=meta,
                                keep_each=True)
    jpost, jfe = jrx.infer_batched(jzoo.hgf(), {"y": y},
                                   iterations=ITERATIONS, free_energy=True,
                                   initialization=z_init(jd), meta=meta,
                                   returnvars=jrx.KeepEach())
    tc, _ = trx.batched_program(tzoo.hgf(), {"y": y}, iterations=ITERATIONS,
                                free_energy=True, initialization=z_init(td),
                                meta=meta, keep_each=True, device=CPU)
    tpost, tfe = trx.infer_batched(tzoo.hgf(), {"y": y},
                                   iterations=ITERATIONS, free_energy=True,
                                   initialization=z_init(td), meta=meta,
                                   returnvars=trx.KeepEach(), device=CPU)
    return dict(jc=jc, jpost=jpost, jfe=np.asarray(jfe), tc=tc, tpost=tpost,
                tfe=tfe.numpy())


def test_hgf_infer_batched_matches_jax(hgf_runs):
    r = hgf_runs
    for name in ("x", "z"):
        assert len(r["tpost"][name]) == ITERATIONS
        for tp, jp in zip(r["tpost"][name], r["jpost"][name]):
            assert_rel(tp.mean().numpy(), jp.mean(), POST_TOL)
            assert_rel(tp.var().numpy(), jp.var(), POST_TOL)


def z_entropy_offset(post_z):
    """ROADMAP C8 on the HGF: the JAX free energy minus the port's, per
    sweep: H[q(z_t)] over the GCV transitions' slots 1..T-1."""
    return np.stack([p.entropy().numpy()[..., 1:].sum(-1) for p in post_z])


def test_hgf_fe_is_jax_fe_with_the_c8_offset(hgf_runs):
    r = hgf_runs
    assert r["tfe"].shape == (ITERATIONS, B)
    assert np.isfinite(r["tfe"]).all()
    np.testing.assert_allclose(
        r["tfe"], r["jfe"] - z_entropy_offset(r["tpost"]["z"]), **FE_TOL)


def test_hgf_plan_report_matches_jax(hgf_runs):
    report = hgf_runs["tc"].plan_report()
    assert report == hgf_runs["jc"].plan_report()
    assert report["x"]["reason"].startswith("GCVChainBlock has")
    assert report["z"]["reason"] == ("evidence factor GCV reads the chain's "
                                     "own marginal (state-dependent message)")


def test_damping_blends_the_stored_messages(hgf_runs):
    """Under damping the z chain's GCV messages are kept in the state
    (``_msg:<factor id>:z``); without it they are not.  (The observation
    factor's cavity store of its (out, mean) cluster, ``_msg:<id>:mean``,
    is kept either way, as in the JAX package.)"""
    program = trx.batched_program(
        tzoo.hgf(), {"y": hgf_y()}, iterations=2, initialization=z_init(td),
        meta=DAMPED, device=CPU)[1]
    state, _, _ = program({"y": hgf_y()})
    keys = [k for k in state if k.startswith("_msg:") and k.endswith(":z")]
    assert len(keys) == 1
    assert tuple(state[keys[0]].xi.shape) == (B, T - 1)
    program = trx.batched_program(
        tzoo.hgf(), {"y": hgf_y()}, iterations=2, initialization=z_init(td),
        device=CPU)[1]
    state = program({"y": hgf_y()})[0]
    assert not [k for k in state if k.endswith(":z")]
    assert [k for k in state if k.startswith("_")] \
        == [k for k in state if k.startswith("_msg:") and k.endswith(":mean")]


def test_hgf_infer_matches_jax():
    y = hgf_y(1)[0]
    kw = dict(data={"y": y}, iterations=3, free_energy=True)
    jres = jrx.infer(jzoo.hgf(), initialization=z_init(jd), **kw)
    tres = trx.infer(tzoo.hgf(), initialization=z_init(td), device=CPU, **kw)
    for name in ("x", "z"):
        for tp, jp in zip(tres.posteriors[name], jres.posteriors[name]):
            assert_rel(tp.mean().numpy(), jp.mean(), POST_TOL)
            assert_rel(tp.var().numpy(), jp.var(), POST_TOL)
    np.testing.assert_allclose(
        tres.free_energy.numpy(),
        np.asarray(jres.free_energy)
        - z_entropy_offset(tres.posteriors["z"]), **FE_TOL)


def iid_volatility(rx, t_len):
    """A GCV chain whose volatilities are independent a step, not a chain:
    z is a plain array group whose rule (GCV's message to z) reads its own
    marginal."""
    @rx.model
    def iid_z(y):
        z = rx.latent(t_len, name="z")
        for t in rx.plate(t_len):
            z[t] = rx.Normal(mean=-1.0, var=1.0)
        x = rx.latent(t_len, name="x")
        x[0] = rx.Normal(mean=0.0, var=1.0)
        for t in rx.plate(1, t_len):
            x[t] = rx.GCV(x[t - 1], z[t], kappa=KAPPA, omega=OMEGA)
        for t in rx.plate(t_len):
            y[t] = rx.Normal(mean=x[t], var=0.01)
        return {"z": z, "x": x}

    return iid_z


def test_a_plain_group_reading_its_own_marginal_matches_jax():
    y = hgf_y()
    kw = dict(iterations=3, free_energy=True)
    jinit = {"z": jd.NormalMeanVariance(-1.0, 1.0)}
    tinit = {"z": td.NormalMeanVariance(torch.tensor(-1.0),
                                        torch.tensor(1.0))}
    jc, _ = jrx.batched_program(iid_volatility(jrx, T), {"y": y},
                                initialization=jinit, **kw)
    jpost, jfe = jrx.infer_batched(iid_volatility(jrx, T), {"y": y},
                                   initialization=jinit, **kw)
    tc, _ = trx.batched_program(iid_volatility(trx, T), {"y": y},
                                initialization=tinit, device=CPU, **kw)
    tpost, tfe = trx.infer_batched(iid_volatility(trx, T), {"y": y},
                                   initialization=tinit, device=CPU, **kw)
    assert [k for k, _ in tc.blocks] == [k for k, _ in jc.blocks]
    for name in ("x", "z"):
        assert_rel(tpost[name].mean().numpy(), jpost[name].mean(), POST_TOL)
        assert_rel(tpost[name].var().numpy(), jpost[name].var(), POST_TOL)
    np.testing.assert_allclose(
        tfe.numpy()[-1],
        np.asarray(jfe)[-1] - tpost["z"].entropy().numpy()[:, 1:].sum(-1),
        **FE_TOL)


def test_meta_by_neighbourhood_matches_jax():
    """``meta={("GCV", ("x", "z")): ...}`` reaches the GCV factors bound to
    x and z; a key naming another variable reaches none."""
    y = hgf_y()
    kw = dict(iterations=3, device=CPU, initialization=z_init(td))
    meta = {("GCV", ("x", "z")): {"damping": 0.5}}
    jpost, _ = jrx.infer_batched(jzoo.hgf(), {"y": y}, iterations=3,
                                 initialization=z_init(jd), meta=meta)
    tpost, _ = trx.infer_batched(tzoo.hgf(), {"y": y}, meta=meta, **kw)
    assert_rel(tpost["z"].mean().numpy(), jpost["z"].mean(), POST_TOL)
    other, _ = trx.infer_batched(tzoo.hgf(), {"y": y},
                                 meta={("GCV", ("w",)): {"damping": 0.5}},
                                 **kw)
    plain, _ = trx.infer_batched(tzoo.hgf(), {"y": y}, **kw)
    np.testing.assert_array_equal(other["z"].mean().numpy(),
                                  plain["z"].mean().numpy())
    assert not np.array_equal(tpost["z"].mean().numpy(),
                              plain["z"].mean().numpy())


def test_program_cache_tells_meta_values_apart():
    """A damped program, then an undamped one of the same model and
    shapes: the second call must not get the damped program back (the
    port's caches compared the bound values, the initialization and the
    options, not the meta); both entry points."""
    y = hgf_y()
    model = tzoo.hgf()
    kw = dict(iterations=3, initialization=z_init(td), device=CPU)
    c_damped, _ = trx.batched_program(model, {"y": y}, meta=DAMPED, **kw)
    # an equal meta value (a fresh dict) is a hit
    assert trx.batched_program(model, {"y": y},
                               meta={"GCV": {"damping": 0.8}},
                               **kw)[0] is c_damped
    c_plain, _ = trx.batched_program(model, {"y": y}, **kw)
    assert c_plain is not c_damped
    assert trx.batched_program(model, {"y": y}, meta={"GCV": {"damping": 0.5}},
                               **kw)[0] is not c_plain
    damped_z = trx.infer_batched(model, {"y": y}, meta=DAMPED,
                                 **kw)[0]["z"].mean().numpy()
    plain_z = trx.infer_batched(model, {"y": y}, **kw)[0]["z"].mean().numpy()
    fresh, _ = trx.infer_batched(tzoo.hgf(), {"y": y}, **kw)
    np.testing.assert_array_equal(plain_z, fresh["z"].mean().numpy())
    assert not np.allclose(plain_z, damped_z, rtol=1e-3, atol=1e-3)
    one = dict(data={"y": y[0]}, iterations=3, initialization=z_init(td),
               device=CPU)
    d_res = trx.infer(model, meta=DAMPED, **one)
    p_res = trx.infer(model, **one)
    assert p_res.model is not d_res.model
    np.testing.assert_array_equal(
        p_res.posteriors["z"][-1].mean().numpy(),
        trx.infer(tzoo.hgf(), **one).posteriors["z"][-1].mean().numpy())


def test_a_single_step_gcv_is_refused_with_its_roadmap_item():
    """A single-step GCV (no chain's transition), refused until ROADMAP A6c
    ported its (out, in) pair (``attach_gcv_pair_cross``): ``infer`` now
    runs it, and its posteriors and free energy equal the JAX package's."""
    def make(rx):
        @rx.model
        def one_step(y):
            x0 = rx.Normal(mean=0.0, var=1.0)
            z = rx.Normal(mean=0.0, var=1.0)
            x = rx.GCV(x0, z, kappa=KAPPA, omega=OMEGA)
            y.observe(rx.Normal(mean=x, var=0.01))
            return {"x": x}

        return one_step

    kw = dict(data={"y": np.float32(0.3)}, iterations=6, free_energy=True,
              returnvars=jrx.KeepLast())
    jres = jrx.infer(make(jrx), initialization={
        n: jd.NormalMeanVariance(0.0, 1.0) for n in ("z", "x")}, **kw)
    kw["returnvars"] = trx.KeepLast()
    tres = trx.infer(make(trx), initialization={
        n: td.NormalMeanVariance(torch.tensor(0.0), torch.tensor(1.0))
        for n in ("z", "x")}, device=CPU, **kw)
    assert_rel(tres.posteriors["x"].mean().numpy(),
               jres.posteriors["x"].mean(), POST_TOL)
    assert_rel(tres.posteriors["x"].var().numpy(),
               jres.posteriors["x"].var(), POST_TOL)
    np.testing.assert_allclose(tres.free_energy.numpy(),
                               np.asarray(jres.free_energy), **FE_TOL)
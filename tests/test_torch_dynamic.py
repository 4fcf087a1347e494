"""The dynamic-precision tier through both packages: chains whose
observation precision (W) and/or process noise (Q) is a random ``Gamma`` /
``Wishart`` variable, re-closed per chain every sweep and solved by the
fused smoother with per-chain W / Q (the models of
tests/engine/test_fused_dynamic.py but ``shared=``, whose pooling is not
ported, and the cavity case, whose ``Delta`` node is not ported).  For each
model: the plan report and plan fields against the JAX package's planner,
and the posteriors of x and of the precisions after every sweep
(``KeepEach``) against the JAX package's fused program and against the
port's own ``fused_kernels=False`` program; ``infer`` on the scalar-tau
model against JAX ``infer``; the float32 vague-precision guard; the two
planner guards; the plan converter.  JAX runs as its own tests run it on
the CPU (Pallas in interpret mode); the port runs on the CPU with its
kernels' plain versions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rxinfer_tpu as jrx
import rxinfer_tpu_torch as trx
from rxinfer_tpu import dists as jd
from rxinfer_tpu.engine import batched as jbatched
from rxinfer_tpu_torch import convert
from rxinfer_tpu_torch import dists as td
from rxinfer_tpu_torch.engine import batched as tbatched
from rxinfer_tpu_torch.graph.ir import Ref, Variable

CPU = torch.device("cpu")
# The JAX package's own fused-vs-scan tolerances for these models
# (tests/engine/test_fused_dynamic.py): posterior means atol 5e-5 with
# rtol 1e-4 (atol 1e-4 for the d = 2 model with both precisions random),
# precision means rtol 1e-4.  Port against JAX and port fused against port
# unfused are held to the same: float32 in two libraries, and the fused
# smoother against the associative scans.
MEAN_TOL = dict(rtol=1e-4, atol=5e-5)
MV_MEAN_TOL = dict(rtol=1e-4, atol=1e-4)
PREC_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# -- the models, one source for both packages ------------------------------------------

def walk_tau(rx):
    @rx.model
    def walk_tau(y):
        T = len(y)
        tau = rx.Gamma(shape=2.0, rate=2.0)
        x = rx.latent(T, name="x")
        x[0] = rx.Normal(mean=0.0, var=100.0)
        for t in rx.plate(1, T):
            x[t] = rx.Normal(mean=x[t - 1], var=0.25)
        for t in rx.plate(T):
            y[t] = rx.Normal(mean=x[t], precision=tau)

    return walk_tau


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


HIER_D = 2


def hier(rx):
    d = HIER_D
    a = (0.9 * np.eye(d)).astype(np.float32)
    nu0 = float(d) + 1.0
    eye = np.eye(d, dtype=np.float32)

    @rx.model
    def hier(y):
        T = len(y)
        Wq = rx.Wishart(nu0, eye)
        Wr = rx.Wishart(nu0, eye)
        x = rx.latent(T, name="x")
        x[0] = rx.MvNormal(mean=np.zeros(d, np.float32),
                           cov=(10.0 * np.eye(d)).astype(np.float32))
        for t in rx.plate(1, T):
            x[t] = rx.MvNormal(mean=a @ x[t - 1], precision=Wq)
        for t in rx.plate(T):
            y[t] = rx.MvNormal(mean=x[t], precision=Wr)

    return hier


def two_tau(rx):
    @rx.model
    def two_tau(y1, y2):
        T = len(y1)
        tau1 = rx.Gamma(shape=2.0, rate=2.0)
        tau2 = rx.Gamma(shape=3.0, rate=1.0)
        x = rx.latent(T, name="x")
        x[0] = rx.Normal(mean=0.0, var=50.0)
        for t in rx.plate(1, T):
            x[t] = rx.Normal(mean=x[t - 1], var=0.3)
        for t in rx.plate(T):
            y1[t] = rx.Normal(mean=x[t], precision=tau1)
        for t in rx.plate(T):
            y2[t] = rx.Normal(mean=x[t], precision=tau2)

    return two_tau


def gain_tau(rx):
    """Evidence factors that differ only in a constant gain: slot 0 reads
    2 x[0], the others 3 x[t], all with the same random precision."""
    @rx.model
    def gain_tau(y):
        T = len(y)
        tau = rx.Gamma(shape=2.0, rate=2.0)
        x = rx.latent(T, name="x")
        x[0] = rx.Normal(mean=0.0, var=100.0)
        for t in rx.plate(1, T):
            x[t] = rx.Normal(mean=x[t - 1], var=0.25)
        y[0] = rx.Normal(mean=2.0 * x[0], precision=tau)
        for t in rx.plate(1, T):
            y[t] = rx.Normal(mean=3.0 * x[t], precision=tau)

    return gain_tau


def _gamma(dists, a, b):
    if dists is td:
        return td.GammaShapeRate(torch.tensor(a), torch.tensor(b))
    return jd.GammaShapeRate(a, b)


def _wishart(dists, nu, s):
    if dists is td:
        return td.Wishart(torch.tensor(nu), torch.as_tensor(s))
    return jd.Wishart(nu, s)


def _data(name):
    if name == "walk_tau":
        rng = np.random.default_rng(0)
        return {"y": np.cumsum(rng.standard_normal((3, 17)),
                               axis=1).astype(np.float32)}
    if name == "walk_q":
        rng = np.random.default_rng(2)
        return {"y": np.cumsum(0.5 * rng.standard_normal((4, 15)),
                               axis=1).astype(np.float32)}
    if name == "hier":
        rng = np.random.default_rng(3)
        return {"y": np.cumsum(rng.standard_normal((3, 14, HIER_D)),
                               axis=1).astype(np.float32)}
    rng = np.random.default_rng(7)
    walk = np.cumsum(0.6 * rng.standard_normal((3, 13)), axis=1)
    return {"y1": (walk + 0.7 * rng.standard_normal((3, 13))).astype(
                np.float32),
            "y2": (walk + 0.4 * rng.standard_normal((3, 13))).astype(
                np.float32)}


def _init(name, dists):
    eye = np.eye(HIER_D, dtype=np.float32)
    return {
        "walk_tau": lambda: {"tau": _gamma(dists, 2.0, 2.0)},
        "walk_q": lambda: {"tw": _gamma(dists, 2.0, 1.0)},
        "hier": lambda: {"Wq": _wishart(dists, 3.0, eye),
                         "Wr": _wishart(dists, 3.0, eye)},
        "two_tau": lambda: {"tau1": _gamma(dists, 2.0, 2.0),
                            "tau2": _gamma(dists, 3.0, 1.0)},
    }[name]()


# name -> (source, dynamic report, W-linear or None, precision variables)
CASES = {
    "walk_tau": (walk_tau, ["W"], True, ("tau",)),
    "walk_q": (walk_q, ["Q"], None, ("tw",)),
    "hier": (hier, ["W", "Q"], True, ("Wq", "Wr")),
    "two_tau": (two_tau, ["W"], False, ("tau1", "tau2")),
}
ITERATIONS = 3


def _first(data):
    return {k: np.asarray(v)[0] for k, v in data.items()}


@pytest.fixture(scope="module")
def jax_runs():
    """Each model's JAX plan and fused posteriors after every sweep, once."""
    out = {}

    def run(name):
        if name not in out:
            source, *_ = CASES[name]
            data = _data(name)
            init = _init(name, jd)
            compiled, _ = jrx.batched_program(source(jrx), data, iterations=1,
                                              initialization=init)
            plan = jbatched.build_plans(compiled, _first(data))
            post, _ = jrx.infer_batched(source(jrx), data,
                                        iterations=ITERATIONS,
                                        initialization=init,
                                        returnvars=jrx.KeepEach())
            out[name] = (dict(compiled._plan_report), plan, post)
        return out[name]

    return run


def _port_posteriors(name, **options):
    source, *_ = CASES[name]
    post, _ = trx.infer_batched(source(trx), _data(name),
                                iterations=ITERATIONS,
                                initialization=_init(name, td),
                                returnvars=trx.KeepEach(), device=CPU,
                                options=dict(options, warn=False))
    return post


@pytest.mark.parametrize("name", sorted(CASES))
def test_dynamic_plan_matches_jax(name, jax_runs):
    source, dynamic, wlin, _ = CASES[name]
    jreport, jplans, _ = jax_runs(name)
    data = _data(name)
    compiled, _ = trx.batched_program(source(trx), data,
                                      initialization=_init(name, td),
                                      device=CPU)
    report = compiled.plan_report()["x"]
    assert report["fused"] is True and jreport["x"]["fused"] is True
    assert report["dynamic"] == jreport["x"]["dynamic"] == dynamic
    plan = tbatched.build_plans(compiled, _first(data), device=CPU)["x"]
    jplan = jplans["x"]
    assert (plan.dyn_w, plan.dyn_q) == (jplan.dyn_w, jplan.dyn_q)
    assert (plan.W is None, plan.Q is None, plan.E is None) == (
        jplan.W is None, jplan.Q is None, jplan.E is None)
    assert (plan.wlin is not None) == (jplan.wlin is not None)
    if wlin is None:
        assert "w_linear" not in report
    else:
        assert report["w_linear"] is wlin
        assert jreport["x"].get("w_linear", False) is wlin
    if wlin is False:
        assert "2 precision variables" in report["w_linear_reason"]
    if plan.wlin is not None:
        _, scalar_v, e0, jt, c0, w0, dw = plan.wlin
        _, jscalar, je0, jjt, jc0, jw0, jdw = jplan.wlin
        assert scalar_v == jscalar and sorted(e0) == sorted(je0)
        for k in e0:
            np.testing.assert_allclose(e0[k], je0[k], rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(jt[k], jjt[k], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(w0, jw0, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(c0, jc0, rtol=1e-5, atol=1e-5)


def _mean(q):
    return np.asarray(q.mean().numpy() if isinstance(q.mean(), torch.Tensor)
                      else q.mean())


@pytest.mark.parametrize("name", sorted(CASES))
def test_dynamic_posteriors_match_jax_and_the_scan_path(name, jax_runs):
    _, _, _, precisions = CASES[name]
    _, _, jpost = jax_runs(name)
    fused = _port_posteriors(name)
    scan = _port_posteriors(name, fused_kernels=False)
    mean_tol = MV_MEAN_TOL if name == "hier" else MEAN_TOL
    for nm in ("x",) + precisions:
        assert len(fused[nm]) == len(scan[nm]) == len(jpost[nm]) \
            == ITERATIONS
        tol = mean_tol if nm == "x" else PREC_TOL
        for it in range(ITERATIONS):
            got = _mean(fused[nm][it])
            np.testing.assert_allclose(got, _mean(jpost[nm][it]), **tol)
            np.testing.assert_allclose(got, _mean(scan[nm][it]), **tol)
    x = fused["x"][-1]
    var = x.cov().numpy() if name == "hier" else x.var().numpy()
    jx = jpost["x"][-1]
    jvar = np.asarray(jx.cov() if name == "hier" else jx.var())
    np.testing.assert_allclose(var, jvar, **mean_tol)
    if name == "walk_tau":
        # the per-chain precisions diverge: the kernels saw batch-varying W
        assert np.ptp(_mean(fused["tau"][-1])) > 1e-3


def test_dyn_w_matches_per_dataset_infer_and_jax_infer():
    """The batched dynamic path against the single-dataset ``infer`` (which
    never plans) of both packages, element by element."""
    data = _data("walk_tau")
    y = data["y"]
    post, _ = trx.infer_batched(walk_tau(trx), data, iterations=3,
                                initialization=_init("walk_tau", td),
                                returnvars=trx.KeepLast(), device=CPU)
    for i in (0, y.shape[0] - 1):
        ref = trx.infer(walk_tau(trx), data={"y": y[i]}, iterations=3,
                        initialization=_init("walk_tau", td),
                        returnvars=trx.KeepLast(), device=CPU)
        np.testing.assert_allclose(post["x"].mean().numpy()[i],
                                   ref.posteriors["x"].mean().numpy(),
                                   **MEAN_TOL)
        np.testing.assert_allclose(post["tau"].mean().numpy()[i],
                                   ref.posteriors["tau"].mean().numpy(),
                                   **PREC_TOL)
    jref = jrx.infer(model=walk_tau(jrx), data={"y": y[0]}, iterations=3,
                     initialization=_init("walk_tau", jd),
                     returnvars=jrx.KeepLast())
    ref = trx.infer(walk_tau(trx), data={"y": y[0]}, iterations=3,
                    initialization=_init("walk_tau", td),
                    returnvars=trx.KeepLast(), device=CPU)
    np.testing.assert_allclose(ref.posteriors["x"].mean().numpy(),
                               np.asarray(jref.posteriors["x"].mean()),
                               **MEAN_TOL)
    np.testing.assert_allclose(ref.posteriors["tau"].mean().numpy(),
                               np.asarray(jref.posteriors["tau"].mean()),
                               **PREC_TOL)


def test_dyn_w_respects_keep_each_history():
    """KeepEach across sweeps: the fused dynamic path keeps every sweep's
    marginals as the scan path does."""
    rng = np.random.default_rng(6)
    y = rng.standard_normal((2, 10)).astype(np.float32)
    kw = dict(iterations=3, initialization=_init("walk_tau", td),
              returnvars=trx.KeepEach(), device=CPU)
    fused, _ = trx.infer_batched(walk_tau(trx), {"y": y}, **kw)
    scan, _ = trx.infer_batched(walk_tau(trx), {"y": y},
                                options={"fused_kernels": False}, **kw)
    assert isinstance(fused["x"], list) and len(fused["x"]) == 3
    for qf, qs in zip(fused["x"], scan["x"]):
        np.testing.assert_allclose(qf.mean().numpy(), qs.mean().numpy(),
                                   **MEAN_TOL)


def test_the_vague_precision_guard_caps_the_process_noise_in_both():
    """A vague Gamma on the process-noise precision (E[tw] = 1e-9) gives
    Q = (E[tw] + 1e-4)^-1 ~ 1e4 in both packages, not 1e9, and both fused
    programs stay finite with positive variances and agree."""
    rng = np.random.default_rng(9)
    y = np.cumsum(0.5 * rng.standard_normal((3, 12)), axis=1).astype(
        np.float32)
    vague = {"tw": _gamma(td, 1.0, 1e9)}
    jvague = {"tw": _gamma(jd, 1.0, 1e9)}
    tc, _ = trx.batched_program(walk_q(trx), {"y": y}, initialization=vague,
                                device=CPU)
    jc, _ = jrx.batched_program(walk_q(jrx), {"y": y}, initialization=jvague)
    tblock = next(b for k, b in tc.blocks if k == "chain")
    jblock = next(b for k, b in jc.blocks if k == "chain")
    _, _, tq = tblock._transition_params(tc._init_state(),
                                         {"y": torch.as_tensor(y[0])}, 12)
    _, _, jq = jblock._transition_params(jc._init_state(),
                                         {"y": jnp.asarray(y[0])}, 12)
    want = 1.0 / (1e-9 + 1e-4)
    np.testing.assert_allclose(tq.numpy()[0, 0, 0], want, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(jq)[0, 0, 0], want, rtol=1e-4)
    kw = dict(iterations=3, returnvars=trx.KeepLast())
    post, _ = trx.infer_batched(walk_q(trx), {"y": y}, initialization=vague,
                                device=CPU, **kw)
    jpost, _ = jrx.infer_batched(walk_q(jrx), {"y": y},
                                 initialization=jvague, **kw)
    var = post["x"].var().numpy()
    assert np.isfinite(var).all() and (var > 0).all()
    np.testing.assert_allclose(post["x"].mean().numpy(),
                               np.asarray(jpost["x"].mean()), **MEAN_TOL)
    np.testing.assert_allclose(post["tw"].mean().numpy(),
                               np.asarray(jpost["tw"].mean()), **PREC_TOL)


def test_slot_signature_holds_the_constants():
    """Evidence factors that differ only in a constant gain give different
    W per slot.  With a near-zero initial E[tau] the JAX planner's numeric
    check passes (4 E[tau] and 9 E[tau] are both below its 1e-6) and its
    structural signature omits the constants, so it plans the chain with
    one W for every slot and its fused posteriors leave the scan path's.
    The port's signature holds the constants' values: it keeps the chain
    off the dynamic tier, and its posteriors are the scan path's."""
    rng = np.random.default_rng(12)
    y = np.cumsum(rng.standard_normal((2, 9)), axis=1).astype(np.float32)
    kw = dict(iterations=3, returnvars=jrx.KeepLast())
    jinit = {"tau": _gamma(jd, 1.0, 1e7)}
    jfused, _ = jrx.infer_batched(gain_tau(jrx), {"y": y},
                                  initialization=jinit,
                                  options={"warn": False}, **kw)
    jscan, _ = jrx.infer_batched(gain_tau(jrx), {"y": y},
                                 initialization=jinit,
                                 options={"fused_kernels": False,
                                          "warn": False}, **kw)
    jc, _ = jrx.batched_program(gain_tau(jrx), {"y": y},
                                initialization=jinit)
    assert jc._plan_report["x"].get("dynamic") == ["W"]
    assert np.abs(np.asarray(jfused["x"].mean())
                  - np.asarray(jscan["x"].mean())).max() > 1e-2

    tinit = {"tau": _gamma(td, 1.0, 1e7)}
    with pytest.warns(UserWarning, match="constants per slot"):
        tc, _ = trx.batched_program(gain_tau(trx), {"y": y},
                                    initialization=tinit, device=CPU)
    assert tc.plan_report()["x"]["fused"] is False
    post, _ = trx.infer_batched(gain_tau(trx), {"y": y},
                                initialization=tinit, device=CPU,
                                options={"warn": False}, iterations=3,
                                returnvars=trx.KeepLast())
    np.testing.assert_allclose(post["x"].mean().numpy(),
                               np.asarray(jscan["x"].mean()), **MEAN_TOL)
    np.testing.assert_allclose(post["tau"].mean().numpy(),
                               np.asarray(jscan["tau"].mean()), **PREC_TOL)


def _walk_tau_block():
    data = _data("walk_tau")
    compiled, _ = trx.batched_program(walk_tau(trx), data,
                                      initialization=_init("walk_tau", td),
                                      device=CPU)
    block = next(b for k, b in compiled.blocks if k == "chain")
    return block, _first(data), compiled._init_state()


def test_a_dynamic_precision_must_be_a_single_copy_variable():
    """A whole-variable reference to an array variable (several copies, a
    marginal a slot) is not one precision.  The port's compiler refuses
    such a model (an array group must be indexed), so no model of ported
    nodes reaches the planner with one; the planner refuses it too."""
    block, d0, state0 = _walk_tau_block()
    ef, iface = block.evidence[0]
    taus = Variable("taus", "random", block.var.length)
    ef.interfaces["prec"] = Ref(taus)
    plan, reason = tbatched._plan_fused_gaussian(block, d0, state0)
    assert plan is None and "several copies" in reason


def test_cavity_evidence_stays_off_the_dynamic_tier():
    """A random interface beside a random precision in the evidence
    factor's BP cluster needs the EP message store: the planner refuses."""
    block, d0, state0 = _walk_tau_block()
    ef, iface = block.evidence[0]
    assert iface == "mean"
    ef.out = Ref(Variable("z", "random", None))
    plan, reason = tbatched._plan_fused_gaussian(block, d0, state0)
    assert plan is None and "cavity division" in reason


def test_converted_dynamic_plan_reproduces_the_jax_update(jax_runs):
    """A JAX dynamic plan's fields through ``fused_plan_from_numpy``: the
    port's update on the initial state equals the JAX package's."""
    _, jplans, _ = jax_runs("hier")
    jplan = jplans["x"]
    fields = {f: getattr(jplan, f) for f in (
        "A", "b", "Q", "W", "m0", "p0", "E", "c", "chunk", "dyn_w", "dyn_q",
        "wlin")}
    tplan = convert.fused_plan_from_numpy(jax.tree_util.tree_map(
        lambda a: np.asarray(a) if isinstance(a, jax.Array) else a, fields))
    assert tplan.dyn_w and tplan.dyn_q and tplan.W is None
    data = _data("hier")
    b = data["y"].shape[0]
    jc, _ = jrx.batched_program(hier(jrx), data, iterations=1,
                                initialization=_init("hier", jd))
    tc, _ = trx.batched_program(hier(trx), data,
                                initialization=_init("hier", td), device=CPU)
    jblock = next(blk for k, blk in jc.blocks if k == "chain")
    tblock = next(blk for k, blk in tc.blocks if k == "chain")
    jstate = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (b,) + jnp.shape(a)), jc._init_state())
    tstate = {k: td.tree_map(lambda a: a.expand((b,) + tuple(a.shape)), v)
              for k, v in tc._init_state().items()}
    jmarg, jcross = jbatched._fused_gaussian_update(
        jblock, jplan, {"y": jnp.asarray(data["y"])}, b, state=jstate)
    tmarg, tcross = tbatched._fused_gaussian_update(
        tblock, tplan, {"y": torch.as_tensor(data["y"])}, b, state=tstate)
    np.testing.assert_allclose(tmarg.mu.numpy(), np.asarray(jmarg.mu),
                               **MV_MEAN_TOL)
    np.testing.assert_allclose(tcross.numpy(), np.asarray(jcross),
                               **MV_MEAN_TOL)


def test_dist_from_numpy_takes_the_precision_families():
    rng = np.random.default_rng(14)
    s = np.eye(3, dtype=np.float32) + 0.1
    w = convert.dist_from_numpy("Wishart", {"nu": 5.0, "s": s})
    np.testing.assert_allclose(w.mean().numpy(),
                               np.asarray(jd.Wishart(5.0, s).mean()),
                               rtol=1e-6)
    g = convert.dist_from_numpy("GammaShapeRate", [2.0, 3.0])
    assert float(g.mean()) == pytest.approx(2.0 / 3.0)
    c = convert.dist_from_numpy("WishartInverseScale",
                                [5.0, rng.random((3, 3)) + 3 * np.eye(3)])
    assert isinstance(c.to_wishart(), td.Wishart)

"""BASELINE config 5's engine through both packages: ``infer(datastream=,
autoupdates=)``, ``RxInferenceEngine`` (``on_next``, ``run_offline`` on one
stream and on a batch of streams, through the fused stream plan and the
generic tick), its events, history and free energy per tick, mu(x)
autoupdates and its refusals, held tick by tick against the JAX engine.
Each package's autoupdate mappings are written in its own array library over
the same numpy constants.  Inputs come from numpy seeds; the port runs on
the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rxinfer_tpu as jrx
import rxinfer_tpu_torch as trx
from rxinfer_tpu import dists as jd
from rxinfer_tpu.models import zoo as jzoo
from rxinfer_tpu_torch import dists as td
from rxinfer_tpu_torch.models import zoo as tzoo

CPU = torch.device("cpu")
# float32 ticks in two libraries, the same operations a tick
TICK_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _system(d=2):
    th = np.pi / 20
    a = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]],
                 np.float32)
    q = 0.5 * np.eye(d, dtype=np.float32)
    b = np.array([[1.0, 0.2], [0.0, 1.0]], np.float32)
    r = np.eye(d, dtype=np.float32)
    return a, q, b, r


def _moments_close(jpost, tpost):
    np.testing.assert_allclose(_np(tpost.mean()), _np(jpost.mean()),
                               **TICK_TOL)
    np.testing.assert_allclose(_np(tpost.cov()), _np(jpost.cov()), **TICK_TOL)


# -- zoo.kalman_filter_step ----------------------------------------------------------

def test_kalman_step_on_next_matches_jax_tick_by_tick():
    a, q, b, r = _system()
    y = np.random.default_rng(0).standard_normal((15, 2)).astype(np.float32)
    m0, v0 = np.zeros(2, np.float32), 25 * np.eye(2, dtype=np.float32)
    jstep, jau = jzoo.kalman_filter_step(a, q, b, r)
    tstep, tau = tzoo.kalman_filter_step(a, q, b, r)
    stream = [{"y": y[t]} for t in range(len(y))]
    jeng = jrx.infer(model=jstep, datastream=stream, autoupdates=jau(m0, v0),
                     keephistory=100)
    teng = trx.infer(model=tstep, datastream=stream, autoupdates=tau(m0, v0),
                     keephistory=100, device=CPU)
    assert len(teng.history) == len(jeng.history) == len(y)
    for jh, th in zip(jeng.history, teng.history):
        _moments_close(jh["x"], th["x"])
    for k in ("pm", "pc"):
        np.testing.assert_allclose(_np(teng.args[k]), _np(jeng.args[k]),
                                   **TICK_TOL)


def test_kalman_step_run_offline_matches_jax_and_on_next():
    a, q, b, r = _system()
    y = np.random.default_rng(1).standard_normal((20, 2)).astype(np.float32)
    m0, v0 = np.zeros(2, np.float32), 25 * np.eye(2, dtype=np.float32)
    jstep, jau = jzoo.kalman_filter_step(a, q, b, r)
    tstep, tau = tzoo.kalman_filter_step(a, q, b, r)
    jposts, jfes = jrx.RxInferenceEngine(jstep, jau(m0, v0)).run_offline(
        {"y": y})
    teng = trx.RxInferenceEngine(tstep, tau(m0, v0), device=CPU)
    tposts, tfes = teng.run_offline({"y": y})
    _moments_close(jposts["x"], tposts["x"])
    assert tuple(tfes.shape) == np.asarray(jfes).shape == (20, 0)
    # the same stream tick by tick through on_next
    online = trx.infer(model=tstep, datastream=[{"y": v} for v in y],
                       autoupdates=tau(m0, v0), keephistory=20, device=CPU)
    np.testing.assert_allclose(
        np.stack([_np(h["x"].mean()) for h in online.history]),
        _np(tposts["x"].mean()), rtol=0, atol=0)


def test_a_missing_observation_leaves_the_prediction_on_next_and_offline():
    """A NaN observation removes its likelihood from the tick (its factor
    copy is masked), so the posterior is the prediction, in both
    packages."""
    a, q, b, r = _system()
    y = np.random.default_rng(6).standard_normal((6, 2)).astype(np.float32)
    y[2] = np.nan
    m0, v0 = np.zeros(2, np.float32), 4 * np.eye(2, dtype=np.float32)
    jstep, jau = jzoo.kalman_filter_step(a, q, b, r)
    tstep, tau = tzoo.kalman_filter_step(a, q, b, r)
    stream = [{"y": v} for v in y]
    jeng = jrx.infer(model=jstep, datastream=stream, autoupdates=jau(m0, v0),
                     keephistory=6)
    teng = trx.infer(model=tstep, datastream=stream, autoupdates=tau(m0, v0),
                     keephistory=6, device=CPU)
    for jh, th in zip(jeng.history, teng.history):
        _moments_close(jh["x"], th["x"])
    np.testing.assert_allclose(_np(teng.history[2]["x"].mean()),
                               a @ _np(teng.history[1]["x"].mean()),
                               rtol=1e-5, atol=1e-6)
    jposts, _ = jrx.RxInferenceEngine(jstep, jau(m0, v0)).run_offline(
        {"y": y})
    tposts, _ = trx.RxInferenceEngine(tstep, tau(m0, v0),
                                      device=CPU).run_offline({"y": y})
    _moments_close(jposts["x"], tposts["x"])


def _batched_au(pkg, a, q, bsz, v0):
    initial = {"pm": np.zeros((bsz, 2), np.float32),
               "pc": np.broadcast_to(v0, (bsz, 2, 2)).copy()}
    if pkg is jrx:
        return jrx.autoupdates(
            initial=initial,
            pm=lambda qq: jnp.einsum("ij,bj->bi", a, qq["x"].mean()),
            pc=lambda qq: jnp.einsum("ij,bjk,lk->bil", a, qq["x"].cov(), a)
            + q)
    at, qt = torch.as_tensor(a), torch.as_tensor(q)
    return trx.autoupdates(
        initial=initial,
        pm=lambda qq: torch.einsum("ij,bj->bi", at, qq["x"].mean()),
        pc=lambda qq: torch.einsum("ij,bjk,lk->bil", at, qq["x"].cov(), at)
        + qt)


def _stream_tick(rx, r):
    """bench.py:446-449's tick model."""
    @rx.model
    def tick(y, pm, pc):
        x = rx.MvNormal(mean=pm, cov=pc)
        y.observe(rx.MvNormal(mean=x, cov=r))
        return {"x": x}

    return tick


@pytest.mark.parametrize("returnvars,fused", [(None, True), ("x", False)])
def test_batched_run_offline_matches_jax(returnvars, fused):
    """The fused stream plan and the generic tick (``returnvars`` turns the
    plan off, in both packages) against the JAX engine, tick by tick."""
    a, q, _, r = _system()
    bsz, t_len = 6, 14
    v0 = 9 * np.eye(2, dtype=np.float32)
    y = np.random.default_rng(2).standard_normal((t_len, bsz, 2)).astype(
        np.float32)
    jeng = jrx.infer(model=_stream_tick(jrx, r), datastream=None,
                     autoupdates=_batched_au(jrx, a, q, bsz, v0),
                     batched=True, returnvars=returnvars)
    teng = trx.infer(model=_stream_tick(trx, r), datastream=None,
                     autoupdates=_batched_au(trx, a, q, bsz, v0),
                     batched=True, returnvars=returnvars, device=CPU)
    jposts, jfes = jeng.run_offline({"y": y})
    tposts, tfes = teng.run_offline({"y": y})
    assert (("fstream",) in jeng._jitted) is fused
    assert bool(teng._stream_plan) is fused
    _moments_close(jposts["x"], tposts["x"])
    assert tuple(tposts["x"].mean().shape) == (t_len, bsz, 2)
    assert tuple(tfes.shape) == np.asarray(jfes).shape == (t_len, bsz, 0)
    for k in ("pm", "pc"):
        np.testing.assert_allclose(_np(teng.args[k]), _np(jeng.args[k]),
                                   **TICK_TOL)
    # a second call carries on from the first call's final arguments
    jposts2, _ = jeng.run_offline({"y": y[:3]})
    tposts2, _ = teng.run_offline({"y": y[:3]})
    _moments_close(jposts2["x"], tposts2["x"])


def test_fused_plan_constants_match_jax():
    from rxinfer_tpu.engine.stream_plan import plan_fused_stream as jplan
    from rxinfer_tpu_torch.engine.stream_plan import plan_fused_stream

    a, q, _, r = _system()
    v0 = 4 * np.eye(2, dtype=np.float32)
    jeng = jrx.infer(model=_stream_tick(jrx, r), datastream=None,
                     autoupdates=_batched_au(jrx, a, q, 3, v0), batched=True)
    teng = trx.infer(model=_stream_tick(trx, r), datastream=None,
                     autoupdates=_batched_au(trx, a, q, 3, v0), batched=True,
                     device=CPU)
    y0 = np.zeros((1, 3, 2), np.float32)
    jeng.run_offline({"y": y0})
    teng.run_offline({"y": y0})
    jp = jplan(jeng._compiled, jeng.autoupdates, {"y": y0[0, 0]})
    tp = plan_fused_stream(teng._compiled, teng.autoupdates,
                           {"y": y0[0, 0]}, CPU)
    for field in ("W_obs", "E", "c", "F", "g", "Q"):
        np.testing.assert_allclose(getattr(tp, field), getattr(jp, field),
                                   rtol=1e-5, atol=1e-6)
    assert (tp.var, tp.obs, tp.pm_arg, tp.pc_arg) == ("x", "y", "pm", "pc")


def test_a_nonlinear_autoupdate_takes_the_generic_tick():
    """The probe refuses a mean map that is not affine in the posterior
    mean; the generic tick then runs, and agrees with the JAX engine."""
    a, q, _, r = _system()
    bsz = 4
    y = np.random.default_rng(3).standard_normal((6, bsz, 2)).astype(
        np.float32)
    v0 = np.eye(2, dtype=np.float32)
    init = {"pm": np.zeros((bsz, 2), np.float32),
            "pc": np.broadcast_to(v0, (bsz, 2, 2)).copy()}
    jau = jrx.autoupdates(initial=init, pm=lambda qq: jnp.tanh(qq["x"].mean()),
                          pc=lambda qq: qq["x"].cov() + q)
    tau = trx.autoupdates(initial=init,
                          pm=lambda qq: torch.tanh(qq["x"].mean()),
                          pc=lambda qq: qq["x"].cov() + torch.as_tensor(q))
    jeng = jrx.infer(model=_stream_tick(jrx, r), datastream=None,
                     autoupdates=jau, batched=True)
    teng = trx.infer(model=_stream_tick(trx, r), datastream=None,
                     autoupdates=tau, batched=True, device=CPU)
    jposts, _ = jeng.run_offline({"y": y})
    tposts, _ = teng.run_offline({"y": y})
    assert teng._stream_plan is False and ("fstream",) not in jeng._jitted
    _moments_close(jposts["x"], tposts["x"])


def test_batched_on_next_matches_batched_run_offline():
    a, q, _, r = _system()
    bsz = 5
    v0 = 9 * np.eye(2, dtype=np.float32)
    y = np.random.default_rng(4).standard_normal((7, bsz, 2)).astype(
        np.float32)
    offline = trx.infer(model=_stream_tick(trx, r), datastream=None,
                        autoupdates=_batched_au(trx, a, q, bsz, v0),
                        batched=True, device=CPU)
    posts, _ = offline.run_offline({"y": y})
    online = trx.infer(model=_stream_tick(trx, r),
                       datastream=[{"y": v} for v in y],
                       autoupdates=_batched_au(trx, a, q, bsz, v0),
                       batched=True, keephistory=7, device=CPU)
    np.testing.assert_allclose(
        np.stack([_np(h["x"].mean()) for h in online.history]),
        _np(posts["x"].mean()), rtol=1e-6, atol=1e-6)


# -- events ---------------------------------------------------------------------------

def _bb_step(rx):
    @rx.model
    def step_model(y, pa, pb):
        theta = rx.Beta(pa, pb)
        y.observe(rx.Bernoulli(theta))
        return {"theta": theta}

    return step_model


def _bb_au(rx):
    return rx.autoupdates(initial={"pa": 1.0, "pb": 1.0},
                          pa=lambda q: q["theta"].a,
                          pb=lambda q: q["theta"].b)


def test_event_subset_matches_jax():
    """tests/inference/test_streaming.py:122's four events, in order."""
    names = ("before_data_update", "on_marginal_update", "after_data_update",
             "on_tick")
    seen = {}
    for rx, kw in ((jrx, {}), (trx, {"device": CPU})):
        got = seen[rx.__name__] = []
        eng = rx.RxInferenceEngine(
            _bb_step(rx), _bb_au(rx),
            event_callbacks={n: (lambda ev, _g=got: _g.append(ev.name))
                             for n in names}, **kw)
        eng.on_next({"y": np.asarray(1.0, np.float32)})
        np.testing.assert_allclose(_np(eng.posteriors["theta"].a), 2.0)
    assert seen["rxinfer_tpu_torch"] == seen["rxinfer_tpu"] == list(names)


def _gauss_scalar_step(rx):
    @rx.model
    def step(y, pm, pv):
        x = rx.Normal(mean=pm, var=pv)
        y.observe(rx.Normal(mean=x, var=1.0))
        return {"x": x}

    return step


def test_event_sequence_matches_jax():
    """tests/inference/test_streaming.py:186: every engine event, in the
    JAX engine's order, with one on_complete."""
    sequences = []
    for rx, kw in ((jrx, {}), (trx, {"device": CPU})):
        au = rx.autoupdates(initial={"pm": 0.0, "pv": 100.0},
                            pm=lambda q: q["x"].mean(),
                            pv=lambda q: q["x"].var())
        eng = rx.infer(model=_gauss_scalar_step(rx), autoupdates=au,
                       keephistory=4,
                       datastream=[{"y": np.float32(v)} for v in (0.1, -0.3)],
                       **kw)
        eng.stop()
        sequences.append([e.name for e in eng.events])
        assert not eng.is_running and not eng.is_errored
    assert sequences[0] == sequences[1]
    assert sequences[1].count("on_complete") == 1
    assert sequences[1][0] == "before_autostart"


def test_an_error_in_a_tick_fires_on_error():
    au = trx.autoupdates(initial={"pm": 0.0, "pv": 100.0},
                         pm=lambda q: q["x"].mean(),
                         pv=lambda q: q["nope"].var())
    eng = trx.RxInferenceEngine(_gauss_scalar_step(trx), au, device=CPU)
    with pytest.raises(KeyError):
        eng.start([{"y": np.float32(0.1)}])
    names = [e.name for e in eng.events]
    assert eng.is_errored and "on_error" in names
    assert names[-1] == "after_autostart" and "on_complete" not in names


def test_per_iteration_callbacks_and_stop_iteration_match_jax():
    """tests/inference/test_streaming_kwargs.py:47: a before/after_iteration
    callback runs the tick as a host loop; stop_iteration ends it early."""
    seen = {}
    for rx, dists, kw in ((jrx, jd, {}), (trx, td, {"device": CPU})):
        iters = seen[rx.__name__] = []

        def on_after(ev, _i=iters):
            _i.append((ev.payload["iteration"],
                       float(ev.payload["free_energy"])))
            if ev.payload["iteration"] == 2:
                ev.stop_iteration = True

        two = (np.float32(2.0) if rx is jrx else torch.tensor(2.0))
        eng = rx.infer(
            model=_gauss_step(rx), datastream=None, autoupdates=_gauss_au(rx),
            iterations=10, free_energy=True,
            initialization={"tau": dists.GammaShapeRate(two, two)},
            callbacks={"after_iteration": on_after}, **kw)
        eng.on_next({"y": np.float32(1.0)})
        eng.on_next({"y": np.float32(0.5)})
    jits, tits = seen["rxinfer_tpu"], seen["rxinfer_tpu_torch"]
    assert [i for i, _ in tits] == [0, 1, 2, 0, 1, 2]
    np.testing.assert_allclose([f for _, f in tits], [f for _, f in jits],
                               rtol=1e-5)


# -- history, returnvars and the free energy per tick ----------------------------------

def _gauss_step(rx):
    """tests/inference/test_streaming_kwargs.py:28's model."""
    @rx.model
    def step(y, pm, pv):
        x = rx.Normal(mean=pm, var=pv)
        tau = rx.Gamma(shape=2.0, rate=2.0)
        y.observe(rx.Normal(mean=x, precision=tau))
        return {"x": x, "tau": tau}

    return step


def _gauss_au(rx):
    return rx.autoupdates(initial={"pm": 0.0, "pv": 10.0},
                          pm=lambda q: q["x"].mean(),
                          pv=lambda q: q["x"].var())


def _gauss_engine(rx, dists, **kw):
    two = np.float32(2.0) if rx is jrx else torch.tensor(2.0)
    extra = {} if rx is jrx else {"device": CPU}
    return rx.infer(model=_gauss_step(rx), autoupdates=_gauss_au(rx),
                    initialization={"tau": dists.GammaShapeRate(two, two)},
                    **kw, **extra)


def test_historyvars_keep_each_and_keep_last_match_jax():
    stream = [{"y": np.float32(v)} for v in (1.0, 0.5, 2.0)]
    kw = dict(datastream=stream, iterations=4, keephistory=2)
    jeng = _gauss_engine(jrx, jd, historyvars={"x": jrx.KeepEach(),
                                               "tau": jrx.KeepLast()}, **kw)
    teng = _gauss_engine(trx, td, historyvars={"x": trx.KeepEach(),
                                               "tau": trx.KeepLast()}, **kw)
    assert len(teng.history) == len(jeng.history) == 2
    for jh, th in zip(jeng.history, teng.history):
        assert isinstance(th["x"], list) and len(th["x"]) == 4
        assert not isinstance(th["tau"], list)
        for jx, tx in zip(jh["x"], th["x"]):
            np.testing.assert_allclose(_np(tx.mean()), _np(jx.mean()),
                                       **TICK_TOL)
        np.testing.assert_allclose(_np(th["tau"].mean()),
                                   _np(jh["tau"].mean()), **TICK_TOL)


def test_historyvars_without_keephistory_warns():
    with pytest.warns(UserWarning, match="keephistory"):
        trx.infer(model=_bb_step(trx), datastream=[{"y": np.float32(1.0)}],
                  autoupdates=_bb_au(trx), historyvars=trx.KeepEach(),
                  device=CPU)


def test_returnvars_selects_posteriors():
    eng = _gauss_engine(trx, td, datastream=[{"y": np.float32(1.0)}],
                        returnvars=["x"])
    assert set(eng.posteriors) == {"x"}


def test_free_energy_per_tick_matches_jax():
    stream = [{"y": np.float32(v)} for v in (1.0, -0.4, 2.5, 0.3)]
    kw = dict(datastream=stream, iterations=3, free_energy=True)
    jeng = _gauss_engine(jrx, jd, **kw)
    teng = _gauss_engine(trx, td, **kw)
    assert len(teng.fe_history) == len(jeng.fe_history) == len(stream)
    np.testing.assert_allclose(np.stack([_np(f) for f in teng.fe_history]),
                               np.stack([_np(f) for f in jeng.fe_history]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(teng.posteriors["x"].mean()),
                               _np(jeng.posteriors["x"].mean()), **TICK_TOL)


def test_warm_ticks_and_initialization_at_tick_one_only():
    """The second tick starts from the first tick's marginals, not from
    the initialization: one sweep a tick, so tau's second posterior reads
    the first tick's x (a cold restart would give tick 1's values back)."""
    stream = [{"y": np.float32(1.0)}, {"y": np.float32(1.0)}]
    jeng = _gauss_engine(jrx, jd, datastream=stream, keephistory=2)
    teng = _gauss_engine(trx, td, datastream=stream, keephistory=2)
    cold = _gauss_engine(trx, td, datastream=stream[:1], keephistory=1)
    t0, t1 = (h["tau"] for h in teng.history)
    assert abs(float(t1.mean()) - float(t0.mean())) > 1e-3
    np.testing.assert_allclose(_np(t0.mean()),
                               _np(cold.history[0]["tau"].mean()), rtol=0)
    for jh, th in zip(jeng.history, teng.history):
        np.testing.assert_allclose(_np(th["tau"].mean()),
                                   _np(jh["tau"].mean()), **TICK_TOL)


def test_beta_bernoulli_run_offline_matches_jax():
    flips = (np.random.default_rng(5).random(30) < 0.7).astype(np.float32)
    jposts, _ = jrx.RxInferenceEngine(_bb_step(jrx), _bb_au(jrx)).run_offline(
        {"y": flips})
    teng = trx.RxInferenceEngine(_bb_step(trx), _bb_au(trx), device=CPU)
    tposts, _ = teng.run_offline({"y": flips})
    np.testing.assert_allclose(_np(tposts["theta"].a),
                               _np(jposts["theta"].a), rtol=1e-6)
    np.testing.assert_allclose(_np(teng.args["pb"]), 1.0 + 30 - flips.sum())


# -- mu(x) -------------------------------------------------------------------------------

def test_mu_autoupdate_message_argument_matches_jax():
    """tests/inference/test_streaming.py:146: mu(x) of a plain group is the
    prior-side message, untouched by the observation."""
    out = []
    for rx, kw in ((jrx, {}), (trx, {"device": CPU})):
        au = rx.autoupdates(initial={"pm": 0.0, "pv": 100.0},
                            pm=lambda q, mu: mu["x"].mean(),
                            pv=lambda q: q["x"].var() + 0.5)
        eng = rx.infer(model=_gauss_scalar_step(rx), datastream=None,
                       autoupdates=au, **kw)
        eng.on_next({"y": np.float32(5.0)})
        posts, _ = eng.run_offline({"y": np.full(4, 5.0, np.float32)})
        out.append((eng, posts))
    (jeng, jposts), (teng, tposts) = out
    assert abs(float(teng.args["pm"])) < 1e-4
    for k in ("pm", "pv"):
        np.testing.assert_allclose(_np(teng.args[k]), _np(jeng.args[k]),
                                   **TICK_TOL)
    np.testing.assert_allclose(_np(tposts["x"].mean()),
                               _np(jposts["x"].mean()), **TICK_TOL)


def _ssm(rx, t_len=8):
    @rx.model
    def ssm(y, pm):
        x = rx.latent(t_len, name="x")
        x[0] = rx.Normal(mean=pm, var=5.0)
        for t in rx.plate(1, t_len):
            x[t] = rx.Normal(mean=x[t - 1], var=1.0)
        for t in rx.plate(t_len):
            y[t] = rx.Normal(mean=x[t], var=0.5)
        return {"x": x}

    return ssm


def test_mu_on_a_chain_block_variable_matches_jax():
    """tests/inference/test_streaming.py:214: mu(x) of a chain is the
    smoothed state with its own observation left out; as an autoupdate it
    drives the next tick's prior."""
    from rxinfer_tpu_torch.engine.blocks import BatchContext

    y = np.cumsum(np.random.default_rng(0).standard_normal(8)).astype(
        np.float32)
    data = {"y": y, "pm": np.float32(0.0)}
    jres = jrx.infer(_ssm(jrx), data=data, iterations=1,
                     returnvars=jrx.KeepLast())
    tres = trx.infer(_ssm(trx), data=data, iterations=1,
                     returnvars=trx.KeepLast(), device=CPU)
    jmu = jres.model.variable_outbound_message(
        {"x": jrx.getdata(jres.posteriors["x"])},
        {k: jnp.asarray(v) for k, v in data.items()}, "x")
    tdata = {k: torch.as_tensor(v)[None] for k, v in data.items()}
    tmu = tres.model.variable_outbound_message(
        {"x": td.tree_map(lambda v: v[None], tres.posteriors["x"])}, tdata,
        "x", BatchContext(CPU, 1, {}))
    np.testing.assert_allclose(_np(tmu.xi[0]), _np(jmu.xi), **TICK_TOL)
    np.testing.assert_allclose(_np(tmu.w[0]), _np(jmu.w), **TICK_TOL)
    # leave-own-evidence-out: slot 3's mu is the smoothed marginal with y[3]
    # missing
    y_miss = y.copy()
    y_miss[3] = np.nan
    oracle = trx.infer(_ssm(trx), data={"y": y_miss, "pm": np.float32(0.0)},
                       device=CPU).posteriors["x"]
    np.testing.assert_allclose(float(tmu.xi[0, 3] / tmu.w[0, 3]),
                               float(oracle.mean()[3]), atol=2e-3)

    args = []
    for rx, kw in ((jrx, {}), (trx, {"device": CPU})):
        au = rx.autoupdates(initial={"pm": 0.0},
                            pm=lambda q, mu: mu["x"].mean()[-1])
        eng = rx.infer(model=_ssm(rx), datastream=None, autoupdates=au, **kw)
        eng.on_next({"y": y})
        eng.on_next({"y": y[::-1].copy()})
        args.append(float(eng.args["pm"]))
    np.testing.assert_allclose(args[1], args[0], rtol=1e-5, atol=1e-5)


# -- refusals ------------------------------------------------------------------------------

def test_autoupdates_need_initial_values_and_a_mapping():
    with pytest.raises(ValueError, match="initial value"):
        trx.autoupdates(pm=lambda q: q["x"].mean())
    with pytest.raises(ValueError, match="did not find any auto-update"):
        trx.autoupdates()


def test_data_colliding_with_an_autoupdated_argument_is_refused():
    @trx.model
    def beta_bernoulli(a, b, y):
        t = trx.Beta(a, b)
        y.observe(trx.Bernoulli(t))
        return {"t": t}

    au = trx.autoupdates(initial={"a": 1.0, "b": 1.0},
                         a=lambda q: q["t"].a, b=lambda q: q["t"].b)
    eng = trx.infer(model=beta_bernoulli, datastream=None, autoupdates=au,
                    device=CPU)
    with pytest.raises(ValueError, match="present both in the `data`"):
        eng.on_next({"y": np.float32(1.0), "a": np.float32(2.0)})


@pytest.mark.parametrize("kwargs,item", [
    ({"constraints": trx.constraints(submodel={"walk": trx.constraints()})},
     "A6i"),
    ({"session": trx.create_session()}, "A6"),
    ({"postprocess": lambda d: ("post", d)}, "A4c"),
    ({"annotations": trx.LogScaleAnnotations()}, "A4c"),
    ({"catch_exception": True}, None),
    ({"meta": {"Beta": {}}}, "A4c"),
])
def test_unported_streaming_arguments_raise(kwargs, item):
    """``catch_exception=`` is batch-only, as in the JAX package.  The
    arguments of A4c, A6h and A6i, refused until they were ported, run:
    a tick takes the meta, the annotations and the postprocess, the session
    logs the engine, and a submodel block naming no scope of the tick's
    model raises ``ValueError`` at the first tick, as in the JAX engine."""
    if item is None:
        with pytest.raises(ValueError, match="batch-only"):
            trx.infer(model=_bb_step(trx), datastream=None,
                      autoupdates=_bb_au(trx), device=CPU, **kwargs)
        return
    eng = trx.infer(model=_bb_step(trx), datastream=None,
                    autoupdates=_bb_au(trx), device=CPU, **kwargs)
    if item == "A6i":
        with pytest.raises(ValueError, match="'walk' matches no scope"):
            eng.on_next({"y": np.float32(1.0)})
        return
    post = eng.on_next({"y": np.float32(1.0)})
    if "session" in kwargs:
        assert kwargs["session"].get_session_stats(
            "streaming_inference").total == 1
    if "postprocess" in kwargs:
        assert all(p[0] == "post" for p in post.values())
    if "annotations" in kwargs:
        # without the free energy there is no log-scale to carry: the
        # posteriors come bare, as the JAX engine gives them
        assert not any(trx.getannotations(p) for p in post.values())


def test_streaming_runs_on_the_card_unless_told_otherwise(monkeypatch):
    if torch.cuda.is_available():
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trx.infer(model=_bb_step(trx), datastream=None,
                  autoupdates=_bb_au(trx))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trx.RxInferenceEngine(_bb_step(trx), _bb_au(trx))


def test_benchmark_and_trace_record_every_event():
    eng = trx.infer(model=_bb_step(trx), autoupdates=_bb_au(trx),
                    datastream=[{"y": np.float32(1.0)},
                                {"y": np.float32(0.0)}],
                    benchmark=True, trace=True, device=CPU)
    assert len(eng.trace.events) == len(eng.events)
    assert len(eng.benchmark.timestamps["on_tick"]) == 2
    np.testing.assert_allclose(_np(eng.posteriors["theta"].a), 2.0)
    np.testing.assert_allclose(_np(eng.posteriors["theta"].b), 2.0)

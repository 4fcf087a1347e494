"""The same ``lgssm`` source built through both packages' ``@model``:
graph parity after contraction, fused-plan parity against the JAX package's
``build_plans``, posterior and chain_cross parity against JAX
``batched_program``, ``infer_batched`` parity, the plan conversion helper,
the unfused chain path (``fused_kernels=False``, missing observations, a
state dimension beyond the kernels', a program mixing fused and unfused
chains) against the JAX package, and the ``NotImplementedError`` boundary
of the port.  JAX runs as its own
tests run it on the CPU (Pallas in interpret mode); the port runs on the CPU
with its kernels' plain versions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rxinfer_tpu as jrx
import rxinfer_tpu_torch as trx
from rxinfer_tpu.engine import batched as jbatched
from rxinfer_tpu.engine.compile import CompiledModel as JCompiledModel
from rxinfer_tpu_torch import convert
from rxinfer_tpu_torch.engine import batched as tbatched
from rxinfer_tpu_torch.engine.compile import CompiledModel as TCompiledModel

TOL = dict(rtol=3e-4, atol=3e-4)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def lgssm_source(rx, A, Q, H, R, m0, V0):
    """One model source; ``rx`` is either package's top-level module."""

    @rx.model
    def lgssm(y):
        T = len(y)
        x = rx.latent(T, name="x")
        x[0] = rx.MvNormal(mean=m0, cov=V0)
        for t in rx.plate(1, T):
            x[t] = rx.MvNormal(mean=A @ x[t - 1], cov=Q)
        for t in rx.plate(T):
            y[t] = rx.MvNormal(mean=H @ x[t], cov=R)
        return {"x": x}

    return lgssm


def scalar_source(rx, a, q, h, r):
    @rx.model
    def scalar_ssm(y):
        T = len(y)
        x = rx.latent(T, name="x")
        x[0] = rx.Normal(mean=0.5, var=4.0)
        for t in rx.plate(1, T):
            x[t] = rx.Normal(mean=a * x[t - 1] + 0.1, var=q)
        for t in rx.plate(T):
            y[t] = rx.Normal(mean=h * x[t], precision=1.0 / r)
        return {"x": x}

    return scalar_ssm


def constants(d, seed=0):
    rng = np.random.default_rng(seed)
    th = np.pi / 35
    rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]],
                   np.float32)
    A = np.kron(np.eye(d // 2, dtype=np.float32), rot)
    Q = (0.5 * np.eye(d)).astype(np.float32)
    H = (1.3 * np.eye(d) + 0.1 * rng.standard_normal((d, d))).astype(np.float32)
    R = (np.eye(d) + 0.2 * np.ones((d, d))).astype(np.float32)
    m0 = (0.1 * np.arange(d)).astype(np.float32)
    V0 = (25.0 * np.eye(d)).astype(np.float32)
    return A, Q, H, R, m0, V0


def observations(b, t, d, seed=1):
    return np.random.default_rng(seed).standard_normal((b, t, d)).astype(
        np.float32)


def _fforms(graph):
    return [(f.fform, sorted(f.interfaces)) for f in graph.factors]


@pytest.mark.parametrize("d", [2, 4])
def test_graph_and_plan_parity(d):
    c = constants(d)
    y0 = observations(1, 30, d)[0]
    jc = JCompiledModel(lgssm_source(jrx, *c).trace({"y": y0}))
    tc = TCompiledModel(lgssm_source(trx, *c).trace({"y": y0}))
    assert _fforms(tc.graph) == _fforms(jc.graph)
    assert [f.fform for f in tc.graph.factors] == [
        "MvNormalMeanCovariance", "MvLinearGaussianCovariance",
        "MvLinearGaussianCovariance"]
    assert tc.sweep == jc.sweep == ["x"]

    jplan = jbatched.build_plans(jc, {"y": jnp.asarray(y0)})["x"]
    tplan = tbatched.build_plans(tc, {"y": y0}, device=CPU)["x"]
    for field in ("A", "b", "Q", "W", "m0", "p0", "c"):
        np.testing.assert_allclose(getattr(tplan, field),
                                   np.asarray(getattr(jplan, field)),
                                   rtol=1e-5, atol=1e-6, err_msg=field)
    assert set(tplan.E) == set(jplan.E) == {"y"}
    np.testing.assert_allclose(tplan.E["y"], jplan.E["y"], rtol=1e-5,
                               atol=1e-6)
    assert tc.plan_report() == {
        "x": {"fused": True, "kernel": "fused_smoother", "route": "plain"}}


@pytest.mark.parametrize("d,iterations", [(2, 1), (2, 2), (4, 1), (4, 2)])
def test_batched_program_matches_jax(d, iterations):
    c = constants(d, seed=d)
    y = observations(3, 30, d, seed=iterations)
    _, jprog = jrx.batched_program(lgssm_source(jrx, *c), {"y": y},
                                   iterations=iterations)
    jstate, _, _ = jprog({"y": jnp.asarray(y)})
    tcomp, tprog = trx.batched_program(lgssm_source(trx, *c), {"y": y},
                                       iterations=iterations, device=CPU)
    tstate, tfe, _ = tprog({"y": y})
    np.testing.assert_allclose(tstate["x"].mu.numpy(),
                               np.asarray(jstate["x"].mu), **TOL)
    np.testing.assert_allclose(tstate["x"].sigma.numpy(),
                               np.asarray(jstate["x"].sigma), **TOL)
    assert tuple(tfe.shape) == (0, 3)


@pytest.mark.parametrize("d", [2, 4])
def test_chain_cross_matches_jax(d):
    c = constants(d, seed=10 + d)
    y = observations(3, 25, d, seed=d)
    jc = JCompiledModel(lgssm_source(jrx, *c).trace({"y": y[0]}))
    tc = TCompiledModel(lgssm_source(trx, *c).trace({"y": y[0]}))
    jplan = jbatched.build_plans(jc, {"y": jnp.asarray(y[0])})["x"]
    tplan = tbatched.build_plans(tc, {"y": y[0]}, device=CPU)["x"]
    jblock, tblock = jc.blocks[0][1], tc.blocks[0][1]
    jmarg, jcross = jax.jit(lambda yy: jbatched._fused_gaussian_update(
        jblock, jplan, {"y": yy}, 3))(jnp.asarray(y))
    tmarg, tcross = tbatched._fused_gaussian_update(
        tblock, tplan, {"y": torch.as_tensor(y)}, 3)
    assert tuple(tcross.shape) == (3, 24, d, d)
    np.testing.assert_allclose(tcross.numpy(), np.asarray(jcross), **TOL)
    np.testing.assert_allclose(tmarg.mu.numpy(), np.asarray(jmarg.mu), **TOL)


def test_scalar_chain_matches_jax():
    y = observations(4, 20, 1, seed=5)[..., 0]
    args = (0.9, 0.3, 1.2, 0.5)
    _, jprog = jrx.batched_program(scalar_source(jrx, *args), {"y": y})
    jstate, _, _ = jprog({"y": jnp.asarray(y)})
    _, tprog = trx.batched_program(scalar_source(trx, *args), {"y": y},
                                   device=CPU)
    tstate, _, _ = tprog({"y": y})
    assert type(tstate["x"]).__name__ == type(jstate["x"]).__name__
    np.testing.assert_allclose(tstate["x"].mu.numpy(),
                               np.asarray(jstate["x"].mu), **TOL)
    np.testing.assert_allclose(tstate["x"].v.numpy(),
                               np.asarray(jstate["x"].v), **TOL)


@pytest.mark.parametrize("keep", ["last", "each"])
def test_infer_batched_matches_jax(keep):
    d = 2
    c = constants(d, seed=3)
    y = observations(5, 16, d, seed=7)
    rv_j = jrx.KeepEach() if keep == "each" else None
    rv_t = trx.KeepEach() if keep == "each" else None
    jpost, jfe = jrx.infer_batched(lgssm_source(jrx, *c), {"y": y},
                                   iterations=2, returnvars=rv_j)
    tpost, tfe = trx.infer_batched(lgssm_source(trx, *c), {"y": y},
                                   iterations=2, returnvars=rv_t, device=CPU)
    assert jfe is None and tfe is None
    jx, tx = jpost["x"], tpost["x"]
    if keep == "each":
        assert len(tx) == len(jx) == 2
        jx, tx = jx[-1], tx[-1]
    np.testing.assert_allclose(tx.mu.numpy(), np.asarray(jx.mu), **TOL)
    np.testing.assert_allclose(tx.sigma.numpy(), np.asarray(jx.sigma), **TOL)


def test_infer_batched_chunks_over_the_budget():
    d = 2
    c = constants(d, seed=4)
    y = observations(7, 12, d, seed=8)
    full, _ = trx.infer_batched(lgssm_source(trx, *c), {"y": y}, device=CPU)
    per_elem = 12 * (2 * d + 2 * 3 + d * d + d) * 4 * 2
    with pytest.warns(UserWarning, match="sequential chunks"):
        chunked, _ = trx.infer_batched(
            lgssm_source(trx, *c), {"y": y}, device=CPU,
            options={"hbm_budget_bytes": 3 * per_elem})
    torch.testing.assert_close(chunked["x"].mu, full["x"].mu)
    torch.testing.assert_close(chunked["x"].sigma, full["x"].sigma)


def test_converted_jax_plan_reproduces_jax_posteriors():
    d = 4
    c = constants(d, seed=6)
    y = observations(3, 21, d, seed=9)
    jc = JCompiledModel(lgssm_source(jrx, *c).trace({"y": y[0]}))
    jplan = jbatched.build_plans(jc, {"y": jnp.asarray(y[0])})["x"]
    fields = {
        "A": np.asarray(jplan.A), "b": np.asarray(jplan.b),
        "Q": np.asarray(jplan.Q), "W": np.asarray(jplan.W),
        "m0": np.asarray(jplan.m0), "p0": np.asarray(jplan.p0),
        "E": {k: np.asarray(v) for k, v in jplan.E.items()},
        "c": np.asarray(jplan.c), "chunk": jplan.chunk,
    }
    tplan = convert.fused_plan_from_numpy(fields)
    _, jprog = jrx.batched_program(lgssm_source(jrx, *c), {"y": y})
    jstate, _, _ = jprog({"y": jnp.asarray(y)})
    marg, cross = tbatched.run_fused_plan(tplan, {"y": torch.as_tensor(y)},
                                          batch=3, length=21)
    np.testing.assert_allclose(marg.mu.numpy(), np.asarray(jstate["x"].mu),
                               **TOL)
    np.testing.assert_allclose(marg.sigma.numpy(),
                               np.asarray(jstate["x"].sigma), **TOL)
    assert tuple(cross.shape) == (3, 20, d, d)


@pytest.mark.parametrize("kwargs,match", [
    ({"options": {"fused_moment_dtype": "bfloat16"}}, "fused_moment_dtype"),
    ({"free_energy": True}, "free_energy"),
    ({"shared": ("x",)}, "shared"),
])
def test_unported_options_raise(kwargs, match):
    c = constants(2)
    y = observations(2, 8, 2)
    with pytest.raises(NotImplementedError, match=match):
        trx.batched_program(lgssm_source(trx, *c), {"y": y}, device=CPU,
                            **kwargs)


def _unfused_matches_jax(c, y, *, reason, iterations=1, **kwargs):
    """The port's batched program against the JAX package's on the same
    call, its chain reported off the kernels with ``reason``."""
    _, jprog = jrx.batched_program(lgssm_source(jrx, *c), {"y": y},
                                   iterations=iterations, **kwargs)
    jstate, _, _ = jprog({"y": jnp.asarray(y)})
    tcomp, tprog = trx.batched_program(lgssm_source(trx, *c), {"y": y},
                                       iterations=iterations, device=CPU,
                                       **kwargs)
    report = tcomp.plan_report()["x"]
    assert report["fused"] is False and reason in report["reason"]
    tstate, tfe, _ = tprog({"y": y})
    np.testing.assert_allclose(tstate["x"].mu.numpy(),
                               np.asarray(jstate["x"].mu), **TOL)
    np.testing.assert_allclose(tstate["x"].sigma.numpy(),
                               np.asarray(jstate["x"].sigma), **TOL)
    assert tuple(tfe.shape) == (0, y.shape[0])
    return tstate


@pytest.mark.parametrize("t_len", [8, 60])
def test_fused_kernels_off_matches_jax_and_the_fused_program(t_len):
    """``options={"fused_kernels": False}`` runs the chain's scans (the
    sequential smoother at 8 slots, the associative scan at 60)."""
    c = constants(2)
    y = observations(2, t_len, 2)
    state = _unfused_matches_jax(c, y, reason="fused_kernels",
                                 options={"fused_kernels": False})
    _, fused = trx.batched_program(lgssm_source(trx, *c), {"y": y},
                                   device=CPU)
    fstate, _, _ = fused({"y": y})
    torch.testing.assert_close(state["x"].mu, fstate["x"].mu, **TOL)
    torch.testing.assert_close(state["x"].sigma, fstate["x"].sigma, **TOL)


@pytest.mark.parametrize("t_len", [20, 50])
def test_scalar_chain_unfused_matches_jax(t_len):
    y = observations(4, t_len, 1, seed=5)[..., 0]
    y[1, 3] = np.nan
    args = (0.9, 0.3, 1.2, 0.5)
    opts = {"fused_kernels": False}
    _, jprog = jrx.batched_program(scalar_source(jrx, *args), {"y": y},
                                   options=opts)
    jstate, _, _ = jprog({"y": jnp.asarray(y)})
    _, tprog = trx.batched_program(scalar_source(trx, *args), {"y": y},
                                   options=opts, device=CPU)
    tstate, _, _ = tprog({"y": y})
    assert type(tstate["x"]).__name__ == type(jstate["x"]).__name__
    np.testing.assert_allclose(tstate["x"].mu.numpy(),
                               np.asarray(jstate["x"].mu), **TOL)
    np.testing.assert_allclose(tstate["x"].v.numpy(),
                               np.asarray(jstate["x"].v), **TOL)
    jres = jrx.infer(model=scalar_source(jrx, *args), data={"y": y[1]})
    tres = trx.infer(scalar_source(trx, *args), data={"y": y[1]},
                     device=CPU)
    np.testing.assert_allclose(tres.posteriors["x"].v.numpy(),
                               np.asarray(jres.posteriors["x"].v), **TOL)
    np.testing.assert_allclose(tres.predictions["y"].mean().numpy(),
                               np.asarray(jres.predictions["y"].mean()),
                               **TOL)


def test_unported_infer_batched_arguments_raise():
    c = constants(2)
    y = observations(2, 8, 2)
    for name in ("annotations", "mesh"):
        with pytest.raises(NotImplementedError, match=name):
            trx.infer_batched(lgssm_source(trx, *c), {"y": y}, device=CPU,
                              **{name: object()})


def test_infer_batched_predictvars_dict_matches_jax():
    """The call that raised before the predictions were ported."""
    c = constants(2)
    y = observations(2, 8, 2)
    jres = jrx.infer_batched(lgssm_source(jrx, *c), {"y": y},
                             predictvars={"y": None})
    tres = trx.infer_batched(lgssm_source(trx, *c), {"y": y}, device=CPU,
                             predictvars={"y": None})
    got, want = tres.predictions["y"], jres.predictions["y"]
    np.testing.assert_allclose(got.mean().numpy(), np.asarray(want.mean()),
                               **TOL)
    np.testing.assert_allclose(got.cov().numpy(), np.asarray(want.cov()),
                               **TOL)


def test_state_dim_beyond_the_kernels_runs_unfused_and_matches_jax():
    d = 10
    c = constants(d)
    y = observations(2, 6, d)
    _unfused_matches_jax(c, y, reason="state dim 10 > 8")


@pytest.mark.parametrize("iterations", [1, 2])
def test_missing_observations_run_unfused_and_match_jax(iterations):
    c = constants(4, seed=2)
    y = observations(3, 50, 4, seed=3)
    y[np.random.default_rng(4).random((3, 50)) < 0.1] = np.nan
    _unfused_matches_jax(c, y, reason="missing observations",
                         iterations=iterations)
    jpost, _ = jrx.infer_batched(lgssm_source(jrx, *c), {"y": y})
    tpost, _ = trx.infer_batched(lgssm_source(trx, *c), {"y": y}, device=CPU)
    np.testing.assert_allclose(tpost["x"].mu.numpy(),
                               np.asarray(jpost["x"].mu), **TOL)


def test_one_program_mixes_fused_and_unfused_chains():
    """Two independent chains, one within the kernels' state dims and one
    beyond: the first runs fused, the second its scans, in one sweep."""
    def source(rx, cs, cz):
        @rx.model
        def two_chains(y, v):
            T = len(y)
            x = rx.latent(T, name="x")
            z = rx.latent(T, name="z")
            x[0] = rx.MvNormal(mean=cs[4], cov=cs[5])
            z[0] = rx.MvNormal(mean=cz[4], cov=cz[5])
            for t in rx.plate(1, T):
                x[t] = rx.MvNormal(mean=cs[0] @ x[t - 1], cov=cs[1])
                z[t] = rx.MvNormal(mean=cz[0] @ z[t - 1], cov=cz[1])
            for t in rx.plate(T):
                y[t] = rx.MvNormal(mean=cs[2] @ x[t], cov=cs[3])
                v[t] = rx.MvNormal(mean=cz[2] @ z[t], cov=cz[3])
            return {"x": x, "z": z}

        return two_chains

    cs, cz = constants(2, seed=1), constants(10, seed=2)
    data = {"y": observations(2, 12, 2, seed=5),
            "v": observations(2, 12, 10, seed=6)}
    _, jprog = jrx.batched_program(source(jrx, cs, cz), data)
    jstate, _, _ = jprog({k: jnp.asarray(v) for k, v in data.items()})
    tcomp, tprog = trx.batched_program(source(trx, cs, cz), data, device=CPU)
    report = tcomp.plan_report()
    assert report["x"]["fused"] is True and report["z"]["fused"] is False
    tstate, _, _ = tprog(data)
    for name in ("x", "z"):
        np.testing.assert_allclose(tstate[name].mu.numpy(),
                                   np.asarray(jstate[name].mu), **TOL)


def test_a_kernel_failure_raises_and_is_not_rerouted(monkeypatch):
    """The unfused path is a plan decision, never a fallback."""
    def broken(*args, **kwargs):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(
        "rxinfer_tpu_torch.ops.fused_smoother.fused_batched_smoother", broken)
    c = constants(2)
    y = observations(2, 8, 2)
    comp, prog = trx.batched_program(lgssm_source(trx, *c), {"y": y},
                                     device=CPU)
    assert comp.plan_report()["x"]["fused"] is True
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        prog({"y": y})


def test_the_budget_counts_the_unfused_working_set():
    c = constants(4)
    y = observations(2, 30, 4)
    fused, _ = trx.batched_program(lgssm_source(trx, *c), {"y": y},
                                   device=CPU)
    unfused, _ = trx.batched_program(lgssm_source(trx, *c), {"y": y},
                                     device=CPU,
                                     options={"fused_kernels": False})
    per_fused = tbatched.chain_hbm_bytes_per_element(fused)
    per_unfused = tbatched.chain_hbm_bytes_per_element(unfused)
    assert per_fused == 30 * (2 * 4 + 2 * 10 + 16 + 4) * 4 * 2
    assert per_unfused == 30 * tbatched.UNFUSED_SCAN_FLOATS * 56 * 4 * 2
    assert tbatched.batch_chunk_size(unfused, 2, 1 * per_unfused) == 1


def test_non_chain_variables_are_not_ported():
    """Plain groups run since slice 2 (tests/test_torch_hmm.py); a group of
    a family without a natural-parameter view in the port still raises."""
    @trx.model
    def iid_precision(y):
        tau = trx.Gamma(shape=1.0, rate=1.0)
        for t in trx.plate(len(y)):
            y[t] = trx.Normal(mean=0.0, precision=tau)
        return {"tau": tau}

    with pytest.raises(NotImplementedError, match="family 'gamma'"):
        trx.batched_program(iid_precision,
                            {"y": np.zeros((2, 5), np.float32)}, device=CPU)

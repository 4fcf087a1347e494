"""Slice 2 of the PyTorch port against the JAX package: the fused HMM
forward-backward (plain version vs the JAX Pallas kernels in interpret mode
and vs the JAX scan solver), the discrete distributions and rules, the plate
reductions with and without a batch axis, plain conjugate groups, and
``batched_program`` / ``infer_batched`` on ``zoo.hmm`` (with and without
missing observations).  Inputs come from numpy seeds and cross between the
packages as numpy.  On the CPU the port's wrappers take their plain versions;
the CUDA kernels are held against the same plain versions on the card by the
``gpu``-marked test below and by ``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rxinfer_tpu as jrx
import rxinfer_tpu.dists as jd
import rxinfer_tpu_torch as trx
from rxinfer_tpu.dists import natural as jnat
from rxinfer_tpu.engine import batched as jbatched
from rxinfer_tpu.models import zoo as jzoo
from rxinfer_tpu.ops.discrete_chain import forward_backward
from rxinfer_tpu.ops.pallas_discrete import fused_fb_batched as jax_fused_fb
from rxinfer_tpu.rules.nodes import DiscreteTransitionNode as JDT
from rxinfer_tpu_torch import convert
from rxinfer_tpu_torch.dists import natural as tnat
from rxinfer_tpu_torch.engine import batched as tbatched
from rxinfer_tpu_torch.engine.blocks import BatchContext
from rxinfer_tpu_torch.models import zoo as tzoo
from rxinfer_tpu_torch.ops import fused_fb as ffb
from rxinfer_tpu_torch.rules.nodes import DiscreteTransitionNode as TDT

# The JAX package's own tolerance for fused vs scan forward-backward
# (tests/engine/test_batched_engine.py:232-235); logZ and the summed xi are
# sums over T steps, so they get a relative term as well.
FB_TOL = dict(rtol=2e-5, atol=2e-5)
# Distribution/rule parity: float32 digamma/einsum in two libraries.
RULE_TOL = dict(rtol=1e-5, atol=1e-5)
# Engine parity after 8 VMP sweeps (the JAX package's fused-vs-infer HMM
# tolerances: 5e-5 on s, 1e-4 on the concentrations).
S_TOL = dict(rtol=0, atol=5e-5)
CONC_TOL = dict(rtol=1e-5, atol=1e-4)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _fb_inputs(b, t, k, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, k)).astype(np.float32),
            rng.standard_normal((b, k, k)).astype(np.float32),
            rng.standard_normal((t, b, k)).astype(np.float32))


FB_CASES = [(3, 37, 4), (2, 9, 1), (2, 1, 3), (2, 2, 3), (3, 20, 8)]


@pytest.mark.parametrize("per_step_xi", [False, True])
@pytest.mark.parametrize("b,t,k", FB_CASES)
def test_fused_fb_matches_jax(b, t, k, per_step_xi):
    lp, lt, le = _fb_inputs(b, t, k, seed=b * 100 + t * 10 + k)
    jout = jax_fused_fb(jnp.asarray(lp), jnp.asarray(lt), jnp.asarray(le),
                        chunk=8, interpret=True, per_step_xi=per_step_xi)
    tout = ffb.fused_fb_batched(torch.as_tensor(lp), torch.as_tensor(lt),
                                torch.as_tensor(le), per_step_xi=per_step_xi)
    assert len(tout) == len(jout) == (4 if per_step_xi else 3)
    shapes = [(t, b, k), (b, k, k), (b,), (t - 1, b, k, k)]
    for name, got, want, shape in zip(("gammas", "xi_sum", "logz", "xis"),
                                      tout, jout, shapes):
        assert tuple(got.shape) == shape, name
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=name, **FB_TOL)
    # the JAX scan solver, chain by chain
    for i in range(b):
        res = forward_backward(jnp.asarray(lp[i]),
                               jnp.asarray(np.broadcast_to(lt[i],
                                                           (t - 1, k, k))),
                               jnp.asarray(le[:, i]))
        np.testing.assert_allclose(tout[0][:, i].numpy(),
                                   np.asarray(res.gammas), **FB_TOL)
        np.testing.assert_allclose(float(tout[2][i]), float(res.logZ),
                                   **FB_TOL)
        if per_step_xi:
            np.testing.assert_allclose(tout[3][:, i].numpy(),
                                       np.asarray(res.xis), **FB_TOL)


def test_fused_fb_cpu_tensors_take_the_plain_version():
    lp, lt, le = (torch.as_tensor(a) for a in _fb_inputs(2, 6, 3, seed=1))
    before = dict(ffb.LAUNCHES)
    alphas, logz = ffb.fb_forward(lp, lt, le)
    alphas_r, logz_r = ffb.fb_forward_reference(lp, lt, le)
    torch.testing.assert_close(alphas, alphas_r, rtol=0, atol=0)
    torch.testing.assert_close(logz, logz_r, rtol=0, atol=0)
    assert ffb.LAUNCHES == before


def test_more_than_eight_states_raise_with_the_reason():
    """The kernels' own limit; a model with more states runs unfused
    (``test_more_than_eight_states_run_unfused_and_match_jax``)."""
    lp, lt, le = (torch.as_tensor(a) for a in _fb_inputs(2, 4, 9, seed=2))
    with pytest.raises(NotImplementedError, match="K = 1..8"):
        ffb.fused_fb_batched(lp, lt, le)


@pytest.mark.parametrize("t_len", [5, 60])
def test_more_than_eight_states_run_unfused_and_match_jax(t_len):
    y = np.eye(3, dtype=np.float32)[
        np.random.default_rng(t_len).integers(0, 3, (2, t_len))]
    b0 = np.ones((3, 9), np.float32) + np.eye(3, 9, dtype=np.float32)
    init = lambda rx: {"A": rx.DirichletCollection(np.ones((9, 9),
                                                           np.float32)),
                       "B": rx.DirichletCollection(b0)}
    _, jprog = jrx.batched_program(jzoo.hmm(9, 3), {"y": y}, iterations=3,
                                   initialization=init(jrx))
    jstate, _, _ = jprog({"y": jnp.asarray(y)})
    tcomp, tprog = trx.batched_program(tzoo.hmm(9, 3), {"y": y}, iterations=3,
                                       initialization=init(trx), device=CPU)
    report = tcomp.plan_report()["s"]
    assert report["fused"] is False and "9 states > 8" in report["reason"]
    before = dict(ffb.LAUNCHES)
    tstate, _, _ = tprog({"y": y})
    assert ffb.LAUNCHES == before
    np.testing.assert_allclose(tstate["s"].probs().numpy(),
                               np.asarray(jstate["s"].probs()), **S_TOL)
    for n in ("A", "B"):
        np.testing.assert_allclose(tstate[n].alpha.numpy(),
                                   np.asarray(jstate[n].alpha), **CONC_TOL)


# -- distributions, rules and plate reductions ------------------------------------

def _alpha(rng, shape):
    return (0.5 + 3.0 * rng.random(shape)).astype(np.float32)


def test_dirichlet_collection_reduces_over_the_outcome_axis():
    """A batched (B, K_out, K_in) collection against JAX per element: the
    simplex runs over K_out, never over the batch."""
    rng = np.random.default_rng(3)
    a = _alpha(rng, (4, 3, 2))
    t = trx.dists.DirichletCollection(torch.as_tensor(a))
    for i in range(a.shape[0]):
        j = jd.DirichletCollection(jnp.asarray(a[i]))
        np.testing.assert_allclose(t.mean_log()[i].numpy(),
                                   np.asarray(j.mean_log()), **RULE_TOL)
        np.testing.assert_allclose(t.mean()[i].numpy(), np.asarray(j.mean()),
                                   **RULE_TOL)
        np.testing.assert_allclose(t.var()[i].numpy(), np.asarray(j.var()),
                                   **RULE_TOL)
    np.testing.assert_allclose(t.mean().sum(-2).numpy(), 1.0, rtol=1e-6)


def test_categorical_matches_jax():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((5, 4)).astype(np.float32)
    t = trx.dists.Categorical(torch.as_tensor(logits))
    j = jd.Categorical(jnp.asarray(logits))
    for name in ("probs", "log_probs", "mean", "var", "entropy"):
        np.testing.assert_allclose(getattr(t, name)().numpy(),
                                   np.asarray(getattr(j, name)()),
                                   err_msg=name, **RULE_TOL)
    p = rng.random(4).astype(np.float32)
    np.testing.assert_allclose(
        trx.Categorical(p).logits.numpy(),
        np.asarray(jd.Categorical.from_probs(jnp.asarray(p)).logits))


@pytest.mark.parametrize("matrix", ["dirichlet", "pointmass"])
def test_discrete_transition_messages_match_jax(matrix):
    """The three messages over a batch of plate copies (B, P, ...), with the
    matrix shared by the copies (B, 1, K, K) as the batched program passes
    it, against JAX per dataset (P, ...) with a (K, K) matrix."""
    rng = np.random.default_rng(5)
    b, p, k = 3, 6, 4
    a = _alpha(rng, (b, k, k))
    if matrix == "pointmass":
        a = a / a.sum(-2, keepdims=True)
    lin = rng.standard_normal((b, p, k)).astype(np.float32)
    yout = np.eye(k, dtype=np.float32)[rng.integers(k, size=(b, p))]

    def port_q(i_out, i_in):
        mat = (trx.PointMass(torch.as_tensor(a)[:, None]) if matrix == "pointmass"
               else trx.dists.DirichletCollection(torch.as_tensor(a)[:, None]))
        return {"matrix": mat, "out": trx.PointMass(torch.as_tensor(i_out)),
                "in": trx.dists.Categorical(torch.as_tensor(i_in))}

    tq = port_q(yout, lin)
    t_msgs = {"out": TDT.message_to_out(tq).logits,
              "in": TDT.message_to_in(tq).logits,
              "matrix": TDT.message_to_matrix(tq).alpha}
    for i in range(b):
        mat = (jd.PointMass(jnp.asarray(a[i])) if matrix == "pointmass"
               else jd.DirichletCollection(jnp.asarray(a[i])))
        jq = {"matrix": mat, "out": jd.PointMass(jnp.asarray(yout[i])),
              "in": jd.Categorical(jnp.asarray(lin[i]))}
        j_msgs = {"out": JDT.message_to_out(jq).logits,
                  "in": JDT.message_to_in(jq).logits,
                  "matrix": JDT.message_to_matrix(jq).alpha}
        for name in j_msgs:
            np.testing.assert_allclose(t_msgs[name][i].numpy(),
                                       np.asarray(j_msgs[name]),
                                       err_msg=name, **RULE_TOL)


@pytest.mark.parametrize("shared", [False, True])
def test_prod_reduce_and_pad_plate_match_jax(shared):
    """Without a batch axis the port's reductions are the JAX package's;
    with one, each dataset's slice is the JAX result for that dataset.  A
    shared (plate-less) leaf counts once per copy and never multiplies the
    batch."""
    rng = np.random.default_rng(6)
    b, p, k = 3, 5, 2
    shape = (k, k) if shared else (p, k, k)
    a = _alpha(rng, (b,) + shape)
    jmsg = [jd.DirichletCollection(jnp.asarray(a[i])) for i in range(b)]
    # no batch axis: the JAX package's semantics
    t0 = trx.dists.DirichletCollection(torch.as_tensor(a[0]))
    np.testing.assert_allclose(tnat.prod_reduce(t0, p).alpha.numpy(),
                               np.asarray(jnat.prod_reduce(jmsg[0], p).alpha),
                               **RULE_TOL)
    np.testing.assert_allclose(
        tnat.pad_plate(t0, 1, 1 + p, p + 3).alpha.numpy(),
        np.asarray(jnat.pad_plate(jmsg[0], 1, 1 + p, p + 3).alpha), **RULE_TOL)
    # batch axis first
    tb = trx.dists.DirichletCollection(torch.as_tensor(a))
    red = tnat.prod_reduce(tb, p, batch_ndim=1).alpha
    pad = tnat.pad_plate(tb, 1, 1 + p, p + 3, batch_ndim=1).alpha
    assert tuple(red.shape) == (b, k, k)
    assert tuple(pad.shape) == (b, p + 3, k, k)
    for i in range(b):
        np.testing.assert_allclose(
            red[i].numpy(), np.asarray(jnat.prod_reduce(jmsg[i], p).alpha),
            **RULE_TOL)
        np.testing.assert_allclose(
            pad[i].numpy(),
            np.asarray(jnat.pad_plate(jmsg[i], 1, 1 + p, p + 3).alpha),
            **RULE_TOL)
    # an unbatched prior message meets a batched one: it broadcasts
    prior = trx.dists.DirichletCollection(torch.ones((k, k)))
    prod = tnat.prod_all([prior, trx.dists.DirichletCollection(
        torch.as_tensor(a[:, 0] if not shared else a))])
    assert tuple(prod.alpha.shape) == (b, k, k)


def test_dist_from_numpy_round_trips_a_jax_dirichlet_collection():
    rng = np.random.default_rng(7)
    a = _alpha(rng, (3, 3))
    j = jd.DirichletCollection(jnp.asarray(a))
    t = convert.dist_from_numpy(type(j).__name__, [np.asarray(j.alpha)])
    assert isinstance(t, trx.dists.DirichletCollection)
    np.testing.assert_array_equal(t.alpha.numpy(), a)
    c = convert.dist_from_numpy("Categorical", {"logits": a[0]})
    np.testing.assert_array_equal(c.logits.numpy(), a[0])


# -- the engine: zoo.hmm through both packages ------------------------------------

def hmm_data(b, t, seed=0):
    """One-hot observations simulated as the JAX package's HMM tests do."""
    rng = np.random.default_rng(seed)
    a_true = np.array([[0.9, 0.05, 0.05], [0.05, 0.9, 0.05],
                       [0.05, 0.05, 0.9]])
    yh = np.zeros((b, t), np.int64)
    for i in range(b):
        s = rng.integers(3)
        for j in range(t):
            s = rng.choice(3, p=a_true[:, s])
            yh[i, j] = rng.choice(3, p=a_true[:, s])
    return np.eye(3, dtype=np.float32)[yh]


def hmm_init(rx):
    return {"A": rx.DirichletCollection(np.full((3, 3), 1.0, np.float32)),
            "B": rx.DirichletCollection(np.float32(np.eye(3) * 5.0 + 1.0))}


def _assert_hmm_state(tstate, jstate):
    np.testing.assert_allclose(tstate["s"].probs().numpy(),
                               np.asarray(jstate["s"].probs()), **S_TOL)
    for name in ("A", "B"):
        np.testing.assert_allclose(tstate[name].alpha.numpy(),
                                   np.asarray(jstate[name].alpha),
                                   err_msg=name, **CONC_TOL)


@pytest.mark.parametrize("missing", [False, True])
def test_batched_program_matches_jax_on_hmm(missing):
    y = hmm_data(4, 40)
    if missing:
        y[1, 7] = np.nan
        y[2, 20:23] = np.nan
        y[3, 0] = np.nan
    jcomp, jprog = jrx.batched_program(jzoo.hmm(3, 3), {"y": y},
                                       iterations=8, initialization=hmm_init(jrx))
    jstate, _, _ = jprog({"y": jnp.asarray(y)})
    tcomp, tprog = trx.batched_program(tzoo.hmm(3, 3), {"y": y}, iterations=8,
                                       initialization=hmm_init(trx),
                                       device=CPU)
    assert tcomp.sweep == jcomp.sweep == ["s", "A", "B"]
    assert tcomp.plan_report() == {
        "s": {"fused": True, "kernel": "fused_fb", "route": "plain"}}
    tstate, tfe, _ = tprog({"y": y})
    assert tuple(tfe.shape) == (0, 4)
    assert tuple(tstate["s"].logits.shape) == (4, 40, 3)
    assert tuple(tstate["A"].alpha.shape) == (4, 3, 3)
    _assert_hmm_state(tstate, jstate)

    # chain_cross: the discrete update on the (matching) final states
    jblock = next(b for _, b in jcomp.blocks if b.var.name == "s")
    tblock = next(b for _, b in tcomp.blocks if b.var.name == "s")
    _, jcross = jax.jit(lambda st, yy: jbatched._fused_discrete_update(
        jblock, st, {"y": yy}, {}))(jstate, jnp.asarray(y))
    masks = {}
    yt = torch.as_tensor(y)
    if missing:
        from rxinfer_tpu_torch.engine.blocks import factor_data_mask

        for f in tcomp.graph.factors:
            m = factor_data_mask(f, {"y": yt})
            if m is not None:
                masks[f.id] = m
        yt = torch.nan_to_num(yt)
    ctx = BatchContext(CPU, 4, {}, masks)
    _, tcross = tbatched._fused_discrete_update(tblock, tstate, {"y": yt}, {},
                                                ctx)
    assert tuple(tcross.shape) == (4, 39, 3, 3)
    np.testing.assert_allclose(tcross.numpy(), np.asarray(jcross), **S_TOL)


@pytest.mark.parametrize("keep", ["last", "each"])
def test_infer_batched_matches_jax_on_hmm(keep):
    y = hmm_data(4, 40, seed=1)
    rv_j = jrx.KeepEach() if keep == "each" else jrx.KeepLast()
    rv_t = trx.KeepEach() if keep == "each" else None
    jpost, _ = jrx.infer_batched(jzoo.hmm(3, 3), {"y": y}, iterations=8,
                                 initialization=hmm_init(jrx), returnvars=rv_j)
    tpost, tfe = trx.infer_batched(tzoo.hmm(3, 3), {"y": y}, iterations=8,
                                   initialization=hmm_init(trx),
                                   returnvars=rv_t, device=CPU)
    assert tfe is None and set(tpost) == {"s", "A", "B"}
    if keep == "each":
        assert all(len(tpost[n]) == len(jpost[n]) == 8 for n in tpost)
        for i in (0, 3, 7):
            _assert_hmm_state({n: tpost[n][i] for n in tpost},
                              {n: jpost[n][i] for n in jpost})
    else:
        _assert_hmm_state(tpost, jpost)


# -- plain conjugate groups ---------------------------------------------------------

def iid_source(rx, n):
    @rx.model
    def iid(y):
        theta = rx.Normal(mean=0.5, var=100.0)
        for i in rx.plate(n):
            y[i] = rx.Normal(mean=theta, var=2.0)
        return {"theta": theta}

    return iid


def array_source(rx, n):
    """An array group: slot 0 pinned by an unplated factor, the rest by a
    plate, each slot observed once."""

    @rx.model
    def arr(y):
        x = rx.latent(n, name="x")
        x[0] = rx.Normal(mean=1.0, var=4.0)
        for i in rx.plate(1, n):
            x[i] = rx.Normal(mean=-1.0, var=9.0)
        for i in rx.plate(n):
            y[i] = rx.Normal(mean=x[i], var=0.5)
        return {"x": x}

    return arr


@pytest.mark.parametrize("source,var", [(iid_source, "theta"),
                                        (array_source, "x")])
def test_plain_gaussian_groups_match_jax(source, var):
    y = np.random.default_rng(8).standard_normal((3, 12)).astype(np.float32)
    y[1, 4] = np.nan
    _, jprog = jrx.batched_program(source(jrx, 12), {"y": y}, iterations=2)
    jstate, _, _ = jprog({"y": jnp.asarray(y)})
    tcomp, tprog = trx.batched_program(source(trx, 12), {"y": y},
                                       iterations=2, device=CPU)
    assert [k for k, _ in tcomp.blocks] == ["plain"]
    tstate, _, _ = tprog({"y": y})
    j, t = jstate[var], tstate[var]
    assert type(t).__name__ == type(j).__name__
    np.testing.assert_allclose(t.mean().numpy(), np.asarray(j.mean()),
                               **RULE_TOL)
    np.testing.assert_allclose(t.var().numpy(), np.asarray(j.var()),
                               **RULE_TOL)


def test_cavity_message_stores_are_not_ported():
    @trx.model
    def two_level(y):
        mu = trx.Normal(mean=0.0, var=1.0)
        x = trx.Normal(mean=mu, var=1.0)
        for i in trx.plate(len(y)):
            y[i] = trx.Normal(mean=x, var=1.0)
        return {"mu": mu, "x": x}

    with pytest.raises(NotImplementedError, match="cavity"):
        trx.batched_program(two_level, {"y": np.zeros((2, 4), np.float32)},
                            initialization={"mu": trx.Normal(mean=0.0,
                                                             var=1.0)},
                            device=CPU)


# -- the kernels on the card --------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the forward-backward kernels run "
                    "only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,k", [(1000, 257, 3), (64, 33, 8), (50, 1, 3)])
def test_fb_kernels_match_plain_version_on_the_card(cuda_device, b, t, k):
    lp, lt, le = (torch.as_tensor(a, device=cuda_device)
                  for a in _fb_inputs(b, t, k, seed=9))
    before = dict(ffb.LAUNCHES)
    alphas, logz = ffb.fb_forward(lp, lt, le)
    alphas_r, logz_r = ffb.fb_forward_reference(lp, lt, le)
    g, xs, steps = ffb.fb_backward(lt, le, alphas, per_step_xi=True)
    g_r, xs_r, steps_r = ffb.fb_backward_reference(lt, le, alphas, True)
    torch.cuda.synchronize()
    for got, want in ((alphas, alphas_r), (logz, logz_r), (g, g_r),
                      (xs, xs_r), (steps, steps_r)):
        torch.testing.assert_close(got, want, **FB_TOL)
    assert ffb.LAUNCHES["fused_fb_fwd"] == before["fused_fb_fwd"] + 1
    assert ffb.LAUNCHES["fused_fb_bwd"] == before["fused_fb_bwd"] + 1

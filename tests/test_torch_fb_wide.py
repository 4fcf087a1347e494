"""The HMM forward-backward above eight states (ROADMAP V4): on the card a
chain of K > 8 states launches the wide kernels of
``csrc/fused_fb_wide.cu``; on the CPU their plain versions run, which this
file holds against the JAX package: its Pallas kernels in interpret mode at
K = 9 (the trace grows with K^2, so one case), its scan solver
(``rxinfer_tpu/ops/discrete_chain.py`` ``forward_backward``) at K = 12, 16
(the half-warp order of sums), 33 and 64, and its ``batched_program`` on
``zoo.hmm(9, 3)`` and
``zoo.hmm(16, 4)``, whose plans fuse the chain as the JAX planner does.
The rule that picks the wide marginal pass's tile is pinned, and the
``gpu``-marked tests hold the wide kernels against their plain versions on
the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rxinfer_tpu as jrx
import rxinfer_tpu_torch as trx
from rxinfer_tpu.models import zoo as jzoo
from rxinfer_tpu.ops.discrete_chain import forward_backward
from rxinfer_tpu.ops.pallas_discrete import fused_fb_batched as jax_fused_fb
from rxinfer_tpu_torch.models import zoo as tzoo
from rxinfer_tpu_torch.ops import fused_fb as ffb

# The JAX package's fused-vs-scan forward-backward tolerance
# (tests/engine/test_batched_engine.py:232-235), as in test_torch_hmm.py.
FB_TOL = dict(rtol=2e-5, atol=2e-5)
# Engine parity after a few VMP sweeps: the JAX package's fused-vs-infer HMM
# tolerances, as in test_torch_hmm.py.
S_TOL = dict(rtol=0, atol=5e-5)
CONC_TOL = dict(rtol=1e-5, atol=1e-4)
# The free energy, as in test_torch_free_energy.py: float32 sums over T
# steps in two libraries.
FE_TOL = dict(rtol=1e-5, atol=1e-3)
H100_SMS = 132
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(b, t, k, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, k)).astype(np.float32),
            (2.0 * rng.standard_normal((b, k, k))).astype(np.float32),
            (2.0 * rng.standard_normal((t, b, k))).astype(np.float32))


def _torch(*arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


# -- the plain versions against the JAX package -------------------------------------

def test_plain_fb_at_nine_states_matches_the_jax_kernels():
    """The wide kernels' plain versions at K = 9 against the JAX Pallas
    forward-backward in interpret mode (one case: the interpreter traces a
    K^2 step body)."""
    lp, lt, le = _inputs(4, 6, 9, seed=9)
    jout = jax_fused_fb(jnp.asarray(lp), jnp.asarray(lt), jnp.asarray(le),
                        chunk=8, interpret=True, per_step_xi=True)
    tout = ffb.fused_fb_batched(*_torch(lp, lt, le), per_step_xi=True)
    shapes = [(6, 4, 9), (4, 9, 9), (4,), (5, 4, 9, 9)]
    for name, got, want, shape in zip(("gammas", "xi_sum", "logz", "xis"),
                                      tout, jout, shapes):
        assert tuple(got.shape) == shape, name
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=name, **FB_TOL)


@pytest.mark.parametrize("k", [12, 16, 33, 64])
def test_plain_fb_matches_the_jax_scan_solver(k):
    """At K = 12 and 16 (the half-warp order of sums), 33 and 64 (past one
    warp's lanes, and a table of 64 x 64) against the JAX package's scan
    forward-backward, chain by chain."""
    b, t = 3, 12
    lp, lt, le = _inputs(b, t, k, seed=k)
    gammas, xi_sum, logz, xis = ffb.fused_fb_batched(*_torch(lp, lt, le),
                                                     per_step_xi=True)
    assert tuple(xis.shape) == (t - 1, b, k, k)
    for i in range(b):
        res = forward_backward(jnp.asarray(lp[i]),
                               jnp.asarray(np.broadcast_to(lt[i],
                                                           (t - 1, k, k))),
                               jnp.asarray(le[:, i]))
        np.testing.assert_allclose(gammas[:, i].numpy(),
                                   np.asarray(res.gammas), **FB_TOL)
        np.testing.assert_allclose(xis[:, i].numpy(), np.asarray(res.xis),
                                   **FB_TOL)
        np.testing.assert_allclose(xi_sum[i].numpy(),
                                   np.asarray(res.xis).sum(0), **FB_TOL)
        np.testing.assert_allclose(float(logz[i]), float(res.logZ),
                                   **FB_TOL)


@pytest.mark.parametrize("k", [3, 9, 16])
def test_vectorised_forward_is_the_entry_list_step(k):
    """The plain forward pass runs every state at once (``alpha_step``);
    each entry takes ``forward_step``'s operations in its order, so the two
    agree to the last rounding of the CPU's exp and log on tensors of
    another length."""
    lp, lt, le = _torch(*_inputs(5, 9, k, seed=k + 1))
    alphas, logz = ffb.fb_forward_reference(lp, lt, le)
    entries = [[lt[:, i, j] for j in range(k)] for i in range(k)]
    alpha = [lp[:, i] for i in range(k)]
    cum = torch.zeros(5)
    for t in range(9):
        alpha, m = ffb.forward_step(alpha, [le[t, :, i] for i in range(k)],
                                    entries, first=t == 0)
        cum = cum + m
        np.testing.assert_allclose(alphas[t].numpy(),
                                   torch.stack(alpha, -1).numpy(),
                                   rtol=1e-6, atol=1e-6)
    assert tuple(logz.shape) == (5,)


def test_cpu_tensors_above_eight_states_take_the_plain_version():
    lp, lt, le = _torch(*_inputs(2, 5, 12, seed=3))
    before = dict(ffb.LAUNCHES)
    alphas, logz = ffb.fb_forward(lp, lt, le)
    want = ffb.fb_forward_reference(lp, lt, le)
    assert torch.equal(alphas, want[0]) and torch.equal(logz, want[1])
    got = ffb.fb_backward(lt, le, alphas, per_step_xi=True)
    ref = ffb.fb_backward_reference(lt, le, alphas, True)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert ffb.LAUNCHES == before


def test_launch_keys_split_at_eight_states():
    assert ffb.launch_key("fwd", 8) == "fused_fb_fwd"
    assert ffb.launch_key("bwd", 9) == "fused_fb_bwd_wide"
    assert set(ffb.LAUNCHES) == {"fused_fb_fwd", "fused_fb_bwd",
                                 "fused_fb_fwd_wide", "fused_fb_bwd_wide",
                                 "fused_fb_serial_wide", "fused_fb_marg_wide"}


# -- the wide marginal pass's tile --------------------------------------------------

@pytest.mark.parametrize("b,t,want", [(1024, 1000, 200), (8, 4099, 7),
                                      (37, 1001, 8), (33, 97, 4),
                                      (3, 17, 4), (2, 9, 4), (2000, 50, 25)])
def test_pick_tile_wide_at_the_checked_shapes(b, t, want):
    """A half-warp a (tile, chain): ceil(T / n) for the most tiles n whose
    B * n half-warps 132 SMs hold at once at 20 warps an SM, at least
    MIN_TILE_STEPS steps a tile."""
    assert ffb.pick_tile_wide(b, t, H100_SMS) == want


@pytest.mark.parametrize("b,t", [(1, 1), (1, 3), (5, 2), (64, 10_000),
                                 (4096, 200)])
def test_pick_tile_wide_fills_the_card_in_warps(b, t):
    tile = ffb.pick_tile_wide(b, t, H100_SMS)
    assert min(t, ffb.MIN_TILE_STEPS) <= tile <= t
    units = H100_SMS * ffb.MARGINAL_WARPS_PER_SM * 2   # two a warp
    # the card at least half full, all in one wave
    assert b * -(-t // tile) * 2 > units or tile == min(t, ffb.MIN_TILE_STEPS)
    assert b * -(-t // tile) <= max(units, b)
    # a thread a (tile, chain) asks for 32 times the pairs: tiles as short
    assert ffb.pick_tile(b, t, H100_SMS) <= tile


# -- batched_program on more than eight states --------------------------------------

def _hmm(k, m, b, t, seed):
    """One-hot observations of a sticky K-state chain with emissions that
    favour category state % m, and the initialization that breaks the
    states' symmetry."""
    rng = np.random.default_rng(seed)
    s = rng.integers(k, size=b)
    ys = np.zeros((b, t), np.int64)
    for step in range(t):
        jump = rng.random(b) < 0.1
        s = np.where(jump, rng.integers(k, size=b), s)
        noisy = rng.random(b) < 0.2
        ys[:, step] = np.where(noisy, rng.integers(m, size=b), s % m)
    y = np.eye(m, dtype=np.float32)[ys]
    b0 = (np.ones((m, k)) + 4.0 * (np.arange(m)[:, None] == np.arange(k) % m)
          + 0.1 * np.arange(k) / k).astype(np.float32)
    init = lambda rx: {"A": rx.DirichletCollection(np.ones((k, k), np.float32)),
                       "B": rx.DirichletCollection(b0)}
    return y, init


def _jax_hmm_program(k, m, y, init, fused, **kw):
    """The JAX package's program and its plan: ``fused`` runs its Pallas
    kernels (in interpret mode on the CPU, minutes a call at K = 16), else
    its scan path; the plan is the same JAX planner's either way."""
    jcomp, jprog = jrx.batched_program(jzoo.hmm(k, m), {"y": y}, iterations=3,
                                       initialization=init(jrx), **kw)
    if not fused:
        _, jprog = jrx.batched_program(
            jzoo.hmm(k, m), {"y": y}, iterations=3, initialization=init(jrx),
            options={"fused_kernels": False}, **kw)
    return jcomp, jprog


@pytest.mark.parametrize("k,m,t,jax_fused", [(9, 3, 14, True),
                                             (16, 4, 10, False)])
def test_batched_program_fuses_more_than_eight_states_and_matches_jax(
        k, m, t, jax_fused):
    """K = 9 against the JAX package's fused program; K = 16 against its
    scan path (its interpret-mode kernels take minutes there)."""
    y, init = _hmm(k, m, 3, t, seed=k)
    jcomp, jprog = _jax_hmm_program(k, m, y, init, jax_fused)
    jstate, _, _ = jprog({"y": jnp.asarray(y)})
    tcomp, tprog = trx.batched_program(tzoo.hmm(k, m), {"y": y}, iterations=3,
                                       initialization=init(trx), device=CPU)
    assert jcomp.plan_report()["s"]["fused"] is True
    assert tcomp.plan_report() == {
        "s": {"fused": True, "kernel": "fused_fb", "route": "plain"}}
    before = dict(ffb.LAUNCHES)
    tstate, _, _ = tprog({"y": y})
    assert ffb.LAUNCHES == before
    np.testing.assert_allclose(tstate["s"].probs().numpy(),
                               np.asarray(jstate["s"].probs()), **S_TOL)
    for n in ("A", "B"):
        np.testing.assert_allclose(tstate[n].alpha.numpy(),
                                   np.asarray(jstate[n].alpha), err_msg=n,
                                   **CONC_TOL)


def test_fe_at_nine_states_is_jax_fe_with_the_matrix_entropy_per_transition():
    """C6 at K = 9: the JAX package leaves out the entropy of the random
    transition matrix A once per transition copy, so the port's FE is the
    JAX FE (its scan path, which forms the FE as its fused path does) minus
    (T - 1) H[q(A)] at every sweep."""
    t = 12
    y, init = _hmm(9, 3, 3, t, seed=5)
    _, jprog = _jax_hmm_program(9, 3, y, init, False, free_energy=True)
    _, jfe, _ = jprog({"y": jnp.asarray(y)})
    tcomp, tprog = trx.batched_program(tzoo.hmm(9, 3), {"y": y}, iterations=3,
                                       free_energy=True, keep_each=True,
                                       initialization=init(trx), device=CPU)
    assert tcomp.plan_report()["s"]["fused"] is True
    _, tfe, hist = tprog({"y": y})
    assert tuple(tfe.shape) == (3, 3)
    h_a = np.stack([h["A"].entropy().numpy() for h in hist])
    np.testing.assert_allclose(tfe.numpy(), np.asarray(jfe) - (t - 1) * h_a,
                               **FE_TOL)


# -- the wide kernels on the card ----------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the wide forward-backward kernels "
                    "run only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("per_step_xi", [False, True])
@pytest.mark.parametrize("b,t,k", [(37, 101, 9), (8, 300, 16), (33, 40, 32),
                                   (5, 33, 33), (3, 17, 64), (2, 9, 240)])
def test_wide_kernels_match_their_plain_versions_on_the_card(cuda_device, b,
                                                             t, k,
                                                             per_step_xi):
    lp, lt, le = (torch.as_tensor(a, device=cuda_device)
                  for a in _inputs(b, t, k, seed=b + t + k))
    before = dict(ffb.LAUNCHES)
    alphas, logz = ffb.fb_forward(lp, lt, le)
    got = ffb.fb_backward(lt, le, alphas, per_step_xi)
    again = ffb.fb_backward(lt, le, alphas, per_step_xi)
    a_r, z_r = ffb.fb_forward_reference(lp, lt, le)
    ref = ffb.fb_backward_reference(
        lt, le, alphas, per_step_xi,
        tile=ffb.device_tile(b, t, cuda_device, k))
    torch.cuda.synchronize()
    torch.testing.assert_close(alphas, a_r, **FB_TOL)
    torch.testing.assert_close(logz, z_r, **FB_TOL)
    for g, r in zip(got, ref):
        if r is not None:
            torch.testing.assert_close(g, r, **FB_TOL)
    assert torch.equal(got[1], again[1])     # xi_sum: no atomics
    assert ffb.LAUNCHES["fused_fb_fwd_wide"] == before["fused_fb_fwd_wide"] + 1
    assert ffb.LAUNCHES["fused_fb_bwd_wide"] == before["fused_fb_bwd_wide"] + 2

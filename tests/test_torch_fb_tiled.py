"""The HMM backward pass of the PyTorch port as its kernels run it: the beta
recursion step by step, then the marginals over all steps at once, with
xi_sum summed in time tiles (``rxinfer_tpu_torch/ops/fused_fb.py``).  The
tiled plain version is held against the one-recursion plain version it
replaced and against the JAX package's Pallas forward-backward in interpret
mode (its references from one call, the cases embedded into one chain
batch: ``jax_refs``); xi_sum must not depend on the run; and the rule that
picks the marginal tile is pinned at its edges.

The CUDA kernels are held against the tiled plain version on the card by
the ``gpu``-marked test below and by ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rxinfer_tpu.ops.pallas_discrete import fused_fb_batched as jax_fused_fb
from rxinfer_tpu_torch.ops import fused_fb as ffb

# The JAX package's fused-vs-scan forward-backward tolerance
# (tests/engine/test_batched_engine.py:232-235), as in test_torch_hmm.py.
FB_TOL = dict(rtol=2e-5, atol=2e-5)
# Tiled against one recursion: the same operations on the same values, but
# the elementwise ops run on (T-1, B) tensors instead of (B,) ones (the CPU
# may take another exp/log code path for another length) and xi_sum adds
# the same terms in another order (tiles from t = 0 against one sum from
# t = T-2 down), a few float32 roundoffs over at most 3L+5 terms.
STEPWISE_TOL = dict(rtol=1e-5, atol=1e-6)
H100_SMS = 132
L = 4   # the marginal tile of the parity cases
CPU = torch.device("cpu")
# the parity cases' state counts and lengths (around the tile's edges)
PARITY_KS = [1, 3, 8]
PARITY_TS = [1, 2, L - 1, L, L + 1, 3 * L + 5]


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


# -- the JAX references, once a module ----------------------------------------------
#
# Each parity case (k, t) needs the JAX Pallas forward-backward in
# interpret mode on its three chains: a trace of its own at every (K, T),
# 2-20 s each on the CPU.  One call holds them all: each case's chains are
# embedded into EMBED_K states and the longest T steps, the states past k
# and the steps past t given a log-potential of NEG, so far below the
# chain's that its exponential is an exact float32 zero, and an end state
# (the last) that every state enters with log-potential 0 after step t - 1
# and never leaves.  Every sum of the JAX kernels then adds exact zeros
# after the case's own terms and every maximum finds the case's own; the
# end state's backward messages are equal over the states, so the case's
# betas restart from 0 at its last step as a chain of t steps does, and
# its forward normalisers carry log Z.  ``test_embedded_references_are_the
# _direct_calls`` holds the embedding's outputs equal, bit for bit, to
# direct calls at a few cases (all 18 were equal when it was written).
EMBED_K = max(PARITY_KS) + 1
NEG = -1e4


def _embed(lp, lt, le, t_out):
    """One case's (B, k) prior, (B, k, k) table and (t, B, k) evidence
    embedded into EMBED_K states and ``t_out`` steps."""
    b, k = lp.shape
    t = le.shape[0]
    end = EMBED_K - 1
    lp_e = np.full((b, EMBED_K), NEG, np.float32)
    lp_e[:, :k] = lp
    lt_e = np.full((b, EMBED_K, EMBED_K), NEG, np.float32)
    lt_e[:, :k, :k] = lt
    lt_e[:, end, :] = 0.0          # every state enters the end state
    le_e = np.full((t_out, b, EMBED_K), NEG, np.float32)
    le_e[:t, :, :k] = le
    le_e[t:, :, end] = 0.0         # after step t - 1 only the end state
    return lp_e, lt_e, le_e


def _parity_inputs(k, t):
    return _inputs(3, t, k, seed=10 * k + t)


def _jax_direct(lp, lt, le):
    return tuple(np.asarray(o) for o in jax_fused_fb(
        jnp.asarray(lp), jnp.asarray(lt), jnp.asarray(le), chunk=8,
        interpret=True, per_step_xi=True))


@pytest.fixture(scope="module")
def jax_refs():
    """(k, t) -> the JAX kernels' (gammas, xi_sum, logz, xi_steps) of that
    parity case, all cases from one embedded call."""
    cases = [(k, t) for k in PARITY_KS for t in PARITY_TS]
    t_out = max(PARITY_TS)
    parts = [_embed(*_parity_inputs(k, t), t_out) for k, t in cases]
    out = _jax_direct(*(np.concatenate([p[i] for p in parts],
                                       axis=1 if i == 2 else 0)
                        for i in range(3)))
    refs = {}
    for n, (k, t) in enumerate(cases):
        rows = slice(3 * n, 3 * n + 3)
        refs[(k, t)] = (out[0][:t, rows, :k], out[1][rows, :k, :k],
                        out[2][rows], out[3][:t - 1, rows, :k, :k])
    return refs


@pytest.mark.parametrize("k,t", [(1, 1), (1, 3 * L + 5), (3, L + 1)])
def test_embedded_references_are_the_direct_calls(k, t, jax_refs):
    direct = _jax_direct(*_parity_inputs(k, t))
    for name, e, d in zip(("gammas", "xi_sum", "logz", "xi_steps"),
                          jax_refs[(k, t)], direct):
        assert e.shape == d.shape and np.array_equal(e, d), name


# -- the tiled plain version ------------------------------------------------------

@pytest.mark.parametrize("t", PARITY_TS)
@pytest.mark.parametrize("k", PARITY_KS)
def test_tiled_backward_matches_stepwise_and_jax(k, t, jax_refs):
    lp, lt, le = _parity_inputs(k, t)
    tlp, tlt, tle = _torch(lp, lt, le)
    alphas, logz = ffb.fb_forward_reference(tlp, tlt, tle)
    got = ffb.fb_backward_reference(tlt, tle, alphas, True, tile=L)
    old = ffb._fb_backward_stepwise(tlt, tle, alphas, True)
    for name, g, w in zip(("gammas", "xi_sum", "xi_steps"), got, old):
        assert tuple(g.shape) == tuple(w.shape), name
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=name,
                                   **STEPWISE_TOL)
    jout = jax_refs[(k, t)]
    mine = (got[0], got[1], logz, got[2])
    for name, g, w in zip(("gammas", "xi_sum", "logz", "xi_steps"), mine,
                          jout):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **FB_TOL)


@pytest.mark.parametrize("tile", [1, 2, 3, 5, 16, 40])
def test_any_tile_gives_the_same_gammas_and_xis(tile):
    """The tile only orders xi_sum's additions: gammas and xi_steps are
    bit-identical, xi_sum equal to float32 roundoff."""
    tlp, tlt, tle = _torch(*_inputs(5, 17, 3, seed=4))
    alphas, _ = ffb.fb_forward_reference(tlp, tlt, tle)
    one = ffb.fb_backward_reference(tlt, tle, alphas, True)
    got = ffb.fb_backward_reference(tlt, tle, alphas, True, tile=tile)
    assert torch.equal(got[0], one[0]) and torch.equal(got[2], one[2])
    np.testing.assert_allclose(got[1].numpy(), one[1].numpy(), **STEPWISE_TOL)


def test_xi_sum_sums_tiles_in_order():
    """xi_sum is the tile partials added in tile order, each partial the
    tile's xi_t added in step order, both from zero: as the marginal and
    xi_sum passes add them."""
    tlp, tlt, tle = _torch(*_inputs(2, 11, 3, seed=5))
    alphas, _ = ffb.fb_forward_reference(tlp, tlt, tle)
    _, xi_sum, xis = ffb.fb_backward_reference(tlt, tle, alphas, True, tile=4)
    want = torch.zeros_like(xi_sum)
    for t0 in range(0, 11, 4):
        part = torch.zeros_like(xi_sum)
        for t in range(t0, min(t0 + 4, 10)):
            part = part + xis[t]
        want = want + part
    assert torch.equal(xi_sum, want)


def test_xi_sum_is_bit_identical_across_runs():
    tlp, tlt, tle = _torch(*_inputs(6, 3 * L + 5, 8, seed=6))
    alphas, _ = ffb.fb_forward_reference(tlp, tlt, tle)
    runs = [ffb.fb_backward_reference(tlt, tle, alphas, steps, tile=L)[1]
            for steps in (True, False, True)]
    assert all(torch.equal(runs[0], r) for r in runs[1:])


def test_betas_are_max_normalised_and_zero_at_the_end():
    tlp, tlt, tle = _torch(*_inputs(4, 9, 3, seed=7))
    betas = ffb.beta_pass_reference(tlt, tle)
    assert tuple(betas.shape) == (9, 4, 3)
    assert not betas[-1].any()
    assert torch.equal(betas.max(dim=-1).values, torch.zeros(9, 4))


def test_cpu_wrapper_takes_the_tiled_plain_version():
    tlp, tlt, tle = _torch(*_inputs(3, 10, 3, seed=8))
    alphas, _ = ffb.fb_forward(tlp, tlt, tle)
    before = dict(ffb.LAUNCHES)
    got = ffb.fb_backward(tlt, tle, alphas, per_step_xi=True)
    want = ffb.fb_backward_reference(tlt, tle, alphas, True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ffb.LAUNCHES == before


# -- the tile rule ------------------------------------------------------------------

def _wanted_threads(sms=H100_SMS):
    return sms * ffb.SCHEDULERS_PER_SM * 32 * ffb.MARGINAL_WARPS_PER_SCHEDULER


def test_pick_tile_at_the_main_shape():
    """B=256, T=200 (the HMM bench): 132 tiles would fill the card, so the
    least tile length holds: 50 tiles of 4 steps."""
    assert ffb.pick_tile(256, 200, H100_SMS) == ffb.MIN_TILE_STEPS == 4


@pytest.mark.parametrize("t", [1, 2, 3, 4, 5, 10_000])
def test_one_chain_takes_the_shortest_tiles(t):
    assert ffb.pick_tile(1, t, H100_SMS) == min(t, ffb.MIN_TILE_STEPS)


@pytest.mark.parametrize("b,t", [(100_000, 200), (_wanted_threads(), 64),
                                 (8448, 1)])
def test_a_batch_that_fills_the_card_takes_one_tile(b, t):
    assert ffb.pick_tile(b, t, H100_SMS) == t


@pytest.mark.parametrize("b,t,want", [(8448, 64, 16), (4096, 1000, 111),
                                      (64, 10_000, 18), (0, 7, 4)])
def test_pick_tile_at_the_timed_shapes(b, t, want):
    assert ffb.pick_tile(b, t, H100_SMS) == want


@pytest.mark.parametrize("b", [1, 7, 64, 256, 1000, 8448, 40_000])
@pytest.mark.parametrize("t", [1, 3, 33, 200, 1001, 4099])
def test_pick_tile_fills_the_card_or_holds_the_least_tile(b, t):
    tile = ffb.pick_tile(b, t, H100_SMS)
    tiles = -(-t // tile)
    assert 1 <= tile <= t
    assert tile >= min(t, ffb.MIN_TILE_STEPS)
    if tile > ffb.MIN_TILE_STEPS:
        assert b * tiles >= _wanted_threads() or tiles == 1


# -- the kernels on the card ----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the forward-backward kernels run "
                    "only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,k", [(40, 1001, 3), (8, 4099, 8), (33, 97, 5)])
def test_tiled_kernels_match_plain_version_on_the_card(cuda_device, b, t, k):
    lp, lt, le = (torch.as_tensor(a, device=cuda_device)
                  for a in _inputs(b, t, k, seed=9))
    alphas, _ = ffb.fb_forward(lp, lt, le)
    got = ffb.fb_backward(lt, le, alphas, per_step_xi=True)
    want = ffb.fb_backward_reference(
        lt, le, alphas, True, tile=ffb.device_tile(b, t, cuda_device, k))
    again = ffb.fb_backward(lt, le, alphas, per_step_xi=True)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **FB_TOL)
    assert torch.equal(got[1], again[1])

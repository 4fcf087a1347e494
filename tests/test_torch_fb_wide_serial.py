"""The wide forward-backward's two calls above eight states
(``rxinfer_tpu_torch/ops/fused_fb.py``): ``fb_serial_wide`` runs the
forward and the beta recursion in one launch, ``fb_marginals_wide`` the
marginals.  From 9 to 16 states the kernels split each step over two
half-warps, and the plain versions take their order of sums; this file
holds that order against a lane-by-lane emulation of the kernels' shuffles
on the CPU, the two calls against the plain versions on CPU tensors, and
(``gpu``-marked; they decide inside a fixture whether there is a card) the
kernels against the plain versions on the card.  It imports neither JAX nor
the JAX package, so the card tests run on a machine without them:

    python -m pytest --noconftest -m gpu tests/test_torch_fb_wide_serial.py

The plain versions against the JAX kernels are in
``tests/test_torch_fb_wide.py``.
"""

import numpy as np
import pytest
import torch

from rxinfer_tpu_torch.ops import fused_fb as ffb

FB_TOL = dict(rtol=2e-5, atol=2e-5)   # as in test_torch_fb_wide.py


def _inputs(b, t, k, seed, device="cpu"):
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(a.astype(np.float32), device=device)
                 for a in (rng.standard_normal((b, k)),
                           2.0 * rng.standard_normal((b, k, k)),
                           2.0 * rng.standard_normal((t, b, k))))


# -- the half-warp order, lane by lane ---------------------------------------------

def _butterfly(lanes, ops):
    """``lanes`` (16, ...) after v_l = v_l + v_{l ^ o} for each o in
    ``ops``, as the shuffles compute it lane by lane."""
    idx = torch.arange(16)
    for o in ops:
        lanes = lanes + lanes[idx ^ o]
    return lanes


@pytest.mark.parametrize("k", [9, 12, 16])
def test_gamma_sum_is_the_half_warp_butterfly(k):
    """Gamma's sum over the states: lane l holds exp(g_l - max) (zero past
    K), the half-warp adds v_{l ^ 8}, v_{l ^ 4}, v_{l ^ 2}, v_{l ^ 1}; every
    lane ends with the plain version's bits."""
    g = torch.as_tensor(np.random.default_rng(k).standard_normal(
        (7, k)).astype(np.float32))
    e = torch.exp(g - g.amax(-1, keepdim=True))
    lanes = torch.zeros(16, 7)
    lanes[:k] = e.T
    lanes = _butterfly(lanes, (8, 4, 2, 1))
    assert all(torch.equal(lanes[0], lanes[l]) for l in range(16))
    assert torch.equal(ffb._softmax_last(g), e / lanes[0][:, None])


@pytest.mark.parametrize("k", [9, 12, 16])
def test_xi_normaliser_is_the_half_warp_order(k):
    """xi's sum of row sums: lane l = 4q + c holds entries (4m + q, 4c + k)
    of the 16 x 16 block, sums each row's four in order, adds lanes c ^ 1
    and c ^ 2, sums its four rows as (R0 + R1) + (R2 + R3), then adds lanes
    l ^ 4 and l ^ 8: the plain version's bits."""
    x = torch.as_tensor(np.random.default_rng(k).standard_normal(
        (5, k, k)).astype(np.float32))
    e = torch.exp(x - x.amax((-2, -1), keepdim=True))
    block = torch.zeros(5, 16, 16)
    block[:, :k, :k] = e
    rs = torch.zeros(16, 4, 5)          # [lane, m, batch]
    for lane in range(16):
        q, c = divmod(lane, 4)
        for m in range(4):
            v = block[:, 4 * m + q, 4 * c:4 * c + 4]
            rs[lane, m] = ((v[:, 0] + v[:, 1]) + v[:, 2]) + v[:, 3]
    rs = _butterfly(rs, (1, 2))
    tot = (rs[:, 0] + rs[:, 1]) + (rs[:, 2] + rs[:, 3])
    tot = _butterfly(tot, (4, 8))
    assert all(torch.equal(tot[0], tot[l]) for l in range(16))
    assert torch.equal(ffb._xi_from_logits(x), e / tot[0][:, None, None])


@pytest.mark.parametrize("k", [9, 13, 16])
def test_log_sum_exp_splits_at_the_half_warps(k):
    """A step's log-sum-exp at 9..16 states: the maximum of all terms, the
    exp sums of terms 0..7 and 8..K-1 each in order, low plus high; at 17
    and above (and at 8 or fewer) one sum in index order."""
    terms = list(torch.as_tensor(np.random.default_rng(k).standard_normal(
        (k, 6)).astype(np.float32)))
    m = torch.stack(terms).amax(0)
    lo = ffb._exp_sum(terms[:ffb.HALF_TERMS], m)
    hi = ffb._exp_sum(terms[ffb.HALF_TERMS:], m)
    assert torch.equal(ffb._lse(terms, True), m + torch.log(lo + hi))
    assert ffb.halves(k) and not ffb.halves(8) and not ffb.halves(17)
    assert torch.equal(ffb._lse(terms), m + torch.log(ffb._exp_sum(terms, m)))


def test_plain_beta_step_takes_the_score_offset_first_at_sixteen_states():
    """At 9..16 states the scores are logA[i][j] + (le[i] + beta[i]), the
    row offset the beta warp keeps; above, (logA + le) + beta."""
    for k, halves in ((16, True), (17, False)):
        lp, lt, le = _inputs(3, 2, k, seed=k)
        beta = torch.randn(3, k, generator=torch.Generator().manual_seed(k))
        got = ffb.beta_step(beta, le[1], lt)
        s = (lt + (le[1] + beta)[..., None] if halves
             else lt + le[1][..., None] + beta[..., None])
        raw = ffb._lse([s[:, i] for i in range(k)], halves)
        assert torch.equal(got, raw - raw.amax(-1, keepdim=True))


# -- the two calls on CPU tensors -------------------------------------------------

@pytest.mark.parametrize("k", [9, 16, 33])
def test_the_two_calls_take_the_plain_versions_on_cpu_tensors(k):
    lp, lt, le = _inputs(3, 11, k, seed=k + 3)
    before = dict(ffb.LAUNCHES)
    alphas, logz, betas = ffb.fb_serial_wide(lp, lt, le)
    a_r, z_r = ffb.fb_forward_reference(lp, lt, le)
    assert torch.equal(alphas, a_r) and torch.equal(logz, z_r)
    assert torch.equal(betas, ffb.beta_pass_reference(lt, le))
    got = ffb.fb_marginals_wide(lt, le, alphas, betas, per_step_xi=True)
    ref = ffb.fb_backward_reference(lt, le, alphas, True)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    fused = ffb.fused_fb_batched(lp, lt, le, per_step_xi=True)
    assert all(torch.equal(g, r) for g, r in
               zip(fused, (ref[0], ref[1], logz, ref[2])))
    assert ffb.LAUNCHES == before


def test_the_two_calls_refuse_eight_states():
    lp, lt, le = _inputs(2, 4, 8, seed=1)
    with pytest.raises(ValueError, match="K > 8"):
        ffb.fb_serial_wide(lp, lt, le)
    with pytest.raises(ValueError, match="K > 8"):
        ffb.fb_marginals_wide(lt, le, le, le)


def test_launch_keys_of_the_two_calls():
    assert ffb.launch_key("serial", 9) == "fused_fb_serial_wide"
    assert ffb.launch_key("marg", 240) == "fused_fb_marg_wide"
    with pytest.raises(ValueError, match="K > 8"):
        ffb.launch_key("serial", 8)


@pytest.mark.parametrize("b,t", [(1024, 1000), (8, 4099), (37, 1001),
                                 (4096, 200), (1, 5)])
def test_marginal_units_fit_one_wave(b, t):
    """B * tiles half-warps fit the card at MARGINAL_WARPS_PER_SM warps an
    SM (two units a warp), unless one tile a chain already overfills it;
    and a tile one step shorter would need more tiles than fit, unless the
    tile is at its floor."""
    sms = 132
    units = sms * ffb.MARGINAL_WARPS_PER_SM * 2
    fit = max(1, units // b)
    tile = ffb.pick_tile_wide(b, t, sms)
    assert -(-t // tile) <= fit
    assert tile == min(t, ffb.MIN_TILE_STEPS) or -(-t // (tile - 1)) > fit


# -- on the card ------------------------------------------------------------------

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
def test_serial_and_marginal_launches_match_their_plain_versions_on_the_card(
        cuda_device, b, t, k, per_step_xi):
    lp, lt, le = _inputs(b, t, k, seed=b + t + k, device=cuda_device)
    before = dict(ffb.LAUNCHES)
    alphas, logz, betas = ffb.fb_serial_wide(lp, lt, le)
    fwd_only = ffb.fb_forward(lp, lt, le)   # the same kernel, one role
    beta_only = ffb._serial_cuda(None, lt, le, forward=False, beta=True)
    got = ffb.fb_marginals_wide(lt, le, alphas, betas, per_step_xi)
    again = ffb.fb_marginals_wide(lt, le, alphas, betas, per_step_xi)
    fused = ffb.fused_fb_batched(lp, lt, le, per_step_xi)
    a_r, z_r = ffb.fb_forward_reference(lp, lt, le)
    b_r = ffb.beta_pass_reference(lt, le)
    ref = ffb.marginals_reference(
        lt, le, alphas, betas, per_step_xi,
        tile=ffb.device_tile(b, t, cuda_device, k))
    torch.cuda.synchronize()
    torch.testing.assert_close(alphas, a_r, **FB_TOL)
    torch.testing.assert_close(logz, z_r, **FB_TOL)
    torch.testing.assert_close(betas, b_r, **FB_TOL)
    assert torch.equal(fwd_only[0], alphas) and torch.equal(betas,
                                                            beta_only[2])
    for g, r in zip(got, ref):
        if r is not None:
            torch.testing.assert_close(g, r, **FB_TOL)
    assert torch.equal(got[1], again[1])     # xi_sum: no atomics
    assert torch.equal(fused[1], got[1]) and torch.equal(fused[2], logz)
    rose = {key: ffb.LAUNCHES[key] - before[key] for key in before}
    assert rose == {**{key: 0 for key in before}, "fused_fb_serial_wide": 2,
                    "fused_fb_marg_wide": 3, "fused_fb_fwd_wide": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("per_step_xi", [False, True])
@pytest.mark.parametrize("b,t,k", [(37, 1001, 17), (33, 97, 32), (9, 130, 20),
                                   (5, 41, 31), (1024, 50, 32), (3, 1, 24)])
def test_marginal_kernel_past_sixteen_states_matches_the_plain_version(
        cuda_device, b, t, k, per_step_xi):
    """The row kernel (16 < K <= 32) at ragged shapes: B past a CTA's four
    warps, ragged tiles, K % 4 == 0 (16-byte stores) and not (17, 31), one
    step; the same bits over two calls (no atomics)."""
    lp, lt, le = _inputs(b, t, k, seed=b + t + k, device=cuda_device)
    assert ffb.marginal_plan(k)["kernel"] == "fb_wide_marg_rows_kernel"
    alphas, _, betas = ffb.fb_serial_wide(lp, lt, le)
    before = ffb.LAUNCHES["fused_fb_marg_wide"]
    got = ffb.fb_marginals_wide(lt, le, alphas, betas, per_step_xi)
    again = ffb.fb_marginals_wide(lt, le, alphas, betas, per_step_xi)
    ref = ffb.marginals_reference(
        lt, le, alphas, betas, per_step_xi,
        tile=ffb.device_tile(b, t, cuda_device, k))
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        if r is not None:
            torch.testing.assert_close(g, r, **FB_TOL)
    assert all(x is None and y is None or torch.equal(x, y)
               for x, y in zip(got, again))
    assert ffb.LAUNCHES["fused_fb_marg_wide"] == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("per_step_xi", [False, True])
@pytest.mark.parametrize("b,t,k", [(5, 101, 33), (3, 50, 48), (7, 37, 63),
                                   (2, 999, 64), (1, 1, 40), (600, 9, 64)])
def test_marginal_kernel_past_thirty_two_states_gives_the_plain_bits(
        cuda_device, b, t, k, per_step_xi):
    """The two-warp row kernel (32 < K <= 64) at ragged shapes: ragged
    tiles, K % 4 == 0 (16-byte stores: 48, 64) and not (33, 63), one step,
    more units than a wave; the plain version's bits, the same over two
    calls (no atomics)."""
    lp, lt, le = _inputs(b, t, k, seed=b + t + k, device=cuda_device)
    assert ffb.marginal_plan(k)["kernel"] == "fb_wide_marg_rows2_kernel"
    alphas, _, betas = ffb.fb_serial_wide(lp, lt, le)
    before = ffb.LAUNCHES["fused_fb_marg_wide"]
    got = ffb.fb_marginals_wide(lt, le, alphas, betas, per_step_xi)
    again = ffb.fb_marginals_wide(lt, le, alphas, betas, per_step_xi)
    ref = ffb.marginals_reference(
        lt, le, alphas, betas, per_step_xi,
        tile=ffb.device_tile(b, t, cuda_device, k))
    torch.cuda.synchronize()
    for x, y, r in zip(got, again, ref):
        assert x is None and y is None and r is None or (
            torch.equal(x, r) and torch.equal(x, y))
    assert ffb.LAUNCHES["fused_fb_marg_wide"] == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("k", [33, 64])
def test_marginal_kernel_past_thirty_two_states_divides_tiny_quotients(
        cuda_device, k):
    """Log-potentials spread 20 times wider, so that most per-step xi
    entries fall below 2^-100 or to zero: the rows whose quotients the
    kernel forms by the IEEE division, the plain version's bits all the
    same."""
    lp, lt, le = _inputs(3, 40, k, seed=k, device=cuda_device)
    lt, le = 20 * lt, 20 * le
    alphas, _, betas = ffb.fb_serial_wide(lp, lt, le)
    got = ffb.fb_marginals_wide(lt, le, alphas, betas, True)
    ref = ffb.marginals_reference(
        lt, le, alphas, betas, True, tile=ffb.device_tile(3, 40, cuda_device,
                                                          k))
    torch.cuda.synchronize()
    assert float((ref[2] < 2.0 ** -100).float().mean()) > 0.5
    assert all(torch.equal(x, r) for x, r in zip(got, ref))

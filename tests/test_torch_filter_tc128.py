"""The warp K3's tensor-core tier past 64 (64 < d <= 128,
``warp_filter_tc128_kernel`` of ``csrc/fused_filter_tc128.cu``).  The
tier's arithmetic is emulated here in torch on the CPU: the state padded to
128 with an identity block, each product in 3xTF32 a k tile of 8 at a time
(``test_torch_filter_tc64.py``'s ``mma3``), F P F^T + Q from the symmetric
P, both inverses as the Schur blocks at 64 (the 64 x 64 inverses as the
tier past 32's, at 32, with the 32 x 32 ones at 16, the 16 x 16 ones at 8
and Gauss-Jordan leaves of 8) with the mean-|diagonal| scale, every block
above a diagonal the transpose of its mirror below where the kernel forms
it so, the second inverse refined by one Newton step, and P's diagonal 16
x 16 blocks mirrored each step.  The emulation
is held against the plain version at the tier's first d, the JAX package's
``filtering_scan`` and, over 200 one-observation steps, a float64 filter
(ROADMAP C7); ``warp_plan``'s routing and the tier's plan are pinned.  The
JAX package is imported inside the fixture that needs it, so the
``gpu``-marked cases (the kernel against the plain version and the float64
filter on the card) run on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_filter_tc128.py
"""

import numpy as np
import pytest
import torch

from rxinfer_tpu_torch.ops import fused_filter as ff
from rxinfer_tpu_torch.ops import fused_smoother as fs
from test_torch_filter_tc64 import (  # noqa: F401  (fixtures)
    H100_SMEM,
    KERNEL_TOL,
    ORACLE_TOL,
    TOL,
    _filter64,
    _inv32,
    _mirror_diagonal_blocks,
    _one_thread,
    _plain,
    _schur,
    _system,
    jax_filtering_scan,
    mma3,
)

DP = 128


# -- the tier's arithmetic, emulated -----------------------------------------

def _upper_from_lower(m, n):
    """The 16 x 16 blocks above the diagonal of m's top-left n x n corner
    the transposes of their mirrors below (the kernel writes them so)."""
    for i in range(0, n, 16):
        for j in range(i + 16, n, 16):
            m[:, i:i + 16, j:j + 16] = m[:, j:j + 16, i:i + 16].transpose(
                -1, -2)
    return m


def _inv64(m):
    """``inv64``: the tier past 32's 64 x 64 inverse (the Schur blocks at
    32, X^T by transposition, TL's upper-right block the transpose of its
    lower-left), unscaled."""
    return _upper_from_lower(_schur(m, 32, _inv32, _inv32, True), 32)


def sym_inv128(m, d):
    """The tier's inverse of the padded (B, 128, 128) m: scaled by the mean
    |diagonal| of its d real entries, the Schur blocks at 64, TL's blocks
    above its diagonal the transposes of those below."""
    diag = torch.diagonal(m, dim1=-2, dim2=-1)[:, :d].abs().sum(-1) / d
    inv_s = 1.0 / torch.where(diag > 0, diag, torch.ones_like(diag))
    out = _schur(m * inv_s[:, None, None], 64, _inv64, _inv64, True)
    return _upper_from_lower(out, 64) * inv_s[:, None, None]


def refine(m, p0):
    """One Newton step on the inverse p0 of m (both (B, 128, 128), p0
    symmetric): R = I - m p0 (a block at a time from the identity), then
    p0 + p0 R, its blocks above the diagonal the transposes of those below
    and its diagonal blocks mirrored."""
    eye = torch.eye(DP).expand_as(m)
    r = mma3(-m, p0, acc=eye)
    p1 = mma3(p0, r.transpose(-1, -2), acc=p0)
    return _mirror_diagonal_blocks(_upper_from_lower(p1, DP))


def emulate_filter(m0, p0, ys, f, q, hr, w):
    """The tier's step over (B, d) m0, (B, d, d) p0, (T, B, dy) ys: means
    (T, B, d), final m, final P, all float32."""
    d = f.shape[0]
    pad = lambda a: torch.nn.functional.pad(
        torch.as_tensor(a, dtype=torch.float32), (0, DP - d, 0, DP - d))
    fp, wp = pad(f), pad(w)
    qp = pad(q) + torch.diag((torch.arange(DP) >= d).float())
    hrt = torch.as_tensor(hr, dtype=torch.float32)
    bsz = m0.shape[0]
    m = torch.zeros((bsz, DP))
    m[:, :d] = torch.as_tensor(m0)
    p = torch.eye(DP).repeat(bsz, 1, 1)
    p[:, :d, :d] = torch.as_tensor(p0)
    fb = fp.expand(bsz, DP, DP)
    means = []
    for y in torch.as_tensor(ys):
        m_pred = m @ fp.T
        p_pred = mma3(mma3(fb, p), fb, acc=qp.expand_as(p))
        lam = sym_inv128(p_pred, d)
        xi = torch.zeros((bsz, DP))
        xi[:, :d] = y @ hrt.T
        h = torch.einsum("bij,bj->bi", lam, m_pred) + xi
        mw = _upper_from_lower(lam + wp, DP)   # M as the kernel keeps it
        p = refine(mw, _mirror_diagonal_blocks(sym_inv128(mw, d)))
        m = torch.einsum("bij,bj->bi", p, h)
        means.append(m[:, :d])
    return torch.stack(means), m[:, :d], p[:, :d, :d]


# (d, dy, T): the tier's first d (a ragged padding of 63 states) and d = 72
# with 70 observations (three staged chunks on the card), one step: the
# plain step is about 2e6 small torch operations there (1e7 at d = 128)
@pytest.mark.parametrize("d,dy,t", [(65, 5, 1), (72, 70, 1)])
def test_emulated_tier_matches_plain_version(d, dy, t):
    m, p, ys, f, q, h, r = _system(2, t, d, dy, 9.0, seed=d + dy)
    w_obs, hr = ff.evidence_operators(h, r)
    got = emulate_filter(m, p, ys, f, q, hr, w_obs)
    for g, want in zip(got, _plain(m, p, ys, f, q, hr, w_obs)):
        torch.testing.assert_close(g, want, **KERNEL_TOL)


# (d, dy, P0 scale): the first d, a padding of 32, the full width; d = 96
# with a vague prior and twice the observations (W well conditioned)
@pytest.mark.parametrize("d,dy,p0_scale", [(65, 9, 9.0), (96, 192, 1e6),
                                           (128, 128, 9.0)])
def test_emulated_tier_matches_jax(d, dy, p0_scale, jax_filtering_scan):
    m, p, ys, f, q, h, r = _system(3, 2, d, dy, p0_scale, seed=d + dy)
    w_obs, hr = ff.evidence_operators(h, r)
    got = emulate_filter(m, p, ys, f, q, hr, w_obs)
    for g, want in zip(got, jax_filtering_scan(m, p, ys, f, q, h, r)):
        np.testing.assert_allclose(g.numpy(), want, **TOL)


def test_emulated_tier_keeps_a_long_chain_on_the_float64_filter():
    """ROADMAP C7 at d = 128: one observation a step over 200 steps
    (chip_smoke.py phase 17 (a)'s system and seeds), every chain within
    ORACLE_TOL of the float64 filter, P's two triangles kept one matrix by
    the transposed blocks and the mirrored diagonal blocks."""
    import chip_smoke as cs

    d = DP
    f, q, h, r = cs._filter_system(d, 1, seed=d + 1)
    w_obs, hr = ff.evidence_operators(h, r)
    rng = np.random.default_rng(d)
    ys = rng.standard_normal((cs.ONE_OBS_T, 1, 4)).astype(np.float32)
    m = rng.standard_normal((4, d)).astype(np.float32)
    p = np.broadcast_to(9.0 * np.eye(d, dtype=np.float32), (4, d, d)).copy()
    ys = ys.transpose(0, 2, 1)
    got = emulate_filter(m, p, ys, f, q, hr, w_obs)
    want = _filter64(m, p, ys, f, q, h, r)
    for g, w in zip(got, want):
        assert np.isfinite(g.numpy()).all()
        assert float(np.abs(g.numpy() - w).max()) <= ORACLE_TOL


def test_emulated_tier_holds_the_float64_filter_with_few_observations():
    """Phase 17 (a)'s check at d = 100 (7 observations, ``chip_smoke``'s
    system, seed and tolerance): the Schur inverse alone left the means
    1.2e-3 (2.2e-3 emulated) from the float64 filter; with the Newton step
    on the second inverse they hold RTOL / ATOL as the plain version does."""
    import chip_smoke as cs

    bsz, t_len, d, dy = 3, 3, 100, 7
    f, q, h, r = cs._filter_system(d, dy, seed=1750)
    w_obs, hr = ff.evidence_operators(h, r)
    rng = np.random.default_rng(1750)
    ys = rng.standard_normal((t_len, dy, bsz)).astype(np.float32)
    m = rng.standard_normal((bsz, d)).astype(np.float32)
    p = np.broadcast_to(9.0 * np.eye(d, dtype=np.float32), (bsz, d, d)).copy()
    ys = ys.transpose(0, 2, 1)
    got = emulate_filter(m, p, ys, f, q, hr, w_obs)
    for g, w in zip(got, cs.filter_float64(m, p, ys, f, q, h, r)):
        assert cs._max_err(g.numpy(), w)[2]


def test_schur_inverse_at_128_inverts():
    rng = np.random.default_rng(4)
    a = rng.standard_normal((2, DP, DP))
    spd = (a @ a.transpose(0, 2, 1) / DP + np.eye(DP)).astype(np.float32)
    for d in (DP, 100):
        m = torch.eye(DP).repeat(2, 1, 1)
        m[:, :d, :d] = torch.as_tensor(spd[:, :d, :d])
        eye = sym_inv128(m, d).double() @ m.double()
        assert float((eye - torch.eye(DP, dtype=torch.float64)).abs().max()
                     ) < 1e-5


# -- the plan ------------------------------------------------------------

@pytest.mark.parametrize("d", [65, 72, 96, 100, 127, 128])
def test_warp_plan_routes_65_to_128_to_the_tier_past_64(d):
    plan = ff.warp_plan(d, H100_SMEM)
    assert plan == ff.tc128_plan(d) == ff.warp_plan(d, 48 * 1024)
    assert plan["tier"] == "tensor_cores_128"
    assert ff.launch_key(d, d) == "fused_filter_warp"
    assert plan["padded_dim"] == plan["tensor_dim"] == 128
    # 8 modulo the 32 banks: a quad's float2 fragment loads take distinct
    # banks
    assert plan["stride"] == 136 and plan["stride"] % 32 == 8
    assert plan["params"] == "F shared, Q and W device"
    assert plan["chain_matrices"] == "shared"
    # a chain a block of eight warps, one block an SM
    assert plan["chains_per_block"] == 1
    assert plan["warps_per_chain"] == plan["warps_per_sm"] == 8
    assert plan["lanes_per_chain"] == 256
    mat = 128 * 136 * 4
    # F, P and the work matrix; m, m_pred, h, each warp's observation chunk
    # and partial sum
    assert plan["smem_bytes"] == 3 * mat + (3 * 128 + 8 * 32 + 8) * 4
    assert plan["smem_bytes"] <= H100_SMEM < 2 * plan["smem_bytes"]
    # the tier past 32's layout at 128 would not fit: F's two parts, Q, W
    # and a chain's two matrices
    assert 6 * mat > H100_SMEM


@pytest.mark.parametrize("d", [64, 129])
def test_the_tier_past_64_stops_at_its_edges(d):
    assert ff.warp_plan(d, H100_SMEM)["tier"] == (
        "tensor_cores_64" if d == 64 else "sweep")


# -- on the card ---------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the tier past 64 runs only on the "
                    "card")
    return torch.device("cuda")


def _card_and_host(b, t, d, dy, p0_scale, seed, device):
    m, p, ys, f, q, h, r = _system(b, t, d, dy, p0_scale, seed=seed)
    w_obs, hr = ff.evidence_operators(h, r)
    host = (torch.as_tensor(m).t().contiguous(),
            fs.sym_fold(torch.as_tensor(p)).contiguous(),
            torch.as_tensor(ys).transpose(1, 2).contiguous())
    assert ff.device_warp_plan(d, device)["tier"] == "tensor_cores_128"
    before = ff.LAUNCHES["fused_filter_warp"]
    got = ff.fused_filter(*(a.to(device) for a in host), f, q, hr, w_obs)
    torch.cuda.synchronize()
    assert ff.LAUNCHES["fused_filter_warp"] == before + 1
    return got, host, (m, p, ys, f, q, h, r, hr, w_obs)


@pytest.mark.gpu
@pytest.mark.parametrize("b,d,t,dy", [(3, 65, 1, 5), (2, 72, 1, 70)])
def test_tier_past_64_matches_plain_version_on_the_card(cuda_device, b, d, t,
                                                        dy):
    got, host, (*_, f, q, h, r, hr, w_obs) = _card_and_host(
        b, t, d, dy, 9.0, 17, cuda_device)
    # the plain version on the host (seconds a step past d = 64)
    want = ff.fused_filter_reference(*host, f, q, hr, w_obs)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, **KERNEL_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("b,d,t,dy,p0_scale", [(5, 128, 3, 128, 9.0),
                                               (3, 100, 2, 200, 1e6),
                                               (4, 128, 200, 1, 9.0)])
def test_tier_past_64_matches_the_float64_filter_on_the_card(
        cuda_device, b, d, t, dy, p0_scale):
    got, _, (m, p, ys, f, q, h, r, _, _) = _card_and_host(
        b, t, d, dy, p0_scale, 19, cuda_device)
    want = _filter64(m, p, ys, f, q, h, r)
    means, mf, pf = (g.cpu() for g in got)
    for g, w in ((means.transpose(1, 2), want[0]), (mf.t(), want[1]),
                 (fs.sym_unfold_t(pf[None], d)[0], want[2])):
        assert float(np.abs(g.numpy() - w).max()) <= 3e-4

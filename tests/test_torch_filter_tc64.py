"""The warp K3's tensor-core tier past 32 (32 < d <= 64,
``warp_filter_tc64_kernel`` of ``csrc/fused_filter_warp.cu``).  The tier's
arithmetic is emulated here in torch on the CPU: the state padded to 48 or
64 with an identity block, each product in 3xTF32 a k tile of 8 at a time
(each operand's high part rounded to TF32 as ``cvt.rna`` does, its low part
cut to the 19 bits the tensor cores read), F P F^T + Q from the symmetric
P, both inverses as the Schur blocks at 32 (the 32 x 32 inverses at 16, the
16 x 16 ones at 8, Gauss-Jordan leaves of 8) with the mean-|diagonal|
scale, the lower-left blocks the transposes of the upper-right ones and
P's diagonal 16 x 16 blocks mirrored each step.  The emulation is held
against the plain version and the JAX package's ``filtering_scan``, and
over 200 one-observation steps against a float64 filter (ROADMAP C7);
``warp_plan``'s routing and the tier's plan are pinned.  The JAX package is
imported inside the fixture that needs it, so the ``gpu``-marked cases
(the kernel against the plain version on the card) run on a machine
without it:

    python -m pytest --noconftest -m gpu tests/test_torch_filter_tc64.py
"""

import numpy as np
import pytest
import torch

from rxinfer_tpu_torch.ops import fused_filter as ff
from rxinfer_tpu_torch.ops import fused_smoother as fs

# the JAX package's filter-test tolerance
TOL = dict(rtol=2e-4, atol=2e-4)
# the kernel (and its emulation) against the plain version: chip_smoke.py's
# RTOL / ATOL (3xTF32 products and Gauss-Jordan leaves against the Schur
# recursion to 2 x 2: rounding only)
KERNEL_TOL = dict(rtol=3e-4, atol=3e-4)
# against the float64 filter: chip_smoke.py's ORACLE_TOL
ORACLE_TOL = 1e-4
H100_SMEM = 232_448


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# -- the tier's arithmetic, emulated -----------------------------------------

def _tf32(x):
    """float32 to TF32, to nearest on the 13 dropped bits, ties away."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & -0x2000).view(torch.float32)


def _split(x):
    """The high part rounded to TF32, the low part the float32 rest as the
    tensor cores read it (its top 19 bits)."""
    hi = _tf32(x)
    lo = (x - hi).contiguous().view(torch.int32) & -0x2000
    return hi, lo.view(torch.float32)


def mma3(a, n, acc=None):
    """``acc + a n^T``, a k tile of 8 at a time, each tile's three TF32
    products (lo hi, hi lo, hi hi) summed on their own, then added."""
    out = torch.zeros(a.shape[:-1] + n.shape[-2:-1]) if acc is None \
        else acc.clone()
    ah, al = _split(a)
    nh, nl = _split(n)
    for k in range(0, a.shape[-1], 8):
        s = slice(k, k + 8)
        part = al[..., s] @ nh[..., s].transpose(-1, -2)
        part = part + ah[..., s] @ nl[..., s].transpose(-1, -2)
        part = part + ah[..., s] @ nh[..., s].transpose(-1, -2)
        out = out + part
    return out


def _gauss_jordan(m):
    """The leaves' unpivoted Gauss-Jordan sweep over (B, 8, 8) blocks."""
    m = m.clone()
    for k in range(m.shape[-1]):
        p = 1.0 / m[:, k, k]
        col = m[:, :, k].clone()
        qj = m[:, k, :] * p[:, None]
        m = m - col[:, :, None] * qj[:, None, :]
        m[:, k, :] = qj
        m[:, :, k] = -col * p[:, None]
        m[:, k, k] = p
    return m


def _schur(m, h, inv_a, inv_d, top):
    """The inverse of the symmetric m by the Schur blocks at h, from its
    lower blocks: A^-1, X = A^-1 B, S = D - B^T X, S^-1, Y = X S^-1, TL =
    A^-1 + Y X^T, the upper-right block -Y.  At the top level (``top``) B^T
    X is formed from X^T, X transposed; below it from Z = B^T A^-1, a
    product.  The lower-left block -Y^T is Y transposed, but in the 16 x 16
    inverses (h = 8) the product S^-1 X^T (``tc16.cuh`` inv16)."""
    a, bt, dd = m[:, :h, :h], m[:, h:, :h], m[:, h:, h:]
    ai = inv_a(a)
    x = mma3(ai, bt)
    if top:
        s = mma3(-bt, x.transpose(-1, -2), acc=dd)
    else:
        s = mma3(-mma3(bt, ai), bt, acc=dd)
    si = inv_d(s)
    y = mma3(x, si)
    tl = mma3(y, x, acc=ai)
    yt = mma3(si, x) if h == 8 else y.transpose(-1, -2)
    return torch.cat([torch.cat([tl, -y], -1), torch.cat([-yt, si], -1)], -2)


def _inv16(m):
    return _schur(m, 8, _gauss_jordan, _gauss_jordan, False)


def _inv32(m):
    return _schur(m, 16, _inv16, _inv16, False)


def sym_inv64(m, d):
    """The tier's inverse of the padded (B, DP, DP) m: scaled by the mean
    |diagonal| of its d real entries, the Schur blocks at 32, TL's
    upper-right 16 x 16 block the transpose of its lower-left."""
    diag = torch.diagonal(m, dim1=-2, dim2=-1)[:, :d].abs().sum(-1) / d
    inv_s = 1.0 / torch.where(diag > 0, diag, torch.ones_like(diag))
    inv_d = _inv32 if m.shape[-1] == 64 else _inv16
    out = _schur(m * inv_s[:, None, None], 32, _inv32, inv_d, True)
    out[:, :16, 16:32] = out[:, 16:32, :16].transpose(-1, -2)
    return out * inv_s[:, None, None]


def _mirror_diagonal_blocks(p):
    """Each diagonal 16 x 16 block's lower triangle the mirror of its
    upper (``tc16.cuh`` ``mirror_upper``)."""
    p = p.clone()
    for i in range(0, p.shape[-1], 16):
        blk = p[:, i:i + 16, i:i + 16]
        up = torch.triu(blk)
        p[:, i:i + 16, i:i + 16] = up + up.transpose(-1, -2) - torch.diag_embed(
            torch.diagonal(blk, dim1=-2, dim2=-1))
    return p


def emulate_filter(m0, p0, ys, f, q, hr, w):
    """The tier's step over (B, d) m0, (B, d, d) p0, (T, B, dy) ys: means
    (T, B, d), final m, final P, all float32."""
    d = f.shape[0]
    dp = ff.tc64_plan(d)["padded_dim"]
    pad = lambda a: torch.nn.functional.pad(
        torch.as_tensor(a, dtype=torch.float32), (0, dp - d, 0, dp - d))
    fp, wp = pad(f), pad(w)
    qp = pad(q) + torch.diag((torch.arange(dp) >= d).float())
    hrt = torch.as_tensor(hr, dtype=torch.float32)
    bsz = m0.shape[0]
    m = torch.zeros((bsz, dp))
    m[:, :d] = torch.as_tensor(m0)
    p = torch.eye(dp).repeat(bsz, 1, 1)
    p[:, :d, :d] = torch.as_tensor(p0)
    fb = fp.expand(bsz, dp, dp)
    means = []
    for y in torch.as_tensor(ys):
        m_pred = m @ fp.T
        p_pred = mma3(mma3(fb, p), fb, acc=qp.expand_as(p))
        lam = sym_inv64(p_pred, d)
        xi = torch.zeros((bsz, dp))
        xi[:, :d] = y @ hrt.T
        h = torch.einsum("bij,bj->bi", lam, m_pred) + xi
        p = _mirror_diagonal_blocks(sym_inv64(lam + wp, d))
        m = torch.einsum("bij,bj->bi", p, h)
        means.append(m[:, :d])
    return torch.stack(means), m[:, :d], p[:, :d, :d]


def _system(b, t, d, dy, p0_scale, seed):
    """``chip_smoke._filter_system``'s dense system: F a scaled orthonormal
    matrix, H = 1.2 I + 0.2 N (dy, d), R with unit correlations."""
    rng = np.random.default_rng(seed)
    qm, _ = np.linalg.qr(rng.standard_normal((d, d)))
    f = (0.98 * qm).astype(np.float32)
    q = (0.4 * np.eye(d)).astype(np.float32)
    h = (1.2 * np.eye(dy, d) + 0.2 * rng.standard_normal((dy, d))).astype(
        np.float32)
    r = (0.8 * np.eye(dy) + 0.1 * np.ones((dy, dy))).astype(np.float32)
    ys = rng.standard_normal((t, b, dy)).astype(np.float32)
    m = rng.standard_normal((b, d)).astype(np.float32)
    p = np.broadcast_to(p0_scale * np.eye(d, dtype=np.float32),
                        (b, d, d)).copy()
    return m, p, ys, f, q, h, r


def _plain(m, p, ys, f, q, hr, w_obs):
    d = f.shape[0]
    pm, pf, pp = ff.fused_filter_reference(
        torch.as_tensor(m).t().contiguous(),
        fs.sym_fold(torch.as_tensor(p)).contiguous(),
        torch.as_tensor(ys).transpose(1, 2).contiguous(), f, q, hr, w_obs)
    return pm.transpose(1, 2), pf.t(), fs.sym_unfold_t(pp[None], d)[0]


def _filter64(m, p, ys, f, q, h, r):
    """The information-form filter in float64 (chip_smoke.filter_float64)."""
    f, q, h, r = (np.asarray(a, np.float64) for a in (f, q, h, r))
    hr = h.T @ np.linalg.inv(r)
    w = hr @ h
    m, p = np.asarray(m, np.float64), np.asarray(p, np.float64)
    means = []
    for y in np.asarray(ys, np.float64):
        m = m @ f.T
        p = f @ p @ f.T + q
        lam = np.linalg.inv(p)
        p = np.linalg.inv(lam + w)
        m = np.einsum("nij,nj->ni", p, np.einsum("nij,nj->ni", lam, m)
                      + y @ hr.T)
        means.append(m)
    return np.stack(means), m, p


@pytest.fixture(scope="module")
def jax_filtering_scan():
    """The JAX package's ``filtering_scan`` on numpy inputs (imported here,
    so that the module imports without JAX)."""
    import jax.numpy as jnp

    from rxinfer_tpu.parallel.filtering import FilterState, filtering_scan

    def run(m, p, ys, f, q, h, r):
        final, means = filtering_scan(
            FilterState(jnp.asarray(m), jnp.asarray(p)), jnp.asarray(ys),
            jnp.asarray(f), jnp.asarray(q), jnp.asarray(h), jnp.asarray(r))
        return (np.asarray(means), np.asarray(final.m), np.asarray(final.p))

    return run


# (d, dy, P0 scale, T): the tier's first d (DP = 48, a ragged padding of 15
# states), d = 48 (no padding) and 49 (DP = 64), d = 64 with 100
# observations (four staged chunks on the card), and a vague prior with
# twice the observations (W well conditioned: past d = 32 the square
# random H of this system reaches condition numbers of 1e6, where no
# float32 filter holds 2e-4).  Few steps: the plain step is about 1.4e6
# small torch operations at d = 64.
CASES = [(33, 5, 9.0, 2), (48, 7, 9.0, 2), (49, 49, 9.0, 1),
         (64, 100, 9.0, 2), (40, 80, 1e6, 2)]


@pytest.mark.parametrize("d,dy,p0_scale,t", CASES)
def test_emulated_tier_matches_plain_version_and_jax(d, dy, p0_scale, t,
                                                     jax_filtering_scan):
    m, p, ys, f, q, h, r = _system(3, t, d, dy, p0_scale, seed=d + dy)
    w_obs, hr = ff.evidence_operators(h, r)
    got = emulate_filter(m, p, ys, f, q, hr, w_obs)
    plain = _plain(m, p, ys, f, q, hr, w_obs)
    ref = jax_filtering_scan(m, p, ys, f, q, h, r)
    jax_out = (ref[0], ref[1], ref[2])
    for g, want_plain, want_jax in zip(got, plain, jax_out):
        torch.testing.assert_close(g, want_plain, **KERNEL_TOL)
        np.testing.assert_allclose(g.numpy(), want_jax, **TOL)


@pytest.mark.parametrize("d", [48, 64])
def test_emulated_tier_keeps_a_long_chain_on_the_float64_filter(d):
    """ROADMAP C7 at the tier's padded widths: one observation a step over
    200 steps (chip_smoke.py phase 17 (a)'s system and seeds), every chain
    within ORACLE_TOL of the float64 filter, P's two triangles kept one
    matrix by the transposed blocks and the mirrored diagonal blocks."""
    import chip_smoke as cs

    f, q, h, r = cs._filter_system(d, 1, seed=d + 1)
    w_obs, hr = ff.evidence_operators(h, r)
    rng = np.random.default_rng(d)
    ys = rng.standard_normal((cs.ONE_OBS_T, 1, 8)).astype(np.float32)
    m = rng.standard_normal((8, d)).astype(np.float32)
    p = np.broadcast_to(9.0 * np.eye(d, dtype=np.float32), (8, d, d)).copy()
    ys = ys.transpose(0, 2, 1)
    got = emulate_filter(m, p, ys, f, q, hr, w_obs)
    want = _filter64(m, p, ys, f, q, h, r)
    for g, w in zip(got, want):
        assert np.isfinite(g.numpy()).all()
        assert float(np.abs(g.numpy() - w).max()) <= ORACLE_TOL


def test_schur_inverse_at_64_inverts():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((2, 64, 64))
    spd = (a @ a.transpose(0, 2, 1) / 64 + np.eye(64)).astype(np.float32)
    for d, dp in ((64, 64), (45, 48)):
        m = torch.eye(dp).repeat(2, 1, 1)
        m[:, :d, :d] = torch.as_tensor(spd[:, :d, :d])
        eye = sym_inv64(m, d).double() @ m.double()
        assert float((eye - torch.eye(dp, dtype=torch.float64)).abs().max()
                     ) < 1e-5


# -- the plan --------------------------------------------------------------------

@pytest.mark.parametrize("d", [33, 40, 48, 49, 56, 64])
def test_warp_plan_routes_33_to_64_to_the_tier_past_32(d):
    plan = ff.warp_plan(d, H100_SMEM)
    assert plan == ff.tc64_plan(d)
    assert plan["tier"] == "tensor_cores_64"
    assert ff.launch_key(d, d) == "fused_filter_warp"
    dp = 48 if d <= 48 else 64
    assert plan["padded_dim"] == plan["tensor_dim"] == dp
    # a quad's float2 fragment loads of rows g take distinct banks: the
    # stride is 8 or 24 modulo 32
    assert plan["stride"] == dp + 8 and plan["stride"] % 32 in (8, 24)
    assert plan["params"] == plan["chain_matrices"] == "shared"
    # eight chains of one warp a block at DP = 48, four of two at 64
    chains, warps = (8, 1) if dp == 48 else (4, 2)
    assert plan["chains_per_block"] == chains
    assert plan["warps_per_chain"] == warps
    assert plan["lanes_per_chain"] == 32 * warps
    assert plan["warps_per_sm"] == chains * warps
    mat = dp * (dp + 8) * 4
    # each chain's m, m_pred, h, a warp's observation chunk and partial sum
    assert plan["smem_bytes"] == 4 * mat + chains * (
        2 * mat + (3 * dp + warps * ff.WARP_Y_CHUNK + 4) * 4)
    # one block an SM: a second would not fit beside it
    assert plan["smem_bytes"] <= H100_SMEM < 2 * plan["smem_bytes"]


@pytest.mark.parametrize("d", [32, 65])
def test_the_tier_past_32_stops_at_its_edges(d):
    # past 64 the tier past 64 (tests/test_torch_filter_tc128.py)
    assert ff.warp_plan(d, H100_SMEM)["tier"] == (
        "tensor_cores" if d == 32 else "tensor_cores_128")


# -- on the card -------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the tier past 32 runs only on the "
                    "card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b,d,t,dy", [(10, 33, 3, 5), (17, 48, 2, 7),
                                      (9, 64, 1, 1), (5, 64, 1, 100),
                                      (7, 50, 2, 100)])
def test_tier_past_32_matches_plain_version_on_the_card(cuda_device, b, d, t,
                                                        dy):
    m, p, ys, f, q, h, r = _system(b, t, d, dy, 9.0, seed=13)
    w_obs, hr = ff.evidence_operators(h, r)
    host = (torch.as_tensor(m).t().contiguous(),
            fs.sym_fold(torch.as_tensor(p)).contiguous(),
            torch.as_tensor(ys).transpose(1, 2).contiguous())
    assert ff.device_warp_plan(d, cuda_device)["tier"] == "tensor_cores_64"
    before = ff.LAUNCHES["fused_filter_warp"]
    got = ff.fused_filter(*(a.to(cuda_device) for a in host), f, q, hr,
                          w_obs)
    # the plain version on the host (seconds a step at d = 64)
    want = ff.fused_filter_reference(*host, f, q, hr, w_obs)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, **KERNEL_TOL)
    assert ff.LAUNCHES["fused_filter_warp"] == before + 1

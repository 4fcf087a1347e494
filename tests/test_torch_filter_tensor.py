"""The warp K3's tensor-core tier (16 < d <= 32, ``warp_filter_tc_kernel``
of ``csrc/fused_filter_warp.cu``).  The tier's arithmetic is emulated here
in torch on the CPU and held against the plain version and the JAX
package's ``filtering_scan``: each operand's high part rounded to TF32 as
``cvt.rna`` does (to nearest on the 13 dropped mantissa bits, ties away
from zero), its low part the float32 rest cut to the 19 bits the tensor
cores read, each product summed as three TF32 products (lo hi + hi lo + hi
hi, a k tile of 8
at a time, as the kernel issues its ``mma.sync``), the inverses as Schur
blocks at 16 and 8 with Gauss-Jordan leaves of 8 and the mean-|diagonal|
scale, the
state padded to 32 with an identity block.  The same emulation with one
plain TF32 product in place of the three is printed beside it, not held to
a tolerance: it shows what the split buys.  ``warp_plan``'s routing is
pinned, and the ``gpu``-marked cases hold the kernel against the plain
version on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rxinfer_tpu.parallel.filtering import (
    FilterState as JaxFilterState,
    filtering_scan as jax_filtering_scan,
)
from rxinfer_tpu_torch.ops import fused_filter as ff
from rxinfer_tpu_torch.ops import fused_smoother as fs

# the JAX package's filter-test tolerance
TOL = dict(rtol=2e-4, atol=2e-4)
# the kernel against the plain version (chip_smoke.py's RTOL / ATOL): the
# two differ in rounding only (3xTF32 products, Gauss-Jordan leaves against
# the Schur recursion to 2 x 2)
KERNEL_TOL = dict(rtol=3e-4, atol=3e-4)
H100_SMEM = 232_448
PAD = 32


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# -- the tier's arithmetic, emulated -----------------------------------------

def tf32(x):
    """``cvt.rna.tf32.f32``: float32 to TF32 (10 mantissa bits), to nearest,
    ties away from zero, as float32 with the 13 low bits zero."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & -0x2000).view(torch.float32)


def tensor_core_operand(x):
    """What the tensor cores read of a float32 register given as TF32: its
    top 19 bits (the 13 low mantissa bits dropped)."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(x):
    """The kernel's ``split``: hi rounded to TF32, lo the float32 rest as
    the tensor cores read it."""
    hi = tf32(x)
    return hi, tensor_core_operand(x - hi)


def mma3(a, n, acc=None, three=True):
    """``acc + a n^T`` a k tile of 8 at a time, each tile's product as the
    three TF32 products lo hi, hi lo, hi hi added in turn (or one TF32
    product, ``three=False``): the kernel's ``blk_mul`` / ``mul_*``."""
    out = torch.zeros(a.shape[:-1] + n.shape[-2:-1]) if acc is None \
        else acc.clone()
    ah, al = split(a)
    nh, nl = split(n)
    for k in range(0, a.shape[-1], 8):
        s = slice(k, k + 8)
        if three:
            out = out + al[..., s] @ nh[..., s].transpose(-1, -2)
            out = out + ah[..., s] @ nl[..., s].transpose(-1, -2)
        out = out + ah[..., s] @ nh[..., s].transpose(-1, -2)
    return out


def gauss_jordan(m):
    """The unpivoted in-place Gauss-Jordan sweep of the leaves (B, n, n);
    each pivot's reciprocal exact (the kernel takes the hardware's, within
    about an ulp)."""
    m = m.clone()
    n = m.shape[-1]
    for k in range(n):
        p = 1.0 / m[:, k, k]
        col = m[:, :, k].clone()
        qj = m[:, k, :] * p[:, None]
        m = m - col[:, :, None] * qj[:, None, :]
        m[:, k, :] = qj
        m[:, :, k] = -col * p[:, None]
        m[:, k, k] = p
    return m


def schur_blocks(m, leaf, three=True, yt_product=True):
    """The inverse of the symmetric (B, 2n, 2n) m by the Schur blocks at n
    (``leaf`` inverts the n x n blocks), in the kernel's order: X, Z and S,
    then Y, Y^T and TL (its upper-right block never read).  Y^T is the
    product S^-1 X^T, or with ``yt_product=False`` the transpose of Y (the
    warp tier's top level, ``tc16.cuh`` ``transpose``)."""
    n = m.shape[-1] // 2
    a, bt, dd = m[:, :n, :n], m[:, n:, :n], m[:, n:, n:]
    ai = leaf(a)
    x = mma3(ai, bt, three=three)                  # A^-1 B
    z = mma3(bt, ai, three=three)                  # B^T A^-1
    si = leaf(mma3(-z, bt, acc=dd, three=three))   # (D - Z B)^-1
    y = mma3(x, si, three=three)                   # X S^-1
    yt = mma3(si, x, three=three) if yt_product \
        else y.transpose(-1, -2)                   # S^-1 X^T, or Y^T
    tl = mma3(y, x, acc=ai, three=three)           # A^-1 + Y X^T
    return torch.cat([torch.cat([tl, -y], -1), torch.cat([-yt, si], -1)], -2)


def schur_inverse(m, d, three=True, mirror=True):
    """The inverse of the padded (B, 32, 32) m, scaled by the mean
    |diagonal| of its d real entries, by the Schur blocks at 16 and, inside
    each 16 x 16 inverse, at 8, with Gauss-Jordan leaves of 8.  The
    lower-left block is the transpose of the upper-right (``mirror``, as
    the kernel forms it) or its own product (``mirror=False``)."""
    diag = torch.diagonal(m, dim1=-2, dim2=-1)[:, :d].abs().sum(-1) / d
    inv_s = 1.0 / torch.where(diag > 0, diag, torch.ones_like(diag))
    m = m * inv_s[:, None, None]
    inv16 = lambda b: schur_blocks(b, gauss_jordan, three)
    return schur_blocks(m, inv16, three, yt_product=not mirror) \
        * inv_s[:, None, None]


def mirror_upper(p):
    """The symmetric matrix of p's upper triangle (``tc16.cuh``
    ``mirror_upper``, and what a kernel stores of P)."""
    up = torch.triu(p)
    return up + up.transpose(-1, -2) - torch.diag_embed(
        torch.diagonal(p, dim1=-2, dim2=-1))


def emulate_filter(m0, p0, ys, f, q, hr, w, three=True, mirror=True):
    """The tier's step over (B, d) m0, (B, d, d) p0, (T, B, dy) ys:
    returns means (T, B, d), final m, final P, all float32.  With
    ``mirror`` (the kernel) each inverse's lower-left block is the
    transpose of its upper-right and P's lower triangle the mirror of its
    upper after each step's second inverse; ``mirror=False`` keeps both
    triangles as the Schur blocks leave them (the tier before ROADMAP C7's
    repair)."""
    d = f.shape[0]
    pad = lambda a: torch.nn.functional.pad(
        torch.as_tensor(a, dtype=torch.float32), (0, PAD - d, 0, PAD - d))
    fp, wp = pad(f), pad(w)
    qp = pad(q) + torch.diag((torch.arange(PAD) >= d).float())
    hrt = torch.as_tensor(hr, dtype=torch.float32)
    bsz = m0.shape[0]
    m = torch.zeros((bsz, PAD))
    m[:, :d] = torch.as_tensor(m0)
    p = torch.eye(PAD).repeat(bsz, 1, 1)
    p[:, :d, :d] = torch.as_tensor(p0)
    means = []
    for y in torch.as_tensor(ys):
        m_pred = m @ fp.T
        fb = fp.expand(bsz, PAD, PAD)
        p_pred = mma3(mma3(fb, p, three=three), fb, acc=qp.expand_as(p),
                      three=three)
        lam = schur_inverse(p_pred, d, three, mirror)
        xi = torch.zeros((bsz, PAD))
        xi[:, :d] = y @ hrt.T
        h = torch.einsum("bij,bj->bi", lam, m_pred) + xi
        p = schur_inverse(lam + wp, d, three, mirror)
        if mirror:
            p = mirror_upper(p)
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


# (d, dy, P0 scale): the tier's edges and its middle on dense systems, and a
# vague prior (1e6 I) with 40 observations of the 32 states.  Under a vague
# prior the first posterior is about W^-1, so W must be well conditioned for
# any float32 filter to hold 2e-4: dy = 40 gives a condition near 46; dy < d
# leaves W singular, and this system at d = dy = 32 has a condition near
# 5e4, where the plain version and the JAX filter differ by 1.3e-2.
CASES = [(17, 17, 9.0), (24, 12, 9.0), (32, 40, 9.0), (32, 40, 1e6)]


@pytest.mark.parametrize("d,dy,p0_scale", CASES)
def test_emulated_tier_matches_plain_version_and_jax(d, dy, p0_scale,
                                                     capsys):
    m, p, ys, f, q, h, r = _system(4, 12, d, dy, p0_scale, seed=d + dy)
    w_obs, hr = ff.evidence_operators(h, r)
    got = emulate_filter(m, p, ys, f, q, hr, w_obs)
    # the plain version, batch-minor
    pm, pf, pp = ff.fused_filter_reference(
        torch.as_tensor(m).t().contiguous(),
        fs.sym_fold(torch.as_tensor(p)).contiguous(),
        torch.as_tensor(ys).transpose(1, 2).contiguous(), f, q, hr, w_obs)
    plain = (pm.transpose(1, 2), pf.t(), fs.sym_unfold_t(pp[None], d)[0])
    ref = jax_filtering_scan(
        JaxFilterState(jnp.asarray(m), jnp.asarray(p)), jnp.asarray(ys),
        jnp.asarray(f), jnp.asarray(q), jnp.asarray(h), jnp.asarray(r))
    (jfinal, jmeans) = ref
    jax_out = (np.asarray(jmeans), np.asarray(jfinal.m),
               np.asarray(jfinal.p))
    for g, want_plain, want_jax in zip(got, plain, jax_out):
        torch.testing.assert_close(g, want_plain, **KERNEL_TOL)
        np.testing.assert_allclose(g.numpy(), want_jax, **TOL)
    one = emulate_filter(m, p, ys, f, q, hr, w_obs, three=False)
    errs = [float((a - b).abs().max()) for a, b in zip(got, plain)]
    errs1 = [float((a - b).abs().max()) for a, b in zip(one, plain)]
    with capsys.disabled():
        print(f"\n[tc emulation] d={d} dy={dy} P0={p0_scale:g} I, max abs "
              f"difference from the plain version (means, final m, final "
              f"P): 3xTF32 {errs[0]:.3g} {errs[1]:.3g} {errs[2]:.3g}; one "
              f"TF32 product {errs1[0]:.3g} {errs1[1]:.3g} {errs1[2]:.3g}")


@pytest.mark.parametrize("d", [24, 32])
def test_mirrored_tier_keeps_a_long_chain_on_the_float64_filter(d, capsys):
    """One observation of d states over 40 steps (ROADMAP C7): the Schur
    blocks leave P's two triangles apart by rounding and the two inverses a
    step amplify that, so the tier forms each inverse's lower-left block as
    the transpose of its upper-right and mirrors P's diagonal blocks after
    the second.  Mirrored, the emulation holds the float64 filter at
    ``chip_smoke.ORACLE_TOL``; as the Schur blocks leave it, its drift is
    printed, not held."""
    from chip_smoke import ORACLE_TOL, filter_float64

    m, p, ys, f, q, h, r = _system(3, 40, d, 1, 9.0, seed=d + 1)
    w_obs, hr = ff.evidence_operators(h, r)
    o_means, o_m, o_p = filter_float64(m, p, ys, f, q, h, r)
    got = emulate_filter(m, p, ys, f, q, hr, w_obs)
    for g, want in zip(got, (o_means, o_m, o_p)):
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=ORACLE_TOL)
    drift = emulate_filter(m, p, ys, f, q, hr, w_obs, mirror=False)[0]
    with capsys.disabled():
        print(f"\n[tc emulation] d={d} dy=1, 40 steps: means from the "
              f"float64 filter {np.abs(got[0].numpy() - o_means).max():.3g} "
              f"mirrored, {np.abs(drift.numpy() - o_means).max():.3g} "
              f"without")


def test_tf32_rounds_to_nearest_ties_away():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -(1.0 + 2 ** -11), 1.0 + 2 ** -12, 3.0e-39])
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 * 2 ** -10,
                         -(1.0 + 2 ** -10), 1.0])
    got = tf32(x)
    assert torch.equal(got[:5], want)
    assert ((got.view(torch.int32) & 0x1FFF) == 0).all()
    # hi + lo carries x to 21 bits or more
    x = torch.tensor([1.0 / 3.0, -2.718281828, 1234.5678, 7.0e-20])
    hi, lo = split(x)
    assert ((hi + lo - x).abs() <= 2.0 ** -21 * x.abs()).all()
    assert ((lo.view(torch.int32) & 0x1FFF) == 0).all()


def test_three_tf32_products_keep_float32_accuracy():
    """3xTF32 over a 32-term product: within a few float32 roundings of
    float64; one TF32 product is about a thousand times further."""
    rng = np.random.default_rng(3)
    a = torch.as_tensor(rng.standard_normal((1, 32, 32)).astype(np.float32))
    n = torch.as_tensor(rng.standard_normal((1, 32, 32)).astype(np.float32))
    exact = a.double() @ n.double().transpose(-1, -2)
    scale = (a.double().abs() @ n.double().abs().transpose(-1, -2)).max()
    e3 = float((mma3(a, n).double() - exact).abs().max() / scale)
    e1 = float((mma3(a, n, three=False).double() - exact).abs().max()
               / scale)
    assert e3 < 4e-7
    assert e1 > 100 * e3


def test_schur_blocks_invert():
    rng = np.random.default_rng(5)
    for d in (17, 24, 32):
        x = rng.standard_normal((3, d, d))
        spd = x @ x.transpose(0, 2, 1) + d * np.eye(d)
        m = torch.eye(PAD).repeat(3, 1, 1)
        m[:, :d, :d] = torch.as_tensor(spd.astype(np.float32))
        inv = schur_inverse(m, d).double()
        eye = inv @ m.double()
        assert float((eye - torch.eye(PAD, dtype=torch.float64)).abs().max()
                     ) < 1e-5


# -- the plan ------------------------------------------------------------------

@pytest.mark.parametrize("d", [17, 20, 24, 25, 31, 32])
def test_warp_plan_routes_17_to_32_to_the_tensor_cores(d):
    plan = ff.warp_plan(d, H100_SMEM)
    assert plan["tier"] == "tensor_cores"
    assert ff.launch_key(d, d) == "fused_filter_warp"
    assert plan["padded_dim"] == ff.TC_DIM == 32
    # the products to 24 (the last 8-column tile padding) or to 32
    assert plan["tensor_dim"] == (24 if d <= 24 else 32)
    assert plan["chain_matrices"] == "registers"
    assert plan["params"] == "shared"
    assert plan["chains_per_block"] == ff.WARP_MAX_CHAINS
    # F (float32 and its two TF32 parts), Q, W at rows of 40 floats, and
    # each chain's m, m_pred, h, observation chunk and a parked 16 x 16
    # block of P_pred (8 floats a lane)
    assert plan["smem_bytes"] == 4 * (5 * 32 * 40 + 8 * (3 * 32 + 32 + 256))
    assert plan["max_registers"] == 128
    assert plan["warps_per_sm"] == 16
    # the parameters' device tensor of the sweep tiers: (4, 32, 36)
    assert plan["stride"] == 36


@pytest.mark.parametrize("d", [33, 40, 64, 96, 97, 160, 161, 300])
def test_warp_plan_keeps_the_sweep_tiers_past_32(d):
    plan = ff.warp_plan(d, H100_SMEM)
    assert plan["tier"] == "sweep"
    assert plan == ff.sweep_warp_plan(d, H100_SMEM)


# -- the bound ---------------------------------------------------------------

def _block_product_ops(n, levels):
    """Operations of the plain ``sym_inv``'s block products at size n and
    ``levels - 1`` levels below, from its loops: X = A^-1 B (k x m entries
    of k products), the Schur complement's upper triangle (k products and a
    subtraction), X S^-1 (k x m of m products), the top-left block's upper
    triangle (m products and an addition), with k = n // 2, m = n - k."""
    if levels == 0 or n <= 2:
        return 0
    k, m = n // 2, n - n // 2
    return (k * m * (2 * k - 1) + m * (m + 1) // 2 * 2 * k
            + k * m * (2 * m - 1) + k * (k + 1) // 2 * 2 * m
            + _block_product_ops(k, levels - 1)
            + _block_product_ops(m, levels - 1))


@pytest.mark.parametrize("d", [16, 17, 24, 32, 33])
def test_filter_bound_prices_the_tiers_products_at_3xtf32(d):
    """``chip_smoke.filter_bound``: at the tensor-core tier (16 < d <= 32),
    F P F^T + Q and both inverses' block products at the top two levels
    (the operations the tier runs on the tensor cores) at 495 / 3 TFLOP/s,
    the rest at 67; at d = 16 (the wide K3 on the tensor cores) the same at
    the top level and the evidence HR y; past 32 every operation at 67."""
    import chip_smoke as cs

    b, t = 10_000, 200
    bnd = cs.filter_bound(b, t, d, d)
    nsym = d * (d + 1) // 2
    sandwich = d * d * (2 * d - 1) + nsym * 2 * d
    levels = 2 if 16 < d <= 32 else 1 if d == 16 else 0
    want_tc = sandwich + 2 * _block_product_ops(d, levels) if levels else 0
    if levels == 1:
        want_tc += d * (2 * d - 1)
    assert bnd["ops_tensor_cores"] == want_tc * t * b
    want_ms = ((bnd["ops"] - bnd["ops_tensor_cores"]) / 67e12
               + bnd["ops_tensor_cores"] / (495e12 / 3)) * 1e3
    assert bnd["bound_by"] == "operations"
    assert bnd["bound_ms"] == pytest.approx(want_ms, rel=1e-12)
    if d == 32:
        # 159,744 of the step's 174,676 operations go to the tensor cores
        assert bnd["ops_tensor_cores"] == 159_744 * t * b
        assert bnd["ops"] == 174_676 * t * b


# -- on the card -----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the tensor-core tier runs only on "
                    "the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b,d,t,dy", [(37, 17, 5, 40), (33, 24, 4, 40),
                                      (40, 32, 4, 40)])
def test_tensor_tier_matches_plain_version_on_the_card(cuda_device, b, d, t,
                                                       dy):
    m, p, ys, f, q, h, r = _system(b, t, d, dy, 9.0, seed=11)
    w_obs, hr = ff.evidence_operators(h, r)
    args = (torch.as_tensor(m, device=cuda_device).t().contiguous(),
            fs.sym_fold(torch.as_tensor(p, device=cuda_device)).contiguous(),
            torch.as_tensor(ys, device=cuda_device).transpose(1, 2)
            .contiguous())
    assert ff.device_warp_plan(d, cuda_device)["tier"] == "tensor_cores"
    before = ff.LAUNCHES["fused_filter_warp"]
    got = ff.fused_filter(*args, f, q, hr, w_obs)
    want = ff.fused_filter_reference(*args, f, q, hr, w_obs)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **KERNEL_TOL)
    assert ff.LAUNCHES["fused_filter_warp"] == before + 1

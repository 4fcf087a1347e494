"""The wide K1/K2's order of arithmetic (d 9..16, ``wide_fwd_tc_kernel`` and
``wide_bwd_ring_kernel`` of ``csrc/fused_smoother_wide.cu``), emulated in
torch on the CPU and held against the plain versions and the JAX package's
sequential smoother (``rxinfer_tpu/ops/kalman.py``).

The emulation is the kernels' step: the state padded to 16 with an
identity block (F, b, W with zeros, Q and P with the identity), every
16 x 16 product in 3xTF32 as C = A N^T a k tile of 8 at a time (each
operand's high part rounded to TF32, its low part the float32 rest cut to
the 19 bits the tensor cores read), each inverse scaled by the mean
|diagonal| of its d real rows and inverted by the Schur blocks at 8 with
Gauss-Jordan leaves of 8, the vectors in float32.  K1 carries its full
P from step to step and stores the upper triangle; K2's producer forms
P_pred = (F P_f) F^T + Q, P_f F^T, the inverse and G = (P_f F^T)
P_pred^-T from K1's stored (mirrored) P_f, and its consumer D = P_s' -
P_pred, the cross G P_s'^T, G D^T, P_f + (G D^T) G^T and the mean, as the
kernels order them.  The same emulation with one TF32 product in place of
the three is printed beside it, not held: it shows what the split buys.
The TF32 helpers are the warp K3's (``tests/test_torch_filter_tensor.py``),
whose tier the kernels share (``csrc/tc16.cuh``).  Last, the bound that
``chip_smoke.kernel_bounds`` gives the wide kernels."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rxinfer_tpu.ops import kalman as jk
from rxinfer_tpu_torch.ops import fused_smoother as fs
from test_torch_filter_tensor import gauss_jordan, mma3, schur_blocks
from test_torch_filter_tensor import mirror_upper as _mirror

# the kernels against the plain versions (chip_smoke.py's RTOL / ATOL): the
# two differ in rounding only (3xTF32 products, Schur at 8 with
# Gauss-Jordan leaves against the Schur recursion split at d / 2)
KERNEL_TOL = dict(rtol=3e-4, atol=3e-4)
# against the JAX package's smoother: its smoother-test tolerance (float32
# in two libraries, Schur recursion against solves)
TOL = dict(rtol=3e-4, atol=3e-4)
PAD = 16


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# -- the kernels' arithmetic, emulated ---------------------------------------

def gauss_jordan_pairs(m):
    """``tc16.cuh`` ``leaf8_pairs``: the in-place Gauss-Jordan sweep of the
    (B, n, n) leaves by 2 x 2 pivot blocks, each inverted by its
    determinant's reciprocal (exact here; the kernels take the hardware's,
    within about an ulp), in the kernel's order of products."""
    m = m.clone()
    n = m.shape[-1]
    for k in range(0, n, 2):
        a, b = m[:, k, k], m[:, k, k + 1]
        c, e = m[:, k + 1, k], m[:, k + 1, k + 1]
        rdet = 1.0 / (a * e - b * c)
        i00, i01, i10, i11 = e * rdet, -b * rdet, -c * rdet, a * rdet
        r0, r1 = m[:, k, :].clone(), m[:, k + 1, :].clone()
        f0, f1 = m[:, :, k].clone(), m[:, :, k + 1].clone()
        q0 = i00[:, None] * r0 + i01[:, None] * r1          # Pi^-1 R
        q1 = i10[:, None] * r0 + i11[:, None] * r1
        m = m - f0[:, :, None] * q0[:, None, :] - f1[:, :, None] * q1[:, None, :]
        m[:, :, k] = -(f0 * i00[:, None] + f1 * i10[:, None])
        m[:, :, k + 1] = -(f0 * i01[:, None] + f1 * i11[:, None])
        m[:, k, :], m[:, k + 1, :] = q0, q1
        m[:, k, k], m[:, k, k + 1] = i00, i01
        m[:, k + 1, k], m[:, k + 1, k + 1] = i10, i11
    return m


# the kernels' leaves (fused_smoother_wide.cu's sym_inv_scaled<true> in K1,
# <false> in K2): K1 by pairs of pivots, K2 a pivot at a time
FWD_LEAF, BWD_LEAF = gauss_jordan_pairs, gauss_jordan


def inverse16(m, d, three=True, leaf=gauss_jordan):
    """The inverse of the padded (B, 16, 16) m, scaled by the mean
    |diagonal| of its d real rows: the Schur blocks at 8 with Gauss-Jordan
    leaves of 8 (``tc16.cuh`` ``inv16``, ``sym_inv_scaled`` in the
    kernels), ``leaf`` sweeping them."""
    total = torch.diagonal(m, dim1=-2, dim2=-1)[:, :d].abs().sum(-1)
    # the kernels' d / sum, one rounding of the plain version's 1 / (sum / d)
    inv_s = torch.where(total > 0, d / total, torch.ones_like(total))
    m = m * inv_s[:, None, None]
    return schur_blocks(m, leaf, three) * inv_s[:, None, None]


def _pad_params(f, bvec, q, w, bsz, d):
    """F, b, W padded with zeros and Q with the identity, per chain
    (B, 16, 16) / (B, 16); q, w shared (d, d) or per chain (B, d, d)."""
    def pad(a, eye):
        a = torch.as_tensor(a, dtype=torch.float32)
        out = torch.zeros((bsz, PAD, PAD))
        out[:, :d, :d] = a
        if eye:
            out[:, range(d, PAD), range(d, PAD)] = 1.0
        return out

    bp = torch.zeros((bsz, PAD))
    bp[:, :d] = torch.as_tensor(bvec)
    return pad(f, False), bp, pad(q, True), pad(w, False)


def emulate_forward(m0, p0, xi, f, bvec, q, w, three=True, mirror=True):
    """K1 over (B, d) m0, (B, d, d) p0, (T, B, d) xi: the filtered means
    (T, B, d) and covariances (T, B, d, d) as stored (the upper triangle,
    mirrored), float32.  With ``mirror`` (the kernel) P's lower triangle is
    the mirror of its upper after each step's second inverse;
    ``mirror=False`` carries it as the inverse leaves it (K1 before ROADMAP
    C7's repair)."""
    t_len, bsz, d = xi.shape
    fp, bp, qp, wp = _pad_params(f, bvec, q, w, bsz, d)
    m = torch.zeros((bsz, PAD))
    m[:, :d] = torch.as_tensor(m0)
    p = torch.eye(PAD).repeat(bsz, 1, 1)
    p[:, :d, :d] = _mirror(torch.as_tensor(p0))
    xip = torch.zeros((t_len, bsz, PAD))
    xip[:, :, :d] = torch.as_tensor(xi)
    means, covs = [], []
    for t in range(t_len):
        if t:
            m_pred = torch.einsum("bij,bj->bi", fp, m) + bp
            p = mma3(mma3(fp, p, three=three), fp, acc=qp, three=three)
        else:
            m_pred = m
        lam = inverse16(p, d, three, FWD_LEAF)
        h = torch.einsum("bij,bj->bi", lam, m_pred) + xip[t]
        p = inverse16(lam + wp, d, three, FWD_LEAF)
        if mirror:
            p = _mirror(p)
        m = torch.einsum("bij,bj->bi", p, h)
        means.append(m[:, :d])
        covs.append(_mirror(p[:, :d, :d]))
    return torch.stack(means), torch.stack(covs)


def emulate_backward(mf, pf, f, bvec, q, three=True):
    """K2 over K1's (T, B, d) means and (T, B, d, d) stored covariances:
    smoothed means, covariances (the upper triangle, mirrored) and the cross
    (T - 1, B, d, d), float32."""
    t_len, bsz, d = mf.shape
    fp, bp, qp, _ = _pad_params(f, bvec, q, np.zeros((d, d)), bsz, d)

    def padded(t):
        m = torch.zeros((bsz, PAD))
        m[:, :d] = mf[t]
        p = torch.eye(PAD).repeat(bsz, 1, 1)
        p[:, :d, :d] = pf[t]
        return m, p

    m_s, p_s = padded(t_len - 1)
    means, covs, cross = [mf[t_len - 1]], [pf[t_len - 1]], []
    for t in range(t_len - 2, -1, -1):
        # the producer: what does not read the smoothed step after t
        m_f, p_f = padded(t)
        pp = mma3(mma3(fp, p_f, three=three), fp, acc=qp, three=three)
        pft = mma3(p_f, fp, three=three)
        gain = mma3(pft, inverse16(pp, d, three, BWD_LEAF), three=three)
        fmb = torch.einsum("bij,bj->bi", fp, m_f) + bp
        # the consumer
        cr = mma3(gain, p_s, three=three)
        gd = mma3(gain, p_s - pp, three=three)
        p_s = mma3(gd, gain, acc=p_f, three=three)
        m_s = m_f + torch.einsum("bij,bj->bi", gain, m_s - fmb)
        means.append(m_s[:, :d])
        covs.append(_mirror(p_s[:, :d, :d]))
        cross.append(cr[:, :d, :d])
    return (torch.stack(means[::-1]), torch.stack(covs[::-1]),
            torch.stack(cross[::-1]))


# -- the cases ---------------------------------------------------------------

def _system(b, t, d, p0_scale, per_chain, seed):
    """``chip_smoke._smoother_params``' system (F a scaled orthogonal
    matrix, b = 0.1 k, Q = 0.4 I, W = 0.8 I + A A^T), or W and Q per chain
    around 0.8 I and 0.4 I; xi and m0 from a seed."""
    rng = np.random.default_rng(seed)
    qm, _ = np.linalg.qr(rng.standard_normal((d, d)))
    f = (0.98 * qm).astype(np.float32)
    bvec = (0.1 * np.arange(d)).astype(np.float32)
    q = (0.4 * np.eye(d)).astype(np.float32)
    a = rng.standard_normal((d, d)) * 0.2
    w = (0.8 * np.eye(d) + a @ a.T).astype(np.float32)
    if per_chain:
        def spd(scale):
            x = 0.3 * rng.standard_normal((b, d, d))
            return (scale * np.eye(d) + x @ np.swapaxes(x, -1, -2)).astype(
                np.float32)
        w, q = spd(0.8), spd(0.4)
    xi = rng.standard_normal((t, b, d)).astype(np.float32)
    m0 = rng.standard_normal((b, d)).astype(np.float32)
    p0 = np.broadcast_to(p0_scale * np.eye(d, dtype=np.float32),
                         (b, d, d)).copy()
    return m0, p0, xi, f, bvec, q, w


def _plain(m0, p0, xi, f, bvec, q, w, per_chain):
    """The plain versions, K2 on the plain K1's outputs; returned in the
    emulation's layouts."""
    t = torch.as_tensor
    kw = dict(w_batch=t(w), q_batch=t(q)) if per_chain else {}
    q_sh, w_sh = (None, None) if per_chain else (q, w)
    d = xi.shape[-1]
    mf, pf = fs.fused_forward_reference(t(m0), t(p0), t(xi), f, bvec, q_sh,
                                        w_sh, **kw)
    ms, ps, cr = fs.fused_backward_reference(
        mf, pf, f, bvec, q_sh, kw.get("q_batch"))
    unfold = lambda x: fs.sym_unfold_t(x, d)
    return (mf.transpose(1, 2), unfold(pf), ms.transpose(1, 2), unfold(ps),
            cr.reshape(cr.shape[0], d, d, -1).permute(0, 3, 1, 2))


def _jax(m0, p0, xi, f, bvec, q, w, per_chain):
    """The JAX package's sequential smoother, vmapped over the chains (W
    and Q per chain with ``per_chain``): means, covariances, cross."""
    t_len, b, d = xi.shape
    qs = jnp.broadcast_to(jnp.asarray(q)[:, None] if per_chain
                          else jnp.asarray(q), ((b,) if per_chain else ())
                          + (t_len - 1, d, d))
    ws = jnp.asarray(w)[:, None] if per_chain else jnp.asarray(w)[None, None]
    fields = jk.ChainParams(
        jnp.asarray(m0), jnp.asarray(p0),
        jnp.broadcast_to(jnp.asarray(f), (t_len - 1, d, d)),
        jnp.broadcast_to(jnp.asarray(bvec), (t_len - 1, d)), qs,
        jnp.asarray(np.moveaxis(xi, 1, 0)),
        jnp.broadcast_to(ws, (b, t_len, d, d)))
    axes = jk.ChainParams(0, 0, None, None, 0 if per_chain else None, 0, 0)
    res = jax.vmap(jk.sequential_smoother, in_axes=(axes,))(fields)
    return [np.moveaxis(np.asarray(x), 0, 1)
            for x in (res.means, res.covs, res.cross)]


# (d, W and Q per chain, P0 scale): the tier's edges and its middle, and a
# vague prior (1e6 I) at d = 16 with W and Q per chain, where one plain
# TF32 product loses digits.
CASES = [(9, False, 9.0), (12, True, 9.0), (16, False, 9.0), (16, True, 1e6)]


@pytest.mark.parametrize("d,per_chain,p0_scale", CASES)
def test_emulated_kernels_match_plain_versions_and_jax(d, per_chain,
                                                       p0_scale, capsys):
    m0, p0, xi, f, bvec, q, w = _system(3, 4, d, p0_scale, per_chain,
                                        seed=d)

    def emulate(three):
        mf, pf = emulate_forward(m0, p0, torch.as_tensor(xi), f, bvec, q, w,
                                 three)
        return (mf, pf) + emulate_backward(mf, pf, f, bvec, q, three)

    got = emulate(True)
    plain = _plain(m0, p0, xi, f, bvec, q, w, per_chain)
    for g, want in zip(got, plain):
        torch.testing.assert_close(g, want, **KERNEL_TOL)
    for g, want in zip(got[2:], _jax(m0, p0, xi, f, bvec, q, w, per_chain)):
        np.testing.assert_allclose(g.numpy(), want, **TOL)
    one = emulate(False)
    names = ("mf", "pf", "ms", "ps", "cross")
    err = lambda out: ", ".join(
        f"{n} {float((a - b).abs().max()):.3g}"
        for n, a, b in zip(names, out, plain))
    with capsys.disabled():
        print(f"\n[wide tc emulation] d={d} {'W, Q per chain' if per_chain else 'static'}"
              f" P0={p0_scale:g} I, max abs difference from the plain "
              f"versions: 3xTF32 {err(got)}; one TF32 product {err(one)}")


def test_mirrored_forward_keeps_a_long_chain_on_the_float64_rts(capsys):
    """One observation of 16 states (a rank-one W) over 40 steps, ROADMAP
    C7: the Schur blocks leave P's two triangles apart by rounding and the
    two inverses a step amplify that, so K1 mirrors P's upper triangle after
    each step's second inverse.  Mirrored, the emulated K1 holds the float64
    filter, and the emulated K2 on its outputs the float64 RTS, at
    ``chip_smoke.ORACLE_TOL``; K1 as the inverse leaves P is printed, not
    held."""
    from chip_smoke import ORACLE_TOL, one_observation_system, rts_float64

    m0, p0, xi, f, bvec, q, w = one_observation_system(16, 3, 40)
    o_mf, o_pf, o_ms, o_ps = rts_float64(m0, p0, xi, f, bvec, q, w,
                                         filtered=True)
    mf, pf = emulate_forward(m0, p0, torch.as_tensor(xi), f, bvec, q, w)
    ms, ps, _ = emulate_backward(mf, pf, f, bvec, q)
    for g, want in zip((mf, pf, ms, ps), (o_mf, o_pf, o_ms, o_ps)):
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=ORACLE_TOL)
    drift = emulate_forward(m0, p0, torch.as_tensor(xi), f, bvec, q, w,
                            mirror=False)[0]
    with capsys.disabled():
        print(f"\n[wide tc emulation] d=16, rank-one W, 40 steps: K1's "
              f"means from the float64 filter "
              f"{np.abs(mf.numpy() - o_mf).max():.3g} mirrored, "
              f"{np.abs(drift.numpy() - o_mf).max():.3g} without; K2's "
              f"from the float64 RTS {np.abs(ms.numpy() - o_ms).max():.3g}")


@pytest.mark.parametrize("leaf", [gauss_jordan, gauss_jordan_pairs])
def test_inverse16_inverts_the_padded_block(leaf):
    rng = np.random.default_rng(7)
    for d in (9, 12, 16):
        x = rng.standard_normal((3, d, d))
        spd = x @ x.transpose(0, 2, 1) + d * np.eye(d)
        m = torch.eye(PAD).repeat(3, 1, 1)
        m[:, :d, :d] = torch.as_tensor(spd.astype(np.float32))
        eye = inverse16(m, d, leaf=leaf).double() @ m.double()
        assert float((eye - torch.eye(PAD, dtype=torch.float64)).abs().max()
                     ) < 1e-5
        # the padding stays an identity block apart from the real one
        if d < PAD:
            inv = inverse16(m, d, leaf=leaf)
            assert float(inv[:, :d, d:].abs().max()) == 0.0
            assert float(inv[:, d:, :d].abs().max()) == 0.0


# -- the bound ---------------------------------------------------------------

def _tc_ops(d):
    """Operations of a chain-step that the wide kernels run on the tensor
    cores, counted from the plain step's loops: K1 F P F^T + Q and its two
    inverses' top-level block products; K2 F P_f F^T + Q, P_f F^T, its
    inverse's top-level block products, the gain, G (P_s' - P_pred), the
    new covariance's upper triangle and the cross."""
    import chip_smoke as cs

    nsym = d * (d + 1) // 2
    sandwich = d * d * (2 * d - 1) + nsym * 2 * d
    product = d * d * (2 * d - 1)
    top = cs._schur_product_ops(d, 1)
    fwd = sandwich + 2 * top
    bwd = sandwich + product + top + product + product + nsym * 2 * d \
        + product
    return fwd, bwd


@pytest.mark.parametrize("d", [4, 9, 12, 16])
def test_kernel_bounds_price_the_wide_products_at_3xtf32(d):
    """``chip_smoke.kernel_bounds``: at the wide tier (8 < d <= 16) the
    operations the wide kernels run on the tensor cores at 495 / 3 TFLOP/s,
    the rest at 67; below it every operation at 67."""
    import chip_smoke as cs

    b, t = 1024, 2048
    bnd = cs.kernel_bounds(b, t, d)
    fwd_tc, bwd_tc = _tc_ops(d) if d > fs.REG_MAX_DIM else (0, 0)
    for name, tc, steps in (("fused_smoother_fwd", fwd_tc, t),
                            ("fused_smoother_bwd", bwd_tc, t - 1)):
        row = bnd[name]
        assert row["ops_tensor_cores"] == tc * steps * b
        t_ops = ((row["ops"] - row["ops_tensor_cores"]) / 67e12
                 + row["ops_tensor_cores"] / (495e12 / 3)) * 1e3
        t_fp32 = row["ops"] / 67e12 * 1e3
        t_bytes = row["bytes"] / 3.35e12 * 1e3
        assert row["bound_ms"] == pytest.approx(max(t_ops, t_bytes),
                                                rel=1e-12)
        assert row["bound_ms_fp32"] == pytest.approx(max(t_fp32, t_bytes),
                                                     rel=1e-12)
    if d == 16:
        # the float32-only bounds of the d16 row, as before
        assert bnd["fused_smoother_fwd"]["bound_ms_fp32"] == pytest.approx(
            0.7115, abs=5e-5)
        assert bnd["fused_smoother_bwd"]["bound_ms_fp32"] == pytest.approx(
            1.6917, abs=5e-5)

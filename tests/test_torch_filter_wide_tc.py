"""The wide K3's order of arithmetic (d 9..16, or dy > 8 at any d <= 8:
``wide_filter_tc_kernel`` of ``csrc/fused_filter_wide.cu``), emulated in
torch on the CPU and held against the plain version and the JAX package's
``filtering_scan``.

The emulation is the kernel's step: the wide K1's
(``tests/test_torch_smoother_wide_tc.py``, the two kernels share it through
``csrc/wide_step.cuh``) with the transition applied at every step, no bias,
and the evidence formed from the observations.  The state is padded to 16
with an identity block (F and W with zeros, Q and P with the identity);
F P F^T + Q is formed in 3xTF32 as C = A N^T a k tile of 8 at a time; both
inverses are scaled by the mean |diagonal| of the d real rows and inverted
by the Schur blocks at 8 with Gauss-Jordan leaves of 8 swept a pivot at
a time; P's lower triangle is the mirror of its upper after the second;
the evidence XI = HR Y of a block's chains is formed in 3xTF32 a k tile of
eight observations at a time; the vectors are float32.  The kernel stores the upper triangle of
its final P.  The same emulation with one TF32 product in place
of the three is printed beside it, not held: it shows what the split buys.
Last, the bound that ``chip_smoke.filter_bound`` gives the wide K3."""

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
from test_torch_filter_tensor import _system, gauss_jordan, mma3
from test_torch_smoother_wide_tc import PAD, _mirror, inverse16

# the kernel against the plain version (chip_smoke.py's RTOL / ATOL): the
# two differ in rounding only (3xTF32 products, Schur at 8 with
# Gauss-Jordan leaves against the Schur recursion split at d / 2)
KERNEL_TOL = dict(rtol=3e-4, atol=3e-4)
# against the JAX package: its filter-test tolerance
TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# -- the kernel's arithmetic, emulated ---------------------------------------

def evidence(hr, y, three=True):
    """xi (B, 16) of the (d, dy) HR and (B, dy) observations as the kernel
    forms it: XI = HR Y on the tensor cores, a k tile of eight observations
    at a time in 3xTF32 (``three``) or one TF32 product; zero past d."""
    d = hr.shape[0]
    out = mma3(hr.expand(y.shape[0], d, -1), y[:, None, :], three=three)
    xi = torch.zeros((y.shape[0], PAD))
    xi[:, :d] = out[:, :, 0]
    return xi


def emulate_filter(m0, p0, ys, f, q, hr, w, three=True, mirror=True):
    """The kernel over (B, d) m0, (B, d, d) p0, (T, B, dy) ys: means
    (T, B, d), the final m and P (its upper triangle, mirrored), float32.
    P's lower triangle is the mirror of its upper after each step's second
    inverse (``mirror=False``: as the inverse leaves it)."""
    d = f.shape[0]
    bsz = m0.shape[0]

    def pad(a, eye):
        out = torch.zeros((bsz, PAD, PAD))
        out[:, :d, :d] = torch.as_tensor(a, dtype=torch.float32)
        if eye:
            out[:, range(d, PAD), range(d, PAD)] = 1.0
        return out

    fp, qp, wp = pad(f, False), pad(q, True), pad(w, False)
    hrt = torch.as_tensor(hr, dtype=torch.float32)
    m = torch.zeros((bsz, PAD))
    m[:, :d] = torch.as_tensor(m0)
    p = torch.eye(PAD).repeat(bsz, 1, 1)
    p[:, :d, :d] = torch.as_tensor(p0)
    means = []
    for y in torch.as_tensor(ys):
        m_pred = torch.einsum("bij,bj->bi", fp, m)
        p = mma3(mma3(fp, p, three=three), fp, acc=qp, three=three)
        lam = inverse16(p, d, three, gauss_jordan)
        h = torch.einsum("bij,bj->bi", lam, m_pred) + evidence(hrt, y,
                                                                three)
        p = inverse16(lam + wp, d, three, gauss_jordan)
        if mirror:
            p = _mirror(p)
        m = torch.einsum("bij,bj->bi", p, h)
        means.append(m[:, :d])
    return torch.stack(means), m[:, :d], _mirror(p[:, :d, :d])


# (d, dy, P0 scale): d = 9, 12, 16 at one observation, as many as the
# register kernel takes plus one, as many as states and past 32 (the staged
# rows and the rest from device memory); d = 4 with twelve observations (the
# padded work of the register kernel's d); a vague prior (1e6 I) at dy = 40,
# where W is well conditioned (see ``test_torch_filter_tensor.CASES``).
# Eleven chains: a block of eight and a ragged three.
CASES = [(d, dy, 9.0) for d in (9, 12, 16) for dy in (1, 9, 16, 40)] + [
    (4, 12, 9.0), (16, 40, 1e6)]


@pytest.mark.parametrize("d,dy,p0_scale", CASES)
def test_emulated_kernel_matches_plain_version_and_jax(d, dy, p0_scale,
                                                       capsys):
    assert ff.launch_key(d, dy) == "fused_filter_wide"
    m, p, ys, f, q, h, r = _system(11, 6, d, dy, p0_scale, seed=d + dy)
    w_obs, hr = ff.evidence_operators(h, r)
    got = emulate_filter(m, p, ys, f, q, hr, w_obs)
    pm, pf, pp = ff.fused_filter_reference(
        torch.as_tensor(m).t().contiguous(),
        fs.sym_fold(torch.as_tensor(p)).contiguous(),
        torch.as_tensor(ys).transpose(1, 2).contiguous(), f, q, hr, w_obs)
    plain = (pm.transpose(1, 2), pf.t(), fs.sym_unfold_t(pp[None], d)[0])
    jfinal, jmeans = jax_filtering_scan(
        JaxFilterState(jnp.asarray(m), jnp.asarray(p)), jnp.asarray(ys),
        jnp.asarray(f), jnp.asarray(q), jnp.asarray(h), jnp.asarray(r))
    jax_out = (np.asarray(jmeans), np.asarray(jfinal.m), np.asarray(jfinal.p))
    for g, want_plain, want_jax in zip(got, plain, jax_out):
        torch.testing.assert_close(g, want_plain, **KERNEL_TOL)
        np.testing.assert_allclose(g.numpy(), want_jax, **TOL)
    one = emulate_filter(m, p, ys, f, q, hr, w_obs, three=False)
    errs = [float((a - b).abs().max()) for a, b in zip(got, plain)]
    errs1 = [float((a - b).abs().max()) for a, b in zip(one, plain)]
    with capsys.disabled():
        print(f"\n[wide K3 emulation] d={d} dy={dy} P0={p0_scale:g} I, max "
              f"abs difference from the plain version (means, final m, "
              f"final P): 3xTF32 {errs[0]:.3g} {errs[1]:.3g} {errs[2]:.3g};"
              f" one TF32 product {errs1[0]:.3g} {errs1[1]:.3g} "
              f"{errs1[2]:.3g}")


def test_mirrored_covariance_keeps_a_long_chain_on_the_float64_filter(
        capsys):
    """One observation of 16 states over 40 steps: the Schur inverse leaves
    P's two triangles apart by rounding and the two inverses a step amplify
    that, so the kernel mirrors P's upper triangle each step.  Mirrored, the
    emulation holds the float64 filter at ``chip_smoke.ORACLE_TOL``; as the
    inverse leaves it, its drift is printed, not held."""
    from chip_smoke import ORACLE_TOL, filter_float64

    m, p, ys, f, q, h, r = _system(3, 40, 16, 1, 9.0, seed=17)
    w_obs, hr = ff.evidence_operators(h, r)
    o_means, o_m, o_p = filter_float64(m, p, ys, f, q, h, r)
    got = emulate_filter(m, p, ys, f, q, hr, w_obs)
    for g, want in zip(got, (o_means, o_m, o_p)):
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=ORACLE_TOL)
    drift = emulate_filter(m, p, ys, f, q, hr, w_obs, mirror=False)[0]
    with capsys.disabled():
        print(f"\n[wide K3 emulation] d=16 dy=1, 40 steps: means from the "
              f"float64 filter {np.abs(got[0].numpy() - o_means).max():.3g} "
              f"with P mirrored, "
              f"{np.abs(drift.numpy() - o_means).max():.3g} without")


# -- the bound ---------------------------------------------------------------

def test_filter_bound_prices_the_wide_tier_at_3xtf32():
    """``chip_smoke.filter_bound`` at the wide K3 (launch key
    ``fused_filter_wide``): F P F^T + Q, both inverses' top-level Schur
    block products and the evidence HR y (the kernel's tensor-core tiles) at
    495 / 3 TFLOP/s, the rest at 67; ``bound_ms_fp32`` every operation at
    67.  The register kernel's and the warp K3's bounds are as before."""
    import chip_smoke as cs

    b, t = 10_000, 200
    wide = cs.filter_bound(b, t, 16, 16)
    # of the step's 23,212 operations, 18,432 are F P F^T + Q and the block
    # products (0.3661 ms with the rest at 67) and 496 the evidence
    assert wide["ops_tensor_cores"] == (18_432 + 16 * 31) * t * b
    assert wide["ops"] == 23_212 * t * b
    assert wide["bound_by"] == "operations"
    assert wide["bound_ms"] == pytest.approx(0.3573, abs=5e-5)
    assert wide["bound_ms_fp32"] == pytest.approx(0.6929, abs=5e-5)
    # d <= 8 with dy > 8 runs the wide kernel: its products are priced too
    padded = cs.filter_bound(b, t, 4, 12)
    assert padded["ops_tensor_cores"] > 0
    assert padded["bound_ms"] <= padded["bound_ms_fp32"]
    # the register kernel (d, dy <= 8): bytes, no tensor cores
    reg = cs.filter_bound(b, t, 4, 4)
    assert reg["ops_tensor_cores"] == 0
    assert reg["bound_by"] == "bytes"
    assert reg["bound_ms"] == reg["bound_ms_fp32"] == pytest.approx(
        0.019439, abs=5e-6)
    # the warp K3's tensor-core tier (d = 32): two levels, as before
    warp = cs.filter_bound(b, t, 32, 32)
    assert warp["ops_tensor_cores"] == 159_744 * t * b
    assert warp["bound_ms"] == pytest.approx(2.3820, abs=5e-5)
    assert warp["bound_ms_fp32"] == pytest.approx(5.2142, abs=5e-5)

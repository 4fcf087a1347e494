#!/usr/bin/env python3
"""How far the tensor-core kernels' covariance recursions drift from a
float64 filter on chains with one observation a step.

    python3 scripts/symmetry_drift.py [--card] [--steps T]

Run from the root of a checkout.  The kernels that invert by the Schur
blocks of ``csrc/tc16.cuh`` leave a matrix's two triangles apart by
rounding; where the filter's two inverses a step amplify that (few
observations of many states), the means drift without bound unless the
recursion keeps its covariance symmetric.  The wide K3 mirrors P's upper
triangle each step (``tc16.cuh`` ``mirror_upper``), and so, since
ROADMAP C7's repair, do the wide K1 and the warp K3's tensor-core tier.
Cases: the wide K3 at d = 16 and 12, the warp K3's tensor-core tier at
d = 24 and 32 (each with one observation, ``chip_smoke._filter_system``,
P0 = 9 I), and the wide K1 and K2 (the smoother's two passes) at d = 16
with a rank-one W (``chip_smoke.one_observation_system``).  Each line: the
max abs difference of the means from the float64 filter (K2: RTS) over T
steps (default 40).

Without ``--card`` the sources are built with ``g++`` against the stub
runtime of ``scripts/rehearse_kernels_cpu.py`` (``mma.sync`` emulated; 3
chains, a minute or two).  With ``--card`` the package's kernels run on the
CUDA device through their wrappers (37 chains).  Prints; holds nothing.
"""

import argparse
import ctypes
import os
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, os.getcwd())
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main(argv) -> int:
    import torch

    from chip_smoke import (_filter_system, filter_float64,
                            one_observation_system, rts_float64)
    from rxinfer_tpu_torch.ops import fused_filter as ff
    from rxinfer_tpu_torch.ops import fused_smoother as fs

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--card", action="store_true")
    parser.add_argument("--steps", type=int, default=40)
    args = parser.parse_args(argv)
    t_len = args.steps
    if args.card:
        if not torch.cuda.is_available():
            print("no CUDA device available", file=sys.stderr)
            return 2
        dev, b = torch.device("cuda"), 37
    else:
        import rehearse_kernels_cpu as reh

        torch.set_num_threads(1)
        dev, b = torch.device("cpu"), 3
        out = Path(tempfile.mkdtemp(prefix="drift_"))
        libs = reh.build(out, ["fused_filter_wide", "fused_filter_warp",
                               "fused_smoother_wide"])
        ctypes.c_int.in_dll(libs["fused_filter_warp"],
                            "rxt_smem_optin").value = 232_448
    print(f"{'card' if args.card else 'g++ stub'}: {t_len} steps, {b} chains",
          flush=True)
    for d, dy in [(16, 1), (12, 1), (24, 1), (32, 1)]:
        f, q, h, r = _filter_system(d, dy, seed=d + dy)
        w_obs, hr = ff.evidence_operators(h, r)
        rng = np.random.default_rng(d)
        ys = rng.standard_normal((t_len, b, dy)).astype(np.float32)
        m = rng.standard_normal((b, d)).astype(np.float32)
        p = np.broadcast_to(9 * np.eye(d, dtype=np.float32), (b, d, d)).copy()
        key = ff.launch_key(d, dy)
        as_t = lambda a: torch.as_tensor(a, device=dev)
        m0 = as_t(m).t().contiguous()
        p0 = fs.sym_fold(as_t(p)).contiguous()
        ys_soa = as_t(ys).transpose(1, 2).contiguous()
        if args.card:
            got = ff.fused_filter(m0, p0, ys_soa, f, q, hr, w_obs)[0]
        else:
            got = _stub_filter(libs, key, m0, p0, ys_soa, f, q, hr, w_obs)
        o_means, _, _ = filter_float64(m, p, ys, f, q, h, r)
        err = np.abs(got.cpu().numpy().transpose(0, 2, 1) - o_means)
        print(f"{key} d={d} dy={dy}: means vs float64 {err.max():.3g} "
              f"(first 5 steps {err[:5].max():.3g})", flush=True)
    for d in (16,):
        m0, p0, xi, f, bvec, q, w = one_observation_system(d, b, t_len)
        o_mf, _, o_ms, _ = rts_float64(m0, p0, xi, f, bvec, q, w,
                                       filtered=True)
        as_t = lambda a: torch.as_tensor(a, device=dev)
        if args.card:
            mf, pf = fs.fused_forward(as_t(m0), as_t(p0), as_t(xi), f, bvec,
                                      q, w)
            ms = fs.fused_backward(mf, pf, f, bvec, q)[0]
        else:
            mf, pf = _stub_k1(libs["fused_smoother_wide"], m0, p0, xi, f,
                              bvec, q, w)
            ms = _stub_k2(libs["fused_smoother_wide"], mf, pf, f, bvec, q)
        for name, got, want in (("fwd", mf, o_mf), ("bwd", ms, o_ms)):
            err = np.abs(got.cpu().numpy().transpose(0, 2, 1) - want)
            print(f"fused_smoother_{name}_wide d={d}, rank-one W: means vs "
                  f"float64 {'filter' if name == 'fwd' else 'RTS'} "
                  f"{err.max():.3g} (first 5 steps {err[:5].max():.3g})",
                  flush=True)
    return 0


def _stub_filter(libs, key, m0, p0, ys, f, q, hr, w_obs):
    """The wide or warp K3 built on the stub, through its launcher."""
    import torch

    from rxinfer_tpu_torch.ops import fused_filter as ff
    from rxinfer_tpu_torch.ops.fused_smoother import _host_ptr

    t_len, dy, b = ys.shape
    d = m0.shape[0]
    lib = libs[key]
    fh, qh, hrh, wh = ff._host_params(f, q, hr, w_obs, d, dy)
    hr_t = torch.from_numpy(np.ascontiguousarray(hrh.T))
    means = torch.empty((t_len, d, b))
    mf, pf = torch.empty((d, b)), torch.empty((d * (d + 1) // 2, b))
    vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    ptrs = [x.data_ptr() for x in (ys, m0, p0, hr_t)]
    outs = [x.data_ptr() for x in (means, mf, pf)]
    if key == "fused_filter_wide":
        lib.rxt_wide_filter.argtypes = [ci, ci] + [vp] * 7 + [i64, i64] \
            + [vp] * 4
        rc = lib.rxt_wide_filter(d, dy, *ptrs, *outs, t_len, b,
                                 _host_ptr(fh), _host_ptr(qh), _host_ptr(wh),
                                 None)
    else:
        plan = ff.warp_plan(d, 232_448)
        stride = plan["stride"]
        prm = np.zeros((4, plan["padded_dim"], stride), np.float32)
        for k, a in enumerate((fh, fh.T, qh, wh)):
            prm[k, :d, :d] = a
        prm = torch.from_numpy(prm)
        lib.rxt_warp_filter_tc.argtypes = [ci, ci] + [vp] * 8 + [i64, i64,
                                                                  ci, ci, vp]
        rc = lib.rxt_warp_filter_tc(d, dy, *ptrs, prm.data_ptr(), *outs,
                                    t_len, b, stride,
                                    plan["chains_per_block"], None)
    if rc:
        raise RuntimeError(f"{key}: launcher returned {rc}")
    return means


def _stub_k1(lib, m0, p0, xi, f, bvec, q, w):
    """The wide K1 built on the stub, through its launcher: means (T, d, B)."""
    import torch

    from rxinfer_tpu_torch.ops import fused_smoother as fs

    t_len, b, d = xi.shape
    vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.rxt_wide_smoother_fwd.argtypes = [ci] + [vp] * 5 + [i64, i64] \
        + [vp] * 6 + [ci, vp]
    fh, bh, qh, wh = fs._host_params(f, bvec, q, w, d)
    mf = torch.empty((t_len, d, b))
    pf = torch.empty((t_len, d * (d + 1) // 2, b))
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a))
    xi_t, m0_t, p0_t = t(xi), t(m0), t(p0)
    rc = lib.rxt_wide_smoother_fwd(
        d, xi_t.data_ptr(), m0_t.data_ptr(), p0_t.data_ptr(), mf.data_ptr(),
        pf.data_ptr(), t_len, b, fs._host_ptr(fh), fs._host_ptr(bh),
        fs._host_ptr(qh), fs._host_ptr(wh), None, None, 0, None)
    if rc:
        raise RuntimeError(f"wide K1: launcher returned {rc}")
    return mf, pf


def _stub_k2(lib, mf, pf, f, bvec, q):
    """The wide K2 built on the stub, on K1's outputs: means (T, d, B)."""
    import torch

    from rxinfer_tpu_torch.ops import fused_smoother as fs

    t_len, d, b = mf.shape
    vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.rxt_wide_smoother_bwd.argtypes = [ci] + [vp] * 5 + [i64, i64] \
        + [vp] * 4 + [ci, vp]
    fh, bh, qh, _ = fs._host_params(f, bvec, q, None, d)
    ms, ps = torch.empty_like(mf), torch.empty_like(pf)
    cross = torch.empty((t_len - 1, d * d, b))
    rc = lib.rxt_wide_smoother_bwd(
        d, mf.data_ptr(), pf.data_ptr(), ms.data_ptr(), ps.data_ptr(),
        cross.data_ptr(), t_len, b, fs._host_ptr(fh), fs._host_ptr(bh),
        fs._host_ptr(qh), None, 0, None)
    if rc:
        raise RuntimeError(f"wide K2: launcher returned {rc}")
    return ms


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

#!/usr/bin/env python3
"""Bounds of the warp K3 and the wide K5 at the shapes of the kernel table:

    python3 scripts/tier_bounds.py

- the warp K3 at d = 64 (the tensor-core tier past 32,
  ``warp_filter_tc64_kernel``; before it the sweep tier,
  ``warp_filter_kernel``) at (B, T, d, dy) = (2000, 200, 64, 64), phase
  26 (a)'s cell, and (2000, 50, 64, 64), where the sweep tier was timed;
  at d = 128 (the tier past 64, ``warp_filter_tc128_kernel``, the sweep
  tier beside it) at (1000, 200, 128, 128), phase 27 (a)'s cell; and the
  sweep tier at phase 17 (a)'s check shape past 128, (2, 2, 176, 3):
  ``chip_smoke.filter_bound`` (observations and state read once, means and
  the final state written once, against the plain step's operations),
  ``bound_ms`` with the tier's tensor-core operations (F P F^T + Q and the
  inverses' block products at the top three Schur levels, four at d =
  128) at the 3xTF32 rate, ``bound_ms_fp32`` with every operation at the
  float32 rate (the sweep tier's bound: it runs no tensor cores);
- the wide K5's marginal kernel above 16 states at phase 16 (a)'s check
  shapes with K > 16, at (1024, 1000, 32), phase 26 (b)'s cell, and at
  (512, 1000, 64), phase 27 (b)'s: ``chip_smoke.fb_wide_bounds``'
  ``fused_fb_marg_wide`` entry (the table, evidence, alphas and betas
  read, gammas, the per-step xi and xi_sum written, against the scores',
  softmax's and xi's operations), and at the two cells the serial
  launch's, ``fused_fb_serial_wide``.

The rates are the H100 SXM's (3.35e12 B/s, 67e12 float32 op/s, 495e12 / 3
3xTF32 op/s: ``chip_smoke.HBM_BYTES_PER_S`` / ``FP32_FLOPS`` /
``TF32X3_FLOPS``); the counts run on the CPU (about 10 s at d = 64, 15 s
at 128)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def main() -> None:
    for b, t, d, dy in ((2000, 200, 64, 64), (2000, 50, 64, 64),
                        (cs.FILTER128_B, cs.FILTER128_T, 128, 128),
                        (2, 2, 176, 3)):
        bnd = cs.filter_bound(b, t, d, dy)
        print(f"warp K3 at (B, T, d, dy) = ({b}, {t}, {d}, {dy}): bound "
              f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}; the tier's "
              f"{bnd['ops_tensor_cores']} tensor-core operations at "
              f"3xTF32), {bnd['bound_ms_fp32']:.4f} ms at float32 only; "
              f"{bnd['bytes']} bytes, {bnd['ops']} operations")
    for bsz, t_len, k in cs.FB_WIDE_CHECK_SHAPES:
        if k <= 16:
            continue
        m = cs.fb_wide_bounds(bsz, t_len, k)["fused_fb_marg_wide"]
        print(f"wide K5 marginals (B, T, K) = ({bsz}, {t_len}, {k}): "
              f"bound {m['bound_ms']:.6f} ms ({m['bound_by']}), "
              f"{m['bytes']} bytes, {m['ops']} operations")
    for b, t, k in ((cs.HMM32_B, cs.HMM32_T, cs.HMM32_K),
                    (cs.HMM64_B, cs.HMM64_T, cs.HMM64_K)):
        for name, m in cs.fb_wide_bounds(b, t, k).items():
            print(f"{name} ({b}, {t}, {k}): bound {m['bound_ms']:.4f} ms "
                  f"({m['bound_by']}), {m['bytes']} bytes, {m['ops']} "
                  "operations")


if __name__ == "__main__":
    main()

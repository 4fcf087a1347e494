#!/usr/bin/env python3
"""Bounds of two kernel tiers that no ``chip_smoke.py`` path times:

    python3 scripts/tier_bounds.py

- the warp K3's sweep tier past d = 32 (``warp_filter_kernel``) at
  (B, T, d, dy) = (2000, 50, 64, 64), where its time was measured:
  ``chip_smoke.filter_bound`` (observations and state read once, means and
  the final state written once, against the plain step's operations at the
  float32 rate; no tensor cores in this tier);
- the wide K5's marginal kernel above 16 states (``fb_wide_marg_kernel``,
  a warp a tile and chain) at phase 16 (a)'s check shapes with K > 16:
  ``chip_smoke.fb_wide_bounds``' ``fused_fb_marg_wide`` entry (the table,
  evidence, alphas and betas read, gammas, the per-step xi and xi_sum
  written, against the scores', softmax's and xi's operations).

The rates are the H100 SXM's (3.35e12 B/s, 67e12 float32 op/s,
``chip_smoke.HBM_BYTES_PER_S`` / ``FP32_FLOPS``); the counts run on the
CPU."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def main() -> None:
    b = cs.filter_bound(2000, 50, 64, 64)
    print(f"warp K3 sweep tier (2000, 50, 64, 64): bound "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']}), {b['bytes']} bytes, "
          f"{b['ops']} operations")
    for bsz, t_len, k in cs.FB_WIDE_CHECK_SHAPES:
        if k <= 16:
            continue
        m = cs.fb_wide_bounds(bsz, t_len, k)["fused_fb_marg_wide"]
        print(f"fb_wide_marg_kernel (B, T, K) = ({bsz}, {t_len}, {k}): "
              f"bound {m['bound_ms']:.6f} ms ({m['bound_by']}), "
              f"{m['bytes']} bytes, {m['ops']} operations")
    m = cs.fb_wide_bounds(1024, 1000, 32)["fused_fb_marg_wide"]
    print(f"fb_wide_marg_kernel (1024, 1000, 32): bound "
          f"{m['bound_ms']:.4f} ms ({m['bound_by']})")


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Where the HGF of ``chip_smoke.py`` phase 19 (b) parts between the card
and the CPU (ROADMAP C9), against a float64 oracle.

    python3 scripts/hgf_oracle_gap.py [--rows 0,1,128,255] [--out FILE]

Runs ``zoo.hgf()`` on phase 19 (b)'s data (HGF_B datasets of HGF_T steps,
HGF_IT sweeps, z ~ N(0, 5)) three ways and keeps every sweep's marginals
of the sampled rows:

* the oracle: the port's own CPU path in float64 (its float32 casts --
  the data, the initialization, the model constants and the Gauss-Hermite
  nodes -- widened to float64 for this run, the default dtype float64);
* the port on the CPU in float32, the rows alone;
* the port on the card in float32 over the whole batch (when a CUDA device
  is present), as phase 19 (b) runs it.

It prints, for each sweep and each of x's and z's means and variances, the
largest gap of the CPU run and of the card run to the oracle and between
the two, relative to the largest value (``chip_smoke._rel_max``), and at
the first sweep where card and CPU part by more than 1e-5 which term: the
x chain's smoothed marginals (fed by the last z), or z's evidence, the
Gauss-Hermite message of the GCV factor (``rules/gcv.py``).  Imports no
JAX; a few minutes on a CPU (the float64 program), seconds on the card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


@contextlib.contextmanager
def float64_port():
    """The port's CPU path in float64: its explicit float32 casts widened
    for the duration (restored afterwards)."""
    import torch

    from rxinfer_tpu_torch.engine import blocks, compile as comp
    from rxinfer_tpu_torch.rules import special

    saved = (torch.get_default_dtype(), comp.CompiledModel._device_data,
             comp.CompiledModel._init_state, blocks.BatchContext.const,
             special.gauss_hermite_nodes)

    def device_data(self, data, all_finite, device):
        data, masks = saved[1](self, data, all_finite, device)
        return {k: v.double() for k, v in data.items()}, masks

    def init_state(self):
        from rxinfer_tpu_torch.dists import tree_map

        return {k: tree_map(lambda a: a.double(), d)
                for k, d in saved[2](self).items()}

    def const(self, c):
        hit = self._consts.get(id(c))
        if hit is None:
            hit = (c, torch.as_tensor(np.asarray(c.value, np.float64),
                                      device=self.device))
            self._consts[id(c)] = hit
        return hit[1]

    def gh_nodes(n, device):
        x, w = np.polynomial.hermite_e.hermegauss(n)
        w = w / np.sum(w)
        return (torch.as_tensor(x, dtype=torch.float64, device=device),
                torch.as_tensor(w, dtype=torch.float64, device=device))

    torch.set_default_dtype(torch.float64)
    comp.CompiledModel._device_data = device_data
    comp.CompiledModel._init_state = init_state
    blocks.BatchContext.const = const
    special.gauss_hermite_nodes = gh_nodes
    try:
        yield
    finally:
        torch.set_default_dtype(saved[0])
        (comp.CompiledModel._device_data, comp.CompiledModel._init_state,
         blocks.BatchContext.const, special.gauss_hermite_nodes) = saved[1:]


def run(y, device, rows=None):
    """Every sweep's (x mean, x var, z mean, z var), each (sweeps, rows,
    T), as float64 numpy arrays."""
    import torch

    import rxinfer_tpu_torch as rt
    from rxinfer_tpu_torch.models import zoo

    init = cs.hgf_init()
    if torch.get_default_dtype() == torch.float64:
        from rxinfer_tpu_torch.dists import tree_map

        init = {k: tree_map(lambda a: a.double(), d) for k, d in init.items()}
    res = rt.infer_batched(zoo.hgf(), {"y": torch.as_tensor(y, device=device)},
                           iterations=cs.HGF_IT, initialization=init,
                           returnvars=rt.KeepEach(), device=device,
                           options={"warn": False})
    post = res.posteriors
    pick = (lambda a: a[rows]) if rows is not None else (lambda a: a)
    return {f"{v}_{w}": np.stack([pick(getattr(q, w)().double().cpu().numpy())
                                  for q in post[v]])
            for v in ("x", "z") for w in ("mean", "var")}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", default=",".join(map(str, cs.HGF_ROWS)))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    rows = [int(r) for r in args.rows.split(",")]
    _, _, y = cs.hgf_data(cs.HGF_B, cs.HGF_T)
    torch.set_num_threads(max(1, os.cpu_count() // 2))
    cpu = torch.device("cpu")
    with float64_port():
        oracle = run(y[rows].astype(np.float64), cpu)
    runs = {"cpu": run(y[rows], cpu)}
    if torch.cuda.is_available():
        runs["card"] = run(y, torch.device("cuda"), rows)
    report = {"rows": rows, "sweeps": []}
    parted = None
    for i in range(cs.HGF_IT):
        row = {"sweep": i}
        for name, r in runs.items():
            row[name] = {k: cs._rel_max(r[k][i], oracle[k][i]) for k in r}
        if "card" in runs:
            row["card_cpu"] = {k: cs._rel_max(runs["card"][k][i],
                                              runs["cpu"][k][i])
                               for k in runs["cpu"]}
            if parted is None and max(row["card_cpu"].values()) > 1e-5:
                parted = (i, max(row["card_cpu"], key=row["card_cpu"].get))
        report["sweeps"].append(row)
        print(json.dumps(row))
    report["first_parting"] = parted
    last = report["sweeps"][-1]
    print(f"[c9] rows {rows}, {cs.HGF_IT} sweeps: last sweep against the "
          f"float64 oracle: CPU {last['cpu']}"
          + (f", card {last['card']}, card vs CPU {last['card_cpu']}; first "
             f"sweep where card and CPU part by > 1e-5: {parted}"
             if "card" in runs else ""))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())

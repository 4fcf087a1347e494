#!/usr/bin/env python3
"""Time the warp filter kernel (K3 for d > 16, ``csrc/fused_filter_warp.cu``)
alone with parts of its step taken out, and its inverses with a lane's
column in registers against the sweep in memory.

    python3 scripts/warp_filter_variants.py [BxTxD ...]

Run from the root of a checkout on a machine with a CUDA device and
``nvcc``.  Default shapes: 10000x200x32, 10000x200x17, 10000x200x24 and
2000x50x64, dy = d, the system of ``chip_smoke._filter_system`` and P0 =
9 I.  Each variant is the source with one part of the step replaced,
built with the package's flags (all ``nvcc`` runs started together) and
launched through its ``extern "C"`` launcher on the plan of
``ops/fused_filter.py`` ``device_warp_plan``:

- ``full``: the source as it is, with the plan's inverses;
- ``memory inverses``: the same library with the register inverses turned
  off (the Gauss-Jordan sweep in memory at every d);
- ``no pivot sweeps``, ``no inverses``, ``no products``: the two pivot
  sweeps of the inverses in memory, the two inverses, or the two products
  F P and (F P) F^T taken out (their outputs are wrong by construction).

The card's name and power limit head the output; then each variant's
``ptxas`` registers and spills, each shape's median ms of 3 rounds (CUDA
events, one launch a round, after 2 launches of warm-up) and, where the
plan keeps the columns in registers, whether both inverses gave the same
bits.  Run it from a ``git archive`` of another tree to compare the two
(``cd other && python3 ../scripts/warp_filter_variants.py``).
"""

import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.getcwd())

DEFAULT_SHAPES = ["10000x200x32", "10000x200x17", "10000x200x24",
                  "2000x50x64"]
INV_PM = "sym_inv_scaled(pm, cv, d, s, lane);"
INV_XM = "sym_inv_scaled(xm, cv, d, s, lane);"
MUL_FP = "mat_mul<false, false>(f, pm, nullptr, xm, d, d4, s, lane);"
MUL_FPF = "mat_mul<true, true>(xm, ft, q, pm, d, d4, s, lane);"
SWEEP_START = "  for (int k = 0; k < d; ++k) {\n    for (int i = lane"
SWEEP_END = "  for (int j = lane; j < d; j += kLanes) {\n    for (int i0 = 0; i0 <= j;"


def variants(src: str) -> dict:
    """Variant name -> source text (the register inverses are left in:
    ``memory inverses`` and the parts taken out run with them off)."""
    for text in (INV_PM, INV_XM, MUL_FP, MUL_FPF, SWEEP_START, SWEEP_END):
        if text not in src:
            raise SystemExit(f"csrc/fused_filter_warp.cu has no {text!r}")
    sweep = src[src.index(SWEEP_START):src.index(SWEEP_END)]
    return {
        "full": src,
        "no pivot sweeps": src.replace(sweep, ""),
        "no inverses": src.replace(INV_PM, "").replace(
            INV_XM, "mirror_upper(xm, d, s, lane);"),
        "no products": src.replace(MUL_FP, "").replace(MUL_FPF, ""),
    }


def build(texts: dict, out: str) -> dict:
    from rxinfer_tpu_torch import kernels

    procs = {}
    for i, (name, text) in enumerate(texts.items()):
        path = os.path.join(out, f"v{i}.cu")
        with open(path, "w") as fh:
            fh.write(text)
        procs[name] = (subprocess.Popen(
            [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o",
             os.path.join(out, f"libv{i}.so"), path], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), os.path.join(
            out, f"libv{i}.so"))
    libs = {}
    for name, (proc, lib_path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(lib_path)
        p, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.rxt_warp_filter.argtypes = [ci, ci, p, p, p, p, p, p, p, p, p,
                                        i64, i64, ci, ci, ci, ci, ci, ci, p]
        lib.rxt_warp_filter.restype = ci
        libs[name] = lib
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas] {name}: {line.strip()}")
    return libs


def main(argv) -> int:
    import torch

    from chip_smoke import _cuda_ms, _filter_system
    from rxinfer_tpu_torch import kernels
    from rxinfer_tpu_torch.ops import fused_filter as ff
    from rxinfer_tpu_torch.ops.fused_smoother import sym_fold

    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"tree {os.getcwd()}; {smi}", flush=True)
    src = (kernels.CSRC / "fused_filter_warp.cu").read_text()
    with tempfile.TemporaryDirectory() as out:
        libs = build(variants(src), out)
        shapes = [tuple(int(x) for x in a.split("x"))
                  for a in (argv or DEFAULT_SHAPES)]
        stream = torch.cuda.current_stream().cuda_stream
        for b, t_len, d in shapes:
            f, q, h, r = _filter_system(d, d, seed=1)
            w_obs, hr = ff.evidence_operators(h, r)
            fh, qh, hrh, wh = ff._host_params(f, q, hr, w_obs, d, d)
            plan = ff.device_warp_plan(d, dev)
            dp, stride = plan["padded_dim"], plan["stride"]
            prm = np.zeros((4, dp, stride), np.float32)
            for k, a in enumerate((fh, fh.T, qh, wh)):
                prm[k, :d, :d] = a
            params = torch.as_tensor(prm, device=dev)
            hr_t = torch.as_tensor(np.ascontiguousarray(hrh.T), device=dev)
            ys = torch.randn((t_len, d, b), device=dev,
                             generator=torch.Generator(dev).manual_seed(0))
            m0 = torch.zeros((d, b), device=dev)
            p0 = sym_fold((9 * torch.eye(d, device=dev)).expand(
                (b, d, d)).contiguous()).contiguous()
            ps = plan["params"] == "shared"
            cs = plan["chain_matrices"] == "shared"
            chains = plan["chains_per_block"]
            scratch = None if cs else torch.empty(
                (-(-b // chains) * chains * 2 * dp * stride,), device=dev)
            reg = plan["inverse_columns"] == "registers"
            runs = [("full", "full", reg), ("memory inverses", "full", False)]
            runs += [(n, n, False) for n in libs if n != "full"]
            outs = {}
            for name, lib_name, use_reg in runs:
                lib = libs[lib_name]
                out = (torch.empty((t_len, d, b), device=dev),
                       torch.empty((d, b), device=dev), torch.empty_like(p0))

                def launch():
                    rc = lib.rxt_warp_filter(
                        d, d, ys.data_ptr(), m0.data_ptr(), p0.data_ptr(),
                        hr_t.data_ptr(), params.data_ptr(),
                        *(o.data_ptr() for o in out),
                        None if scratch is None else scratch.data_ptr(),
                        t_len, b, dp, stride, chains, ps, cs, use_reg, stream)
                    if rc:
                        raise RuntimeError(f"{name}: CUDA error {rc}")

                launch()
                torch.cuda.synchronize()
                outs[name] = out
                print(f"(B,T,d)=({b},{t_len},{d}) {name}: "
                      f"{_cuda_ms(launch, 3):.3f} ms", flush=True)
            if reg:
                same = all(torch.equal(a, c) for a, c in zip(
                    outs["full"], outs["memory inverses"]))
                print(f"(B,T,d)=({b},{t_len},{d}) register and memory "
                      f"inverses give equal bits: {same}", flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

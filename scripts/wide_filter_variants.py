#!/usr/bin/env python3
"""Time the wide K3 (``csrc/fused_filter_wide.cu``, d 9-16 or dy > 8) alone
and in path A's call, beside another tree's kernel and with parts of its
step changed or taken out; hold each build to phase 16 (c)'s check.

    python3 scripts/wide_filter_variants.py [--other ROOT] [--only "A;B"]
                                            [--ptxas] [BxTxDxDY ...]

Run from the root of a checkout on a machine with a CUDA device and
``nvcc``.  Default shapes: 10000x200x16x16 (path A at d = 16), then
10000x200x12x12, 10000x200x9x9 and 10000x200x16x40; the system of
``chip_smoke._filter_system``, P0 = 9 I (at d = dy = 16 path A's own,
``chip_smoke.lgssm_constants(16)``), observations from a seed.
Each variant is the source (with ``wide_step.cuh`` and ``tc16.cuh``
inlined) with one part replaced, built with the package's flags (all
``nvcc`` runs started together) and launched through the package's
wrapper (``ops/fused_filter.py`` ``fused_filter``, its library swapped):

- ``tree``: the source as it is;
- ``pivot pairs``: the inverses' 8 x 8 leaves swept two pivots at a time
  (``tc16.cuh`` ``leaf8_pairs``; the tree: ``leaf8``, a pivot at a time);
- ``4 / 16 steps a barrier``: that many steps' evidence and means staged
  between the block's barriers (the tree: 8);
- ``two blocks an SM``, ``four blocks an SM``: the launch bounds' blocks an
  SM (the tree: 3, 80 registers a thread);
- ``no xi``, ``no sandwich``, ``no inverses``: the evidence's products, F P
  F^T or both inverses taken out (outputs wrong by construction);
- ``one TF32 product``: every 3xTF32 product one plain TF32 product;
- ``no mirror``: P's lower triangle left as the inverse gives it, not the
  mirror of its upper (``wide_step.cuh`` ``mirror_upper``);
- ``other``: ``ROOT/rxinfer_tpu_torch/csrc/fused_filter_wide.cu`` (another
  tree's kernel, through the same wrapper), with ``--other ROOT``.

Not measured here: two or more chains a warp (the wide K1 lost with them
at B = 1,024 in its own redesign, and its code is gone).

First each build's ``ptxas`` registers and spills and its kernel's SASS
instructions (``cuobjdump -sass``: the static count, and the tree's mix by
opcode).  ``--ptxas`` adds the ``ptxas`` lines of the package's wide K1 /
K2 (``fused_smoother_wide``) and, with ``--other``, of the other tree's.
Then phase 16 (c)'s own check (``chip_smoke.check_filter_kernel`` at
``FILTER_WIDE_CHECK_SHAPES``, the vague prior included, against the plain
version at RTOL / ATOL) on every build that computes the filter: the tree
and its alternatives must pass, ``one TF32 product`` and ``no mirror``
are expected to fail (the other tree's kernel is checked and reported, not
held).
Then each shape's median ms of 5 rounds (CUDA events, one launch a round,
after a launch of warm-up; the tree timed first and again last), the SM
clock, cycles a step, warps an SM and each variant's max difference from
the tree's outputs; at the first shape also path A's call
(``make_sharded_filtering(fused=True)``) with each build, and the kernel's
device time in one profiled call (``chip_smoke._device_profile``).  The
card's name and power limit head and end the output.  ``--only`` keeps the
variants it names, separated by semicolons (and the tree and the two
that must fail the check).  About three minutes with every variant.
"""

import argparse
import collections
import ctypes
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.getcwd())

DEFAULT_SHAPES = ["10000x200x16x16", "10000x200x12x12", "10000x200x9x9",
                  "10000x200x16x40"]
KERNEL = "wide_filter_tc_kernel"
# the text each variant replaces, and its replacement
PAIRS = "constexpr bool kPairs = false;"
STAGED = "constexpr int kStaged = 8;"
BLOCKS = "constexpr int kMinBlocks = 3;"
XI = "float* dst) {\n    if (s >= T) return;"
SANDWICH = ("mul_f_m(x, fh, fl, p, g, t);", "mul_a_ft<true>(p, x, fh, fl, g, t);")
INVERSE = "sym_inv_scaled<kPairs>(p, d, g, t, lane);"
MIRROR = "    mirror_upper(p, g, t);\n"
MMA3 = ("  mma_tf32(d, al, bh);\n  mma_tf32(d, ah, bl);\n"
        "  mma_tf32(d, ah, bh);\n")
PATCHES = {
    "tree": (),
    "pivot pairs": ((PAIRS, PAIRS.replace("false", "true")),),
    "4 steps a barrier": ((STAGED, STAGED.replace("8", "4")),),
    "16 steps a barrier": ((STAGED, STAGED.replace("8", "16")),),
    "two blocks an SM": ((BLOCKS, BLOCKS.replace("3", "2")),),
    "four blocks an SM": ((BLOCKS, BLOCKS.replace("3", "4")),),
    "no xi": ((XI, XI.replace("s >= T", "true")),),
    "no sandwich": tuple((s, "") for s in SANDWICH),
    "no inverses": ((INVERSE, ""),),
    "one TF32 product": ((MMA3, "  mma_tf32(d, ah, bh);\n"),),
    "no mirror": ((MIRROR, ""),),
}
TAKEN_OUT = ("no xi", "no sandwich", "no inverses")
# builds the card check should fail
WRONG = ("one TF32 product", "no mirror")
CHECKED = ("tree",) + WRONG


def variants(names) -> dict:
    """Variant name -> source text: the tree's source with its headers
    inlined (the variants patch them too) and each of its patches applied
    (every occurrence)."""
    from rxinfer_tpu_torch import kernels

    csrc = kernels.CSRC
    step = (csrc / "wide_step.cuh").read_text().replace(
        '#include "tc16.cuh"', (csrc / "tc16.cuh").read_text())
    src = (csrc / "fused_filter_wide.cu").read_text().replace(
        '#include "wide_step.cuh"', step)
    texts = {}
    for name in names:
        text = src
        for old, new in PATCHES[name]:
            if old not in text:
                raise SystemExit(f"csrc/fused_filter_wide.cu has no {old!r}")
            text = text.replace(old, new)
        texts[name] = text
    return texts


def _ptxas(name: str, log: str) -> None:
    kernel = ""
    for line in log.splitlines():
        if "Compiling entry" in line:
            mangled = line.split("'")[1]
            kernel = next((k for k in (KERNEL, "wide_filter_kernel",
                                       "wide_fwd_tc_kernel",
                                       "wide_bwd_ring_kernel") if k in mangled),
                          mangled[:40])
            kernel += " bf16" if "bfloat16" in mangled else ""
        elif "registers" in line or "spill" in line:
            print(f"[ptxas] {name}, {kernel}: {line.strip()}")


def build(texts: dict, other, out: str, smoother: bool) -> dict:
    """Start every nvcc run, then load each library and print its ptxas
    lines and SASS count.  Returns variant name -> library."""
    from rxinfer_tpu_torch import kernels

    jobs = {}
    for i, (name, text) in enumerate(texts.items()):
        jobs[name] = os.path.join(out, f"v{i}.cu")
        with open(jobs[name], "w") as fh:
            fh.write(text)
    if other:
        jobs["other"] = os.path.join(other, "rxinfer_tpu_torch", "csrc",
                                     "fused_filter_wide.cu")
    if smoother:
        jobs["K1/K2, this tree"] = str(kernels.CSRC / "fused_smoother_wide.cu")
        if other:
            jobs["K1/K2, other"] = os.path.join(
                other, "rxinfer_tpu_torch", "csrc", "fused_smoother_wide.cu")
    procs = {}
    for i, (name, path) in enumerate(jobs.items()):
        lib = os.path.join(out, f"libv{i}.so")
        procs[name] = (subprocess.Popen(
            [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-I",
             os.path.dirname(path), "-o", lib, path], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        _ptxas(name, log)
        if name.startswith("K1/K2"):
            continue
        libs[name] = ctypes.CDLL(path)
        sass(name, path, mix=name == "tree")
    return libs


def sass(name: str, path: str, mix: bool) -> None:
    """The filter kernel's SASS instructions in the library (``cuobjdump
    -sass``, beside ``nvcc``): the static count, and with ``mix`` the top
    opcodes."""
    from rxinfer_tpu_torch import kernels

    tool = os.path.join(os.path.dirname(kernels.nvcc_path()), "cuobjdump")
    res = subprocess.run([tool, "-sass", path], capture_output=True,
                         text=True)
    if res.returncode:
        print(f"[sass] cuobjdump failed: {res.stderr.strip()[:200]}")
        return
    fn, cnt = None, {}
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            cnt[fn] = collections.Counter()
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                     line)
        if fn and m:
            cnt[fn][m.group(1).split(".")[0]] += 1
    for fn, c in cnt.items():
        if "wide_filter" not in fn:
            continue
        top = ", ".join(f"{k} {v}" for k, v in c.most_common(14)) if mix \
            else f"HMMA {c['HMMA']}, SHFL {c['SHFL']}, BAR {c['BAR']}"
        print(f"[sass] {name}: {sum(c.values())} instructions in the "
              f"kernel ({top})", flush=True)


def swapped(lib):
    """A context in which the package loads ``lib`` as its wide K3."""
    import contextlib

    from rxinfer_tpu_torch import kernels

    @contextlib.contextmanager
    def ctx():
        load = kernels.load
        kernels.load = lambda n: lib if n == "fused_filter_wide" else load(n)
        try:
            yield
        finally:
            kernels.load = load
    return ctx()


def check(name, lib, dev) -> bool:
    """Phase 16 (c)'s check of the wide K3 with ``lib`` in place of the
    package's build.  Prints each case's errors; returns whether it
    passed."""
    from chip_smoke import FILTER_WIDE_CHECK_SHAPES, check_filter_kernel

    lines: list = []
    with swapped(lib):
        try:
            check_filter_kernel(dev, FILTER_WIDE_CHECK_SHAPES,
                                log=lines.append, seed=1650)
            passed, why = True, "passed"
        except AssertionError as e:
            passed, why = False, f"failed: {e}"
    for line in lines:
        print(f"{name}: {line}")
    print(f"{name}: phase 16 (c)'s check {why}", flush=True)
    return passed


class Case:
    """The inputs of one (B, T, d, dy) call, batch-minor."""

    def __init__(self, dev, b, t_len, d, dy, seed=0):
        import torch

        from chip_smoke import _filter_system, _soa_state, lgssm_constants
        from rxinfer_tpu_torch.ops import fused_filter as ff

        if d == dy == 16:
            f, q, h, r, _, p0 = lgssm_constants(d)
        else:
            f, q, h, r = _filter_system(d, dy, seed)
            p0 = 9.0 * np.eye(d, dtype=np.float32)
        self.system = (f, q, h, r)
        self.w_obs, self.hr = ff.evidence_operators(h, r)
        gen = torch.Generator(dev).manual_seed(seed)
        self.ys = torch.randn((t_len, b, dy), device=dev, generator=gen)
        self.ys_soa = self.ys.transpose(1, 2).contiguous()
        m = torch.zeros((b, d), device=dev)
        p = torch.as_tensor(p0, device=dev).expand((b, d, d)).contiguous()
        self.state = (m, p)
        self.m0, self.p0 = _soa_state(m, p)

    def kernel(self):
        from rxinfer_tpu_torch.ops import fused_filter as ff

        f, q, _, _ = self.system
        return ff.fused_filter(self.m0, self.p0, self.ys_soa, f, q, self.hr,
                               self.w_obs)


def main(argv) -> int:
    import torch

    from chip_smoke import SmClock, _cuda_ms, _device_profile
    from rxinfer_tpu_torch.ops import fused_filter as ff
    from rxinfer_tpu_torch.parallel.filtering import (
        FilterState,
        make_sharded_filtering,
    )

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", default=None)
    parser.add_argument("--only", default=None)
    parser.add_argument("--ptxas", action="store_true")
    parser.add_argument("shapes", nargs="*")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"tree {os.getcwd()}; {smi}", flush=True)
    names = list(PATCHES)
    if args.only:
        keep = {*CHECKED, *args.only.split(";")}
        names = [n for n in names if n in keep]
    with tempfile.TemporaryDirectory() as out:
        libs = build(variants(names), args.other, out, args.ptxas)
        ok = True
        for name, lib in libs.items():
            if name in TAKEN_OUT:
                continue
            passed = check(name, lib, dev)
            if name != "other":
                ok &= passed != (name in WRONG)
        for k, spec in enumerate(args.shapes or DEFAULT_SHAPES):
            b, t_len, d, dy = (int(x) for x in spec.split("x"))
            if ff.launch_key(d, dy) != "fused_filter_wide":
                raise SystemExit(f"{spec}: (d, dy) = ({d}, {dy}) does not "
                                 "run the wide kernel")
            case = Case(dev, b, t_len, d, dy)
            fn = make_sharded_filtering(None, *case.system, fused=True)
            state = FilterState(*case.state)
            ref = None
            order = list(libs) + ["tree"]
            for i, name in enumerate(order):
                again = i == len(order) - 1
                with swapped(libs[name]):
                    outs = [x.clone() for x in case.kernel()]
                    torch.cuda.synchronize()
                    if ref is None:
                        ref = outs
                    gap = max(float((o - r).abs().max())
                              for o, r in zip(outs, ref))
                    with SmClock() as clk:
                        # launches that bring the clock up, each waited for
                        end = time.perf_counter() + 0.3
                        while time.perf_counter() < end:
                            case.kernel()
                            torch.cuda.synchronize()
                        ms = _cuda_ms(case.kernel, 5, warmup=1)
                    call = ""
                    if k == 0:
                        call_ms = _cuda_ms(lambda: fn(state, case.ys), 5,
                                           warmup=1)
                        prof = _device_profile(
                            lambda: fn(state, case.ys),
                            {"wide": r"wide_filter(?:_tc)?_kernel"})
                        in_call = prof["kernels"]["wide"]["ms_per_launch"]
                        call = (f", path A's call {call_ms:.4f} ms (the "
                                f"kernel {in_call} ms in it)")
                lib = libs[name]
                warps = "not measured"
                if hasattr(lib, "rxt_wide_filter_blocks_per_sm"):
                    warps = 8 * lib.rxt_wide_filter_blocks_per_sm()
                cycles = ms * clk.mhz * 1e3 / t_len
                note = " (parts taken out)" if name in TAKEN_OUT else ""
                print(f"(B,T,d,dy)=({b},{t_len},{d},{dy}) {name}"
                      f"{' (again)' if again else ''}: {ms:.4f} ms alone, "
                      f"{cycles:.0f} cycles a step at {clk.mhz:.0f} MHz, "
                      f"{warps} warps an SM{call}, differs from the tree by "
                      f"{gap:.3g}{note}", flush=True)
            del case
            torch.cuda.empty_cache()
    print(smi)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

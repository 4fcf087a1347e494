#!/usr/bin/env python3
"""Time the wide K1 / K2 (``csrc/fused_smoother_wide.cu``, d 9-16) alone, in
other shapes and with parts of their step taken out; check that phase 15
(a)'s check fails a build with one TF32 product in place of 3xTF32.

    python3 scripts/wide_smoother_variants.py [--other ROOT] [--only "A;B"]
                                              [BxTxD ...]

Run from the root of a checkout on a machine with a CUDA device and
``nvcc``.  Default shapes: 1024x2048x16 (the d16 row of ``bench.py``),
1024x2048x12 and 1024x2048x9; the system of ``chip_smoke._smoother_params``
(F a scaled orthogonal matrix), xi from a seed, P0 = 9 I; per-chain W and
Q from ``chip_smoke._spd_batch``.  Each variant is the source (with
``tc16.cuh`` inlined) with one part replaced, built with the package's
flags (all ``nvcc`` runs started together) and launched through its
``extern "C"`` launchers:

- ``tree``: the source as it is (K1 and K2 in float32 and bf16 moments,
  with shared and with per-chain W and Q);
- ``K1 pivot by pivot``, ``K2 pivot pairs``: each kernel with its inverses'
  8 x 8 leaves swept the other way (``tc16.cuh`` ``leaf8`` a pivot at a
  time, ``leaf8_pairs`` two); ``K1 a step a barrier``, ``K1 8 steps a
  barrier``: the block's warps meet every step or every eight (the tree:
  every four), the steps' moments staged between;
- ``K2 one producer``: one producer warp a chain, a step a round (the
  tree: two);
- ``K2 producers alone``, ``K2 consumer alone``: the consumer's or the
  producers' work taken out (outputs wrong by construction);
- ``one TF32 product``: every 3xTF32 product one plain TF32 product (about
  three decimal digits);
- ``other``: ``ROOT/rxinfer_tpu_torch/csrc/fused_smoother_wide.cu`` (another
  tree's kernels, through the same launchers), with ``--other ROOT``.

Measured and gone with their code (``PERF.md`` §6): K1
with two or four chains a warp, K2 with one producer of two steps a round,
with no split (the consumer producing its own steps) and as two launches
(a gain pass over (T, B), then the serial pass).

First each variant's ``ptxas`` registers and spills, the tree's float32
kernels' SASS instructions by opcode (``cuobjdump -sass``), and the cycles
of one ``mma.sync``, shuffle and reciprocal in a dependent chain (a probe
kernel of one warp, ``clock64``).  Then phase 15 (a)'s own check
(``chip_smoke.check_slice12_kernels`` at ``WIDE_CHECK_SHAPES``, through the
wrappers, at RTOL / ATOL and the bf16 tolerances) on the tree, which must
pass, and on ``one TF32 product``, which it must fail: each case's errors,
and whether the check failed.  Then each shape's median ms of 3 rounds
(CUDA events, one launch a round, after a launch of warm-up; the tree
timed first and again last), the blocks an SM, and each variant's max
difference from the tree's outputs.  The
card's name and power limit head the output.  ``--only`` keeps the
variants it names, separated by semicolons (and the tree and ``one TF32
product``).  About two minutes with every variant.
"""

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.getcwd())

DEFAULT_SHAPES = ["1024x2048x16", "1024x2048x12", "1024x2048x9"]
# the text each variant replaces, and its replacement
K1_INV = "sym_inv_scaled<true>(p, d, g, t, lane);"
K2_INV = "sym_inv_scaled<false>(pp, d, g, t, lane);"
STAGED = "constexpr int kFwdStaged = 4;"
PRODUCERS = "constexpr int kProducers = 2;"
PRODUCE = "if (!consumer) {"
CONSUME = "if (consumer && r >= 0 && r < rounds) {"
MMA3 = ("  mma_tf32(d, al, bh);\n  mma_tf32(d, ah, bl);\n"
        "  mma_tf32(d, ah, bh);\n")
PATCHES = {
    "tree": (),
    "K1 pivot by pivot": ((K1_INV, K1_INV.replace("<true>", "<false>")),),
    "K1 a step a barrier": ((STAGED, STAGED.replace("4", "1")),),
    "K1 8 steps a barrier": ((STAGED, STAGED.replace("4", "8")),),
    "K2 pivot pairs": ((K2_INV, K2_INV.replace("<false>", "<true>")),),
    "K2 one producer": ((PRODUCERS, PRODUCERS.replace("2", "1")),),
    "K2 producers alone": ((CONSUME, "if (false) {"),),
    "K2 consumer alone": ((PRODUCE, "if (false) {"),),
    "one TF32 product": ((MMA3, "  mma_tf32(d, ah, bh);\n"),),
}
TAKEN_OUT = ("K2 producers alone", "K2 consumer alone")
CHECKED = ("tree", "one TF32 product")
# Dependent chains of one instruction in one warp, timed by clock64: the
# latency the wide kernels' steps are made of.
LATENCY_PROBE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void latency_probe(long long* out, float* sink, int n) {
  const int lane = threadIdx.x;
  float d[4] = {1.0f, 1.0f, 1.0f, 1.0f}, v = 1.0f + lane;
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = 0x3f800000u + lane + i;
  for (int i = 0; i < 2; ++i) b[i] = 0x3f000000u + lane + i;
  long long t0 = clock64();
  for (int i = 0; i < n; ++i)   // each product on the last one's sum
    asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  long long t1 = clock64();
  for (int i = 0; i < n; ++i) v = __shfl_sync(0xffffffffu, v, (lane + 1) & 31);
  long long t2 = clock64();
  for (int i = 0; i < n; ++i) v = __fdividef(1.0f, v);
  long long t3 = clock64();
  for (int i = 0; i < n; ++i) v = 1.0f / v;
  long long t4 = clock64();
  if (lane == 0) {
    out[0] = t1 - t0; out[1] = t2 - t1; out[2] = t3 - t2; out[3] = t4 - t3;
  }
  sink[lane] = d[0] + d[1] + d[2] + d[3] + v;
}
extern "C" int rxt_latency_probe(long long* out, float* sink, int n) {
  latency_probe<<<1, 32>>>(out, sink, n);
  return static_cast<int>(cudaGetLastError());
}
"""
LATENCY_NAMES = ("mma.sync m16n8k8 tf32", "shfl.sync", "__fdividef(1, x)",
                 "IEEE 1 / x")


def variants(names) -> dict:
    """Variant name -> source text: the tree's source with ``tc16.cuh``
    inlined (the variants patch it too) and each of its patches applied."""
    from rxinfer_tpu_torch import kernels

    src = (kernels.CSRC / "fused_smoother_wide.cu").read_text().replace(
        '#include "tc16.cuh"', (kernels.CSRC / "tc16.cuh").read_text())
    texts = {}
    for name in names:
        text = src
        for old, new in PATCHES[name]:
            if old not in text:
                raise SystemExit(f"csrc/fused_smoother_wide.cu has no {old!r}")
            text = text.replace(old, new)
        texts[name] = text
    return texts


def build(texts: dict, other, out: str) -> dict:
    """Start every nvcc run, then load each library and print its ptxas
    lines.  Returns variant name -> library."""
    from rxinfer_tpu_torch import kernels

    jobs = {}
    for i, (name, text) in enumerate(texts.items()):
        jobs[name] = os.path.join(out, f"v{i}.cu")
        with open(jobs[name], "w") as fh:
            fh.write(text)
    if other:
        jobs["other"] = os.path.join(other, "rxinfer_tpu_torch", "csrc",
                                     "fused_smoother_wide.cu")
    jobs["latency probe"] = os.path.join(out, "latency_probe.cu")
    with open(jobs["latency probe"], "w") as fh:
        fh.write(LATENCY_PROBE)
    procs = {}
    for i, (name, path) in enumerate(jobs.items()):
        lib = os.path.join(out, f"libv{i}.so")
        procs[name] = (subprocess.Popen(
            [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-I",
             str(kernels.CSRC), "-o", lib, path], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    p, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for name, (proc, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(path)
        if name == "latency probe":
            lib.rxt_latency_probe.argtypes = [p, p, ci]
            libs[name] = lib
            continue
        lib.rxt_wide_smoother_fwd.argtypes = [ci, p, p, p, p, p, i64, i64, p,
                                              p, p, p, p, p, ci, p]
        lib.rxt_wide_smoother_bwd.argtypes = [ci, p, p, p, p, p, i64, i64, p,
                                              p, p, p, ci, p]
        lib.rxt_error_string.argtypes = [ci]
        lib.rxt_error_string.restype = ctypes.c_char_p
        libs[name] = lib
        kernel = ""
        for line in log.splitlines():
            if "Compiling entry" in line:
                mangled = line.split("'")[1]
                kernel = next((k for k in ("wide_fwd_tc_kernel",
                                           "wide_bwd_ring_kernel",
                                           "wide_fwd_kernel",
                                           "wide_bwd_kernel")
                               if k in mangled), mangled[:40])
                kernel += " bf16" if "bfloat16" in mangled else ""
            elif "registers" in line or "spill" in line:
                print(f"[ptxas] {name}, {kernel}: {line.strip()}")
        if name == "tree":
            sass_mix(path)
    return libs


def sass_mix(path: str) -> None:
    """Each float32 kernel's SASS instructions in the library, by opcode
    (``cuobjdump -sass``, beside ``nvcc``): the instruction mix the issue
    rate and the latencies work on."""
    import collections
    import re

    from rxinfer_tpu_torch import kernels

    tool = os.path.join(os.path.dirname(kernels.nvcc_path()), "cuobjdump")
    res = subprocess.run([tool, "-sass", path], capture_output=True,
                         text=True)
    if res.returncode:
        print(f"[sass] cuobjdump failed: {res.stderr.strip()[:200]}")
        return
    fn, mix = None, {}
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            mix[fn] = collections.Counter()
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                     line)
        if fn and m:
            mix[fn][m.group(1).split(".")[0]] += 1
    for fn, cnt in mix.items():
        if "bfloat16" in fn or not any(k in fn for k in (
                "wide_fwd_tc_kernel", "wide_bwd_ring_kernel")):
            continue
        label = "K1" if "wide_fwd_tc_kernel" in fn else "K2"
        top = ", ".join(f"{k} {v}" for k, v in cnt.most_common(14))
        print(f"[sass] {label} {sum(cnt.values())} instructions: {top}")


def latencies(lib, dev) -> None:
    """Cycles of one instruction in a dependent chain of 1,024 in one warp."""
    import torch

    n = 1024
    out = torch.zeros(4, dtype=torch.int64, device=dev)
    sink = torch.zeros(32, device=dev)
    for _ in range(2):
        if lib.rxt_latency_probe(out.data_ptr(), sink.data_ptr(), n):
            raise RuntimeError("latency probe: CUDA error")
        torch.cuda.synchronize()
    print("latency, cycles an instruction in a dependent chain: " + ", ".join(
        f"{name} {c / n:.1f}" for name, c in zip(LATENCY_NAMES,
                                                  out.tolist())), flush=True)


class Case:
    """The inputs and outputs of one (B, T, d) call, float32 or bf16
    moments, shared or per-chain W and Q."""

    def __init__(self, dev, b, t_len, d, bf16, dyn, seed=0):
        import torch

        from chip_smoke import _smoother_params, _spd_batch
        from rxinfer_tpu_torch.ops import fused_smoother as fs

        self.b, self.t, self.d, self.bf16, self.dyn = b, t_len, d, bf16, dyn
        f, bv, q, w = _smoother_params(d, seed=seed)
        rng = np.random.default_rng(seed)
        as_dev = lambda a: torch.as_tensor(a, device=dev)
        self.xi = torch.randn((t_len, b, d), device=dev,
                              generator=torch.Generator(dev).manual_seed(seed))
        self.m0 = as_dev(rng.standard_normal((b, d)).astype(np.float32))
        self.p0 = as_dev(np.broadcast_to(9.0 * np.eye(d, dtype=np.float32),
                                         (b, d, d)).copy())
        self.wb = as_dev(_spd_batch(rng, b, d, 0.8)) if dyn else None
        self.qb = as_dev(_spd_batch(rng, b, d, 0.4)) if dyn else None
        self.q_sh, self.w_sh = (None, None) if dyn else (q, w)
        self.f, self.bv = f, bv
        self.host = fs._host_params(f, bv, self.q_sh, self.w_sh, d)
        tile = lambda x: None if x is None else fs.sym_fold(x).contiguous()
        self.w_tile, self.q_tile = tile(self.wb), tile(self.qb)
        self.md = torch.bfloat16 if bf16 else torch.float32
        nsym = d * (d + 1) // 2
        self.mf = torch.empty((t_len, d, b), device=dev)
        self.pf = torch.empty((t_len, nsym, b), device=dev, dtype=self.md)
        self.ms = torch.empty_like(self.mf)
        self.ps = torch.empty_like(self.pf)
        self.cross = torch.empty((t_len - 1, d * d, b), device=dev,
                                 dtype=self.md)
        self.stream = torch.cuda.current_stream(dev).cuda_stream

    def fwd(self, lib):
        from rxinfer_tpu_torch.ops import fused_smoother as fs

        fh, bh, qh, wh = self.host
        rc = lib.rxt_wide_smoother_fwd(
            self.d, self.xi.data_ptr(), self.m0.data_ptr(),
            self.p0.data_ptr(), self.mf.data_ptr(), self.pf.data_ptr(),
            self.t, self.b, fs._host_ptr(fh), fs._host_ptr(bh),
            fs._host_ptr(qh), fs._host_ptr(wh), fs._ptr(self.w_tile),
            fs._ptr(self.q_tile), int(self.bf16), self.stream)
        if rc:
            raise RuntimeError(f"K1: CUDA error {rc}")

    def bwd(self, lib):
        from rxinfer_tpu_torch.ops import fused_smoother as fs

        fh, bh, qh, _ = self.host
        rc = lib.rxt_wide_smoother_bwd(
            self.d, self.mf.data_ptr(), self.pf.data_ptr(),
            self.ms.data_ptr(), self.ps.data_ptr(), self.cross.data_ptr(),
            self.t, self.b, fs._host_ptr(fh), fs._host_ptr(bh),
            fs._host_ptr(qh), fs._ptr(self.q_tile), int(self.bf16),
            self.stream)
        if rc:
            raise RuntimeError(f"K2: CUDA error {rc}")

    def outputs(self):
        return [x.float().clone() for x in (self.mf, self.pf, self.ms,
                                             self.ps, self.cross)]


def check(name, lib, dev) -> bool:
    """Phase 15 (a)'s check of the wide kernels (``chip_smoke``
    ``check_slice12_kernels`` at ``WIDE_CHECK_SHAPES``, through the
    wrappers) with ``lib`` in place of the package's build.  Prints each
    case's errors; returns whether the check passed."""
    from chip_smoke import check_slice12_kernels, wide_check_cases
    from rxinfer_tpu_torch import kernels

    load = kernels.load
    kernels.load = lambda n: lib if n == "fused_smoother_wide" else load(n)
    lines: list = []
    try:
        check_slice12_kernels(dev, wide_check_cases(), log=lines.append)
        passed, why = True, "passed"
    except AssertionError as e:
        passed, why = False, f"failed: {e}"
    finally:
        kernels.load = load
    for line in lines:
        print(f"{name}: {line}")
    print(f"{name}: phase 15 (a)'s check {why}", flush=True)
    return passed


def main(argv) -> int:
    import torch

    from chip_smoke import _cuda_ms

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", default=None)
    parser.add_argument("--only", default=None)
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
        libs = build(variants(names), args.other, out)
        latencies(libs.pop("latency probe"), dev)
        tree = libs["tree"]
        # the tree must pass phase 15 (a)'s check and one TF32 product fail it
        ok = check("tree", tree, dev)
        ok &= not check("one TF32 product", libs["one TF32 product"], dev)
        for b, t_len, d in [tuple(int(x) for x in s.split("x"))
                            for s in (args.shapes or DEFAULT_SHAPES)]:
            runs = []      # (case label, case)
            for bf16 in (False, True):
                for dyn in (False, True):
                    label = (f"{'bf16' if bf16 else 'float32'} "
                             f"{'W, Q per chain' if dyn else 'static'}")
                    runs.append((label, Case(dev, b, t_len, d, bf16, dyn)))
            for label, case in runs:
                full = label == "float32 static"
                names = [n for n in libs if full or n in ("tree", "other")]
                ref = None
                # the tree again last: its two times bracket the rest
                for k, name in enumerate(names + ["tree"]):
                    lib = libs[name]
                    again = k == len(names)
                    for direction in ("K1", "K2"):
                        if name.startswith("K1") and direction == "K2" or \
                                name.startswith("K2") and direction == "K1":
                            continue
                        # K2 runs on the tree's K1 outputs
                        case.fwd(tree if direction == "K2" else lib)
                        launch = (lambda lib=lib: case.fwd(lib)) \
                            if direction == "K1" else \
                            (lambda lib=lib: case.bwd(lib))
                        launch()
                        torch.cuda.synchronize()
                        outs = case.outputs()
                        if name == "tree" and direction == "K2" and \
                                not again:
                            ref = outs
                        diff = ""
                        if ref is not None and (name != "tree" or again):
                            idx = range(2) if direction == "K1" else \
                                range(2, 5)
                            gap = max(float((outs[i] - ref[i]).abs().max())
                                      for i in idx)
                            diff = f", differs from the tree by {gap:.3g}"
                            if name in TAKEN_OUT:
                                diff += " (parts taken out)"
                        ms = _cuda_ms(launch, 3, warmup=1)
                        lib.rxt_wide_smoother_blocks_per_sm.argtypes = [
                            ctypes.c_int] * 2
                        blocks = lib.rxt_wide_smoother_blocks_per_sm(
                            int(direction == "K2"), int(case.bf16))
                        print(f"(B,T,d)=({b},{t_len},{d}) {label} {direction}"
                              f" {name}{' (again)' if again else ''}: "
                              f"{ms:.4f} ms, {blocks} blocks an SM"
                              f"{diff}", flush=True)
            del runs
            torch.cuda.empty_cache()
    print(smi)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

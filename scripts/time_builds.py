"""Time the ``nvcc`` builds of the port's kernel libraries.

Run from the root of a checkout (or of a ``git archive`` of another
commit, as ``cd other && python3 ../scripts/time_builds.py``): it imports
``rxinfer_tpu_torch.kernels`` from the current directory, so it times that
tree's sources and build rule.  Each build goes to a fresh temporary
directory, never to the tree's ``_build/``.

It prints, in seconds: the whole build as ``chip_smoke.py`` runs it (every
library's ``nvcc`` started together, ``kernels.build_all``), then each
library's ``nvcc`` alone, one after another.  ``--flags`` appends nvcc
flags to the tree's own (e.g. ``--flags=-lineinfo``).  Last line: one
JSON object with the times and the card's name.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--flags", default="", help="extra nvcc flags, "
                    "space-separated")
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    from rxinfer_tpu_torch import kernels

    extra = tuple(args.flags.split())
    kernels.NVCC_FLAGS = tuple(kernels.NVCC_FLAGS) + extra
    names = kernels.sources()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()
    out = {"tree": os.getcwd(), "flags": list(extra), "cpus": os.cpu_count(),
           "card": smi[0] if smi else "not measured", "alone_s": {}}
    with tempfile.TemporaryDirectory() as tmp:
        kernels.BUILD_DIR = Path(tmp) / "all"
        t0 = time.perf_counter()
        kernels.build_all()
        out["all_parallel_s"] = time.perf_counter() - t0
        print(f"[build] all {len(names)} libraries in parallel: "
              f"{out['all_parallel_s']:.1f} s", flush=True)
        for name in names:
            kernels.BUILD_DIR = Path(tmp) / name
            t0 = time.perf_counter()
            started = kernels._start_build(name)
            kernels._finish_build(name, started)
            out["alone_s"][name] = time.perf_counter() - t0
            print(f"[build] {name} alone: {out['alone_s'][name]:.1f} s",
                  flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

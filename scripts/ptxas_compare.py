#!/usr/bin/env python3
"""Compare the ``-Xptxas -v`` lines (registers, stack, spills, shared
memory) of kernel sources built from two checkouts.

    python3 scripts/ptxas_compare.py OTHER_ROOT fused_fb fused_smoother_wide

Run from the root of a checkout; needs ``nvcc``, no card.  Builds each
named ``csrc/<name>.cu`` from this checkout and from ``OTHER_ROOT`` (for
example a ``git archive`` of the parent unpacked into a directory that
``.gitignore`` lists) with the package's flags, all ``nvcc`` runs started
together, and prints for every kernel entry its line from each side and
whether they are equal.  Exits 1 when a kernel's lines differ or a kernel
exists on one side only.
"""

import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, os.getcwd())

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")


def ptxas_lines(log: str) -> dict:
    """Kernel entry (its mangled name, the translation unit's hash taken
    out) -> its ptxas lines after the entry, joined."""
    out, cur = {}, None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = re.sub(r"_GLOBAL__N__\w+?_\d+_\w+?_cu_[0-9a-f]+", "",
                         m.group(1))
            out[cur] = []
        elif cur is not None and ("registers" in line or "spill" in line
                                  or "smem" in line):
            out[cur].append(line.split(":", 1)[-1].strip())
    return {k: " | ".join(v) for k, v in out.items()}


def main(argv) -> int:
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    from rxinfer_tpu_torch import kernels

    other, names = Path(argv[0]), argv[1:]
    tmp = Path(tempfile.mkdtemp(prefix="ptxas_"))
    procs = {}
    for side, root in (("tree", Path.cwd()), ("other", other)):
        for name in names:
            src = root / "rxinfer_tpu_torch" / "csrc" / f"{name}.cu"
            cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o",
                   str(tmp / f"{side}_{name}.so"), str(src)]
            procs[side, name] = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
    logs = {}
    for key, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"nvcc failed for {key}:\n{log}", file=sys.stderr)
            return 2
        logs[key] = ptxas_lines(log)
    same = True
    for name in names:
        tree, theirs = logs["tree", name], logs["other", name]
        for entry in sorted(set(tree) | set(theirs)):
            eq = tree.get(entry) == theirs.get(entry)
            same &= eq
            print(f"{name} {entry[:90]}: {'same' if eq else 'DIFFERENT'}; "
                  f"tree {tree.get(entry, 'absent')}"
                  + ("" if eq else f"; other {theirs.get(entry, 'absent')}"))
    print("every kernel's ptxas lines equal" if same else "ptxas lines differ")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

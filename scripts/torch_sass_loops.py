#!/usr/bin/env python3
"""The loops of a CUDA source's kernels in their SASS: instructions an
iteration, by opcode. Needs the CUDA toolkit (``nvcc``, ``cuobjdump``).

    python3 scripts/torch_sass_loops.py SOURCE.cu KERNEL [KERNEL ...]

Builds SOURCE (a path in the checkout) with the port's flags
(`hitadv_torch/ops/_build.py`) into a temporary library, disassembles
it, and for every kernel whose mangled name contains one of the KERNEL
strings prints each loop (a backward branch and its target) with its
instruction count and opcode counts. MUFU counts the special-function
unit's results, F2F conversions between f32 and f64, DFMA and DADD the
f64 pipe; every instruction takes one issue slot. Instructions a term
are a loop's count over the terms one iteration forms.
"""

from __future__ import annotations

import collections
import os
import re
import subprocess
import sys
import tempfile

sys.path.insert(0, os.getcwd())


def loops(sass: str, pattern: str):
    """{kernel: [(start, end, count, Counter of opcodes)]} for the kernels
    of ``sass`` (cuobjdump -sass text) whose name contains ``pattern``."""
    found, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
            name = name if pattern in name else None
            if name:
                found[name] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if name and m:
            found[name].append((int(m.group(1), 16), m.group(2)))
    out = {}
    for kernel, ins in found.items():
        out[kernel] = []
        for addr, text in ins:
            words = text.split()
            if words[0].startswith("@"):
                words = words[1:]
            if words and words[0].startswith("BRA"):
                target = int(words[-1], 16)
                if target < addr:
                    ops = collections.Counter(
                        (t.split()[1] if t.startswith("@") else
                         t.split()[0]).split(".")[0]
                        for a, t in ins if target <= a <= addr)
                    out[kernel].append((target, addr, sum(ops.values()),
                                        ops))
    return out


def main(argv) -> int:
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    from hitadv_torch.ops import _build

    source, patterns = argv[0], argv[1:]
    nvcc = _build.nvcc_path()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    with tempfile.TemporaryDirectory() as tmp:
        lib = os.path.join(tmp, "lib.so")
        subprocess.run([nvcc, *_build.FLAGS, "-o", lib, source], check=True)
        sass = subprocess.run([cuobjdump, "-sass", lib], check=True,
                              capture_output=True, text=True).stdout
    for pattern in patterns:
        for kernel, found in loops(sass, pattern).items():
            print(kernel)
            for start, end, count, ops in found:
                print(f"  loop {start:#06x}-{end:#06x}: {count} instructions;"
                      f" {dict(ops.most_common())}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

#!/usr/bin/env python3
"""Count the tensor-core (``HGMMA``) instructions of each kernel in the built
CUDA library.

    python3 -m csof_tpu_torch.sass_census [--loops NAME]

Builds the kernels if needed (``ops/kernels/_build.py``), disassembles the
library with ``cuobjdump -sass`` and prints, for every kernel function
(demangled by ``cu++filt``), the number of ``HGMMA`` instructions in its
SASS: a warpgroup ``wgmma`` on the tensor cores (K6's ``conv3x3_kernel`` and
``conv3x3_dx_kernel``, K3's conv pass ``fuse_conv_kernel``: 9 in each bf16
and 27 in each float32 instantiation). ``--loops NAME`` prints instead, for
each kernel whose demangled name contains NAME, every loop of its SASS (a
branch back to an earlier address): the instructions of its body and the
commonest opcodes among them. Needs the CUDA toolkit, not a card.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

from csof_tpu_torch.ops.kernels import _build


def _tool(name: str) -> str:
    for cand in (shutil.which(name),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", name)):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(f"{name} not found (PATH, $CUDA_HOME/bin)")


def functions(lib: Path | None = None) -> dict[str, list[tuple[int, str]]]:
    """{demangled kernel name: [(address, instruction), ...]} of the library's SASS."""
    lib = lib or _build.build()
    sass = subprocess.run([_tool("cuobjdump"), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    out: dict[str, list[tuple[int, str]]] = {}
    name = None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if name is not None and m:
            out[name].append((int(m.group(1), 16), m.group(2)))
    names = subprocess.run([_tool("cu++filt")], input="\n".join(out), capture_output=True,
                           text=True, check=True).stdout.splitlines()
    return dict(zip(names, out.values()))


def counts(lib: Path | None = None) -> dict[str, int]:
    """{demangled kernel name: HGMMA instructions} of the library."""
    return {name: sum(bool(re.search(r"\bHGMMA\.", ins)) for _, ins in code)
            for name, code in functions(lib).items()}


def _opcode(ins: str) -> str:
    return re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0]


def loops(code: list[tuple[int, str]]) -> list[tuple[int, int, Counter]]:
    """(first address, instructions, opcode counts) of each loop body: the
    code from a backward branch's target to the branch."""
    out = []
    for addr, ins in code:
        m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", ins)
        if m and int(m.group(1), 16) < addr:
            body = [i for a, i in code if int(m.group(1), 16) <= a <= addr]
            out.append((int(m.group(1), 16), len(body), Counter(map(_opcode, body))))
    return out


def main() -> int:
    if "--loops" in sys.argv:
        pattern = sys.argv[sys.argv.index("--loops") + 1]
        for name, code in functions().items():
            if pattern in name:
                print(f"{name}: {len(code)} instructions")
                for start, n, ops in loops(code):
                    common = ", ".join(f"{op} {k}" for op, k in ops.most_common(8))
                    print(f"  loop at 0x{start:05x}: {n} instructions ({common})")
        return 0
    for name, n in sorted(counts().items()):
        print(f"HGMMA {n:4d}  {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

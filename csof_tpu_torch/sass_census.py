#!/usr/bin/env python3
"""Count the tensor-core (``HGMMA``) instructions of each kernel in the built
CUDA library.

    python3 -m csof_tpu_torch.sass_census

Builds the kernels if needed (``ops/kernels/_build.py``), disassembles the
library with ``cuobjdump -sass`` and prints, for every kernel function
(demangled by ``cu++filt``), the number of ``HGMMA`` instructions in its
SASS: a warpgroup ``wgmma`` on the tensor cores (K6's ``conv3x3_kernel`` and
``conv3x3_dx_kernel``, K3's conv pass ``fuse_conv_kernel``: 9 in each bf16
and 27 in each float32 instantiation). Needs the CUDA toolkit, not a card.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

from csof_tpu_torch.ops.kernels import _build


def _tool(name: str) -> str:
    for cand in (shutil.which(name),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", name)):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(f"{name} not found (PATH, $CUDA_HOME/bin)")


def counts(lib: Path | None = None) -> dict[str, int]:
    """{demangled kernel name: HGMMA instructions} of the library."""
    lib = lib or _build.build()
    sass = subprocess.run([_tool("cuobjdump"), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    out: dict[str, int] = {}
    name = None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = 0
        elif name is not None and re.search(r"\bHGMMA\.", line):
            out[name] += 1
    names = subprocess.run([_tool("cu++filt")], input="\n".join(out), capture_output=True,
                           text=True, check=True).stdout.splitlines()
    return dict(zip(names, out.values()))


def main() -> int:
    for name, n in sorted(counts().items()):
        print(f"HGMMA {n:4d}  {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

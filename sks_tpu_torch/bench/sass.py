"""Instruction counts of the built kernels, from their SASS.

``nvcc -Xptxas -v`` reports registers and spills; this reads the other half
of what the compiler made: how many instructions each kernel is, and of which
kinds (``cuobjdump -sass`` on the library that
``sks_tpu_torch.kernels._build`` built).  An instruction count times the
threads of a launch, over the card's instruction rate, is the least time the
kernel's own code can take, whatever its flop count says.

Run on a machine with the CUDA toolkit and a card, from the repository root:

    python -m sks_tpu_torch.bench.sass [--ablation] [SUBSTRING ...]

prints one JSON line per kernel whose mangled name contains every SUBSTRING
(all kernels without one) of the package's kernel library, or with
``--ablation`` of the NDLT timing instruments: its instruction count, its 12 commonest opcodes
and its loops (each backward branch: the loop's first address and its length
in instructions).
"""

from __future__ import annotations

import collections
import json
import re
import subprocess
import sys
from pathlib import Path

from sks_tpu_torch.kernels import _build

__all__ = ["kernel_instructions", "parse_kernel", "main"]

_INSTRUCTION = re.compile(
    r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\d\s+)?([A-Z][A-Z0-9_]*)([^;]*);")
_BYTES_PER_INSTRUCTION = 16


def parse_kernel(body: str) -> tuple[collections.Counter, list[tuple[str, int]]]:
    """(opcode counts, loops) of one kernel's SASS listing.  A loop is a
    branch to an address at or before its own: (first address, length in
    instructions), the innermost loops being the shortest."""
    ops, loops = collections.Counter(), []
    for m in map(_INSTRUCTION.search, body.splitlines()):
        if not m:
            continue
        addr, op, operands = int(m.group(1), 16), m.group(2), m.group(3)
        ops[op] += 1
        target = re.search(r"0x([0-9a-f]+)\s*$", operands)
        if op == "BRA" and target and int(target.group(1), 16) <= addr:
            start = int(target.group(1), 16)
            loops.append((hex(start),
                          (addr - start) // _BYTES_PER_INSTRUCTION + 1))
    return ops, loops


def kernel_instructions(library: Path) -> dict[str, tuple]:
    """{mangled kernel name: (opcode counts, loops)} for every kernel in
    ``library`` (see :func:`parse_kernel`)."""
    cuobjdump = Path(_build.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(library)],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for chunk in sass.split("Function :")[1:]:
        name, _, body = chunk.partition("\n")
        out[name.strip()] = parse_kernel(body)
    return out


def main(argv=None) -> None:
    wanted = list(sys.argv[1:] if argv is None else argv)
    if "--ablation" in wanted:
        wanted.remove("--ablation")
        _build.load_ablation_library()
        library = _build.library_path("ablation")
    else:
        _build.load_library()
        library = _build.library_path("kernels")
    for name, (ops, loops) in kernel_instructions(library).items():
        if all(w in name for w in wanted):
            print(json.dumps({"kernel": name, "instructions": sum(ops.values()),
                              "top": ops.most_common(12), "loops": loops}))


if __name__ == "__main__":
    main()

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
``--ablation`` of the timing instruments: its instruction count, its 12
commonest opcodes, its loops (each backward branch: the loop's first address
and its length in instructions), its ``MUFU`` instructions by function (one
starts every IEEE division, reciprocal and square root), and the count up to
the last ``EXIT`` (what follows is the out-of-line slow paths of those
sequences).  ``--trips N`` adds the instructions a thread executes when every
loop runs N times, and the time 2^20 such threads need at the card's instruction
rate (:func:`instruction_limit_ms`).
"""

from __future__ import annotations

import collections
import json
import re
import subprocess
from pathlib import Path

from sks_tpu_torch.kernels import _build

__all__ = ["executed_instructions", "instruction_limit_ms", "kernel_summary",
           "mufu_kinds", "parse_kernel", "main"]

#: Warp schedulers of an H100 SXM (132 SMs of 4), one instruction a clock
#: each, and the clocks its kernels run between: sustained and boost.
H100_SCHEDULERS = 528
H100_CLOCKS_HZ = (1.755e9, 1.98e9)

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


def mufu_kinds(body: str) -> collections.Counter:
    """The ``MUFU`` instructions of a listing by function (RCP, RSQ, SQRT,
    RCP64H, RSQ64H, ...)."""
    return collections.Counter(re.findall(r"\bMUFU\.([A-Z0-9]+)", body))


def executed_instructions(body: str, trips: int = 1) -> int:
    """Instructions one thread executes on the listing's straight path: the
    count up to the last ``EXIT`` (the out-of-line slow paths follow it),
    every loop run ``trips`` times.  Forward branches count as not taken, so
    the few instructions that call a slow path are counted though they are
    skipped: an estimate from above."""
    ops = [(int(m.group(1), 16), m.group(2))
           for m in map(_INSTRUCTION.search, body.splitlines()) if m]
    exits = [i for i, (_, op) in enumerate(ops) if op == "EXIT"]
    straight = ops[:exits[-1] + 1] if exits else ops
    last = straight[-1][0] if straight else 0
    loops = [n for start, n in parse_kernel(body)[1]
             if int(start, 16) <= last]
    return len(straight) + (trips - 1) * sum(loops)


def instruction_limit_ms(instructions: int, threads: int,
                   clock_hz: float = H100_CLOCKS_HZ[0]) -> float:
    """The least ms ``threads`` threads of ``instructions`` instructions take
    on an H100: a warp's instruction is one instruction slot of one of the 528
    schedulers."""
    return instructions * -(-threads // 32) / H100_SCHEDULERS / clock_hz * 1e3


def _listings(library: Path) -> dict[str, str]:
    """{mangled kernel name: SASS listing} for every kernel in ``library``."""
    cuobjdump = Path(_build.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(library)],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for chunk in sass.split("Function :")[1:]:
        name, _, body = chunk.partition("\n")
        out[name.strip()] = body
    return out


def kernel_summary(library: Path, wanted=(), trips=1,
                   threads: int = 1 << 20) -> list[dict]:
    """One dict per kernel of ``library`` whose mangled name contains every
    string of ``wanted``: what :func:`main` prints.  ``trips`` is how often
    every loop runs, a number or a function of the kernel's name."""
    rows = []
    for name, body in _listings(library).items():
        if not all(w in name for w in wanted):
            continue
        ops, loops = parse_kernel(body)
        n = trips(name) if callable(trips) else trips
        executed = executed_instructions(body, n)
        rows.append({
            "kernel": name, "instructions": sum(ops.values()),
            "top": ops.most_common(12), "loops": loops,
            "mufu": dict(mufu_kinds(body)),
            "branches": ops["BRA"], "calls": ops["CALL"],
            "straight_path": executed_instructions(body), "trips": n,
            "executed": executed,
            "instruction_limit_ms": [instruction_limit_ms(executed, threads, hz)
                               for hz in H100_CLOCKS_HZ],
        })
    return rows


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ablation", action="store_true",
                    help="the timing instruments' library")
    ap.add_argument("--trips", type=int, default=1,
                    help="times every loop runs in the executed count")
    ap.add_argument("wanted", nargs="*", metavar="SUBSTRING")
    args = ap.parse_args(argv)
    if args.ablation:
        _build.load_ablation_library()
    else:
        _build.load_library()
    library = _build.library_path("ablation" if args.ablation else "kernels")
    for row in kernel_summary(library, args.wanted, args.trips):
        print(json.dumps(row))


if __name__ == "__main__":
    main()

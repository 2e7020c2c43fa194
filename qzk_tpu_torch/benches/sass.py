"""Instruction counts of the port's CUDA kernels, read from the SASS that
``cuobjdump -sass`` prints for their built libraries: for each kernel,
its static instruction count and, for each loop body (a backward branch),
its instruction count and most frequent opcodes.  With the trip counts
of the loops (a Poseidon permutation runs its full-round body 8 times
and its partial-round body 22 times) this gives the instructions a call
executes, which bound K1 and K2 on the card's integer pipes.

    python3 -m qzk_tpu_torch.benches.sass [--library PATH ...]

Without ``--library`` it builds (at first use) and reads the Poseidon
and NTT libraries.  Prints one JSON line per kernel.  Needs the CUDA
toolkit's ``cuobjdump``; no card.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess

_FUNCTION = re.compile(r"Function : (\S+)")
_INSTRUCTION = re.compile(
    r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);")
_TARGET = re.compile(r"0x([0-9a-f]+)")


def parse(sass: str) -> dict[str, list[tuple[int, str, str]]]:
    """{kernel symbol: [(address, opcode, operands), ...]}"""
    kernels: dict[str, list[tuple[int, str, str]]] = {}
    current = None
    for line in sass.splitlines():
        m = _FUNCTION.search(line)
        if m:
            current = kernels.setdefault(m.group(1), [])
            continue
        m = _INSTRUCTION.search(line)
        if m and current is not None:
            current.append((int(m.group(1), 16), m.group(2), m.group(3)))
    return kernels


def loops(instructions, min_size: int = 50) -> list[dict]:
    """Each loop body of at least min_size instructions: from the target
    of a backward branch to the branch itself."""
    index = {addr: i for i, (addr, _, _) in enumerate(instructions)}
    out = []
    for i, (addr, op, operands) in enumerate(instructions):
        m = _TARGET.search(operands)
        if not op.startswith("BRA") or not m:
            continue
        j = index.get(int(m.group(1), 16))
        if j is None or j > i or i + 1 - j < min_size:
            continue
        body = instructions[j:i + 1]
        ops = collections.Counter(o.split(".")[0] for _, o, _ in body)
        out.append({"start": hex(instructions[j][0]), "instructions": len(body),
                    "opcodes": dict(ops.most_common(8))})
    return out


def report(library: str) -> list[dict]:
    from ..utils import build

    cuobjdump = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", library], capture_output=True,
                          text=True, check=True).stdout
    return [{"library": os.path.basename(library), "kernel": name,
             "instructions": len(ins), "loops": loops(ins)}
            for name, ins in parse(sass).items()]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--library", action="append", default=None,
                    help="a built kernel library (default: the Poseidon and NTT ones)")
    args = ap.parse_args(argv)
    libraries = args.library
    if libraries is None:
        from ..ops import ntt_cuda, poseidon_cuda

        libraries = [poseidon_cuda.library_path(), ntt_cuda.library_path()]
    for lib in libraries:
        for line in report(lib):
            print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()

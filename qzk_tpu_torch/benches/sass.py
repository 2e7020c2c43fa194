"""Instruction counts of the port's CUDA kernels, read from the SASS that
``cuobjdump -sass`` prints for their built libraries: for each kernel,
its static instruction count, its barriers (``BAR``) and shared-memory
loads and stores (``LDS``/``STS``), and, for each loop body (a backward
branch), the same counts and its most frequent opcodes.  With the trip
counts of the loops (a Poseidon permutation runs its full-round body 8
times and its partial-round body 22 times) this gives the instructions a
call executes, which bound K1 and K2 on the card's integer pipes.

For each instantiation of the NTT kernel K3 (``ntt_axis0_kernel<K>``) it
also reads the bodies of its loops over stage groups, the loops with one
barrier (one for the weak path and one for the plain path): one exchange
through shared memory and K stages of 2^(K-1) butterflies in each of the
thread's columns (two for K < 5, one for K = 5, as ntt.cu's log_cols
sets them), so a body's instructions over its butterflies are the
instructions a butterfly, exchange included.

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
                    **memory_counts(body), "opcodes": dict(ops.most_common(8))})
    return out


def memory_counts(instructions) -> dict:
    """Barriers and shared-memory loads and stores among `instructions`."""
    ops = collections.Counter(o.split(".")[0] for _, o, _ in instructions)
    return {"BAR": ops["BAR"], "LDS": ops["LDS"], "STS": ops["STS"]}


_NTT_K = re.compile(r"ntt_axis0_kernelILi(\d+)E")


def ntt_group_bodies(name: str, body_loops: list[dict]) -> list[dict] | None:
    """For an instantiation of K3, each stage-group loop body (a loop with
    one barrier) and the instructions a butterfly there, fewest first;
    None for other kernels."""
    m = _NTT_K.search(name)
    if not m:
        return None
    k = int(m.group(1))
    butterflies = ((k << k) >> 1) * (2 if k < 5 else 1)
    if not butterflies:  # K = 0: one row, no stages
        return []
    bodies = sorted(lp["instructions"] for lp in body_loops if lp["BAR"] == 1)
    return [{"log_r": k, "butterflies": butterflies, "instructions": n,
             "instructions_per_butterfly": n / butterflies} for n in bodies]


def report(library: str) -> list[dict]:
    from ..utils import build

    cuobjdump = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", library], capture_output=True,
                          text=True, check=True).stdout
    out = []
    for name, ins in parse(sass).items():
        body_loops = loops(ins)
        line = {"library": os.path.basename(library), "kernel": name,
                "instructions": len(ins), **memory_counts(ins), "loops": body_loops}
        groups = ntt_group_bodies(name, body_loops)
        if groups is not None:
            line["stage_groups"] = groups
        out.append(line)
    return out


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

"""Offline circuit-artifact generator (parity with the reference's
circuit-builder crate: reference wormhole/circuit-builder/src/
{lib.rs:11-66, main.rs:4-6}), the JAX package's
qzk_tpu/models/wormhole/circuit_builder.py on the port.

Builds the Wormhole circuit with standard_recursion_config (NOT the zk
variant — same deliberate choice as the reference, lib.rs:16; see
SURVEY.md §7 pitfalls) and writes `common.bin`, `verifier.bin` and
optionally `prover.bin` to the output directory.  These artifacts are
the checkpoint/resume mechanism: WormholeProver.default() and
WormholeVerifier.new_from_files() reload them instead of re-running the
one-time circuit build (SURVEY.md §5 "Checkpoint / resume").
common.bin and verifier.bin are byte for byte the JAX package's;
prover.bin is the port's own (utils/serialization.py).  The build runs
on the host: no card is needed.

Run as a CLI:  python -m qzk_tpu_torch.models.wormhole.circuit_builder [outdir]
"""

from __future__ import annotations

from pathlib import Path

from ...plonk.config import CircuitConfig
from ...utils import serialization as ser
from .circuit import WormholeCircuit

DEFAULT_OUTPUT_DIR = "generated-bins"


def generate_circuit_binaries(
    output_dir: str | Path = DEFAULT_OUTPUT_DIR,
    include_prover_data: bool = True,
) -> dict:
    """Build the circuit and serialize its artifacts; returns the
    written paths (lib.rs:11-66)."""
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)

    circuit = WormholeCircuit(CircuitConfig.standard_recursion_config())
    data = circuit.build_circuit()

    paths = {}
    common_path = out / "common.bin"
    common_path.write_bytes(ser.common_to_bytes(data.common))
    paths["common"] = common_path

    verifier_path = out / "verifier.bin"
    verifier_path.write_bytes(
        ser.verifier_only_to_bytes(data.verifier_only)
    )
    paths["verifier"] = verifier_path

    if include_prover_data:
        prover_path = out / "prover.bin"
        prover_path.write_bytes(
            ser.prover_only_to_bytes(data.prover_only)
        )
        paths["prover"] = prover_path
    return paths


def main(argv: list[str] | None = None) -> None:
    import sys

    args = sys.argv[1:] if argv is None else argv
    outdir = args[0] if args else DEFAULT_OUTPUT_DIR
    paths = generate_circuit_binaries(outdir, include_prover_data=True)
    for name, p in paths.items():
        print(f"wrote {name}: {p} ({p.stat().st_size} bytes)")


if __name__ == "__main__":
    main()

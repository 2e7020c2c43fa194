"""Export the dummy proofs that pad an aggregation tree: the port's
counterpart of the JAX package's tools/export_dummy_proof.py (the
reference's ignored export tests, wormhole/tests/src/prover/
prover_tests.rs:56-120 and util.rs:11-29).

    python3 -m qzk_tpu_torch.tools.export_dummy_proof [OUTDIR] [--device cpu]

Proves ``models/wormhole/fixtures.synthetic_circuit_inputs()`` under
``CircuitConfig()`` with zero knowledge on and then off, verifies each
proof, and writes OUTDIR/dummy_proof_zk.bin and OUTDIR/dummy_proof.bin
(OUTDIR: generated-bins by default, the directory from which
``WormholeProofAggregator`` reads them to pad a short buffer).  Their
sha256 are ``WORMHOLE_ZK_PROOF_SHA256`` and
``WORMHOLE_NONZK_PROOF_SHA256``.  Proves on the card unless --device cpu
is given (two CPU Wormhole proves take several minutes).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

# (zero knowledge, file name), in the JAX tool's order
FILES = ((True, "dummy_proof_zk.bin"), (False, "dummy_proof.bin"))


def prove_bytes(config, inputs, device) -> bytes:
    """The Wormhole proof of `inputs` under `config`, verified on the
    host, as bytes."""
    from ..models.wormhole.circuit import WormholeCircuit
    from ..models.wormhole.prover import WormholeProver

    circuit = WormholeCircuit(config)
    targets = circuit.targets()
    data = circuit.build_circuit()
    prover = WormholeProver(config, _circuit_data=data.prover_data(), _targets=targets,
                            device=device)
    proof = prover.commit(inputs).prove()
    data.verifier_data().verify(proof)
    return proof.to_bytes()


def export(outdir="generated-bins", device=None) -> list[Path]:
    """Writes both dummy proofs into `outdir` (made if missing); returns
    their paths, the zk file first."""
    from ..models.wormhole.fixtures import synthetic_circuit_inputs
    from ..plonk.config import CircuitConfig

    out = Path(outdir)
    out.mkdir(parents=True, exist_ok=True)
    paths = []
    for zk, name in FILES:
        path = out / name
        path.write_bytes(prove_bytes(CircuitConfig().with_zero_knowledge(zk),
                                     synthetic_circuit_inputs(), device))
        print(f"wrote {path} ({path.stat().st_size} bytes)", flush=True)
        paths.append(path)
    return paths


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("outdir", nargs="?", default="generated-bins")
    parser.add_argument("--device", default=None,
                        help="torch device of the proves (default: the card)")
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    export(args.outdir, args.device)


if __name__ == "__main__":
    main()

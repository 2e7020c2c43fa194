"""The port's counterpart of benches/bench_verifier.py (the reference's
criterion harness `verifier_verify_proof`, verifier/benches/
verifier.rs:43-63): verify one zk Wormhole proof against circuit data
reloaded from serialized bytes, timed on the host.

    python3 -m qzk_tpu_torch.benches.verify [--proof-file PATH] [--runs 10] [--device cpu]

Builds the Wormhole circuit under ``standard_recursion_zk_config()``,
writes its common and verifier-only data to bytes and reloads them
through ``WormholeVerifier.new_from_bytes``.  The proof is proved on the
device from ``synthetic_circuit_inputs()``, or read from
``--proof-file`` (``generated-bins/dummy_proof_zk.bin`` holds that same
proof); its sha256 must be the JAX package's
``WORMHOLE_ZK_PROOF_SHA256``.  After one verify to warm up, `runs`
verifies are timed on the host clock.  Prints one JSON line: the least
and median seconds, every run, the seconds to reload the circuit data,
where the proof came from, and the card's name and power limit from
nvidia-smi.  A proof that does not verify ends the run with an error
and no line.  ``--device cpu`` proves on the
CPU, for tests only, and the record says so.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import time
from pathlib import Path

METRIC = "verifier_verify_proof"


def run(runs: int, device, proof_file: str | None = None) -> dict:
    from ..models.wormhole.circuit import WormholeCircuit
    from ..models.wormhole.fixtures import WORMHOLE_ZK_PROOF_SHA256, synthetic_circuit_inputs
    from ..models.wormhole.prover import WormholeProver
    from ..models.wormhole.verifier import WormholeVerifier
    from ..plonk.config import CircuitConfig
    from ..plonk.proof import ProofWithPublicInputs
    from ..utils import serialization as ser
    from .kernels import card

    cfg = CircuitConfig.standard_recursion_zk_config()
    circuit = WormholeCircuit(cfg)
    targets = circuit.targets()
    data = circuit.build_circuit()
    common_bytes = ser.common_to_bytes(data.common)
    verifier_bytes = ser.verifier_only_to_bytes(data.verifier_only)
    t0 = time.perf_counter()
    verifier = WormholeVerifier.new_from_bytes(verifier_bytes, common_bytes)
    load_s = time.perf_counter() - t0

    if proof_file is None:
        prover = WormholeProver(cfg, _circuit_data=data.prover_data(), _targets=targets,
                                device=device)
        proof = prover.commit(synthetic_circuit_inputs()).prove()
        source = f"proved on {device}"
    else:
        proof = ProofWithPublicInputs.from_bytes(
            Path(proof_file).read_bytes(), verifier.circuit_data.common)
        source = str(proof_file)
    digest = hashlib.sha256(proof.to_bytes()).hexdigest()
    if digest != WORMHOLE_ZK_PROOF_SHA256:
        raise RuntimeError(f"proof sha256 {digest} != the JAX package's {WORMHOLE_ZK_PROOF_SHA256}")

    verifier.verify(proof)  # warm-up and correctness
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        verifier.verify(proof)
        times.append(time.perf_counter() - t0)
    where = card() if device.type == "cuda" else {"card": "cpu", "power_limit": None}
    return {
        "metric": METRIC, "value": min(times), "unit": "s", "median_s": statistics.median(times),
        "runs_s": times, "circuit_load_s": load_s, "common_bytes": len(common_bytes),
        "verifier_bytes": len(verifier_bytes), "config": "zk",
        "degree_bits": data.common.degree_bits, "proof": source, "sha256": digest,
        "clock": "host", "device": str(device), **where,
    }


def main(argv=None) -> None:
    from ..utils.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--proof-file", default=None,
                    help="read the zk proof from this file in place of proving it")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.runs, resolve_device(args.device), args.proof_file)), flush=True)


if __name__ == "__main__":
    main()

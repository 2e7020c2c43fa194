"""The port's counterpart of the repository's headline benchmark
(bench.py): warm commit + prove of the Wormhole circuit under
``CircuitConfig.standard_recursion_zk_config()`` from
``synthetic_circuit_inputs()``, on one card.

    python3 -m qzk_tpu_torch.benches.prove [--runs 5] [--device cpu]

Builds the circuit (timed once, as ``build_s``), proves once to warm
up, then times `runs` warm commit + prove calls, each on the host clock
between two ``torch.cuda.synchronize()``.  Prints one JSON line: the
median and least seconds, every run, the config, the proof's sha256,
and the card's name and power limit from nvidia-smi.  A proof whose
sha256 is not the JAX package's (``WORMHOLE_ZK_PROOF_SHA256``), or that
does not verify, ends the run with an error and no line.
``--device cpu`` runs the plain torch path on the CPU, for tests only:
its seconds are the CPU's, and the record says so (``"device": "cpu"``,
``"card": "cpu"``).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import time

import torch

METRIC = "wormhole_prove_wall_clock"


def time_proves(prove_once, device: torch.device, runs: int = 5) -> dict:
    """One warm-up call of prove_once(), then `runs` timed calls, each
    between two synchronizes of `device`.  Returns the seconds and the
    last proof's sha256 (the proof itself under "proof")."""

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    proof = prove_once()
    times = []
    for _ in range(runs):
        sync()
        t0 = time.perf_counter()
        proof = prove_once()
        sync()
        times.append(time.perf_counter() - t0)
    return {
        "median_s": statistics.median(times),
        "min_s": min(times),
        "runs_s": times,
        "sha256": hashlib.sha256(proof.to_bytes()).hexdigest(),
        "proof": proof,
    }


def run(runs: int, device: torch.device) -> dict:
    from ..models.wormhole.circuit import WormholeCircuit
    from ..models.wormhole.fixtures import (
        WORMHOLE_ZK_PROOF_SHA256,
        synthetic_circuit_inputs,
    )
    from ..models.wormhole.prover import WormholeProver
    from ..models.wormhole.verifier import WormholeVerifier
    from ..plonk.config import CircuitConfig
    from .kernels import card

    cfg = CircuitConfig.standard_recursion_zk_config()
    t0 = time.perf_counter()
    circuit = WormholeCircuit(cfg)
    targets = circuit.targets()
    data = circuit.build_circuit()
    build_s = time.perf_counter() - t0

    def prove_once():
        prover = WormholeProver(cfg, _circuit_data=data.prover_data(),
                                _targets=targets, device=device)
        return prover.commit(synthetic_circuit_inputs()).prove()

    rec = time_proves(prove_once, device, runs)
    if rec["sha256"] != WORMHOLE_ZK_PROOF_SHA256:
        raise RuntimeError(
            f"proof sha256 {rec['sha256']} != the JAX package's {WORMHOLE_ZK_PROOF_SHA256}")
    WormholeVerifier.new(cfg, data.verifier_data()).verify(rec.pop("proof"))
    where = card() if device.type == "cuda" else {"card": "cpu", "power_limit": None}
    return {
        "metric": METRIC, "scope": "commit+prove (warm)", "config": "zk",
        "degree_bits": data.common.degree_bits, "build_s": build_s, **rec,
        "device": str(device), **where,
    }


def main(argv=None) -> None:
    from ..utils.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.runs, resolve_device(args.device))), flush=True)


if __name__ == "__main__":
    main()

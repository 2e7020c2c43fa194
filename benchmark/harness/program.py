"""What the benchmark takes from the program under test (qzk_tpu_torch):
the Wormhole circuit, from its artifacts when the benchmark's cache holds
them (as a prover service restarts), the prover and aggregator calls
that the window drives, and the key bytes that the reference holds to
its own."""

from __future__ import annotations

import hashlib
import json
import os


def circuit_config(numbers: dict):
    """The program's CircuitConfig of a configuration file's numbers."""
    from qzk_tpu_torch.plonk.config import CircuitConfig, FriConfig

    fri = FriConfig(rate_bits=numbers["rate_bits"], cap_height=numbers["cap_height"],
                    proof_of_work_bits=numbers["proof_of_work_bits"],
                    num_query_rounds=numbers["num_query_rounds"],
                    arity_bits=numbers["arity_bits"],
                    final_poly_bits=numbers["final_poly_bits"])
    return CircuitConfig(num_wires=numbers["num_wires"],
                         num_routed_wires=numbers["num_routed_wires"],
                         num_constants=numbers["num_constants"],
                         security_bits=numbers["security_bits"],
                         num_challenges=numbers["num_challenges"],
                         zero_knowledge=numbers["zero_knowledge"],
                         max_quotient_degree_factor=numbers["max_quotient_degree_factor"],
                         fri_config=fri)


class Wormhole:
    """The Wormhole circuit of `numbers`: its circuit data (loaded from
    <cache>/wormhole_<hash of the numbers>.bin, else built and written
    there) and its targets."""

    def __init__(self, numbers: dict, cache_dir: str):
        from qzk_tpu_torch.models.wormhole.circuit import WormholeCircuit
        from qzk_tpu_torch.utils import serialization as ser

        self.config = circuit_config(numbers)
        tag = hashlib.sha256(json.dumps(numbers, sort_keys=True).encode()).hexdigest()[:16]
        path = os.path.join(cache_dir, f"wormhole_{tag}.bin")
        circuit = WormholeCircuit(self.config)
        self.targets = circuit.targets()
        if os.path.exists(path):
            with open(path, "rb") as f:
                self.data = ser.circuit_data_from_bytes(f.read())
        else:
            self.data = circuit.build_circuit()
            os.makedirs(cache_dir, exist_ok=True)
            with open(path + ".part", "wb") as f:
                f.write(ser.circuit_data_to_bytes(self.data))
            os.replace(path + ".part", path)
        self.prover_data = self.data.prover_data()

    def prove(self, inputs, device, marks=None):
        """One commit + prove through WormholeProver; the proof object."""
        from qzk_tpu_torch.models.wormhole.prover import WormholeProver

        prover = WormholeProver(self.config, _circuit_data=self.prover_data,
                                _targets=self.targets, device=device)
        return prover.commit(inputs).prove(timer=marks)


def key_bytes(common, verifier_only) -> dict:
    """The program's key of a circuit as bytes: {"common", "verifier"} in hex."""
    from qzk_tpu_torch.utils import serialization as ser

    return {"common": ser.common_to_bytes(common).hex(),
            "verifier": ser.verifier_only_to_bytes(verifier_only).hex()}


def circuit_inputs(w):
    """The program's CircuitInputs of a reference.withdrawal.Withdrawal."""
    from qzk_tpu_torch.models.wormhole.inputs import (CircuitInputs, PrivateCircuitInputs,
                                                      PublicCircuitInputs)
    from qzk_tpu_torch.models.wormhole.storage_proof import ProcessedStorageProof
    from qzk_tpu_torch.utils.codec import BytesDigest

    return CircuitInputs(
        public=PublicCircuitInputs(
            funding_amount=w.funding_amount,
            nullifier=BytesDigest(w.public_inputs[0:4].astype("<u8").tobytes()),
            root_hash=BytesDigest(w.root_hash),
            exit_account=BytesDigest(w.exit_account)),
        private=PrivateCircuitInputs(
            secret=w.secret,
            storage_proof=ProcessedStorageProof(proof=list(w.nodes), indices=list(w.indices)),
            transfer_count=w.transfer_count,
            funding_account=BytesDigest(w.funding_account),
            unspendable_account=BytesDigest(w.unspendable_account)))

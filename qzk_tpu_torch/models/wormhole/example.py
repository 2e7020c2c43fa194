"""End-to-end Wormhole demo (parity with the reference's example binary:
reference wormhole/example/src/main.rs:13-73), the JAX package's
qzk_tpu/models/wormhole/example.py on the port.

Uses an EMPTY storage proof: the public root_hash is set directly to
H(leaf_inputs) (main.rs:24-30), so the trie walk degenerates to the
leaf check at node 0.  Proves, parses the public inputs back, verifies,
and writes the hex-encoded proof to `proof_from_bins.hex`.  Proves on
CUDA unless `main` is given device="cpu".

Run:  python -m qzk_tpu_torch.models.wormhole.example
"""

from __future__ import annotations

from pathlib import Path

from ...ops import poseidon
from ...plonk.config import CircuitConfig
from ...utils import codec
from .circuit import WormholeCircuit
from .inputs import CircuitInputs, PrivateCircuitInputs, PublicCircuitInputs
from .nullifier import Nullifier
from .prover import WormholeProver
from .storage_proof import LeafInputs, ProcessedStorageProof
from .unspendable_account import UnspendableAccount
from .verifier import WormholeVerifier

EXAMPLE_SECRET = bytes(range(32))
EXAMPLE_TRANSFER_COUNT = 1
EXAMPLE_FUNDING_ACCOUNT = bytes([7] * 32)
EXAMPLE_FUNDING_AMOUNT = 10**12
EXAMPLE_EXIT_ACCOUNT = bytes([4] * 32)


def build_example_inputs() -> CircuitInputs:
    nullifier = Nullifier.from_preimage(
        EXAMPLE_SECRET, EXAMPLE_TRANSFER_COUNT
    )
    unspendable = UnspendableAccount.from_secret(EXAMPLE_SECRET)
    to_account = codec.BytesDigest.from_felts(unspendable.account_id)
    leaf_inputs = LeafInputs.new(
        EXAMPLE_TRANSFER_COUNT,
        codec.BytesDigest(EXAMPLE_FUNDING_ACCOUNT),
        to_account,
        EXAMPLE_FUNDING_AMOUNT,
    )
    leaf_hash = poseidon.hash_no_pad(leaf_inputs.to_vec())
    root_bytes = b"".join(
        int(x).to_bytes(8, "little") for x in leaf_hash
    )
    return CircuitInputs(
        public=PublicCircuitInputs(
            funding_amount=EXAMPLE_FUNDING_AMOUNT,
            nullifier=codec.BytesDigest.from_felts(nullifier.hash),
            root_hash=codec.BytesDigest(root_bytes),
            exit_account=codec.BytesDigest(EXAMPLE_EXIT_ACCOUNT),
        ),
        private=PrivateCircuitInputs(
            secret=EXAMPLE_SECRET,
            storage_proof=ProcessedStorageProof(proof=[], indices=[]),
            transfer_count=EXAMPLE_TRANSFER_COUNT,
            funding_account=codec.BytesDigest(EXAMPLE_FUNDING_ACCOUNT),
            unspendable_account=to_account,
        ),
    )


def main(device=None) -> None:
    cfg = CircuitConfig.standard_recursion_config()
    circuit = WormholeCircuit(cfg)
    targets = circuit.targets()
    data = circuit.build_circuit()
    prover = WormholeProver(
        cfg, device=device, _circuit_data=data.prover_data(), _targets=targets
    )
    inputs = build_example_inputs()
    proof = prover.commit(inputs).prove()

    parsed = PublicCircuitInputs.try_from_proof(proof)
    print("public inputs:", parsed)
    assert parsed.funding_amount == EXAMPLE_FUNDING_AMOUNT

    verifier = WormholeVerifier.new(cfg, data.verifier_data())
    verifier.verify(proof)
    print("proof verified")

    out = Path("proof_from_bins.hex")
    out.write_text(proof.to_bytes().hex())
    print(f"wrote {out} ({out.stat().st_size} bytes)")


if __name__ == "__main__":
    main()

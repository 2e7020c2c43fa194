"""Circuit inputs + the public-input ABI.

Public-input layout (16 felts; index constants mirror
reference wormhole/circuit/src/inputs.rs:12-19, LEAF_PI_LEN=16 at
:92 — note the reference's PUBLIC_INPUTS_FELTS_LEN=14 constant is stale,
SURVEY.md §7 pitfalls):
    nullifier[0..4], root_hash[4..8], funding_amount[8..12],
    exit_account[12..16]
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ...utils import codec
from .storage_proof import ProcessedStorageProof

PUBLIC_INPUTS_FELTS_LEN = 16
NULLIFIER_START_INDEX = 0
NULLIFIER_END_INDEX = 4
ROOT_HASH_START_INDEX = 4
ROOT_HASH_END_INDEX = 8
FUNDING_AMOUNT_START_INDEX = 8
FUNDING_AMOUNT_END_INDEX = 12
EXIT_ACCOUNT_START_INDEX = 12
EXIT_ACCOUNT_END_INDEX = 16

LEAF_PI_LEN = 16


@dataclass(frozen=True)
class PublicCircuitInputs:
    funding_amount: int  # u128
    nullifier: codec.BytesDigest
    root_hash: codec.BytesDigest
    exit_account: codec.BytesDigest

    @classmethod
    def try_from_slice(cls, pis) -> "PublicCircuitInputs":
        pis = np.asarray(pis, dtype=np.uint64)
        if len(pis) != LEAF_PI_LEN:
            raise ValueError(
                f"public inputs should contain: {LEAF_PI_LEN} field "
                f"elements, got: {len(pis)}"
            )
        nullifier = codec.BytesDigest.from_felts(
            pis[NULLIFIER_START_INDEX:NULLIFIER_END_INDEX]
        )
        root_hash = codec.BytesDigest.from_felts(
            pis[ROOT_HASH_START_INDEX:ROOT_HASH_END_INDEX]
        )
        funding_amount = codec.felts_to_u128(
            pis[FUNDING_AMOUNT_START_INDEX:FUNDING_AMOUNT_END_INDEX]
        )
        exit_account = codec.BytesDigest.from_felts(
            pis[EXIT_ACCOUNT_START_INDEX:EXIT_ACCOUNT_END_INDEX]
        )
        return cls(
            funding_amount=funding_amount,
            nullifier=nullifier,
            root_hash=root_hash,
            exit_account=exit_account,
        )

    @classmethod
    def try_from_proof(cls, proof) -> "PublicCircuitInputs":
        return cls.try_from_slice(proof.public_inputs)

    @classmethod
    def try_from_aggregated(
        cls, aggregated_proof, leaf_pi_len: int, num_leaves: int
    ) -> list:
        """Parse per-leaf public inputs from an aggregation-root proof
        (inputs.rs:61-89)."""
        pis = np.asarray(aggregated_proof.public_inputs, dtype=np.uint64)
        expected = leaf_pi_len * num_leaves
        if len(pis) != expected:
            raise ValueError(
                f"aggregated public inputs should contain: {expected} "
                f"(= {num_leaves} leaves x {leaf_pi_len} fields), got: "
                f"{len(pis)}"
            )
        return [
            cls.try_from_slice(pis[i * leaf_pi_len : (i + 1) * leaf_pi_len])
            for i in range(num_leaves)
        ]


@dataclass
class TransferProofJson:
    """JSON schema for node-fetched storage proofs (parity with
    reference common/src/circuit.rs:15-21: transfer_count,
    state_root, storage_proof, indices).  This is the interchange format
    the quantus-api-client emits for live-chain transfers (reference
    e2e fuzz tier, SURVEY.md §4 tier 3)."""

    transfer_count: int
    state_root: str  # hex (0x-prefixed or bare)
    storage_proof: list  # list[str], hex-encoded nodes
    indices: list  # list[int], hex-char offsets of child hashes

    @classmethod
    def from_json(cls, text: str) -> "TransferProofJson":
        import json

        d = json.loads(text)
        return cls(
            transfer_count=int(d["transfer_count"]),
            state_root=d["state_root"],
            storage_proof=list(d["storage_proof"]),
            indices=[int(i) for i in d["indices"]],
        )

    def to_json(self) -> str:
        import json

        return json.dumps(
            {
                "transfer_count": self.transfer_count,
                "state_root": self.state_root,
                "storage_proof": list(self.storage_proof),
                "indices": list(self.indices),
            }
        )

    def root_hash_bytes(self) -> bytes:
        s = self.state_root
        if s.startswith("0x"):
            s = s[2:]
        return bytes.fromhex(s)

    def to_processed(self) -> ProcessedStorageProof:
        return ProcessedStorageProof(
            proof=[
                bytes.fromhex(n[2:] if n.startswith("0x") else n)
                for n in self.storage_proof
            ],
            indices=list(self.indices),
        )


@dataclass
class PrivateCircuitInputs:
    secret: bytes  # 32 bytes
    storage_proof: ProcessedStorageProof
    transfer_count: int
    funding_account: codec.BytesDigest
    unspendable_account: codec.BytesDigest


@dataclass
class CircuitInputs:
    public: PublicCircuitInputs
    private: PrivateCircuitInputs

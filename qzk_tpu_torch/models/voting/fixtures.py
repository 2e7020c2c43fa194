"""Voting inputs for the port's own runs: a copy of the JAX package's
``create_test_inputs`` test helper (tests/test_voting.py; the card has
no JAX, so the port keeps its own), the circuit build, and the sha256
of the proof bytes that the JAX package's prover gives for those inputs
under each config, which tests/test_torch_voting.py pins against
qzk_tpu and chip_smoke.py demands of the port's proofs on the card.
"""

from __future__ import annotations

import numpy as np

from ...ops import poseidon
from ...plonk.builder import CircuitBuilder
from ...plonk.config import CircuitConfig
from ...utils import codec
from .circuit import (
    VoteCircuitData,
    VotePrivateInputs,
    VotePublicInputs,
    VoteTargets,
)

VOTING_NONZK_PROOF_SHA256 = (
    "f96bb165ffebc757bd680ecb315f61f208f411568221007aacb24b0091d9ad33"
)
VOTING_ZK_PROOF_SHA256 = (
    "93a678e726f9a66e265947c48c04f0a32a085a36df6a87534aff31641bb81ffe"
)


def build_vote_circuit(config: CircuitConfig):
    """(CircuitData, VoteTargets) of the voting circuit under `config`."""
    builder = CircuitBuilder(config)
    targets = VoteTargets.new(builder)
    VoteCircuitData.circuit(targets, builder)
    return builder.build(), targets


def compute_nullifier(private_key, proposal_id):
    pk_hash = poseidon.hash_no_pad(private_key)
    return poseidon.hash_no_pad(np.concatenate([pk_hash, proposal_id]))


def create_test_inputs() -> VoteCircuitData:
    """A depth-2 membership proof of the first of four keys in a
    four-leaf tree, voting yes on proposal [42] * 32."""
    keys = [codec.BytesDigest(bytes([i] * 32)) for i in range(1, 5)]
    leaves = [
        poseidon.hash_no_pad(codec.digest_bytes_to_felts(k)) for k in keys
    ]
    level1 = [
        poseidon.hash_no_pad(np.concatenate([leaves[0], leaves[1]])),
        poseidon.hash_no_pad(np.concatenate([leaves[2], leaves[3]])),
    ]
    root = poseidon.hash_no_pad(np.concatenate([level1[0], level1[1]]))

    voter_key = codec.digest_bytes_to_felts(keys[0])
    proposal_id = codec.digest_bytes_to_felts(
        codec.BytesDigest(bytes([42] * 32))
    )
    return VoteCircuitData(
        public_inputs=VotePublicInputs(
            proposal_id=proposal_id,
            merkle_root=root,
            vote=True,
            nullifier=compute_nullifier(voter_key, proposal_id),
        ),
        private_inputs=VotePrivateInputs(
            private_key=voter_key,
            merkle_siblings=[leaves[1], level1[1]],
            path_indices=[False, False],
            actual_merkle_depth=2,
        ),
    )

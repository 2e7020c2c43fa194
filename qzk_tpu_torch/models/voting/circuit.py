"""Anonymous voting circuit: Merkle-membership proof of H(private_key)
in a Poseidon Merkle tree (depth <= 32, variable actual depth) plus a
double-vote nullifier H(H(pk) || proposal_id).  A line-for-line copy of
the JAX package's qzk_tpu/models/voting/circuit.py on the port's builder.

Semantics parity: reference voting/src/lib.rs (public inputs in
order proposal_id[4], merkle_root[4], vote[1], nullifier[4] :70-98;
variable-depth path walk with select-based left/right ordering :123-197;
witness fill with ZERO_DIGEST padding above actual depth :199-259).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ...plonk.builder import BoolTarget, CircuitBuilder, HashOutTarget
from ...plonk.gadgets import is_const_less_than
from ...utils.codec import ZERO_DIGEST

MAX_MERKLE_DEPTH = 32


@dataclass
class VotePublicInputs:
    proposal_id: np.ndarray  # (4,)
    merkle_root: np.ndarray  # (4,)
    vote: bool
    nullifier: np.ndarray  # (4,)


@dataclass
class VotePrivateInputs:
    private_key: np.ndarray  # (4,)
    merkle_siblings: list  # list[(4,)]
    path_indices: list  # list[bool]
    actual_merkle_depth: int


@dataclass
class VoteTargets:
    proposal_id: HashOutTarget
    expected_merkle_root: HashOutTarget
    vote: BoolTarget
    expected_nullifier: HashOutTarget
    private_key: HashOutTarget
    merkle_siblings: list
    path_indices: list
    actual_merkle_depth: int  # target

    @classmethod
    def new(cls, builder: CircuitBuilder) -> "VoteTargets":
        proposal_id = builder.add_virtual_hash_public_input()
        expected_merkle_root = builder.add_virtual_hash_public_input()
        vote = builder.add_virtual_bool_target_safe()
        builder.register_public_input(vote.target)
        expected_nullifier = builder.add_virtual_hash_public_input()
        return cls(
            proposal_id=proposal_id,
            expected_merkle_root=expected_merkle_root,
            vote=vote,
            expected_nullifier=expected_nullifier,
            private_key=builder.add_virtual_hash(),
            merkle_siblings=[
                builder.add_virtual_hash() for _ in range(MAX_MERKLE_DEPTH)
            ],
            path_indices=[
                builder.add_virtual_bool_target_safe()
                for _ in range(MAX_MERKLE_DEPTH)
            ],
            actual_merkle_depth=builder.add_virtual_target(),
        )


@dataclass
class VoteCircuitData:
    public_inputs: VotePublicInputs
    private_inputs: VotePrivateInputs

    @staticmethod
    def circuit(targets: VoteTargets, builder: CircuitBuilder) -> None:
        """lib.rs:123-197."""
        leaf_hash = builder.hash_n_to_hash_no_pad(
            list(targets.private_key.elements)
        )
        current = leaf_hash
        n_log = (MAX_MERKLE_DEPTH - 1).bit_length()
        for i in range(MAX_MERKLE_DEPTH):
            is_active = is_const_less_than(
                builder, i, targets.actual_merkle_depth, n_log
            )
            sibling = targets.merkle_siblings[i]
            path_bit = targets.path_indices[i]

            left = [
                builder.select(path_bit, sibling.elements[k], current.elements[k])
                for k in range(4)
            ]
            right = [
                builder.select(path_bit, current.elements[k], sibling.elements[k])
                for k in range(4)
            ]
            parent = builder.hash_n_to_hash_no_pad(left + right)
            nxt = [
                builder.select(
                    is_active, parent.elements[k], current.elements[k]
                )
                for k in range(4)
            ]
            current = HashOutTarget.from_list(nxt)

        builder.connect_hashes(current, targets.expected_merkle_root)

        nullifier_inputs = list(leaf_hash.elements) + list(
            targets.proposal_id.elements
        )
        computed_nullifier = builder.hash_n_to_hash_no_pad(nullifier_inputs)
        builder.connect_hashes(
            computed_nullifier, targets.expected_nullifier
        )

    def fill_targets(self, pw, targets: VoteTargets) -> None:
        """lib.rs:199-259."""
        priv = self.private_inputs
        if priv.actual_merkle_depth > MAX_MERKLE_DEPTH:
            raise ValueError(
                f"Merkle tree depth {priv.actual_merkle_depth} exceeds "
                f"maximum allowed depth {MAX_MERKLE_DEPTH}"
            )
        if len(priv.merkle_siblings) != len(priv.path_indices):
            raise ValueError(
                f"Merkle proof length mismatch: {len(priv.merkle_siblings)} "
                f"siblings vs {len(priv.path_indices)} path indices"
            )
        pub = self.public_inputs
        pw.set_hash_target(targets.proposal_id, pub.proposal_id)
        pw.set_hash_target(targets.expected_merkle_root, pub.merkle_root)
        pw.set_bool_target(targets.vote, pub.vote)
        pw.set_hash_target(targets.expected_nullifier, pub.nullifier)
        pw.set_hash_target(targets.private_key, priv.private_key)
        pw.set_target(targets.actual_merkle_depth, priv.actual_merkle_depth)
        for i in range(MAX_MERKLE_DEPTH):
            if i < priv.actual_merkle_depth:
                pw.set_hash_target(
                    targets.merkle_siblings[i], priv.merkle_siblings[i]
                )
                pw.set_bool_target(
                    targets.path_indices[i], priv.path_indices[i]
                )
            else:
                pw.set_hash_target(targets.merkle_siblings[i], ZERO_DIGEST)
                pw.set_bool_target(targets.path_indices[i], False)

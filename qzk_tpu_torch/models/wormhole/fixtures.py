"""Wormhole inputs for the port's own runs: the reference's test-helpers
defaults (reference wormhole/tests/test-helpers/src/lib.rs:10-80) and
``synthetic_circuit_inputs``, a copy of the JAX package's test fixture
of that name (the card has no JAX, so the port keeps its own).

``WORMHOLE_NONZK_PROOF_SHA256`` and ``WORMHOLE_ZK_PROOF_SHA256`` are the
sha256 of the proof bytes that the JAX package's prover gives for
``synthetic_circuit_inputs()`` under
``CircuitConfig.standard_recursion_config()`` and
``standard_recursion_zk_config()``; tests/test_torch_wormhole.py and
tests/test_torch_zk.py pin them against qzk_tpu.

The aggregation pins, each the sha256 of the JAX package's proof:
``SQUARE_CHUNK_PROOF_SHA256``, of the branching-1 chunk proof
(``build_chunk_circuit(square.common, 1)``) over the square circuit's
proof at x = 5, under ``standard_recursion_config()``
(tests/test_torch_recursion.py); ``AGG_2_1_ZK_ROOT_SHA256``, of the root
of ``aggregate_to_tree`` over the two zk Wormhole proofs of
``aggregation_leaf_inputs()`` as a (2, 1) tree
(tests/test_torch_aggregate_pin.py).

The artifact pins: ``WORMHOLE_COMMON_BIN_SHA256`` and
``WORMHOLE_VERIFIER_BIN_SHA256``, of the common.bin and verifier.bin
that the JAX package's ``generate_circuit_binaries`` writes (the
Wormhole under ``standard_recursion_config()``;
tests/test_torch_serialization.py); ``WORMHOLE_ZK_P2_PROOF_SHA256``, of
the JAX package's ``write_proof(proof_to_p2(proof, common), ...)`` of
the zk Wormhole proof above in the qp-plonky2 byte format
(tests/test_torch_zk.py).
"""

import dataclasses

from .inputs import (
    CircuitInputs,
    PrivateCircuitInputs,
    PublicCircuitInputs,
)
from .nullifier import Nullifier
from .storage_proof import ProcessedStorageProof
from .unspendable_account import UnspendableAccount
from ...utils import codec

WORMHOLE_NONZK_PROOF_SHA256 = (
    "67129ba1b560dfc4900eed96c47cd1cd63c2c47239219d286a376fcb3a020184"
)
WORMHOLE_ZK_PROOF_SHA256 = (
    "2a1e822d7e5bb966976f19de117a9b82f5ae47c5465705216c526f48cee518f9"
)
SQUARE_CHUNK_PROOF_SHA256 = (
    "f254d26c3562d7e9cf52088969392f35844f12f34fb22e223a02a8966d58473c"
)
AGG_2_1_ZK_ROOT_SHA256 = (
    "a64855c51ea85e79cab855cf46c990c9233dc474bdbcaf0e5b705fa14496cfec"
)
WORMHOLE_COMMON_BIN_SHA256 = (
    "8468ed25d14547ceda071f5c243c6ca9d0aa007e84cc87664023a22dc7df5a51"
)
WORMHOLE_VERIFIER_BIN_SHA256 = (
    "92a22c05785a71f8a351aecb1f02204af0b6574062b7a9f2828476f1da234f73"
)
WORMHOLE_ZK_P2_PROOF_SHA256 = (
    "7e8259f8e3de38c9227e8afdb9544bf324737563eb79632f95d65a3a2b90e6d9"
)

DEFAULT_SECRET = (
    "4c8587bd422e01d961acdc75e7d66f6761b7af7c9b1864a492f369c9d6724f05"
)
DEFAULT_TRANSFER_COUNT = 4
DEFAULT_FUNDING_ACCOUNT = bytes(
    [226, 124, 203, 9, 80, 60, 124, 205, 165, 5, 178, 216, 195, 15, 149, 38,
     116, 1, 238, 133, 181, 154, 106, 17, 41, 228, 118, 179, 82, 141, 225, 76]
)
DEFAULT_FUNDING_AMOUNT = int.from_bytes(
    bytes([0, 16, 165, 212, 232, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0]), "little"
)
DEFAULT_TO_ACCOUNT = bytes(
    [162, 77, 187, 9, 249, 178, 185, 87, 194, 50, 198, 98, 179, 134, 179,
     126, 123, 21, 247, 44, 50, 216, 140, 243, 97, 177, 13, 94, 26, 255, 19,
     170]
)
DEFAULT_EXIT_ACCOUNT = bytes([4] * 32)

DEFAULT_ROOT_HASH = (
    "5ffa2ab5b0db9883b22b1e5810932ea9d9eab1840730fd39ace71c26bb8d082d"
)

DEFAULT_STORAGE_PROOF = [
    "0000000000000020bfb500000000000020000000000000005d7c4eb0b2a8bb01872f88950f8c736fc72a250c32b4bdad9a50e7b5163a27aa20000000000000008f6440ed6cd23d75bfdd64b70ec7b0c969bd03e53f9fc1df688f8538dad89f402000000000000000545576a55a3f69e109b776d252064d3c9bf2fd3a0cd0447c8d82ec12b0343f3a20000000000000000f3ed746dd90e0e2a0d3f8faf0b8a41d5fafd9edcbc88630e389f2db76dd44b7200000000000000091c3eead5530405e48b8df6453a60be878eb1fa46c2a95638cdec8c8d722b46020000000000000008475575039b5b19da2901935792d5b1d5f9a09e08065e4d27a438329710120002000000000000000e6f538f42cbc6e72d6a302a648da34c475bcfa104e7cb80625fcf3219bd12172200000000000000056c6d22ef15fbb6005782db4c357b38cb53f5d39e5d8abdb3efffaec0537381420000000000000007f7b9a72037f9305f49bb2c25aa2f2c0108753ae606e1f094e887071e2596cfb2000000000000000805a0b660043743ecac1396810e2c3664e5f6bd54890cfc4eb04d914a38a32ba2000000000000000a22c86fb54dbd5c704fc4d849c715109d7cb3167b0eb2ed270ca658bd9dcca2a20000000000000003687179c5ce1cb12b50e50d421bcbdceb82ec583de7585fb7898e167108168b5",
    "000000000000002004100000000000002000000000000000508b02bea5f6ec0560cb2cbfda44d44ee4ea671f5f3cbb5d27b90e6afcafa1f32000000000000000b7361080961b2d3b348d96affbf10c7ee2d6416efa14b524289e264863a270b6",
    "1e00000000000020261276cc9d1f8598ea4b6a74b15c2f003280000000000000200000000000000036eed7029a2181549ea0a84a554dd682b0184a06f1c56a53ebf70c127123252920000000000000001961560d112cfd667e09610793793d3fc2ee32eb87171773c2e4c6e1473f400b2000000000000000b5e25bb2727a369c7a991e657eb15e8a578a30b89088ba5cf5c588deaee3a9f5200000000000000016b14e363d6ed03d0f13adc683dab364d051a8394db2f605adfe69d0ef5dd78a",
    "000000000000002084000000000000002000000000000000c58635f106880ea6ac74b554a030a74e08587a15fe9cca1117415c1f086613e62000000000000000abf9dfa05f2adc8c6b9447a6dae41d898ac8d77d683c8fe8c9a563a0cd05e0d7",
    "1e00000000000020857e7ea49e785c4e3e1f77a710cfc20085eb00000000000020000000000000007f6a20004a9e9c8534de8e4a017e3795c9d8a30e036108eb593d2ac31f6a34e42000000000000000baf5a768ed92d1ac1cead4bcee891151641cfb6b109c9b6075952a36e5808dfc20000000000000006e19211b4ff0a3feb43b34373129676d22378dfe1303191a96b34012713b65832000000000000000f6885f81a0d9ee08a3a67c4f2ef71a2ec725c8a9c79599eb975c2319e4aae5e920000000000000008d4b3c32ff1324fe3b7a05467e88e9f69b0df523bc3b6fbfdc888f06401bc9e72000000000000000ea72cebf4e99ec5a02713c47fa3198ea718fabce8eaf27707c3ec03eafa34174200000000000000077c5198a04b75c9795fe20a45d68df141ef53182a243c6102607da94ee03a9a82000000000000000ee55785e535fe32542b8b7f8537d8f921df34012c8f8dfd97087159ac05b99d1200000000000000013da88523a40420379a2776f484740dd9e78e858b11c7f43d5db16dc923b5e71",
    "0000000000000020a0000000000000002000000000000000439f73a9fe5a17162de32efd7abca06f0c880dc966613afdcf1ab350e1619c4a2000000000000000797b157cc18a8d60054cf9e008630ef8642b335fe0869a9796b5feb0f464ff4b",
    "3e0000000000003000e339aa4f999f6414fef6d1a1eae663e1cbc7ba7fe5fd365ea504b46241cddf0000000000000000",
]
DEFAULT_STORAGE_PROOF_INDICES = [768, 48, 240, 48, 160, 128, 16]


def synthesize_storage_proof():
    """Rebuild the captured 7-node proof's embedded child hashes
    bottom-up under THIS framework's Poseidon table, preserving the
    exact node structure, sizes and hash indices of the reference
    fixture (test-helpers/src/lib.rs:68-80).

    NOT byte-identical to the raw captured fixture: element 0 of the
    embedded leaf digest (the "first nibble" element the circuit never
    checks, storage_proof/mod.rs:232-240) differs by construction and
    cascades through every parent node.  It is an independent
    construction check of
    the chain structure: node[i] embeds H(pad188(felts(node[i+1]))) at
    byte offset indices[i]/2, the leaf node embeds H(leaf_inputs), and
    the root is H(pad188(node[0])).

    Returns (processed_proof, root_hash_bytes, leaf_inputs_hash).
    """
    import numpy as np

    from ...ops import poseidon
    from .storage_proof import PROOF_NODE_MAX_SIZE_F, LeafInputs

    def node_hash(node_bytes: bytes) -> np.ndarray:
        felts = codec.injective_bytes_to_felts(node_bytes)
        padded = np.zeros(PROOF_NODE_MAX_SIZE_F, dtype=np.uint64)
        padded[: len(felts)] = felts
        return poseidon.hash_no_pad(padded)

    def digest_to_bytes(d: np.ndarray) -> bytes:
        return b"".join(int(x).to_bytes(8, "little") for x in d)

    nodes = [bytearray(bytes.fromhex(n)) for n in DEFAULT_STORAGE_PROOF]
    indices = list(DEFAULT_STORAGE_PROOF_INDICES)

    leaf_inputs = LeafInputs.new(
        DEFAULT_TRANSFER_COUNT,
        codec.BytesDigest(DEFAULT_FUNDING_ACCOUNT),
        _default_unspendable_digest(),
        DEFAULT_FUNDING_AMOUNT,
    )
    leaf_hash = poseidon.hash_no_pad(leaf_inputs.to_vec())

    # leaf node (last) embeds H(leaf_inputs) at its index
    last = len(nodes) - 1
    off = indices[last] // 2
    nodes[last][off : off + 32] = digest_to_bytes(leaf_hash)
    # interior nodes embed H(child node) bottom-up
    for i in range(last - 1, -1, -1):
        child_hash = node_hash(bytes(nodes[i + 1]))
        off = indices[i] // 2
        nodes[i][off : off + 32] = digest_to_bytes(child_hash)
    root_hash = digest_to_bytes(node_hash(bytes(nodes[0])))

    processed = ProcessedStorageProof(
        proof=[bytes(n) for n in nodes], indices=indices
    )
    return processed, root_hash, leaf_hash


def _default_unspendable_digest() -> codec.BytesDigest:
    secret = bytes.fromhex(DEFAULT_SECRET)
    unspendable = UnspendableAccount.from_secret(secret)
    return codec.BytesDigest.from_felts(unspendable.account_id)


def synthetic_circuit_inputs() -> CircuitInputs:
    """Complete wormhole CircuitInputs over the synthesized proof —
    the full 7-node storage-proof walk, provable under this
    framework's Poseidon table."""
    secret = bytes.fromhex(DEFAULT_SECRET)
    nullifier = Nullifier.from_preimage(secret, DEFAULT_TRANSFER_COUNT)
    processed, root_hash, _ = synthesize_storage_proof()
    return CircuitInputs(
        public=PublicCircuitInputs(
            funding_amount=DEFAULT_FUNDING_AMOUNT,
            nullifier=codec.BytesDigest.from_felts(nullifier.hash),
            root_hash=codec.BytesDigest(root_hash),
            exit_account=codec.BytesDigest(DEFAULT_EXIT_ACCOUNT),
        ),
        private=PrivateCircuitInputs(
            secret=secret,
            storage_proof=processed,
            transfer_count=DEFAULT_TRANSFER_COUNT,
            funding_account=codec.BytesDigest(DEFAULT_FUNDING_ACCOUNT),
            unspendable_account=_default_unspendable_digest(),
        ),
    )


def aggregation_leaf_inputs() -> list:
    """The inputs of the two leaves that the aggregation pins prove:
    synthetic_circuit_inputs() with exit accounts [4] * 32 and [5] * 32
    (the first is synthetic_circuit_inputs() itself)."""
    base = synthetic_circuit_inputs()
    return [
        dataclasses.replace(
            base,
            public=dataclasses.replace(
                base.public, exit_account=codec.BytesDigest(bytes([e] * 32))
            ),
        )
        for e in (0x04, 0x05)
    ]


def square_circuit(config):
    """(CircuitData, x) of the square test circuit under `config`: one
    virtual target x and the public input x * x."""
    from ...plonk.builder import CircuitBuilder

    builder = CircuitBuilder(config)
    x = builder.add_virtual_target()
    builder.register_public_input(builder.mul(x, x))
    return builder.build(), x

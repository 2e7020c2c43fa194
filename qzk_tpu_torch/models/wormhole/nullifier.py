"""Nullifier fragment: proves hash = H(H(salt || secret || transfer_count))
with salt "~nullif~"; the hash is a public input.

Semantics parity: reference wormhole/circuit/src/nullifier.rs
(preimage = 2 salt + 8 secret + 2 count felts, all range-checked to 32
bits, nullifier.rs:215-242; native mirror from_preimage :53-73; codecs
:76-181).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ...ops import poseidon
from ...plonk.builder import CircuitBuilder, HashOutTarget
from ...utils import codec

NULLIFIER_SALT = "~nullif~"
SECRET_NUM_TARGETS = 8
TRANSFER_COUNT_NUM_TARGETS = 2


@dataclass
class Nullifier:
    hash: np.ndarray  # (4,) felts
    secret: np.ndarray  # (8,) felts
    transfer_count: np.ndarray  # (2,) felts

    @classmethod
    def new(
        cls, digest: codec.BytesDigest, secret: bytes, transfer_count: int
    ) -> "Nullifier":
        return cls(
            hash=codec.digest_bytes_to_felts(digest),
            secret=codec.injective_bytes_to_felts(secret),
            transfer_count=codec.u64_to_felts(transfer_count),
        )

    @classmethod
    def from_preimage(cls, secret: bytes, transfer_count: int) -> "Nullifier":
        salt = codec.injective_string_to_felts(NULLIFIER_SALT)
        secret_felts = codec.injective_bytes_to_felts(secret)
        count_felts = codec.u64_to_felts(transfer_count)
        preimage = np.concatenate([salt, secret_felts, count_felts])
        inner = poseidon.hash_no_pad(preimage)
        outer = poseidon.hash_no_pad(inner)
        return cls(
            hash=outer, secret=secret_felts, transfer_count=count_felts
        )

    @classmethod
    def from_inputs(cls, inputs) -> "Nullifier":
        return cls.new(
            inputs.public.nullifier,
            inputs.private.secret,
            inputs.private.transfer_count,
        )

    # -- codecs (nullifier.rs:76-181) --------------------------------------

    def to_field_elements(self) -> np.ndarray:
        return np.concatenate([self.hash, self.secret, self.transfer_count])

    @classmethod
    def from_field_elements(cls, elements) -> "Nullifier":
        elements = np.asarray(elements, dtype=np.uint64)
        total = 4 + 8 + 2
        if len(elements) != total:
            raise ValueError(
                f"Expected {total} field elements for Nullifier, got: "
                f"{len(elements)}"
            )
        return cls(
            hash=elements[0:4],
            secret=elements[4:12],
            transfer_count=elements[12:14],
        )

    def to_bytes(self) -> bytes:
        return (
            codec.digest_felts_to_bytes(self.hash)
            + codec.injective_felts_to_bytes(self.secret)
            + codec.injective_felts_to_bytes(self.transfer_count)
        )

    @classmethod
    def from_bytes(cls, data: bytes) -> "Nullifier":
        total = 4 * 8 + 8 * 8 + 2 * 8
        if len(data) != total:
            raise ValueError(
                f"Expected {total} bytes for Nullifier, got: {len(data)}"
            )
        hash_ = codec.digest_bytes_to_felts(data[0:32])
        secret = codec.injective_bytes_to_felts(data[32:96])
        count = codec.injective_bytes_to_felts(data[96:112])
        if len(secret) != 8:
            raise ValueError(
                f"Expected 8 field elements for secret, got: {len(secret)}"
            )
        return cls(hash=hash_, secret=secret, transfer_count=count)


@dataclass
class NullifierTargets:
    hash: HashOutTarget
    secret: list
    transfer_count: list

    @classmethod
    def new(cls, builder: CircuitBuilder) -> "NullifierTargets":
        return cls(
            hash=builder.add_virtual_hash_public_input(),
            secret=builder.add_virtual_targets(SECRET_NUM_TARGETS),
            transfer_count=builder.add_virtual_targets(
                TRANSFER_COUNT_NUM_TARGETS
            ),
        )


def circuit(targets: NullifierTargets, builder: CircuitBuilder) -> None:
    """nullifier.rs:215-242."""
    salt_felts = codec.injective_string_to_felts(NULLIFIER_SALT)
    preimage = [
        builder.constant(int(salt_felts[0])),
        builder.constant(int(salt_felts[1])),
    ]
    preimage.extend(targets.secret)
    preimage.extend(targets.transfer_count)
    for t in preimage:
        builder.range_check(t, 32)
    inner = builder.hash_n_to_hash_no_pad(preimage)
    computed = builder.hash_n_to_hash_no_pad(list(inner.elements))
    builder.connect_hashes(computed, targets.hash)


def fill_targets(nullifier: Nullifier, pw, targets: NullifierTargets) -> None:
    pw.set_hash_target(targets.hash, nullifier.hash)
    pw.set_target_arr(targets.secret, nullifier.secret)
    pw.set_target_arr(targets.transfer_count, nullifier.transfer_count)

"""UnspendableAccount fragment: proves account_id = H(H("wormhole" || secret)).

Semantics parity: reference wormhole/circuit/src/unspendable_account.rs
(10-felt preimage, range-checks only the salt — the shared secret is
checked by the nullifier fragment, :193-199; account_id is private,
:169; native mirror from_secret :38-63; codecs :66-152).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ...ops import poseidon
from ...plonk.builder import CircuitBuilder, HashOutTarget
from ...utils import codec

UNSPENDABLE_SALT = "wormhole"
SECRET_NUM_TARGETS = 8
PREIMAGE_NUM_TARGETS = 10

DEFAULT_SECRET_HEX = (
    "cd94df2e3c38a87f3e429b62af022dbe4363143811219d80037e8798b2ec9229"
)


@dataclass
class UnspendableAccount:
    account_id: np.ndarray  # (4,)
    secret: np.ndarray  # (8,)

    @classmethod
    def new(cls, account_id: codec.BytesDigest, secret: bytes):
        return cls(
            account_id=codec.digest_bytes_to_felts(account_id),
            secret=codec.injective_bytes_to_felts(secret),
        )

    @classmethod
    def from_secret(cls, secret: bytes) -> "UnspendableAccount":
        assert len(secret) == 32
        secret_felts = codec.injective_bytes_to_felts(secret)
        preimage = np.concatenate(
            [codec.injective_string_to_felts(UNSPENDABLE_SALT), secret_felts]
        )
        assert len(preimage) == PREIMAGE_NUM_TARGETS
        inner = poseidon.hash_no_pad(preimage)
        outer = poseidon.hash_no_pad(inner)
        return cls(account_id=outer, secret=secret_felts)

    @classmethod
    def from_inputs(cls, inputs) -> "UnspendableAccount":
        return cls.new(
            inputs.private.unspendable_account, inputs.private.secret
        )

    @classmethod
    def default(cls) -> "UnspendableAccount":
        return cls.from_secret(bytes.fromhex(DEFAULT_SECRET_HEX))

    # -- codecs -------------------------------------------------------------

    def to_field_elements(self) -> np.ndarray:
        return np.concatenate([self.account_id, self.secret])

    @classmethod
    def from_field_elements(cls, elements) -> "UnspendableAccount":
        elements = np.asarray(elements, dtype=np.uint64)
        if len(elements) != 12:
            raise ValueError(
                f"Expected 12 field elements for UnspendableAccount, got: "
                f"{len(elements)}"
            )
        return cls(account_id=elements[:4], secret=elements[4:])

    def to_bytes(self) -> bytes:
        return codec.digest_felts_to_bytes(
            self.account_id
        ) + codec.injective_felts_to_bytes(self.secret)

    @classmethod
    def from_bytes(cls, data: bytes) -> "UnspendableAccount":
        total = 4 * 8 + 8 * 8
        if len(data) != total:
            raise ValueError(
                f"Expected {total} bytes for UnspendableAccount, got: "
                f"{len(data)}"
            )
        return cls(
            account_id=codec.digest_bytes_to_felts(data[:32]),
            secret=codec.injective_bytes_to_felts(data[32:]),
        )


@dataclass
class UnspendableAccountTargets:
    account_id: HashOutTarget
    secret: list

    @classmethod
    def new(cls, builder: CircuitBuilder) -> "UnspendableAccountTargets":
        return cls(
            account_id=builder.add_virtual_hash(),
            secret=builder.add_virtual_targets(SECRET_NUM_TARGETS),
        )


def circuit(targets: UnspendableAccountTargets, builder: CircuitBuilder):
    """unspendable_account.rs:182-208."""
    salt = codec.injective_string_to_felts(UNSPENDABLE_SALT)
    preimage = [builder.constant(int(salt[0])), builder.constant(int(salt[1]))]
    for t in preimage:
        builder.range_check(t, 32)
    # secret range checks are the nullifier fragment's job (shared wires)
    preimage.extend(targets.secret)
    inner = builder.hash_n_to_hash_no_pad(preimage)
    generated = builder.hash_n_to_hash_no_pad(list(inner.elements))
    builder.connect_hashes(generated, targets.account_id)


def fill_targets(account: UnspendableAccount, pw, targets) -> None:
    pw.set_hash_target(targets.account_id, account.account_id)
    pw.set_target_arr(targets.secret, account.secret)

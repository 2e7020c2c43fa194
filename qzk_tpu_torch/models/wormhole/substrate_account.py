"""SubstrateAccount / ExitAccount fragment.

The exit account is bound into the proof as a public input via a
deliberately empty circuit (anti-front-running: the proof commits to the
payout address).  Semantics parity:
reference wormhole/circuit/src/substrate_account.rs (:72-97).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ...plonk.builder import CircuitBuilder, HashOutTarget
from ...utils import codec


@dataclass
class SubstrateAccount:
    account_id: np.ndarray  # (4,) 64-bit-limb digest felts

    @classmethod
    def new(cls, address: bytes) -> "SubstrateAccount":
        return cls.from_bytes(address)

    @classmethod
    def from_bytes(cls, data: bytes) -> "SubstrateAccount":
        digest = codec.BytesDigest(bytes(data))
        return cls(account_id=codec.digest_bytes_to_felts(digest))

    def to_bytes(self) -> bytes:
        return codec.digest_felts_to_bytes(self.account_id)

    def to_field_elements(self) -> np.ndarray:
        return self.account_id.copy()

    @classmethod
    def from_field_elements(cls, elements) -> "SubstrateAccount":
        elements = np.asarray(elements, dtype=np.uint64)
        if len(elements) != 4:
            raise ValueError(
                f"Expected 4 field elements for SubstrateAccount, got: "
                f"{len(elements)}"
            )
        return cls(account_id=elements.copy())


@dataclass
class ExitAccountTargets:
    address: HashOutTarget

    @classmethod
    def new(cls, builder: CircuitBuilder) -> "ExitAccountTargets":
        return cls(address=builder.add_virtual_hash_public_input())


def circuit(targets: ExitAccountTargets, builder: CircuitBuilder) -> None:
    """Deliberately empty — the address participates only as a public
    input (substrate_account.rs:88)."""


def fill_targets(account: SubstrateAccount, pw, targets) -> None:
    pw.set_hash_target(targets.address, account.account_id)

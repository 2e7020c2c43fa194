"""WormholeCircuit: composition of the four fragments + shared-target
connections (parity with reference wormhole/circuit/src/circuit.rs:
44-137).  Defaults to the zero-knowledge config (circuit.rs:70)."""

from __future__ import annotations

from dataclasses import dataclass

from ...plonk.builder import CircuitBuilder
from ...plonk.config import CircuitConfig
from . import nullifier as nf
from . import storage_proof as sp
from . import substrate_account as sa
from . import unspendable_account as ua


@dataclass
class CircuitTargets:
    nullifier: nf.NullifierTargets
    unspendable_account: ua.UnspendableAccountTargets
    storage_proof: sp.StorageProofTargets
    exit_account: sa.ExitAccountTargets

    @classmethod
    def new(cls, builder: CircuitBuilder) -> "CircuitTargets":
        return cls(
            nullifier=nf.NullifierTargets.new(builder),
            unspendable_account=ua.UnspendableAccountTargets.new(builder),
            storage_proof=sp.StorageProofTargets.new(builder),
            exit_account=sa.ExitAccountTargets.new(builder),
        )


def connect_shared_targets(
    targets: CircuitTargets, builder: CircuitBuilder
) -> None:
    """circuit.rs:111-137: nullifier.secret == unspendable.secret;
    nullifier.transfer_count == leaf.transfer_count;
    unspendable.account_id == leaf.to_account."""
    for a, b in zip(
        targets.nullifier.secret, targets.unspendable_account.secret
    ):
        builder.connect(a, b)
    for a, b in zip(
        targets.nullifier.transfer_count,
        targets.storage_proof.leaf_inputs.transfer_count,
    ):
        builder.connect(a, b)
    builder.connect_hashes(
        targets.unspendable_account.account_id,
        targets.storage_proof.leaf_inputs.to_account,
    )


class WormholeCircuit:
    def __init__(self, config: CircuitConfig | None = None):
        if config is None:
            config = CircuitConfig.standard_recursion_zk_config()
        self.builder = CircuitBuilder(config)
        self._targets = CircuitTargets.new(self.builder)
        nf.circuit(self._targets.nullifier, self.builder)
        ua.circuit(self._targets.unspendable_account, self.builder)
        sp.circuit(self._targets.storage_proof, self.builder)
        sa.circuit(self._targets.exit_account, self.builder)
        connect_shared_targets(self._targets, self.builder)

    def targets(self) -> CircuitTargets:
        return self._targets

    def build_circuit(self):
        return self.builder.build()

    def build_prover(self):
        return self.builder.build_prover()

    def build_verifier(self):
        return self.builder.build_verifier()


def fill_all_targets(inputs, pw, targets: CircuitTargets) -> None:
    """Convert CircuitInputs into the four fragment structs and fill
    every target (prover/src/lib.rs:209-225)."""
    nullifier = nf.Nullifier.from_inputs(inputs)
    storage_proof = sp.StorageProof.from_inputs(inputs)
    unspendable = ua.UnspendableAccount.from_inputs(inputs)
    exit_account = sa.SubstrateAccount.from_bytes(
        bytes(inputs.public.exit_account)
    )
    nf.fill_targets(nullifier, pw, targets.nullifier)
    ua.fill_targets(unspendable, pw, targets.unspendable_account)
    sp.fill_targets(storage_proof, pw, targets.storage_proof)
    sa.fill_targets(exit_account, pw, targets.exit_account)

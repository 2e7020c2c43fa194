"""WormholeVerifier (parity with
reference wormhole/verifier/src/lib.rs:81-160).  Verifies on the host.
The constructors from serialized artifacts are not ported yet."""

from __future__ import annotations

from ...plonk.circuit_data import VerifierCircuitData
from ...plonk.config import CircuitConfig
from .circuit import WormholeCircuit


class WormholeVerifier:
    def __init__(self, circuit_data: VerifierCircuitData):
        self.circuit_data = circuit_data

    @classmethod
    def new(
        cls,
        config: CircuitConfig,
        circuit_data: VerifierCircuitData | None = None,
    ) -> "WormholeVerifier":
        if circuit_data is None:
            circuit_data = WormholeCircuit(config).build_verifier()
        return cls(circuit_data)

    def verify(self, proof) -> None:
        self.circuit_data.verify(proof)

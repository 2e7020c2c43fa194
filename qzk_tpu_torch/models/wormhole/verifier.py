"""WormholeVerifier (parity with
reference wormhole/verifier/src/lib.rs:81-160).  Verifies on the host.
Its data comes from a fresh build or from the common.bin and
verifier.bin that either package writes (utils/serialization.py)."""

from __future__ import annotations

from pathlib import Path

from ...plonk.circuit_data import VerifierCircuitData
from ...plonk.config import CircuitConfig
from ...utils import serialization as ser
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

    @classmethod
    def new_from_bytes(
        cls, verifier_bytes: bytes, common_bytes: bytes
    ) -> "WormholeVerifier":
        verifier_only = ser.verifier_only_from_bytes(verifier_bytes)
        common = ser.common_from_bytes(common_bytes)
        return cls(
            VerifierCircuitData(common=common, verifier_only=verifier_only)
        )

    @classmethod
    def new_from_files(cls, verifier_data_path, common_data_path):
        return cls.new_from_bytes(
            Path(verifier_data_path).read_bytes(),
            Path(common_data_path).read_bytes(),
        )

    def verify(self, proof) -> None:
        self.circuit_data.verify(proof)

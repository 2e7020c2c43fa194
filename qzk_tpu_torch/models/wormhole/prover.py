"""WormholeProver — commit -> prove session API (parity with
reference wormhole/prover/src/lib.rs:73-238: consuming commit with
single-shot targets, constructors from fresh build / serialized
artifacts / generated-bins auto-resume).  Proves on the device the
caller names: CUDA unless it passes device="cpu"."""

from __future__ import annotations

from pathlib import Path

from ...plonk.circuit_data import ProverCircuitData
from ...plonk.config import CircuitConfig
from ...plonk.witness import PartialWitness
from ...utils import serialization as ser
from .circuit import WormholeCircuit, fill_all_targets
from .inputs import CircuitInputs

DEFAULT_BINS_DIR = "generated-bins"


class WormholeProver:
    def __init__(
        self,
        config: CircuitConfig | None = None,
        *,
        device=None,
        _circuit_data=None,
        _targets=None,
    ):
        if _circuit_data is not None:
            self.circuit_data = _circuit_data
            self._targets = _targets
        else:
            circuit = WormholeCircuit(
                config or CircuitConfig.standard_recursion_config()
            )
            self._targets = circuit.targets()
            self.circuit_data = circuit.build_prover()
        self.device = device
        self.partial_witness = PartialWitness()

    @classmethod
    def new(cls, config: CircuitConfig, device=None) -> "WormholeProver":
        return cls(config, device=device)

    @classmethod
    def default(cls, device=None) -> "WormholeProver":
        """Resume from generated-bins/ if present, else build the
        zk-config circuit (prover/src/lib.rs:81-101).  Missing files
        take the build, and so does a prover.bin that the JAX package
        wrote there: it fails the port's magic before anything is
        unpickled."""
        try:
            return cls.new_from_files(
                Path(DEFAULT_BINS_DIR) / "prover.bin",
                Path(DEFAULT_BINS_DIR) / "common.bin",
                device=device,
            )
        except (OSError, ValueError):
            return cls(CircuitConfig.standard_recursion_zk_config(), device=device)

    @classmethod
    def new_from_bytes(
        cls, prover_only_bytes: bytes, common_bytes: bytes, device=None
    ) -> "WormholeProver":
        common = ser.common_from_bytes(common_bytes)
        prover_only = ser.prover_only_from_bytes(prover_only_bytes)
        # rebuild targets for the same config (deterministic construction)
        circuit = WormholeCircuit(common.config)
        targets = circuit.targets()
        data = ProverCircuitData(common=common, prover_only=prover_only)
        return cls(device=device, _circuit_data=data, _targets=targets)

    @classmethod
    def new_from_files(cls, prover_data_path, common_data_path, device=None):
        prover_bytes = Path(prover_data_path).read_bytes()
        common_bytes = Path(common_data_path).read_bytes()
        return cls.new_from_bytes(prover_bytes, common_bytes, device=device)

    def commit(self, circuit_inputs: CircuitInputs) -> "WormholeProver":
        """Fill all fragment targets; single-shot (lib.rs:209-225)."""
        if self._targets is None:
            raise RuntimeError("prover has already commited to inputs")
        fill_all_targets(circuit_inputs, self.partial_witness, self._targets)
        self._targets = None
        return self

    def prove(self, timer=None):
        return self.circuit_data.prove(
            self.partial_witness, device=self.device, timer=timer
        )

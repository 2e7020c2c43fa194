"""WormholeProver — commit -> prove session API (parity with
reference wormhole/prover/src/lib.rs:73-238: consuming commit with
single-shot targets).  Proves on the device the caller names: CUDA
unless it passes device="cpu".  The constructors from serialized
artifacts are not ported yet (serialization is a later slice)."""

from __future__ import annotations

from ...plonk.config import CircuitConfig
from ...plonk.witness import PartialWitness
from .circuit import WormholeCircuit, fill_all_targets
from .inputs import CircuitInputs


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

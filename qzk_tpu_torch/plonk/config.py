"""Circuit / FRI configuration.

Parameter parity with the reference's `CircuitConfig::standard_recursion_config`
and `standard_recursion_zk_config` (used at reference wormhole/circuit/
src/circuit.rs:70, circuit-builder/src/lib.rs:16, aggregator.rs:21): 135
wires, 80 routed, 2 constants, 2 challenges, quotient degree factor 8, FRI
rate 1/8, cap height 4, 16 proof-of-work bits, 28 query rounds, constant
arity-16 reduction to a <=2^5-coefficient final polynomial.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class FriConfig:
    rate_bits: int = 3
    cap_height: int = 4
    proof_of_work_bits: int = 16
    num_query_rounds: int = 28
    arity_bits: int = 4
    final_poly_bits: int = 5

    def reduction_arity_bits(self, degree_bits: int) -> list[int]:
        """Fold schedule: arity-16 folds until the remaining polynomial
        has at most 2^final_poly_bits coefficients."""
        out = []
        while degree_bits > self.final_poly_bits:
            step = min(self.arity_bits, degree_bits - self.final_poly_bits)
            out.append(step)
            degree_bits -= step
        return out


@dataclass(frozen=True)
class CircuitConfig:
    num_wires: int = 135
    num_routed_wires: int = 80
    num_constants: int = 2
    security_bits: int = 100
    num_challenges: int = 2
    zero_knowledge: bool = False
    max_quotient_degree_factor: int = 8
    fri_config: FriConfig = field(default_factory=FriConfig)

    @staticmethod
    def standard_recursion_config() -> "CircuitConfig":
        return CircuitConfig()

    @staticmethod
    def standard_recursion_zk_config() -> "CircuitConfig":
        return CircuitConfig(zero_knowledge=True)

    def with_zero_knowledge(self, zk: bool) -> "CircuitConfig":
        return replace(self, zero_knowledge=zk)

"""Wormhole bridge message-verification circuit: prove control of a
secret whose derived unspendable account received a funded transfer
recorded in a Substrate state trie, without revealing which account
(reference layer L3-L5, SURVEY.md §1)."""

from .circuit import CircuitTargets, WormholeCircuit  # noqa: F401
from .inputs import (  # noqa: F401
    CircuitInputs,
    PrivateCircuitInputs,
    PublicCircuitInputs,
)

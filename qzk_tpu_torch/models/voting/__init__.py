from .circuit import (  # noqa: F401
    MAX_MERKLE_DEPTH,
    VoteCircuitData,
    VotePrivateInputs,
    VotePublicInputs,
    VoteTargets,
)

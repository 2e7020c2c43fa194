"""Poseidon permutation & hashes over Goldilocks — numpy reference.

Width-12 HADES construction: 8 full rounds (4 + 4), 22 partial rounds,
sbox x^7, MDS = circulant + diagonal matrix with small entries.  This is
the hash the reference circuits use for everything (Merkle hashing,
nullifier/account derivation, transcript) via plonky2's `PoseidonHash`
(call sites: reference wormhole/circuit/src/nullifier.rs:64-65,
unspendable_account.rs:54-56, voting/src/lib.rs:278-282).

Bit-exactness: validated against the reference repo's golden vectors
(secret -> address pairs in
wormhole/tests/src/circuit/unspendable_account_tests.rs:12-27 and the
nullifier/root digests in tests/src/prover/prover_tests.rs:29-44).

This module is the semantic oracle; the batched device implementations
live in poseidon_torch.py (plain) and poseidon_cuda.py (CUDA kernels).
"""

from __future__ import annotations

import numpy as np

from . import goldilocks as gl
from ._poseidon_constants import ALL_ROUND_CONSTANTS

WIDTH = 12
RATE = 8
CAP = 4
N_FULL_ROUNDS = 8  # 4 + 4
HALF_FULL = 4
N_PARTIAL_ROUNDS = 22
N_ROUNDS = N_FULL_ROUNDS + N_PARTIAL_ROUNDS

# MDS matrix M[r][c] = CIRC[(c - r) mod 12] + (r == c) * DIAG[r]
MDS_CIRC = [17, 15, 41, 16, 2, 28, 13, 13, 39, 18, 34, 20]
MDS_DIAG = [8, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0]

MDS_MATRIX = np.array(
    [
        [
            MDS_CIRC[(c - r) % WIDTH] + (MDS_DIAG[r] if r == c else 0)
            for c in range(WIDTH)
        ]
        for r in range(WIDTH)
    ],
    dtype=np.uint64,
)

_RC = np.array(ALL_ROUND_CONSTANTS, dtype=np.uint64).reshape(N_ROUNDS, WIDTH)


def _sbox(x: np.ndarray) -> np.ndarray:
    """x^7 mod p."""
    x2 = gl.mul(x, x)
    x3 = gl.mul(x2, x)
    x4 = gl.mul(x2, x2)
    return gl.mul(x4, x3)


def _mds(state: np.ndarray) -> np.ndarray:
    """Apply the MDS matrix to state[..., 12].

    Entries are tiny (<= 49): split lanes into 32-bit halves so every
    partial product (<= 2^38) and every 12-term accumulation (< 2^42)
    stays exact in uint64, then do one 128-bit reduction per lane.
    """
    with np.errstate(over="ignore"):
        s_lo = (state & gl._U32)[..., None, :]  # (..., 1, 12)
        s_hi = (state >> gl._32)[..., None, :]
        lo_sum = np.sum(s_lo * MDS_MATRIX, axis=-1)  # (..., 12), < 2^42
        hi_sum = np.sum(s_hi * MDS_MATRIX, axis=-1)
        lo64 = lo_sum + (hi_sum << gl._32)
        carry = (lo64 < lo_sum).astype(np.uint64)
        hi64 = (hi_sum >> gl._32) + carry
    return gl.reduce128(lo64, hi64)


_MDS_INT = [[int(MDS_MATRIX[r][c]) for c in range(WIDTH)] for r in range(WIDTH)]
_RC_INT = [[int(x) for x in row] for row in _RC]


def _permute_scalar(state: np.ndarray) -> np.ndarray:
    """Single-state permutation via python ints — much faster than numpy
    per-element dispatch for the sequential transcript/Merkle-path uses."""
    P = gl.P
    s = [int(x) for x in state]
    for r in range(N_ROUNDS):
        rc = _RC_INT[r]
        s = [(x + c) % P for x, c in zip(s, rc)]
        if HALF_FULL <= r < HALF_FULL + N_PARTIAL_ROUNDS:
            s[0] = pow(s[0], 7, P)
        else:
            s = [pow(x, 7, P) for x in s]
        s = [
            sum(m * x for m, x in zip(row, s)) % P for row in _MDS_INT
        ]
    return np.array(s, dtype=np.uint64)


def permute(state: np.ndarray) -> np.ndarray:
    """Poseidon permutation on state[..., 12] (canonical u64)."""
    state = np.asarray(state, dtype=np.uint64)
    assert state.shape[-1] == WIDTH
    if state.ndim == 1:
        # the C++ kernel beats the python-int path ~100x even for a
        # single state (dominates the verifier's transcript replay)
        from .. import native

        out = native.poseidon_permute_batch(state[None])
        if out is not None:
            return out[0]
        return _permute_scalar(state)
    if state.ndim == 2 and state.shape[0] >= 8:
        from .. import native

        out = native.poseidon_permute_batch(state)
        if out is not None:
            return out
    round_ctr = 0
    # First half of full rounds.
    for _ in range(HALF_FULL):
        state = gl.add(state, _RC[round_ctr])
        state = _sbox(state)
        state = _mds(state)
        round_ctr += 1
    # Partial rounds: sbox only on lane 0.
    for _ in range(N_PARTIAL_ROUNDS):
        state = gl.add(state, _RC[round_ctr])
        lane0 = _sbox(state[..., 0])
        state = state.copy()
        state[..., 0] = lane0
        state = _mds(state)
        round_ctr += 1
    # Second half of full rounds.
    for _ in range(HALF_FULL):
        state = gl.add(state, _RC[round_ctr])
        state = _sbox(state)
        state = _mds(state)
        round_ctr += 1
    return state


def hash_n_to_m_no_pad(inputs: np.ndarray, num_outputs: int) -> np.ndarray:
    """Overwrite-mode sponge, rate 8, capacity 4 (hash_n_to_m_no_pad)."""
    inputs = np.asarray(inputs, dtype=np.uint64).ravel()
    state = np.zeros(WIDTH, dtype=np.uint64)
    # Empty input absorbs nothing (no permutation) — squeeze the zero state.
    for start in range(0, len(inputs), RATE):
        chunk = inputs[start : start + RATE]
        state[: len(chunk)] = chunk
        state = permute(state)
    outputs = []
    while True:
        for i in range(RATE):
            outputs.append(state[i])
            if len(outputs) == num_outputs:
                return np.array(outputs, dtype=np.uint64)
        state = permute(state)


def hash_no_pad(inputs) -> np.ndarray:
    """PoseidonHash::hash_no_pad — 4-felt digest."""
    return hash_n_to_m_no_pad(inputs, 4)


def hash_no_pad_rows(inputs: np.ndarray) -> np.ndarray:
    """Batched hash_no_pad over rows: (n, w) -> (n, 4)."""
    inputs = np.asarray(inputs, dtype=np.uint64)
    n, w = inputs.shape
    if w > 0:
        # whole absorb chain in one native call (the python chain pays
        # one permute dispatch per 8 columns)
        from .. import native

        out = native.poseidon_hash_rows(inputs)
        if out is not None:
            return out
    state = np.zeros((n, WIDTH), dtype=np.uint64)
    for start in range(0, w, RATE):
        chunk = inputs[:, start : start + RATE]
        state[:, : chunk.shape[1]] = chunk
        state = permute(state)
    return state[:, :CAP]


def hash_or_noop(inputs) -> np.ndarray:
    """<= 4 felts: zero-pad to 4 without permuting; else hash_no_pad."""
    inputs = np.asarray(inputs, dtype=np.uint64).ravel()
    if len(inputs) <= 4:
        out = np.zeros(4, dtype=np.uint64)
        out[: len(inputs)] = inputs
        return out
    return hash_no_pad(inputs)


def two_to_one(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """Merkle compression: hash of the 8-felt concatenation."""
    return hash_no_pad(np.concatenate([left, right]))

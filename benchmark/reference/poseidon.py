"""The Poseidon permutation of qp-plonky2 (width 12, rate 8, capacity 4;
4 full rounds, 22 partial rounds, 4 full rounds; S-box x^7), its
overwrite-mode sponge and Merkle compression, over batches of states
(L, 12) so that many hashes share each numpy call."""

from __future__ import annotations

import numpy as np

from . import field as F
from .poseidon_constants import ALL_ROUND_CONSTANTS

WIDTH, RATE, CAPACITY = 12, 8, 4
HALF_FULL, PARTIAL = 4, 22
ROUNDS = 2 * HALF_FULL + PARTIAL

MDS_CIRC = [17, 15, 41, 16, 2, 28, 13, 13, 39, 18, 34, 20]
MDS_DIAG = [8] + [0] * 11
MDS = [[MDS_CIRC[(c - r) % WIDTH] + (MDS_DIAG[r] if r == c else 0)
        for c in range(WIDTH)] for r in range(WIDTH)]
_MDS_T = np.array(MDS, dtype=np.uint64).T.copy()
_RC = np.array(ALL_ROUND_CONSTANTS, dtype=np.uint64).reshape(ROUNDS, WIDTH)


def _x7(x):
    x2 = F.mul(x, x)
    return F.mul(F.mul(x2, x2), F.mul(x2, x))


def _mds(s):
    """The MDS layer on (L, 12): the matrix's entries are under 2^6, so
    products of 32-bit halves sum exactly in 64 bits."""
    with np.errstate(over="ignore"):
        lo = (s & F._LO) @ _MDS_T  # each < 2^42
        hi = (s >> F._32) @ _MDS_T
        low = lo + (hi << F._32)
        carry = (low < lo).astype(np.uint64)
        high = (hi >> F._32) + carry
    return F.reduce128(low, high)


def permute(states: np.ndarray) -> np.ndarray:
    """Permute each row of states (L, 12)."""
    s = F.u64(states).reshape(-1, WIDTH)
    for r in range(ROUNDS):
        s = F.add(s, _RC[r])
        if HALF_FULL <= r < HALF_FULL + PARTIAL:
            s = s.copy()
            s[:, 0] = _x7(s[:, 0])
        else:
            s = _x7(s)
        s = _mds(s)
    return s


def sponge_rows(rows: np.ndarray) -> np.ndarray:
    """The 4-word digest of each row of rows (L, w): the overwrite-mode
    sponge, 8 words a permutation, for any width (none: the zero state)."""
    rows = F.u64(rows)
    state = np.zeros((rows.shape[0], WIDTH), dtype=np.uint64)
    for start in range(0, rows.shape[1], RATE):
        chunk = rows[:, start : start + RATE]
        state[:, : chunk.shape[1]] = chunk
        state = permute(state)
    return state[:, :CAPACITY]


def hash_rows(rows: np.ndarray) -> np.ndarray:
    """A Merkle leaf's digest of each row: rows of at most 4 words are
    their own digest, zero-padded; longer rows go through the sponge."""
    rows = F.u64(rows)
    if rows.shape[1] > CAPACITY:
        return sponge_rows(rows)
    out = np.zeros((rows.shape[0], CAPACITY), dtype=np.uint64)
    out[:, : rows.shape[1]] = rows
    return out


def merkle_root_of_paths(leaf_digests, indices, siblings) -> tuple:
    """Walk L Merkle paths at once: leaf_digests (L, 4), indices (L,),
    siblings (L, depth, 4).  Returns the digests reached and the indices
    left, which name an entry of the cap."""
    h = F.u64(leaf_digests)
    idx = np.asarray(indices, dtype=np.int64).copy()
    for d in range(siblings.shape[1]):
        sib = siblings[:, d, :]
        right = (idx & 1).astype(bool)[:, None]
        state = np.zeros((h.shape[0], WIDTH), dtype=np.uint64)
        state[:, :4] = np.where(right, sib, h)
        state[:, 4:8] = np.where(right, h, sib)
        h = permute(state)[:, :CAPACITY]
        idx >>= 1
    return h, idx

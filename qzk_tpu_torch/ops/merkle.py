"""Merkle trees with caps (Poseidon compression) — numpy oracle + device
builder.

A Merkle cap of height h is the set of 2^h nodes at depth h from the
root; commitments store the cap instead of a single root (trades proof
length against commitment size, cap_height=4 in the standard config —
SURVEY.md §2b row 6).  Leaves are rows of a (n, width) matrix; leaf hash
is hash_or_noop (rows of width <= 4 commit as themselves, zero-padded).

The device builder hashes all leaves in one launch of the CUDA row
sponge (ops/poseidon_cuda.py, K1) and then halves level by level with
the same kernel at width 8; on a CPU tensor the kernel's plain torch
version runs instead.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

import torch

from . import poseidon
from . import poseidon_cuda


@dataclass
class MerkleTree:
    """Host-side tree: leaves (n, w) uint64, all internal levels, cap."""

    leaves: np.ndarray  # (n, w) uint64
    levels: list  # levels[0] = leaf hashes (n, 4), ..., last = cap
    cap_height: int

    @property
    def cap(self) -> np.ndarray:
        return self.levels[-1]

    def prove(self, index: int) -> list[np.ndarray]:
        """Sibling digests from leaf level up to (excluding) the cap."""
        siblings = []
        idx = index
        for level in self.levels[:-1]:
            siblings.append(level[idx ^ 1].copy())
            idx >>= 1
        return siblings


def build_merkle_tree(leaves: np.ndarray, cap_height: int) -> MerkleTree:
    """numpy oracle builder."""
    leaves = np.asarray(leaves, dtype=np.uint64)
    n, w = leaves.shape
    log_n = n.bit_length() - 1
    assert 1 << log_n == n and cap_height <= log_n
    if w <= 4:
        hashes = np.zeros((n, 4), dtype=np.uint64)
        hashes[:, :w] = leaves
    else:
        hashes = poseidon.hash_no_pad_rows(leaves)
    levels = [hashes]
    while len(levels) - 1 < log_n - cap_height:
        pairs = levels[-1].reshape(-1, 8)
        levels.append(poseidon.hash_no_pad_rows(pairs))
    return MerkleTree(leaves=leaves, levels=levels, cap_height=cap_height)


def verify_merkle_proof(
    leaf: np.ndarray,
    index: int,
    siblings: list[np.ndarray],
    cap: np.ndarray,
) -> bool:
    """Check a leaf row against a cap."""
    leaf = np.asarray(leaf, dtype=np.uint64)
    if leaf.shape[-1] <= 4:
        h = np.zeros(4, dtype=np.uint64)
        h[: leaf.shape[-1]] = leaf
    else:
        h = poseidon.hash_no_pad(leaf)
    idx = index
    for sib in siblings:
        if idx & 1:
            h = poseidon.two_to_one(sib, h)
        else:
            h = poseidon.two_to_one(h, sib)
        idx >>= 1
    return bool((h == cap[idx]).all())


# ---------------------------------------------------------------------------
# Device builder (torch; CUDA kernels on the card)
# ---------------------------------------------------------------------------


def build_merkle_levels(leaves: torch.Tensor, cap_height: int) -> list[torch.Tensor]:
    """Device tree build: leaves (n, w) -> list of digest levels.

    Returns levels[0] = (n, 4) leaf hashes ... levels[-1] = cap
    (2^cap_height, 4).  Every level of a CUDA tensor goes through the
    K1 kernel, whatever its size."""
    n, w = leaves.shape
    log_n = n.bit_length() - 1
    assert 1 << log_n == n and cap_height <= log_n
    if w <= 4:
        hashes = torch.nn.functional.pad(leaves, (0, 4 - w))
    else:
        hashes = poseidon_cuda.hash_no_pad_rows(leaves.contiguous())
    levels = [hashes]
    while len(levels) - 1 < log_n - cap_height:
        # a sibling pair is one contiguous row of 8: two_to_one without
        # the concatenation
        levels.append(poseidon_cuda.hash_no_pad_rows(levels[-1].reshape(-1, 8)))
    return levels

"""A Wormhole withdrawal in plain terms: the storage proof's nodes with
their embedded hashes rebuilt bottom-up, and the public inputs a valid
proof of it must carry.

Byte-to-word rules (the reference's common/src/utils.rs):
- digests: 32 bytes, four little-endian 64-bit words, each below p;
- injective: four bytes a word, little-endian, the last chunk
  zero-padded; an 8-byte salt string is two such words;
- u64: two 32-bit words, high first; u128: four 32-bit words, high first.
Hashes (Poseidon's sponge):
- unspendable account = H(H("wormhole" || secret));
- nullifier = H(H("~nullif~" || secret || transfer count));
- leaf = H(transfer count || funding account || unspendable account ||
  funding amount); the last node embeds it at byte index / 2;
- each other node embeds the hash of the next node's 188 words (injective,
  zero-padded) at its index / 2; the root hash is that of the first node.
Public inputs: nullifier[0..4] root hash[4..8] funding amount[8..12]
exit account[12..16]."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import field as F
from .poseidon import sponge_rows

NODE_WORDS = 188


def injective_words(data: bytes) -> np.ndarray:
    data = data + b"\x00" * (-len(data) % 4)
    return np.frombuffer(data, dtype="<u4").astype(np.uint64)


def digest_words(data: bytes) -> np.ndarray:
    if len(data) != 32:
        raise ValueError("a digest is 32 bytes")
    words = np.frombuffer(data, dtype="<u8").astype(np.uint64)
    if (words >= F._P).any():
        raise ValueError("a digest word is not below p")
    return words


def digest_bytes(words) -> bytes:
    return np.asarray(words, dtype="<u8").tobytes()


def u64_words(v: int) -> np.ndarray:
    return np.array([(v >> 32) & 0xFFFFFFFF, v & 0xFFFFFFFF], dtype=np.uint64)


def u128_words(v: int) -> np.ndarray:
    return np.array([(v >> (96 - 32 * i)) & 0xFFFFFFFF for i in range(4)], dtype=np.uint64)


def node_words(node: bytes) -> np.ndarray:
    words = injective_words(node)
    if len(words) > NODE_WORDS:
        raise ValueError("a storage-proof node is longer than 188 words")
    padded = np.zeros(NODE_WORDS, dtype=np.uint64)
    padded[: len(words)] = words
    return padded


@dataclass
class Withdrawal:
    secret: bytes
    transfer_count: int
    funding_account: bytes
    funding_amount: int
    exit_account: bytes
    unspendable_account: bytes
    nodes: list  # bytes each, embedded hashes rebuilt
    indices: list  # hex-character offsets of each node's embedded hash
    root_hash: bytes
    public_inputs: np.ndarray  # (16,)


@dataclass
class Fields:
    """What a withdrawal's owner chooses."""
    secret: bytes  # 32 bytes
    transfer_count: int  # u64
    funding_account: bytes  # a digest
    funding_amount: int  # u128
    exit_account: bytes  # a digest


def build_many(fields: list, template_nodes: list, indices: list) -> list:
    """The withdrawals of `fields` over the template's nodes (their sizes
    and hash offsets kept, their embedded hashes rebuilt), each hash taken
    for all of them in one batch."""
    secrets = np.stack([injective_words(f.secret) for f in fields])
    if secrets.shape[1] != 8:
        raise ValueError("the secret is 32 bytes")
    counts = np.stack([u64_words(f.transfer_count) for f in fields])
    K = len(fields)

    def double_hash(salt, *parts):
        salt_words = np.broadcast_to(injective_words(salt.encode()), (K, 2))
        return sponge_rows(sponge_rows(np.concatenate((salt_words,) + parts, axis=1)))

    unspendable = double_hash("wormhole", secrets)
    nullifier = double_hash("~nullif~", secrets, counts)
    amounts = np.stack([u128_words(f.funding_amount) for f in fields])
    leaf = sponge_rows(np.concatenate([
        counts, np.stack([digest_words(f.funding_account) for f in fields]), unspendable,
        amounts], axis=1))
    nodes = [[bytearray(n) for n in template_nodes] for _ in fields]
    child = leaf
    for i in reversed(range(len(template_nodes))):
        off = indices[i] // 2
        for k in range(K):
            nodes[k][i][off : off + 32] = digest_bytes(child[k])
        child = sponge_rows(np.stack([node_words(bytes(nodes[k][i])) for k in range(K)]))
    exits = np.stack([digest_words(f.exit_account) for f in fields])
    pis = np.concatenate([nullifier, child, amounts, exits], axis=1)
    return [Withdrawal(
        secret=f.secret, transfer_count=f.transfer_count, funding_account=f.funding_account,
        funding_amount=f.funding_amount, exit_account=f.exit_account,
        unspendable_account=digest_bytes(unspendable[k]), nodes=[bytes(n) for n in nodes[k]],
        indices=list(indices), root_hash=digest_bytes(child[k]), public_inputs=pis[k])
        for k, f in enumerate(fields)]

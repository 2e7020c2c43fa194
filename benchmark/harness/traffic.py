"""The one generator of traffic: what a mix's data file asks for, drawn
from --seed.

A withdrawal's owner draws a 32-byte secret, a transfer count (u64), a
funding account and an exit account (digests: four words below p) and a
funding amount (u128); its storage proof keeps the template's node sizes
and hash offsets (the mix's `withdrawal` file) with the embedded hashes
rebuilt.  A mix with `pool` sends the pool's withdrawals in a seeded
order, cycling; one with `leaf_pool` and `batch_leaves` sends batches of
that many distinct leaves of the pool, each batch in a seeded order."""

from __future__ import annotations

import json
import os

import numpy as np

from reference import field as F
from reference import withdrawal as W

TRAFFIC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "traffic")


def rng_of(seed: int) -> np.random.Generator:
    """The seed's generator: any integer, negative or past 64 bits."""
    return np.random.default_rng(int(seed) % (1 << 64))


def _digest(rng) -> bytes:
    return W.digest_bytes(rng.integers(0, F.P, size=4, dtype=np.uint64))


def draw_fields(rng: np.random.Generator, n: int) -> list:
    out = []
    for _ in range(n):
        out.append(W.Fields(
            secret=rng.bytes(32),
            transfer_count=int.from_bytes(rng.bytes(8), "little"),
            funding_account=_digest(rng),
            funding_amount=int.from_bytes(rng.bytes(16), "little"),
            exit_account=_digest(rng)))
    return out


def withdrawals(rng: np.random.Generator, n: int, template: str) -> list:
    """n distinct withdrawals over the named storage-proof template."""
    with open(os.path.join(TRAFFIC_DIR, f"{template}.json")) as f:
        t = json.load(f)
    return W.build_many(draw_fields(rng, n), [bytes.fromhex(x) for x in t["nodes"]],
                        t["indices"])


def batches(rng: np.random.Generator, pool: int, size: int, count: int) -> list:
    """`count` batches of `size` distinct indices into the pool, each in
    its own seeded order."""
    return [list(rng.choice(pool, size=size, replace=False)) for _ in range(count)]

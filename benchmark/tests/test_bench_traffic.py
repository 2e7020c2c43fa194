"""The seeded generator: the same seed gives the same traffic, another
seed other traffic, every withdrawal of a pool distinct and well formed,
and every batch distinct leaves."""

import numpy as np
import pytest

from harness import traffic
from reference import field as F


def pool(seed, n=6):
    return traffic.withdrawals(traffic.rng_of(seed), n, "storage_proof_7")


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 5303535991, -3])
def test_same_seed_same_pool(seed):
    a, b = pool(seed), pool(seed)
    assert [w.nodes for w in a] == [w.nodes for w in b]
    assert all(np.array_equal(x.public_inputs, y.public_inputs) for x, y in zip(a, b))


def test_seeds_differ_and_withdrawals_are_distinct():
    a, b = pool(1), pool(2)
    keys = {w.public_inputs.tobytes() for w in a + b}
    assert len(keys) == len(a) + len(b)
    for w in a:
        assert w.public_inputs.shape == (16,) and (w.public_inputs < F.P).all()
        assert len(w.nodes) == 7 and all(len(n) <= 4 * 188 for n in w.nodes)


def test_batches_are_distinct_leaves_in_seeded_orders():
    rng = traffic.rng_of(9)
    bs = traffic.batches(rng, 16, 8, 50)
    assert all(len(set(b)) == 8 and all(0 <= i < 16 for i in b) for b in bs)
    assert len({tuple(b) for b in bs}) == 50
    assert bs == traffic.batches(traffic.rng_of(9), 16, 8, 50)

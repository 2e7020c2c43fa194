"""The port's device Merkle builder (qzk_tpu_torch.ops.merkle.
build_merkle_levels, K1 on the card, its plain version here) against
the JAX package's host tree (qzk_tpu.ops.merkle.build_merkle_tree):
every level and the cap.  Exact equality."""

import numpy as np
import pytest
import torch

from qzk_tpu.ops import goldilocks as gl
from qzk_tpu.ops import merkle as jmk
from qzk_tpu_torch.ops import goldilocks_torch as gt
from qzk_tpu_torch.ops import merkle as tmk


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the host's cores: one torch thread each."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize(
    "log_n,w,cap_height", [(4, 2, 1), (6, 4, 4), (6, 8, 0), (7, 135, 4), (8, 24, 4), (5, 32, 2)]
)
def test_levels_and_cap_match_host_tree(log_n, w, cap_height, rng):
    leaves = rng.integers(0, gl.P, size=(1 << log_n, w), dtype=np.uint64)
    want = jmk.build_merkle_tree(leaves, cap_height)
    levels = tmk.build_merkle_levels(gt.from_u64(leaves), cap_height)
    assert len(levels) == len(want.levels)
    for got, exp in zip(levels, want.levels):
        assert (gt.to_u64(got) == exp).all()
    assert (gt.to_u64(levels[-1]) == want.cap).all()


def test_tree_proofs_verify_against_cap(rng):
    leaves = rng.integers(0, gl.P, size=(64, 12), dtype=np.uint64)
    levels = tmk.build_merkle_levels(gt.from_u64(leaves), 2)
    tree = tmk.MerkleTree(leaves=leaves, levels=[gt.to_u64(l) for l in levels], cap_height=2)
    for i in (0, 17, 63):
        assert jmk.verify_merkle_proof(leaves[i], i, tree.prove(i), tree.cap)
        assert tmk.verify_merkle_proof(leaves[i], i, tree.prove(i), tree.cap)

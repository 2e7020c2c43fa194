"""The plain versions of the Poseidon CUDA kernels (K1 row sponge, K2
permutation; qzk_tpu_torch.ops.poseidon_torch, reached here through the
poseidon_cuda wrappers with CPU tensors) against the JAX package: its
numpy oracle (qzk_tpu.ops.poseidon), its JAX layer
(qzk_tpu.ops.poseidon_jax) on non-canonical lanes, and the Pallas
kernel's own u32 math (poseidon_pallas.permute_reference_math).  Exact
equality throughout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qzk_tpu.ops import goldilocks as gl
from qzk_tpu.ops import poseidon as pos
from qzk_tpu.ops import poseidon_jax as pj
from qzk_tpu.ops import poseidon_pallas as pp
from qzk_tpu_torch.ops import goldilocks_torch as gt
from qzk_tpu_torch.ops import poseidon_cuda as pc
from qzk_tpu_torch.ops import poseidon_torch as pt

EDGES = np.array([0, 1, gl.P - 1, 1 << 63, gl.P - (1 << 32), (1 << 32) - 1], dtype=np.uint64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the host's cores: one torch thread each."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _states(rng, b, w=12, canonical=True):
    hi = gl.P if canonical else 1 << 64
    x = rng.integers(0, hi, size=(b, w), dtype=np.uint64)
    k = min(b, len(EDGES))
    x[:k] = EDGES[:k, None]
    return x


def test_permute_matches_oracle(rng):
    s = _states(rng, 300)
    assert (gt.to_u64(pc.permute(gt.from_u64(s))) == pos.permute(s)).all()


def test_permute_matches_jax_on_noncanonical_lanes(rng):
    s = _states(rng, 64, canonical=False)
    s[0] = (1 << 64) - 1
    want = np.asarray(pj.permute_batch_u64(s))
    assert (gt.to_u64(pt.permute(gt.from_u64(s))) == want).all()


def test_permute_matches_pallas_kernel_math(rng):
    s = _states(rng, 32)
    with jax.disable_jit():
        want = np.asarray(pp.permute_reference_math(jnp.asarray(s)))
    assert (gt.to_u64(pc.permute(gt.from_u64(s))) == want).all()


@pytest.mark.parametrize("w", [1, 4, 8, 9, 135])
@pytest.mark.parametrize("n", [1, 100, 259])
def test_hash_no_pad_rows(w, n, rng):
    rows = _states(rng, n, w)
    got = gt.to_u64(pc.hash_no_pad_rows(gt.from_u64(rows)))
    assert got.shape == (n, 4)
    assert (got == pos.hash_no_pad_rows(rows)).all()


def test_hash_no_pad_rows_noncanonical_matches_jax(rng):
    rows = _states(rng, 50, 20, canonical=False)
    want = np.asarray(pj.hash_no_pad_batch(jnp.asarray(rows)))
    assert (gt.to_u64(pc.hash_no_pad_rows(gt.from_u64(rows))) == want).all()


def test_two_to_one(rng):
    left, right = _states(rng, 77, 4), _states(rng, 77, 4)[::-1].copy()
    got = gt.to_u64(pc.two_to_one(gt.from_u64(left), gt.from_u64(right)))
    want = np.stack([pos.two_to_one(a, b) for a, b in zip(left, right)])
    assert (got == want).all()


def test_wrappers_validate_inputs_and_count_only_kernel_launches(rng):
    rows = gt.from_u64(_states(rng, 16, 8))
    pc.reset_launches()
    pc.hash_no_pad_rows(rows)
    pc.permute(gt.from_u64(_states(rng, 4)))
    assert pc.LAUNCHES == {"hash_rows": 0, "permute": 0}  # CPU: plain version
    with pytest.raises(TypeError):
        pc.hash_no_pad_rows(rows.to(torch.int32))
    with pytest.raises(ValueError):
        pc.hash_no_pad_rows(rows.t())
    with pytest.raises(ValueError):
        pc.permute(rows)
    with pytest.raises(ValueError):
        pc.hash_no_pad_rows(rows[0])

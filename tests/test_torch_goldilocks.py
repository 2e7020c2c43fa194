"""The port's torch field layer (qzk_tpu_torch.ops.goldilocks_torch)
against the JAX package's numpy oracle (qzk_tpu.ops.goldilocks) on
canonical values, and against its JAX layer (qzk_tpu.ops.goldilocks_jax)
on any 64-bit lanes, canonical or not.  Exact equality throughout:
this is integer field arithmetic."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qzk_tpu.ops import goldilocks as gl
from qzk_tpu.ops import goldilocks_jax as gj
from qzk_tpu_torch.ops import goldilocks_torch as gt

P = gl.P
EDGES = np.array([0, 1, 2, P - 1, P - 2, (1 << 32) - 1, 1 << 32, 1 << 63], dtype=np.uint64)
NONCANON = np.array([P, P + 1, (1 << 64) - 1, (1 << 64) - 2, 1 << 63], dtype=np.uint64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the host's cores: one torch thread each."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _canonical(rng, n=512):
    x = rng.integers(0, P, size=n, dtype=np.uint64)
    x[: len(EDGES)] = EDGES
    return x


def _any64(rng, n=512):
    x = rng.integers(0, 1 << 64, size=n, dtype=np.uint64)
    x[: len(NONCANON)] = NONCANON
    x[len(NONCANON) : len(NONCANON) + len(EDGES)] = EDGES
    return x


def _t(x):
    return gt.from_u64(x)


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_binary_ops_match_oracle(op, rng):
    a, b = _canonical(rng), _canonical(rng)[::-1].copy()
    got = gt.to_u64(getattr(gt, op)(_t(a), _t(b)))
    assert (got == getattr(gl, op)(a, b)).all()


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_binary_ops_match_jax_on_noncanonical_lanes(op, rng):
    a, b = _any64(rng), _any64(rng)[::-1].copy()
    got = gt.to_u64(getattr(gt, op)(_t(a), _t(b)))
    want = np.asarray(getattr(gj, op)(jnp.asarray(a), jnp.asarray(b)))
    assert (got == want).all()


def test_reduce128_matches_jax_on_any_words(rng):
    lo, hi = _any64(rng), _any64(rng)[::-1].copy()
    got = gt.to_u64(gt.reduce128(_t(lo), _t(hi)))
    assert (got == np.asarray(gj.reduce128(jnp.asarray(lo), jnp.asarray(hi)))).all()


@pytest.mark.parametrize("c", [0, 1, 7, 49, (1 << 32) - 1])
def test_mul_small(c, rng):
    a = _any64(rng)
    got = gt.to_u64(gt.mul_small(_t(a), c))
    assert (got == np.asarray(gj.mul_small(jnp.asarray(a), c))).all()
    canon = _canonical(rng)
    assert (gt.to_u64(gt.mul_small(_t(canon), c)) == gl.mul(canon, np.uint64(c))).all()


def test_neg_square_exp(rng):
    a = _canonical(rng)
    assert (gt.to_u64(gt.neg(_t(a))) == gl.neg(a)).all()
    assert (gt.to_u64(gt.square(_t(a))) == gl.mul(a, a)).all()
    assert (gt.to_u64(gt.exp_const(_t(a), 12345)) == gl.exp(a, 12345)).all()


def test_inverse_and_batch_inverse(rng):
    a = _canonical(rng, 64)
    a[a == 0] = 3
    assert (gt.to_u64(gt.inverse(_t(a))) == gl.inverse(a)).all()
    m = a.reshape(8, 8)
    got = gt.to_u64(gt.batch_inverse_axis(_t(m), axis=1))
    assert (got == gl.inverse(m)).all()


def test_sum_mod_and_prefix_product(rng):
    a = _canonical(rng, 7 * 9).reshape(7, 9)
    for axis in (0, 1):
        assert (gt.to_u64(gt.sum_mod(_t(a), axis=axis)) == gl.sum_mod(a, axis=axis)).all()
    col = _canonical(rng, 37)
    want = np.asarray(gj.prefix_prod_exclusive(jnp.asarray(col)))
    assert (gt.to_u64(gt.prefix_prod_exclusive(_t(col))) == want).all()
    assert want[0] == 1 and want[5] == gl.mul(gl.mul(gl.mul(col[0], col[1]), gl.mul(col[2], col[3])), col[4])


def test_powers_vec(rng):
    b = int(rng.integers(2, P, dtype=np.uint64))
    got = gt.to_u64(gt.powers_vec(gt.scalar(b), 37))
    want = np.array([pow(b, i, P) for i in range(37)], dtype=np.uint64)
    assert (got == want).all()


def test_extension_ops(rng):
    a = _canonical(rng, 128).reshape(64, 2)
    b = _canonical(rng, 128)[::-1].copy().reshape(64, 2)
    assert (gt.to_u64(gt.ext_mul(_t(a), _t(b))) == gl.ext_mul(a, b)).all()
    assert (gt.to_u64(gt.ext_add(_t(a), _t(b))) == gl.ext_add(a, b)).all()
    assert (gt.to_u64(gt.ext_sub(_t(a), _t(b))) == gl.ext_sub(a, b)).all()
    nz = a.copy()
    nz[(nz == 0).all(axis=1)] = [1, 0]
    want = np.stack([gl.ext_inverse(x) for x in nz])
    assert (gt.to_u64(gt.ext_inverse_vec(_t(nz))) == want).all()
    z = a[5]
    assert (gt.to_u64(gt.ext_powers(_t(z), 19)) == gl.ext_powers_vec(z, 19)).all()


def test_bit_pattern_round_trip_and_unsigned_compare(rng):
    x = _any64(rng)
    assert (gt.to_u64(_t(x)) == x).all()
    y = x[::-1].copy()
    assert (gt.lt(_t(x), _t(y)).numpy() == (x < y)).all()
    assert (gt.to_u64(gt.shr(_t(x), 32)) == (x >> np.uint64(32))).all()
    assert _t(x).dtype == torch.int64

"""The zk blinding stream: qzk_tpu_torch.ops.threefry against
jax.random (PRNGKey, split, bits of uint64 >> 1) bit for bit, and the
port prover's blinding_stream against the JAX prover's sequence of
draws (qzk_tpu/plonk/prover.py: one split a draw, the blind block first
when there is one, then the wires, zs and quotient salts)."""

import jax
import numpy as np
import pytest
import torch

from qzk_tpu.ops import poseidon as jpos
from qzk_tpu_torch.ops import goldilocks as gl
from qzk_tpu_torch.ops import threefry
from qzk_tpu_torch.plonk.prover import blinding_stream

RANDOM_SEEDS = [
    int(s) for s in np.random.default_rng(20261017).integers(0, 1 << 63, size=3, dtype=np.uint64)
]
SEEDS = [0, 1, (1 << 32) - 1, 1 << 32, (1 << 63) - 1] + RANDOM_SEEDS
SHAPES = [(1,), (7, 4), (1000, 135), (65536, 4)]


def _key(k) -> tuple[int, int]:
    return tuple(int(v) for v in np.asarray(k))


def _jax_draw(sub, shape) -> np.ndarray:
    return np.asarray(jax.random.bits(sub, shape, "uint64") >> np.uint64(1))


def test_jax_threefry_is_partitionable_with_x64():
    """The port copies the partitionable counters; a JAX that turns the
    flag off would change the reference's bytes, and must fail here."""
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_enable_x64 is True


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_and_bits_match_jax(seed, shape):
    jkey = jax.random.PRNGKey(seed)
    key = threefry.prng_key(seed)
    assert key == _key(jkey)
    jnew, jsub = jax.random.split(jkey)
    new, sub = threefry.split(key)
    assert (new, sub) == (_key(jnew), _key(jsub))
    got = threefry.random_bits_u64_shr1(sub, shape, "cpu")
    assert got.dtype == torch.int64 and tuple(got.shape) == shape
    got = got.numpy().view(np.uint64)
    want = _jax_draw(jsub, shape)
    assert want.dtype == np.uint64
    assert np.array_equal(got, want)
    assert (got < np.uint64(1 << 63)).all() and (got < np.uint64(gl.P)).all()


def test_rotations_of_words_at_or_above_2_31():
    """Python ints and int64 tensors give the same rounds, with the
    top bit of a 32-bit word set."""
    words = [0, 1, (1 << 31) - 1, 1 << 31, (1 << 31) + 12345, (1 << 32) - 1]
    k1, k2 = (1 << 32) - 1, 1 << 31
    x0 = torch.tensor(words, dtype=torch.int64)
    x1 = torch.tensor(words[::-1], dtype=torch.int64)
    t0, t1 = threefry.threefry2x32(k1, k2, x0, x1)
    for i, (a, b) in enumerate(zip(words, words[::-1])):
        assert threefry.threefry2x32(k1, k2, a, b) == (int(t0[i]), int(t1[i]))
    assert (t0 >= 0).all() and (t0 <= 0xFFFFFFFF).all()


def test_seed_out_of_range_raises():
    with pytest.raises(ValueError):
        threefry.prng_key(1 << 63)
    with pytest.raises(ValueError):
        threefry.prng_key(-1)


def test_draw_lands_on_the_device_asked():
    assert threefry.random_bits_u64_shr1((1, 2), (3, 4), "meta").device.type == "meta"


@pytest.mark.parametrize("blind_rows", [0, 5])
def test_blinding_stream_matches_the_jax_prover_sequence(blind_rows):
    """blind block (when asked), wires, zs and quotient salts."""
    values = np.random.default_rng(blind_rows).integers(
        0, gl.P, size=1500, dtype=np.uint64)
    lde, wires = 256, 135
    seed = int.from_bytes(
        jpos.hash_no_pad(values[:1024]).astype("<u8").tobytes()[:8], "little")
    jkey = jax.random.PRNGKey(seed & 0x7FFFFFFFFFFFFFFF)
    shapes = ([(blind_rows, wires)] if blind_rows else []) + [(lde, 4)] * 3
    draw = blinding_stream(values, "cpu")
    for shape in shapes:
        jkey, sub = jax.random.split(jkey)
        got = draw(shape).numpy().view(np.uint64)
        assert np.array_equal(got, _jax_draw(sub, shape)), shape

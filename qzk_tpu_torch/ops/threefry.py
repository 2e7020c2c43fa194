"""The zk prover's blinding stream: Threefry-2x32 as ``jax.random`` runs
it in its partitionable mode with 64-bit types on, bit for bit.

The JAX package draws its blinding values with
``jax.random.PRNGKey(seed)``, one ``jax.random.split`` a draw and
``jax.random.bits(sub, shape, "uint64") >> 1``.  With
``jax_threefry_partitionable`` on, those are:

  PRNGKey(seed)  -> (seed >> 32, seed & 0xFFFFFFFF);
  split(key)     -> rows 0 (the new key) and 1 (the subkey) of
                    threefry2x32(key, hi, lo) over the counters 0 and 1,
                    each counter split into its high and low 32-bit words;
  bits(key, shape, uint64)
                 -> (bits1 << 32) | bits2, with (bits1, bits2) =
                    threefry2x32(key, hi, lo) over the row-major linear
                    index of each element.

Each 32-bit word is held in an int64 and masked after every add, so the
same code runs on Python ints (keys) and on torch int64 tensors (draws).
A draw returns ``(bits1 << 31) | (bits2 >> 1)``, the uint64 shifted
right by one: below 2^63 < p, so a canonical field element whose int64
bit pattern never has the sign bit set.

On a CUDA device a draw is one launch of the kernel K8
(``threefry_cuda``, csrc/threefry.cu); on any other it is the plain
version, ``plain_bits_u64_shr1``, torch ops on int64 tensors, which is
K8's oracle.  Keys and splits stay on the host as Python ints.
"""

from __future__ import annotations

import math

import torch

from . import threefry_cuda

MASK32 = 0xFFFFFFFF
KS_PARITY = 0x1BD11BDA
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k1: int, k2: int, x0, x1):
    """Threefry-2x32 with 20 rounds of the key (k1, k2) on the counter
    words (x0, x1): Python ints or int64 tensors holding 32-bit words."""
    ks = (k1, k2, k1 ^ k2 ^ KS_PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + (ks[(i + 2) % 3] + i + 1)) & MASK32
    return x0, x1


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` for 0 <= seed < 2^63, as host ints."""
    seed = int(seed)
    if not 0 <= seed < 1 << 63:
        raise ValueError(f"seed {seed} is not in [0, 2^63)")
    return seed >> 32, seed & MASK32


def split(key: tuple[int, int]) -> tuple[tuple[int, int], tuple[int, int]]:
    """``jax.random.split(key)``: (new key, subkey)."""
    a0, a1 = threefry2x32(key[0], key[1], 0, 0)
    b0, b1 = threefry2x32(key[0], key[1], 0, 1)
    return (a0, a1), (b0, b1)


def random_bits_u64_shr1(key: tuple[int, int], shape, device) -> torch.Tensor:
    """``jax.random.bits(key, shape, "uint64") >> 1`` as int64 on
    `device`: K8 on a CUDA device, the plain version on any other."""
    if torch.device(device).type == "cuda":
        return threefry_cuda.draw(key, shape, device)
    return plain_bits_u64_shr1(key, shape, device)


def plain_bits_u64_shr1(key: tuple[int, int], shape, device) -> torch.Tensor:
    """The draw as torch ops on int64 tensors, on any device (about 170
    launches on a card): K8's oracle."""
    shape = tuple(int(s) for s in shape)
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    hi, lo = threefry2x32(key[0], key[1], idx >> 32, idx & MASK32)
    return ((hi << 31) | (lo >> 1)).reshape(shape)

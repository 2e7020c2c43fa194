"""The zk blinding stream: qzk_tpu_torch.ops.threefry against
jax.random (PRNGKey, split, bits of uint64 >> 1) bit for bit, and the
port prover's blinding_stream against the JAX prover's sequence of
draws (qzk_tpu/plonk/prover.py: one split a draw, the blind block first
when there is one, then the wires, zs and quotient salts).

The card's draw, K8 (ops/csrc/threefry.cu), cannot run here, so its
source is compiled for the host with g++, the CUDA qualifiers stubbed
out and every thread of its grid run in turn, and held to jax.random and
to the plain draw: at the grid the card launches, at grids small enough
that the grid-stride loop turns, on odd counts and at counters whose
high word is set."""

import ctypes
import os
import re
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch

from qzk_tpu.ops import poseidon as jpos
from qzk_tpu_torch.ops import goldilocks as gl
from qzk_tpu_torch.ops import threefry
from qzk_tpu_torch.ops import threefry_cuda
from qzk_tpu_torch.plonk.prover import blinding_seed, blinding_stream

RANDOM_SEEDS = [
    int(s) for s in np.random.default_rng(20261017).integers(0, 1 << 63, size=3, dtype=np.uint64)
]
SEEDS = [0, 1, (1 << 32) - 1, 1 << 32, (1 << 63) - 1] + RANDOM_SEEDS
SHAPES = [(1,), (7, 4), (1000, 135), (65536, 4)]
ODD = (5, 7)

CUDA_STUBS = r"""
#pragma once
#include <cstdint>
#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
typedef int cudaError_t;
typedef void* cudaStream_t;
#define cudaErrorMisalignedAddress 716
inline int cudaGetLastError() { return 0; }
struct ulonglong2 { unsigned long long x, y; };
inline ulonglong2 make_ulonglong2(unsigned long long x, unsigned long long y) { return {x, y}; }
inline uint32_t __funnelshift_l(uint32_t lo, uint32_t hi, unsigned s) {
  s &= 31;
  return s ? (hi << s) | (lo >> (32 - s)) : hi;
}
struct HostDim { unsigned x = 0, y = 0, z = 0; };
static HostDim threadIdx, blockIdx, blockDim, gridDim;
"""

HOST_ENTRY = r"""
extern "C" {
// Every thread of a (grid, block) launch, one after another.
void host_draw(unsigned k0, unsigned k1, uint64_t* out, long long n, unsigned grid,
               unsigned block) {
  gridDim.x = grid;
  blockDim.x = block;
  for (unsigned b = 0; b < grid; ++b) {
    for (unsigned t = 0; t < block; ++t) {
      blockIdx.x = b;
      threadIdx.x = t;
      threefry_draw_kernel(k0, k1, reinterpret_cast<ulonglong2*>(out), n);
    }
  }
}
uint64_t host_bits(unsigned k0, unsigned k1, uint64_t i) { return threefry_bits(k0, k1, i); }
}
"""


def _key(k) -> tuple[int, int]:
    return tuple(int(v) for v in np.asarray(k))


def _jax_draw(sub, shape) -> np.ndarray:
    return np.asarray(jax.random.bits(sub, shape, "uint64") >> np.uint64(1))


def _sub(seed) -> tuple[int, int]:
    return threefry.split(threefry.prng_key(seed))[1]


@pytest.fixture(scope="module")
def host_k8(tmp_path_factory):
    """threefry.cu compiled for the host."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to build the kernel source for the host")
    d = tmp_path_factory.mktemp("threefry_host")
    (d / "cuda_runtime.h").write_text(CUDA_STUBS)
    with open(os.path.join(os.path.dirname(threefry_cuda.__file__), "csrc", "threefry.cu")) as f:
        src = re.sub(r"<<<.*?>>>", "", f.read(), flags=re.S)
    (d / "threefry_host.cpp").write_text(src + HOST_ENTRY)
    so = d / "threefry_host.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-I", str(d),
                    str(d / "threefry_host.cpp"), "-o", str(so)], check=True)
    lib = threefry_cuda.bind(ctypes.CDLL(str(so)))
    u, ll, vp = ctypes.c_uint, ctypes.c_longlong, ctypes.c_void_p
    lib.host_draw.argtypes = [u, u, vp, ll, u, u]
    lib.host_bits.argtypes = [u, u, ctypes.c_uint64]
    lib.host_bits.restype = ctypes.c_uint64
    return lib


def _host_draw(lib, key, n, grid=None, block=256) -> np.ndarray:
    """The host build's draw of n elements at (grid, block), by default
    the card's launch; the words past n stay at a marker."""
    out = np.full(n + 3, 0xDEADBEEF, dtype=np.uint64)
    grid = lib.qzk_threefry_blocks(n) if grid is None else grid
    lib.host_draw(key[0], key[1], out.ctypes.data, n, grid, block)
    assert (out[n:] == 0xDEADBEEF).all(), "wrote past the draw"
    return out[:n]


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
    draw = blinding_stream(blinding_seed(values), "cpu")
    for shape in shapes:
        jkey, sub = jax.random.split(jkey)
        got = draw(shape).numpy().view(np.uint64)
        assert np.array_equal(got, _jax_draw(sub, shape)), shape


@pytest.mark.parametrize("shape", SHAPES + [ODD], ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_cpu_draw_is_the_plain_version_and_launches_nothing(seed, shape):
    """On the CPU a draw runs the plain torch code: jax.random's bits,
    and no K8 launch."""
    sub = _sub(seed)
    before = dict(threefry_cuda.LAUNCHES)
    got = threefry.random_bits_u64_shr1(sub, shape, "cpu")
    assert threefry_cuda.LAUNCHES == before
    assert torch.equal(got, threefry.plain_bits_u64_shr1(sub, shape, "cpu"))
    jkey = jax.random.split(jax.random.PRNGKey(seed))[1]
    assert np.array_equal(got.numpy().view(np.uint64), _jax_draw(jkey, shape))


def test_threefry_kernel_build_needs_nvcc():
    """Without nvcc K8's build raises; nothing falls back."""
    if shutil.which("nvcc") is None and not os.path.exists("/usr/local/cuda/bin/nvcc"):
        with pytest.raises(RuntimeError, match="nvcc"):
            threefry_cuda.library_path()
    else:
        assert os.path.exists(threefry_cuda.library_path())


def test_k8_refuses_a_host_device_and_wide_key_words():
    with pytest.raises(ValueError, match="CUDA"):
        threefry_cuda.draw((1, 2), (4,), "cpu")
    with pytest.raises(ValueError, match="32-bit"):
        threefry_cuda.draw((1 << 32, 2), (4,), "cuda")


@pytest.mark.parametrize("shape", [(1,), (7, 4), ODD, (1000, 135), (65536, 4)], ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_k8_source_matches_jax_at_the_cards_grid(host_k8, seed, shape):
    sub = _sub(seed)
    got = _host_draw(host_k8, sub, int(np.prod(shape)))
    jkey = jax.random.split(jax.random.PRNGKey(seed))[1]
    assert np.array_equal(got, _jax_draw(jkey, shape).reshape(-1))


@pytest.mark.parametrize("n", [1, 2, 3, 63, 64, 65, 1001, 4096])
@pytest.mark.parametrize("grid,block", [(1, 32), (3, 64), (1, 1)])
def test_k8_grid_stride_and_odd_tail(host_k8, n, grid, block):
    """Grids smaller than the draw: the loop over pairs turns, and an odd
    count's last element is written once."""
    sub = _sub(RANDOM_SEEDS[0])
    got = _host_draw(host_k8, sub, n, grid, block)
    want = threefry.plain_bits_u64_shr1(sub, (n,), "cpu").numpy().view(np.uint64)
    assert np.array_equal(got, want)


def test_k8_counters_with_the_high_word_set(host_k8):
    """Element i's counter is (i >> 32, i & 0xFFFFFFFF), as the plain
    rounds on Python ints give it."""
    for seed in SEEDS[:4]:
        k0, k1 = _sub(seed)
        for i in (0, 1, (1 << 32) - 1, 1 << 32, (1 << 32) + 7, (1 << 40) + 3, (1 << 63) - 1):
            hi, lo = threefry.threefry2x32(k0, k1, i >> 32, i & threefry.MASK32)
            assert host_k8.host_bits(k0, k1, i) == (hi << 31) | (lo >> 1)


def test_k8_launch_plan(host_k8):
    """One thread a pair of elements, the odd one included; at most
    4096 blocks of 256, past which the grid-stride loop covers the
    rest; nothing for an empty draw."""
    blocks = host_k8.qzk_threefry_blocks
    assert [blocks(n) for n in (1, 2, 512, 513, 262144, 1 << 20)] == [1, 1, 1, 2, 512, 2048]
    assert blocks(1 << 30) == 4096
    out = np.zeros(2, dtype=np.uint64)
    assert host_k8.qzk_threefry_draw(1, 2, out.ctypes.data, 0, None) == 0
    assert host_k8.qzk_threefry_draw(1, 2, out.ctypes.data + 8, 1, None) == 716

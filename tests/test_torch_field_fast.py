"""The field kernels K4-K7 (qzk_tpu_torch/ops/csrc/field.cu), checked on
the CPU.

The card is not here, so the kernel source itself is compiled for the
host with g++: goldilocks.cuh through the PTX-to-C++ translation of
tests/test_torch_poseidon_fast.py, and field.cu with the host runtime of
tests/test_torch_ntt_fast.py, in which a launch runs every block of the
grid in turn and each thread of a block is a coroutine that runs until
its next __syncthreads() (shared memory starts as garbage).  The tests
drive the wrapper's own launch functions (goldilocks_cuda.launch_*)
with that library and CPU tensors, so that the layout a wrapper
computes (broadcast, element strides, coalesced dims, lanes) is checked
with the kernel it feeds.

Each result is held bit for bit to the plain version
(goldilocks_torch) and to the JAX package's goldilocks_jax, on random
canonical values with the EDGES values planted, and on any 64-bit words
where the op takes them: the call sites' broadcast and stride patterns,
a zero lane in batch_inverse_axis, inverse(0) and ext_inverse_vec of
(0, 0), sum_mod at n = 0, 1, 2, odd n, along either axis and past one
block's shared memory, and prefix_prod_exclusive at n = 1, 2 and odd n.
Needs g++ only.
"""

import ctypes
import os
import re
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qzk_tpu.ops import goldilocks_jax as gj
from qzk_tpu_torch.ops import goldilocks_cuda as gc
from qzk_tpu_torch.ops import goldilocks_torch as gt
from test_torch_ntt_fast import HOST_RUNTIME
from test_torch_poseidon_fast import EDGES, _translate

P = 0xFFFFFFFF00000001
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "qzk_tpu_torch", "ops", "csrc")


@pytest.fixture(scope="module")
def host_field(tmp_path_factory):
    """field.cu compiled for the host, bound as goldilocks_cuda binds it."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to build the kernel source for the host")
    d = tmp_path_factory.mktemp("field_host")
    (d / "cuda_runtime.h").write_text(HOST_RUNTIME)
    with open(os.path.join(CSRC, "goldilocks.cuh")) as f:
        (d / "goldilocks.cuh").write_text(_translate(f.read()))
    with open(os.path.join(CSRC, "field.cu")) as f:
        src = f.read()
    src, n_smem = re.subn(r"extern __shared__ (\w+) (\w+)\[\];",
                          r"\1* \2 = reinterpret_cast<\1*>(hostsim::smem.data());", src)
    src, n_launch = re.subn(r"(\w+(?:<\w+>)?)<<<(.*?)>>>\((.*?)\);",
                            r"hostsim::launch(\2, [&] { \1(\3); });", src, flags=re.S)
    assert "<<<" not in src and "__shared__" not in src and (n_smem, n_launch) == (2, 9)
    (d / "field_host.cpp").write_text(_translate(src))
    so = d / "field_host.so"
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-I", str(d),
                    str(d / "field_host.cpp"), "-o", str(so)], check=True)
    return gc.bind(ctypes.CDLL(str(so)))


def _words(rng, shape, canonical=True):
    """Random canonical values (or any 64-bit words) with EDGES planted
    at both ends."""
    x = rng.integers(0, P if canonical else 1 << 64, size=shape, dtype=np.uint64)
    flat = x.reshape(-1)
    k = min(flat.size, len(EDGES))
    flat[:k] = EDGES[:k]
    flat[flat.size - k:] = EDGES[:k][::-1]
    return gt.from_u64(x)


def _run(host, launch, plan, *args):
    out = torch.empty(plan.out_shape, dtype=torch.int64)
    if out.numel():
        launch(host, plan, *args, out, None)
    return out


def _same(got, want):
    assert got.shape == want.shape
    assert (gt.to_u64(got) == np.asarray(want, dtype=np.uint64)).all()


def _j(x):
    return jnp.asarray(gt.to_u64(x))


# -- K4: the call sites' layouts ---------------------------------------------------


def _map_cases():
    def beta_by_block(rng):  # a 0-d beta against (N, 80) (zs_stage)
        return _words(rng, ()), _words(rng, (16, 10))

    def fold(rng):  # groups[:, k, None, :] against W[k][None, :, None] (FRI fold)
        m, a = 6, 4
        groups = _words(rng, (a * m, 2)).reshape(a, m, 2).movedim(0, 1)
        w = _words(rng, (a, a))
        return groups[:, 1, None, :], w[1][None, :, None]

    def halves(rng):  # t[:, 0::2] against t[:, 1::2] (chunk_products)
        t = _words(rng, (3, 8, 5))
        return t[:, 0::2], t[:, 1::2]

    def openings(rng):  # coeffs (S, N) against p[None, :, 0]
        return _words(rng, (5, 16)), _words(rng, (16, 2))[None, :, 0]

    def transposed(rng):
        return _words(rng, (7, 9)).T, _words(rng, (9, 7))

    def four_dims(rng):
        return _words(rng, (2, 1, 3, 5)), _words(rng, (4, 1, 5))[None]

    def coset_minus_z(rng):  # coset_points - z[0], z[0] a 0-d view at an offset
        return _words(rng, (33,)), _words(rng, (2,))[1]

    def any64(rng):
        return _words(rng, (4, 25), False), _words(rng, (25,), False)

    return {"beta_by_block": beta_by_block, "fold": fold, "halves": halves,
            "openings": openings, "transposed": transposed, "four_dims": four_dims,
            "coset_minus_z": coset_minus_z, "any64": any64}


MAP_CASES = _map_cases()


@pytest.mark.parametrize("op", ["add", "sub", "mul", "reduce128"])
@pytest.mark.parametrize("case", sorted(MAP_CASES))
def test_host_field_map_binary(host_field, rng, op, case):
    a, b = MAP_CASES[case](rng)
    plan = gc.map_plan(op, a, b)
    got = _run(host_field, gc.launch_map, plan, (a, b))
    want = getattr(gt, op)(a, b)
    _same(got, gt.to_u64(want))
    _same(got, getattr(gj, op)(_j(a), _j(b)))


@pytest.mark.parametrize("op", ["neg", "square", "mul_small"])
@pytest.mark.parametrize("canonical", [True, False], ids=["canonical", "any64"])
def test_host_field_map_unary(host_field, rng, op, canonical):
    a = _words(rng, (40, 6), canonical).T  # strided
    extra = (7,) if op == "mul_small" else ()
    plan = gc.map_plan(op, a, c=extra[0] if extra else None)
    got = _run(host_field, gc.launch_map, plan, (a,))
    _same(got, gt.to_u64(getattr(gt, op)(a, *extra)))
    _same(got, getattr(gj, op)(_j(a), *extra))


def _ext_mul_cases(rng):
    m = 12
    return {
        "contiguous": (_words(rng, (m, 2)), _words(rng, (m, 2))),
        "beta_expanded": (_words(rng, (m, 2)), _words(rng, (2,)).expand(m, 2)),  # fold
        "columns": (_words(rng, (2, m)).T, _words(rng, (m, 2))),  # component stride m
        "claims": (_words(rng, (3, 5, 2), False), _words(rng, (5, 2), False)),
    }


@pytest.mark.parametrize("case", ["contiguous", "beta_expanded", "columns", "claims"])
def test_host_field_ext_mul(host_field, rng, case):
    a, b = _ext_mul_cases(rng)[case]
    plan = gc.map_plan("ext_mul", a, b)
    got = _run(host_field, gc.launch_map, plan, (a, b))
    _same(got, gt.to_u64(gt.ext_mul(a, b)))
    _same(got, gj.ext_mul(_j(a), _j(b)))


# -- K5 -------------------------------------------------------------------------


@pytest.mark.parametrize("canonical", [True, False], ids=["canonical", "any64"])
def test_host_field_inverse(host_field, rng, canonical):
    a = _words(rng, (3, 20), canonical)[:, ::2]
    a[0, 0] = 0
    plan = gc.map_plan("inverse", a)
    got = _run(host_field, gc.launch_inverse, plan, a)
    assert int(got[0, 0]) == 0
    _same(got, gt.to_u64(gt.inverse(a)))
    _same(got, gj.inverse(_j(a)))


@pytest.mark.parametrize("layout", ["rows", "columns"])
def test_host_field_ext_inverse_vec(host_field, rng, layout):
    a = _words(rng, (17, 2)) if layout == "rows" else _words(rng, (2, 17)).T
    a[3] = 0  # (0, 0) -> (0, 0)
    plan = gc.map_plan("ext_inverse_vec", a)
    got = _run(host_field, gc.launch_inverse, plan, a)
    assert gt.to_u64(got[3]).tolist() == [0, 0]
    _same(got, gt.to_u64(gt.ext_inverse_vec(a)))
    _same(got, gj.ext_inverse_vec(_j(a)))


@pytest.mark.parametrize("shape,axis,transpose", [
    ((40, 10), 1, False),  # (N, 80) along axis 1, as zs_stage
    ((40, 10), 0, False),
    ((10, 40), 1, True),   # a transposed input
    ((2, 5, 3, 4), 2, False),
    ((6, 1), 1, False),
])
def test_host_field_batch_inverse(host_field, rng, shape, axis, transpose):
    a = _words(rng, shape)
    if transpose:
        a = a.T
    zero = [0] * a.dim()
    zero[axis] = a.shape[axis] - 1
    a[tuple(zero)] = 0  # a zero in lane 0
    plan = gc.lane_plan("batch_inverse_axis", a, axis)
    got = _run(host_field, gc.launch_batch_inverse, plan, a)
    _same(got, gt.to_u64(gt.batch_inverse_axis(a, axis)))
    _same(got, gj.batch_inverse_axis(_j(a), axis))
    assert (gt.to_u64(got.movedim(axis, -1).reshape(-1, a.shape[axis])[0]) == 0).all()


# -- K6 -------------------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 2, 5, 33])
@pytest.mark.parametrize("base", [0, 1, P - 1, P + 3, 0x1234567890ABCDEF])
def test_host_field_powers_vec(host_field, n, base):
    b = gt.from_u64(np.array([5, base], dtype=np.uint64))[1]  # 0-d, at an offset
    plan = gc.powers_plan("powers_vec", b, n)
    got = _run(host_field, gc.launch_powers, plan, b)
    _same(got, gt.to_u64(gt.powers_vec(b, n)))
    _same(got, gj.powers_vec(_j(b), n))


@pytest.mark.parametrize("n", [0, 1, 2, 7, 40])
@pytest.mark.parametrize("layout", ["contiguous", "column"])
def test_host_field_ext_powers(host_field, rng, n, layout):
    z = _words(rng, (2,), False) if layout == "contiguous" else _words(rng, (2, 3))[:, 1]
    plan = gc.powers_plan("ext_powers", z, n)
    got = _run(host_field, gc.launch_powers, plan, z)
    _same(got, gt.to_u64(gt.ext_powers(z, n)))
    _same(got, gj.ext_powers(_j(z), n))


# -- K7 -------------------------------------------------------------------------


# field.cu's sum_mod reduces 2 * SUM_SMEM_WORDS words a lane in one block
SUM_BLOCK_WORDS = 12288


@pytest.mark.parametrize("n", [0, 1, 2, 3, 37, 64, SUM_BLOCK_WORDS, SUM_BLOCK_WORDS + 7,
                               4 * SUM_BLOCK_WORDS + 5])
@pytest.mark.parametrize("axis", [0, 1])
def test_host_field_sum_mod(host_field, rng, n, axis):
    """Canonical values, any 64-bit words, and words all at or above p
    (so that the odd tail's add takes a non-canonical word too)."""
    lanes = 2 if n > 100 else 5
    shape = (n, lanes) if axis == 0 else (lanes, n)
    halvings, m = 0, n  # into scratch, alternating between two regions
    while m > SUM_BLOCK_WORDS:
        halvings, m = halvings + 1, m // 2
    above_p = gt.from_u64(rng.integers(P, 1 << 64, size=shape, dtype=np.uint64))
    for a in (_words(rng, shape), _words(rng, shape, False), above_p):
        plan = gc.lane_plan("sum_mod", a, axis)
        got = torch.empty(plan.out_shape, dtype=torch.int64)
        launches = gc.launch_sum_mod(host_field, plan, a, got, None)
        assert launches == 1 + halvings
        _same(got, gt.to_u64(gt.sum_mod(a, axis)))
        _same(got, gj.sum_mod(_j(a), axis))


def test_host_field_sum_mod_strided_3d(host_field, rng):
    a = _words(rng, (4, 9, 6), False).transpose(0, 2)[:, 1:]  # (6, 8, 4), strided
    for axis in (0, 1, 2, -1):
        plan = gc.lane_plan("sum_mod", a, axis)
        got = _run(host_field, gc.launch_sum_mod, plan, a)
        _same(got, gt.to_u64(gt.sum_mod(a, axis)))
        _same(got, gj.sum_mod(_j(a), axis))


@pytest.mark.parametrize("shape", [(1,), (2,), (37,), (1000,), (37, 3), (5, 2, 2)])
def test_host_field_prefix_prod(host_field, rng, shape):
    a = _words(rng, shape, canonical=len(shape) > 1)
    if len(shape) == 1 and shape[0] > 30:
        a[30] = 0  # the products past a zero are zero
    plan = gc.lane_plan("prefix_prod_exclusive", a, 0)
    got = _run(host_field, gc.launch_prefix_prod, plan, a)
    _same(got, gt.to_u64(gt.prefix_prod_exclusive(a)))
    _same(got, gj.prefix_prod_exclusive(_j(a)))


def test_host_field_prefix_prod_output_1_is_canonical(host_field):
    a = gt.from_u64(np.array([P + 5, 3, 4], dtype=np.uint64))
    got = _run(host_field, gc.launch_prefix_prod, gc.lane_plan("prefix_prod_exclusive", a, 0), a)
    assert gt.to_u64(got).tolist() == [1, 5, 15]

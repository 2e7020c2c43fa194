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
(goldilocks_torch, poseidon_torch for the Poseidon gate's round) and to
the JAX package's goldilocks_jax (poseidon_jax's S-box and MDS layer for
the round), on random canonical values with the EDGES values planted,
and on any 64-bit words where the op takes them: the call sites'
broadcast and stride patterns, each through the K4 path it should take
(the general one, the fast one, the fast one with 16-byte accesses and
an odd tail), pow7 and the round, batch_inverse_axis and
batch_divide_axis at k = 1, 2, odd, below and above a lane's thread
count and 80, along either axis and transposed, a zero lane beside an
intact one in the same block, inverse(0) and ext_inverse_vec of (0, 0),
powers of one base and of two in a launch around the tables' sizes and
at 8192, sum_mod and dot_mod at n = 0,
1, 2, odd n, along either axis (tiled along axis 0 over a lane count
that is no multiple of the tile) and past one block's shared memory,
prod_chunks with a ragged run and runs of one word, and
prefix_prod_exclusive at n = 1, 2 and odd n.  Needs g++ only.
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
from qzk_tpu.ops import poseidon_jax as pj
from qzk_tpu_torch.ops import goldilocks_cuda as gc
from qzk_tpu_torch.ops import goldilocks_torch as gt
from qzk_tpu_torch.ops import poseidon_torch as pt
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
    src, n_launch = re.subn(r"(\w+(?:<[\w, ]+>)?)<<<(.*?)>>>\((.*?)\);",
                            r"hostsim::launch(\2, [&] { \1(\3); });", src, flags=re.S)
    assert "<<<" not in src and "__shared__" not in src and (n_smem, n_launch) == (5, 16)
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

    def flat_odd(rng):  # contiguous, an odd length: the 16-byte path's tail
        return _words(rng, (33,), False), _words(rng, (33,), False)

    def row_broadcast(rng):  # sel[None, :] against (rows, M) constraints
        return _words(rng, (10,))[None, :], _words(rng, (6, 10))

    def column_broadcast(rng):  # a (12, M) state plus a (12, 1) column of constants
        return _words(rng, (12, 10)), _words(rng, (12, 1))

    def flat_strided(rng):  # a column of an (N, 80) block
        return _words(rng, (9, 10))[:, 3], _words(rng, (9,))

    return {"beta_by_block": beta_by_block, "fold": fold, "halves": halves,
            "openings": openings, "transposed": transposed, "four_dims": four_dims,
            "coset_minus_z": coset_minus_z, "any64": any64, "flat_odd": flat_odd,
            "row_broadcast": row_broadcast, "column_broadcast": column_broadcast,
            "flat_strided": flat_strided}


MAP_CASES = _map_cases()
# The K4 path of each case (field.cu's qzk_map_path): 0 the general one,
# 1 the fast one a word a thread, 2 the fast one with 16-byte accesses.
MAP_PATHS = {"beta_by_block": 2, "fold": 0, "halves": 1, "openings": 0, "transposed": 0,
             "four_dims": 0, "coset_minus_z": 2, "any64": 1, "flat_odd": 2,
             "row_broadcast": 2, "column_broadcast": 2, "flat_strided": 1}


@pytest.mark.parametrize("op", ["add", "sub", "mul", "reduce128"])
@pytest.mark.parametrize("case", sorted(MAP_CASES))
def test_host_field_map_binary(host_field, rng, op, case):
    a, b = MAP_CASES[case](rng)
    plan = gc.map_plan(op, a, b)
    got = _run(host_field, gc.launch_map, plan, (a, b))
    assert gc.map_path(host_field, plan, (a, b), got) == MAP_PATHS[case]
    want = getattr(gt, op)(a, b)
    _same(got, gt.to_u64(want))
    _same(got, getattr(gj, op)(_j(a), _j(b)))


def _pow7_jax(x):  # the JAX gate's x7 (the same multiplies as poseidon_jax's S-box)
    return pj._sbox(x)


@pytest.mark.parametrize("op", ["neg", "square", "mul_small", "pow7"])
@pytest.mark.parametrize("canonical", [True, False], ids=["canonical", "any64"])
def test_host_field_map_unary(host_field, rng, op, canonical):
    a = _words(rng, (40, 6), canonical).T  # strided
    extra = (7,) if op == "mul_small" else ()
    plan = gc.map_plan(op, a, c=extra[0] if extra else None)
    got = _run(host_field, gc.launch_map, plan, (a,))
    _same(got, gt.to_u64(getattr(gt, op)(a, *extra)))
    _same(got, _pow7_jax(_j(a)) if op == "pow7" else getattr(gj, op)(_j(a), *extra))


@pytest.mark.parametrize("op", ["mds_full", "mds_partial"])
@pytest.mark.parametrize("layout", ["wire_rows", "transposed"])
@pytest.mark.parametrize("canonical", [True, False], ids=["canonical", "any64"])
def test_host_field_mds(host_field, rng, op, layout, canonical):
    """The Poseidon gate's round against poseidon_torch and the JAX
    gate's x7 and MDS layer (poseidon_jax's, on the transpose)."""
    m = 37
    if layout == "wire_rows":  # rows of a (135, M) wire matrix
        x = _words(rng, (135, m), canonical)[50:62]
        x0 = _words(rng, (135, m), canonical)[7]
    else:
        x = _words(rng, (m, 12), canonical).T
        x0 = _words(rng, (m, 3), canonical)[:, 1]
    xs = (x,) if op == "mds_full" else (x0, x)
    plan = gc.mds_plan(op, *xs)
    got = _run(host_field, gc.launch_mds, plan, xs)
    _same(got, gt.to_u64(getattr(pt, op)(*xs)))
    if op == "mds_full":
        state = _pow7_jax(_j(x))
    else:
        state = jnp.concatenate([_pow7_jax(_j(x0))[None], _j(x)[1:]])
    _same(got, pj._mds(state.T).T)


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


def _lane(a, axis, lane):
    """The index of lane `lane` of `a` along `axis` (the kernel's lane
    order: row-major over the other dims)."""
    rest = [n for k, n in enumerate(a.shape) if k != axis]
    coords = [int(c) for c in np.unravel_index(lane, rest)]
    return tuple(coords[:axis] + [slice(None)] + coords[axis:])


# (shape, axis, transposed input, log2 of the threads a lane or None for
# the kernel's default): k = 1, 2, odd, below G, 80 (the zs stage's (N,
# 80), 16 threads a lane) and above 2 G; lane counts that are no multiple
# of a block's lanes; along axis 1, axis 0 and a transposed input
BATCH_CASES = [
    ((40, 10), 1, False, None),
    ((40, 10), 0, False, None),
    ((10, 40), 1, True, None),
    ((2, 5, 3, 4), 2, False, None),
    ((6, 1), 1, False, None),
    ((37, 2), 1, False, None),
    ((21, 7), 1, False, 4),
    ((5, 37), 1, False, None),
    ((33, 80), 1, False, None),
    ((80, 33), 0, False, None),
    ((80, 33), 1, True, None),
    ((19, 45), 1, False, 4),
]


@pytest.mark.parametrize("op", ["batch_inverse_axis", "batch_divide_axis"])
@pytest.mark.parametrize("shape,axis,transpose,log_g", BATCH_CASES)
def test_host_field_batch_inverse(host_field, rng, shape, axis, transpose, log_g, op):
    """Bit for bit against the plain version and the JAX package's; a
    zero in one lane zeroes that lane, and the neighbouring lane of the
    same block keeps its inverses."""
    a = _words(rng, shape)
    if transpose:
        a = a.T
    k = a.shape[axis]
    lanes = a.numel() // k
    zl = max(0, lanes // 2 - 1)
    a[_lane(a, axis, zl)][k - 1] = 0  # a zero in lane zl
    a[_lane(a, axis, zl + 1)] = gt.from_u64(rng.integers(1, P, size=k, dtype=np.uint64))
    nums = _words(rng, tuple(a.shape), False) if op == "batch_divide_axis" else None
    plan = gc.lane_plan(op, a, axis, nums)
    got = torch.empty(plan.out_shape, dtype=torch.int64)
    assert gc.launch_batch_inverse(host_field, plan, a, got, None, nums, log_g) == 1
    if nums is None:
        _same(got, gt.to_u64(gt.batch_inverse_axis(a, axis)))
        _same(got, gj.batch_inverse_axis(_j(a), axis))
        one = torch.ones(k, dtype=torch.int64)
    else:
        _same(got, gt.to_u64(gt.batch_divide_axis(nums, a, axis)))
        _same(got, gj.mul(_j(nums), gj.batch_inverse_axis(_j(a), axis)))
        one = nums[_lane(nums, axis, zl + 1)]
    assert (gt.to_u64(got[_lane(got, axis, zl)]) == 0).all()
    back = gt.mul(got[_lane(got, axis, zl + 1)], a[_lane(a, axis, zl + 1)])
    _same(back, gt.to_u64(gt.mul(one, torch.ones_like(one))))  # nums' canonical words


def test_host_field_batch_group(host_field):
    """The threads a lane: the fewest that leave a thread at most five
    words (16 for the zs stage's k = 80); lanes past 256 threads' 1280
    words raise, and so does a lane of more words than its threads hold."""
    assert [gc.batch_group(host_field, k) for k in (1, 5, 6, 37, 80, 81, 1280)] == [
        0, 0, 1, 3, 4, 5, 8]
    with pytest.raises(ValueError, match="1280"):
        gc.batch_group(host_field, gc.BATCH_MAX_WORDS + 1)
    a = _words(np.random.default_rng(1), (4, 6))
    plan = gc.lane_plan("batch_inverse_axis", a, 1)
    with pytest.raises(RuntimeError, match="qzk_batch_inverse"):  # 11 words on one thread
        gc.launch_batch_inverse(host_field, plan._replace(n=11), a,
                                torch.empty((4, 6), dtype=torch.int64), None, log_g=0)


# -- K6 -------------------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 2, 5, 33])
@pytest.mark.parametrize("base", [0, 1, P - 1, P + 3, 0x1234567890ABCDEF])
def test_host_field_powers_vec(host_field, n, base):
    b = gt.from_u64(np.array([5, base], dtype=np.uint64))[1]  # 0-d, at an offset
    plan = gc.powers_plan("powers_vec", b, n)
    got = _run(host_field, gc.launch_powers, plan, (b,))
    _same(got, gt.to_u64(gt.powers_vec(b, n)))
    _same(got, gj.powers_vec(_j(b), n))


@pytest.mark.parametrize("n", [0, 1, 2, 7, 40])
@pytest.mark.parametrize("layout", ["contiguous", "column"])
def test_host_field_ext_powers(host_field, rng, n, layout):
    z = _words(rng, (2,), False) if layout == "contiguous" else _words(rng, (2, 3))[:, 1]
    plan = gc.powers_plan("ext_powers", z, n)
    got = _run(host_field, gc.launch_powers, plan, (z,))
    _same(got, gt.to_u64(gt.ext_powers(z, n)))
    _same(got, gj.ext_powers(_j(z), n))


@pytest.mark.parametrize("n", [0, 1, 2, 7, 127, 129, 255, 257, 8192])
@pytest.mark.parametrize("ext", [False, True], ids=["base", "ext"])
@pytest.mark.parametrize("count", [1, 2])
def test_host_field_powers_multi(host_field, rng, n, ext, count):
    """Several bases in one launch (the vanishing's alphas, zeta and g
    zeta): n around the tables' sizes (2^s +- 1) and the openings' 8192,
    bases at an offset and non-canonical words among them."""
    if ext:
        bases = tuple(_words(rng, (2, 3), False)[:, 1 + z % 2] for z in range(count))
        op, plain, jax_one = "ext_powers_multi", gt.ext_powers, gj.ext_powers
    else:
        bases = tuple(_words(rng, (3,), False)[1 + z] for z in range(count))
        op, plain, jax_one = "powers_vec_multi", gt.powers_vec, gj.powers_vec
    plan = gc.powers_plan(op, bases, n)
    got = _run(host_field, gc.launch_powers, plan, bases)
    assert got.shape == (count, n, 2) if ext else (count, n)
    _same(got, gt.to_u64(getattr(gt, op)(bases, n)))
    for z, b in enumerate(bases):
        _same(got[z], gt.to_u64(plain(b, n)))
        _same(got[z], jax_one(_j(b), n))


# -- K7 -------------------------------------------------------------------------


# field.cu's sum_mod reduces 2 * SUM_SMEM_WORDS words a lane in one block
# (one block a lane), or 2 * SUM_SMEM_WORDS / SUM_TILE (a tile of 32 lanes a
# block, where a lane's words are not contiguous and there are lanes to tile)
SUM_BLOCK_WORDS = 12288
SUM_TILE_WORDS = 384


def _halvings(n, lanes, lane_axis_stride):
    """The halvings into scratch before the block sum (qzk_sum_plan)."""
    fits = SUM_TILE_WORDS if lane_axis_stride != 1 and lanes > 1 else SUM_BLOCK_WORDS
    halvings = 0
    while n > fits:
        halvings, n = halvings + 1, n // 2
    return halvings


@pytest.mark.parametrize("n", [0, 1, 2, 3, 37, 64, SUM_BLOCK_WORDS, SUM_BLOCK_WORDS + 7,
                               4 * SUM_BLOCK_WORDS + 5])
@pytest.mark.parametrize("axis", [0, 1])
def test_host_field_sum_mod(host_field, rng, n, axis):
    """Canonical values, any 64-bit words, and words all at or above p
    (so that the odd tail's add takes a non-canonical word too)."""
    lanes = 2 if n > 100 else 5
    shape = (n, lanes) if axis == 0 else (lanes, n)
    halvings = _halvings(n, lanes, lanes if axis == 0 else 1)
    above_p = gt.from_u64(rng.integers(P, 1 << 64, size=shape, dtype=np.uint64))
    for a in (_words(rng, shape), _words(rng, shape, False), above_p):
        plan = gc.lane_plan("sum_mod", a, axis)
        got = torch.empty(plan.out_shape, dtype=torch.int64)
        launches = gc.launch_sum_mod(host_field, plan, a, got, None)
        assert launches == 1 + halvings
        _same(got, gt.to_u64(gt.sum_mod(a, axis)))
        _same(got, gj.sum_mod(_j(a), axis))


@pytest.mark.parametrize("n", [0, 1, 2, 3, 37, 306, SUM_TILE_WORDS + 1, SUM_BLOCK_WORDS + 7])
@pytest.mark.parametrize("axis", [0, 1])
def test_host_field_dot_mod(host_field, rng, n, axis):
    """The call sites' weighted sums: (T, M) terms by a (T, 1) column of
    powers along axis 0 (37 lanes: a tile of 32 and a ragged one), and
    (S, N) coefficients by a row of pairs' first words along axis 1; on
    canonical and any 64-bit words."""
    lanes = 37 if n <= SUM_TILE_WORDS + 1 else 3
    for canonical in (True, False):
        if axis == 0:
            a = _words(rng, (n, lanes), canonical)
            w = _words(rng, (n,), canonical)[:, None]
        else:
            a = _words(rng, (lanes, n), canonical)
            w = _words(rng, (n, 2), canonical)[None, :, 0]
        plan = gc.lane_plan("dot_mod", a, axis, w)
        got = torch.empty(plan.out_shape, dtype=torch.int64)
        launches = gc.launch_dot_mod(host_field, plan, a, w, got, None)
        assert launches == 1 + _halvings(n, lanes, plan.axis[0])
        _same(got, gt.to_u64(gt.dot_mod(a, w, axis)))
        _same(got, gj.sum_mod(gj.mul(_j(a), _j(w)), axis))


@pytest.mark.parametrize("case", ["vanishing", "zs_stage", "transposed", "run_of_one",
                                  "chunk_of_one", "three_dims"])
def test_host_field_prod_chunks(host_field, rng, case):
    """Chunks of 7 over 80 routed wires (a ragged run of 3) as the
    vanishing ((80, M) along axis 0) and zs_stage ((N, 80) along axis 1)
    take them, a transposed view, a last run of one word and runs of one
    word (left as they are, non-canonical too), and a strided 3-dim view."""
    a, axis, chunk = {
        "vanishing": (_words(rng, (80, 9)), 0, 7),
        "zs_stage": (_words(rng, (9, 80)), 1, 7),
        "transposed": (_words(rng, (9, 80)).T, 0, 7),
        "run_of_one": (_words(rng, (8, 3), False), 0, 7),
        "chunk_of_one": (_words(rng, (3, 5), False), 1, 1),
        "three_dims": (_words(rng, (2, 16, 6), False).transpose(1, 2)[:, 1:], 2, 5),
    }[case]
    plan = gc.chunk_plan(a, axis, chunk)
    got = _run(host_field, gc.launch_prod_chunks, plan, a)
    _same(got, gt.to_u64(gt.prod_chunks(a, axis, chunk)))
    x = jnp.moveaxis(_j(a), axis, 0)
    runs = []
    for lo in range(0, x.shape[0], chunk):
        acc = x[lo]
        for j in range(lo + 1, min(lo + chunk, x.shape[0])):
            acc = gj.mul(acc, x[j])
        runs.append(acc)
    _same(got, jnp.moveaxis(jnp.stack(runs), 0, axis))
    if chunk == 1 or case == "run_of_one":  # runs of one word are the words
        last = got.movedim(axis, 0)[-1]
        _same(last, gt.to_u64(a.movedim(axis, 0)[-1]))


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

"""The wrappers of the field kernels (qzk_tpu_torch.ops.goldilocks_cuda)
on the CPU: on CPU tensors every function is its plain version in
goldilocks_torch, bit for bit, and launches nothing; the pure-Python
layout (broadcast shape, element strides, coalesced dims, lanes) that a
wrapper hands its kernel, for the call sites' patterns; what a wrapper
refuses; the launch counts under a recording; FIELD_SHAPES keys back
into calls.  The kernels themselves: tests/test_torch_field_fast.py."""

import os
import shutil

import numpy as np
import pytest
import torch

from qzk_tpu_torch.ops import goldilocks_cuda as gc
from qzk_tpu_torch.ops import goldilocks_torch as gt

P = 0xFFFFFFFF00000001


def _words(rng, shape):
    x = rng.integers(0, 1 << 64, size=shape, dtype=np.uint64)
    flat = x.reshape(-1)
    flat[:3] = [0, 1, P - 1][:flat.size]
    return gt.from_u64(x)


def _calls(rng):
    """(name, args) of every wrapper, at small shapes and in the call
    sites' layouts."""
    a, b = _words(rng, (6, 8)), _words(rng, (8,))
    e, f = _words(rng, (5, 2)), _words(rng, (2,))
    x = _words(rng, (8, 12)).T  # a (12, 8) state, as rows of a transpose
    return [
        ("add", (a, b)), ("sub", (a.T, a.T)), ("neg", (a,)), ("mul", (_words(rng, ()), a)),
        ("square", (a[:, ::2],)), ("mul_small", (a, 7)), ("reduce128", (a, b)),
        ("ext_add", (e, f)), ("ext_sub", (e, e)), ("ext_mul", (e, f.expand(5, 2))),
        ("inverse", (a,)), ("ext_inverse_vec", (e,)), ("batch_inverse_axis", (a, 1)),
        ("powers_vec", (b[3], 9)), ("ext_powers", (f, 7)), ("sum_mod", (a, 0)),
        ("sum_mod", (a, -1)), ("prefix_prod_exclusive", (b,)),
        ("pow7", (a.T,)), ("mds_full", (x,)), ("mds_partial", (b, x)),
        ("dot_mod", (a, b, 1)), ("dot_mod", (a, a[:, :1], 0)), ("prod_chunks", (a, 1, 3)),
        ("batch_divide_axis", (_words(rng, (6, 8)), a, 1)),
        ("powers_vec_multi", ((b[3], b[5]), 9)), ("ext_powers_multi", ((f, e[2]), 7)),
    ]


@pytest.mark.parametrize("i", range(27))
def test_cpu_tensors_take_the_plain_version(rng, i):
    gc.reset_launches()
    name, args = _calls(rng)[i]
    got = getattr(gc, name)(*args)
    assert torch.equal(got, gc.plain_of(name)(*args))
    assert sum(gc.LAUNCHES.values()) == 0 and not gc.FIELD_SHAPES


def test_helpers_are_goldilocks_torch_s():
    for name in ("EPS", "i64", "lt", "ge", "shr", "zeros", "ones"):
        assert getattr(gc, name) is getattr(gt, name)
    x = gc.from_u64([1, P - 1])
    assert gc.to_u64(x).tolist() == [1, P - 1] and int(gc.scalar(P - 1)) == gt.i64(P - 1)


def test_broadcast_strides_of_the_call_sites():
    n, m, a = 16, 6, 4
    block = torch.zeros((n, 80), dtype=torch.int64)
    beta = torch.zeros((), dtype=torch.int64)
    assert gc.broadcast(beta, block) == ((n, 80), [(0, 0), (80, 1)])
    groups = torch.zeros((a * m, 2), dtype=torch.int64).reshape(a, m, 2).movedim(0, 1)
    w = torch.zeros((a, a), dtype=torch.int64)
    assert gc.broadcast(groups[:, 1, None, :], w[1][None, :, None]) == (
        (m, a, 2), [(2, 0, 1), (0, 1, 0)])
    t = torch.zeros((3, 8, 5), dtype=torch.int64)
    assert gc.broadcast(t[:, 0::2], t[:, 1::2]) == ((3, 4, 5), [(40, 10, 1), (40, 10, 1)])
    coeffs, p = torch.zeros((7, n), dtype=torch.int64), torch.zeros((n, 2), dtype=torch.int64)
    assert gc.broadcast(coeffs, p[None, :, 0]) == ((7, n), [(n, 1), (0, 2)])


def test_coalesce_merges_what_every_operand_steps_through_as_one():
    assert gc.coalesce((16, 80), [(0, 0), (80, 1)]) == ([1280], [[0], [1]])
    assert gc.coalesce((6, 4, 2), [(2, 0, 1), (0, 1, 0)]) == ([6, 4, 2], [[2, 0, 1], [0, 1, 0]])
    assert gc.coalesce((3, 4, 5), [(40, 10, 1)] * 2) == ([12, 5], [[10, 1]] * 2)
    assert gc.coalesce((1, 5, 1), [(9, 1, 7)]) == ([5], [[1]])
    assert gc.coalesce((), [()]) == ([1], [[0]])


def test_lane_plans():
    a = torch.zeros((40, 10), dtype=torch.int64)
    plan = gc.lane_plan("batch_inverse_axis", a, 1)
    assert (plan.out_shape, plan.dims, plan.strides, plan.axis, plan.n) == (
        (40, 10), [40], [[10], [10]], (1, 1), 10)
    plan = gc.lane_plan("sum_mod", a.T, 0)  # along the columns of a transpose
    assert (plan.out_shape, plan.dims, plan.strides, plan.axis, plan.n) == (
        (40,), [40], [[10], [1]], (1, 0), 10)
    plan = gc.lane_plan("prefix_prod_exclusive", torch.zeros(9, dtype=torch.int64), 0)
    assert (plan.out_shape, plan.dims, plan.axis, plan.n) == ((9,), [1], (1, 1), 9)
    # dot_mod: the vanishing's (T, M) terms by a (T, 1) column of powers,
    # and the openings' (S, N) coefficients by a row of pairs
    terms, apows = torch.zeros((306, 64), dtype=torch.int64), torch.zeros(306, dtype=torch.int64)
    plan = gc.lane_plan("dot_mod", terms, 0, apows[:, None])
    assert (plan.key, plan.out_shape, plan.dims, plan.strides, plan.axis, plan.n) == (
        ("dot_mod", (306, 64), ((64, 1), (1, 0)), 0), (64,), [64], [[1], [1], [0]],
        (64, 0, 1), 306)
    pows = torch.zeros((16, 2), dtype=torch.int64)
    plan = gc.lane_plan("dot_mod", a.T[:, :16], 1, pows[None, :, 0])
    assert (plan.dims, plan.strides, plan.axis, plan.n) == ([10], [[1], [1], [0]], (10, 0, 2), 16)
    # prod_chunks: (80, M) by chunks of 7 along axis 0, and (N, 80) along axis 1
    plan = gc.chunk_plan(torch.zeros((80, 64), dtype=torch.int64), 0, 7)
    assert (plan.key, plan.out_shape, plan.strides, plan.a_axis, plan.n) == (
        ("prod_chunks", (80, 64), ((64, 1),), (0, 7)), (12, 64), (448, 1), 64, 80)
    plan = gc.chunk_plan(torch.zeros((32, 80), dtype=torch.int64), -1, 7)
    assert (plan.out_shape, plan.strides, plan.axis, plan.a_axis) == ((32, 12), (80, 7), 1, 1)
    # batch_divide_axis: the zs stage's (N, 80) nums and dens along axis 1,
    # and a transposed dens beside contiguous nums
    nums, dens = torch.zeros((40, 80), dtype=torch.int64), torch.zeros((40, 80), dtype=torch.int64)
    plan = gc.lane_plan("batch_divide_axis", dens, 1, nums)
    assert (plan.key, plan.out_shape, plan.dims, plan.strides, plan.axis, plan.n) == (
        ("batch_divide_axis", (40, 80), ((80, 1), (80, 1)), 1), (40, 80), [40],
        [[80], [80], [80]], (1, 1, 1), 80)
    plan = gc.lane_plan("batch_divide_axis", torch.zeros((80, 40), dtype=torch.int64).T, 1,
                        nums)
    assert (plan.key[2], plan.strides, plan.axis) == (((80, 1), (1, 40)), [[1], [80], [80]],
                                                      (40, 1, 1))


def test_powers_plans():
    """One base, and several in one launch: the key carries each base's
    strides (a 0-d base (0,), an extension base (0, its component
    stride)), the output a base axis."""
    b, z = torch.zeros(3, dtype=torch.int64), torch.zeros((2, 3), dtype=torch.int64)
    assert gc.powers_plan("powers_vec", b[1], 9).key == ("powers_vec", (9,), ((0,),), None)
    plan = gc.powers_plan("powers_vec_multi", (b[0], b[2]), 9)
    assert (plan.key, plan.comps) == (("powers_vec_multi", (2, 9), ((0,), (0,)), None), (0, 0))
    plan = gc.powers_plan("ext_powers_multi", (z[:, 1], torch.zeros(2, dtype=torch.int64)), 5)
    assert (plan.key, plan.out_shape, plan.comps) == (
        ("ext_powers_multi", (2, 5, 2), ((0, 3), (0, 1)), None), (2, 5, 2), (3, 1))
    plan = gc.powers_plan("powers_vec_multi", torch.zeros(2, dtype=torch.int64), 4)  # rows
    assert plan.out_shape == (2, 4)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    a = torch.zeros((2, 3), dtype=torch.int64)
    with pytest.raises(TypeError, match="tensor"):
        gc.mul(a, 3)
    with pytest.raises(TypeError, match="int64"):
        gc.add(a, a.to(torch.int32))
    with pytest.raises(ValueError, match="operands on"):
        gc.mul(a, a.to("meta"))
    with pytest.raises(ValueError, match="operands on"):
        gc.broadcast(torch.zeros((), dtype=torch.int64), a.to("meta"))
    five = torch.zeros((1, 1, 1, 1, 2), dtype=torch.int64)
    with pytest.raises(ValueError, match="broadcast dims"):
        gc.broadcast(five, five)
    with pytest.raises(ValueError, match="dims"):
        gc.sum_mod(five, 0)
    with pytest.raises(ValueError, match="2\\^32"):
        gc.mul_small(a, 1 << 32)
    with pytest.raises(ValueError, match="extension"):
        gc.ext_mul(a, a)
    with pytest.raises(ValueError, match="ext_powers"):
        gc.ext_powers(a, 4)
    with pytest.raises(ValueError, match="does not broadcast"):
        gc.dot_mod(a, torch.zeros((4, 2, 3), dtype=torch.int64), 0)
    with pytest.raises(ValueError, match="chunk"):
        gc.prod_chunks(a, 0, 0)
    with pytest.raises(ValueError, match="\\(12, m\\) state"):
        gc.mds_full(a)
    with pytest.raises(ValueError, match="row 0"):
        gc.mds_partial(a[0], torch.zeros((12, 4), dtype=torch.int64))
    with pytest.raises(ValueError, match="differ in shape"):
        gc.batch_divide_axis(a, a[:, :2], 1)
    with pytest.raises(ValueError, match="differ in shape"):
        gc.batch_divide_axis(a[None], a, 1)
    with pytest.raises(ValueError, match="one-element bases"):
        gc.powers_vec_multi((a[0, 0], a[0]), 4)
    with pytest.raises(ValueError, match="\\(2,\\) bases"):
        gc.ext_powers_multi((a[0, :2], a[0]), 4)
    with pytest.raises(ValueError, match="bases; a launch takes 1 to 8"):
        gc.powers_vec_multi((), 4)
    with pytest.raises(ValueError, match="bases; a launch takes 1 to 8"):
        gc.powers_vec_multi(torch.zeros(9, dtype=torch.int64), 4)
    with pytest.raises(TypeError, match="tensor"):
        gc.powers_vec_multi((a[0, 0], 3), 4)


def test_recorded_launches_count_at_each_replay():
    gc.reset_launches()
    key = ("mul", (4,), ((1,), (0,)), None)
    with gc.recording() as rec:
        gc._count("field_map", key)
        gc._count("field_map", key)
        gc._count("field_reduce", ("sum_mod", (4, 2), ((2, 1),), 0), 2)
    assert sum(gc.LAUNCHES.values()) == 0 and not gc.FIELD_SHAPES
    gc.count_replay(rec)
    gc.count_replay(rec)
    assert gc.LAUNCHES == {"field_map": 4, "field_inverse": 0, "field_powers": 0,
                           "field_reduce": 4}
    assert gc.FIELD_SHAPES[key] == 4
    gc.reset_launches()


def _key(name, args):
    if name in ("sum_mod", "batch_inverse_axis"):
        return gc.lane_plan(name, *args).key
    if name == "prefix_prod_exclusive":
        return gc.lane_plan(name, args[0], 0).key
    if name in ("powers_vec", "ext_powers", "powers_vec_multi", "ext_powers_multi"):
        return gc.powers_plan(name, *args).key
    if name == "batch_divide_axis":
        return gc.lane_plan(name, args[1], args[2], args[0]).key
    if name == "mul_small":
        return gc.map_plan(name, args[0], c=args[1]).key
    if name == "dot_mod":
        return gc.lane_plan(name, args[0], args[2], args[1]).key
    if name == "prod_chunks":
        return gc.chunk_plan(*args).key
    if name in ("mds_full", "mds_partial"):
        return gc.mds_plan(name, *args).key
    return gc.map_plan(name.replace("ext_add", "add").replace("ext_sub", "sub"), *args).key


def test_call_of_repeats_a_key(rng):
    words = _words(rng, (4096,))
    for name, args in _calls(rng):
        key = _key(name, args)
        fn, again = gc.call_of(key, lambda n: words[:n])
        assert _key(fn.__name__, again) == key, name
        assert fn(*again).shape == gc.plain_of(name)(*args).shape


def test_field_kernel_build_needs_nvcc():
    """Without nvcc the field kernels' build raises; nothing falls back."""
    if shutil.which("nvcc") is None and not os.path.exists("/usr/local/cuda/bin/nvcc"):
        with pytest.raises(RuntimeError, match="nvcc"):
            gc.library_path()
    else:
        assert os.path.exists(gc.library_path())

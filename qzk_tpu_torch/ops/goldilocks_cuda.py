"""Wrappers of the hand-written field kernels K4-K7 (csrc/field.cu).

Each function has the name and signature of its plain version in
``goldilocks_torch.py``, which is its oracle.  On a CUDA tensor it
launches its kernel on PyTorch's current stream, or raises; on a CPU
tensor it runs the plain version.  There is no switch between the two.

  K4 field_map      add, sub, neg, mul, square, mul_small, reduce128,
                    ext_add, ext_sub, ext_mul, pow7; the Poseidon gate's
                    round mds_full and mds_partial (plain twins in
                    poseidon_torch.py)
  K5 field_inverse  inverse, ext_inverse_vec, batch_inverse_axis,
                    batch_divide_axis
  K6 field_powers   powers_vec, ext_powers, powers_vec_multi,
                    ext_powers_multi (several bases in one launch)
  K7 field_reduce   sum_mod, dot_mod, prod_chunks, prefix_prod_exclusive

Operands are int64 tensors of uint64 bit patterns on one device, of any
layout: a wrapper passes the kernel each operand's element strides over
the broadcast shape (0 on a broadcast dim, at most 4 dims) and never
copies an operand.  Outputs are contiguous.  A wrapper reads no tensor
value, so that a call can be captured in a CUDA graph; it raises on a
Python number, on an operand on another device (a CPU 0-d tensor beside
a CUDA one would be an upload frozen into a capture) and on a dtype
other than int64.

``LAUNCHES`` counts kernel launches by family, and nothing else;
``FIELD_SHAPES`` counts the calls that launched by (op, shape, strides,
extra), the key that ``call_of`` turns back into a call, so that a run
can check and time each op at every shape a prove gave it.  Under CUDA
graph capture, ``recording()`` and ``count_replay`` as in
poseidon_cuda.py.  The library loads, and the counts move, under a lock.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import os
import threading
from typing import NamedTuple

import torch

from . import goldilocks_torch as gt
from . import poseidon_torch as pt

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")

MAX_DIMS = 4
# field.cu's limits on the card: a batch inversion's lane (BATCH_THREADS
# * BATCH_WORDS words), a powers launch's bases (MAX_BASES) and powers a
# base (2^POW_MAX_LOG_N)
BATCH_MAX_WORDS = 1280
MAX_BASES = 8
POW_MAX_N = 1 << 24

# Each kernel family's ops; a family is a key of LAUNCHES.
FAMILIES = {
    "field_map": ("add", "sub", "neg", "mul", "square", "mul_small", "reduce128", "ext_mul",
                  "pow7", "mds_full", "mds_partial"),
    "field_inverse": ("inverse", "ext_inverse_vec", "batch_inverse_axis", "batch_divide_axis"),
    "field_powers": ("powers_vec", "ext_powers", "powers_vec_multi", "ext_powers_multi"),
    "field_reduce": ("sum_mod", "dot_mod", "prod_chunks", "prefix_prod_exclusive"),
}
FAMILY_OF = {op: family for family, ops in FAMILIES.items() for op in ops}
# The ops whose plain twin lives in poseidon_torch, not goldilocks_torch
_POSEIDON_OPS = ("mds_full", "mds_partial")
LAUNCHES = dict.fromkeys(FAMILIES, 0)
FIELD_SHAPES: collections.Counter = collections.Counter()
_LOCK = threading.Lock()
# thread id -> the Counter of an active recording()
_RECORDING: dict = {}

# The helpers that need no kernel.  The host transfers call through to
# goldilocks_torch at each call, so that a test that patches them there
# sees every use.
EPS, i64, lt, ge, shr, zeros, ones = gt.EPS, gt.i64, gt.lt, gt.ge, gt.shr, gt.zeros, gt.ones


def from_u64(x, device=None) -> torch.Tensor:
    return gt.from_u64(x, device)


def to_u64(x: torch.Tensor):
    return gt.to_u64(x)


def scalar(v, device=None) -> torch.Tensor:
    return gt.scalar(v, device)


def plain_of(op: str):
    """The plain twin of an op of FAMILIES (its oracle)."""
    return getattr(pt if op in _POSEIDON_OPS else gt, op)


# -- counts -----------------------------------------------------------------


def reset_launches() -> None:
    with _LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        FIELD_SHAPES.clear()


def _count(family: str, key: tuple, launches: int = 1) -> None:
    with _LOCK:
        rec = _RECORDING.get(threading.get_ident())
        if rec is not None:  # captured into a CUDA graph: no launch yet
            rec[(family, key, launches)] += 1
            return
        LAUNCHES[family] += launches
        FIELD_SHAPES[key] += 1


@contextlib.contextmanager
def recording():
    """Records, and does not count, the launches this thread makes in
    the block: under CUDA graph capture a wrapper's call launches
    nothing.  Yields a Counter of (family, key, launches a call) for
    count_replay."""
    rec: collections.Counter = collections.Counter()
    tid = threading.get_ident()
    with _LOCK:
        _RECORDING[tid] = rec
    try:
        yield rec
    finally:
        with _LOCK:
            del _RECORDING[tid]


def count_replay(rec: collections.Counter) -> None:
    """Counts the launches of one replay of a graph whose capture
    recorded `rec`."""
    with _LOCK:
        for (family, key, launches), calls in rec.items():
            LAUNCHES[family] += calls * launches
            FIELD_SHAPES[key] += calls


# -- the library --------------------------------------------------------------


class _Kernels:
    lib = None


def library_path() -> str:
    """Builds (at first use) and returns the kernels' shared library."""
    from ..utils import build

    return build.cuda_library(
        "qzk_field",
        os.path.join(CSRC, "field.cu"),
        [os.path.join(CSRC, "goldilocks.cuh")],
    )


def bind(lib):
    """Declares the C interface of field.cu on a loaded library."""
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    pll = ctypes.POINTER(ll)
    sig = {
        "qzk_field_map": [i, vp, pll, ll, vp, pll, ll, ctypes.c_ulonglong, i, pll, vp, vp],
        "qzk_map_path": [i, i, pll, pll, pll, vp, vp, vp],
        "qzk_mds": [i, vp, ll, ll, vp, ll, ll, vp, vp],
        "qzk_field_inverse": [i, vp, pll, ll, i, pll, vp, vp],
        "qzk_batch_group": [ll],
        "qzk_batch_inverse": [vp, pll, ll, vp, pll, ll, i, pll, pll, ll, ll, i, vp, vp],
        "qzk_field_powers": [i, i, ctypes.POINTER(vp), pll, ll, vp, vp],
        "qzk_sum_plan": [ll, ll, ll, pll],
        "qzk_sum_mod": [vp, pll, ll, vp, pll, ll, i, pll, ll, vp, vp, vp],
        "qzk_prod_chunks": [vp, pll, i, pll, i, ll, ll, ll, vp, vp],
        "qzk_prefix_threads": [ll],
        "qzk_prefix_prod": [vp, pll, ll, i, pll, pll, ll, ll, vp, vp],
    }
    for name, args in sig.items():
        f = getattr(lib, name)
        f.argtypes, f.restype = args, i
    return lib


def _lib():
    if _Kernels.lib is None:
        with _LOCK:
            if _Kernels.lib is None:
                _Kernels.lib = bind(ctypes.CDLL(library_path()))
    return _Kernels.lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def _arr(values) -> ctypes.Array:
    values = list(values) or [0]
    return (ctypes.c_longlong * len(values))(*values)


# -- layout: pure Python, the same on every device ------------------------------


def check_operands(*xs) -> torch.device:
    """The operands' device; raises unless each is an int64 tensor and
    all lie on one CPU or CUDA device."""
    for x in xs:
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"expected a tensor, got {type(x).__name__}: a field constant "
                            "must be a tensor on the operands' device")
        if x.dtype != torch.int64:
            raise TypeError(f"expected int64 tensors of uint64 bit patterns, got {x.dtype}")
    dev = xs[0].device
    for x in xs[1:]:
        if x.device != dev:
            raise ValueError(f"operands on {dev} and {x.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def broadcast(*xs) -> tuple[tuple, list]:
    """(the broadcast shape of the operands, each operand's element
    strides over it): right-aligned, 0 on a dim the operand broadcasts.
    Raises as check_operands does, and above MAX_DIMS dims."""
    check_operands(*xs)
    shape = tuple(torch.broadcast_shapes(*(x.shape for x in xs)))
    if len(shape) > MAX_DIMS:
        raise ValueError(f"{len(shape)} broadcast dims; the field kernels take {MAX_DIMS}")
    strides = []
    for x in xs:
        lead = len(shape) - x.dim()
        strides.append(tuple(0 if k < lead or x.shape[k - lead] == 1 else x.stride(k - lead)
                             for k in range(len(shape))))
    return shape, strides


def coalesce(shape, strides) -> tuple[list, list]:
    """The kernel's index space: dims of size 1 dropped, and neighbours
    merged where every operand steps through them as one dim.  Returns
    (dims, strides per operand); at least one dim."""
    groups: list = []
    for k, n in enumerate(shape):
        if n == 1:
            continue
        ss = [s[k] for s in strides]
        if groups and all(p == q * n for p, q in zip(groups[-1][1], ss)):
            groups[-1] = (groups[-1][0] * n, ss)
        else:
            groups.append((n, ss))
    if not groups:
        groups = [(1, [0] * len(strides))]
    return [n for n, _ in groups], [[ss[i] for _, ss in groups] for i in range(len(strides))]


def contiguous_strides(shape) -> tuple:
    out, step = [], 1
    for n in reversed(shape):
        out.append(step)
        step *= n
    return tuple(reversed(out))


def _ext_parts(*xs):
    """(..., 2) extension operands -> their first components (views)."""
    for x in xs:
        if x.dim() == 0 or x.shape[-1] != 2:
            raise ValueError(f"expected (..., 2) extension elements, got {tuple(x.shape)}")
    return [x[..., 0] for x in xs]


def _launch(key: tuple, out_shape, device, launch) -> torch.Tensor:
    """A contiguous output of out_shape on the card, filled by
    launch(lib, out, stream), which returns its launch count; counted
    under `key` and its op's family."""
    out = torch.empty(out_shape, dtype=torch.int64, device=device)
    if out.numel():
        with torch.cuda.device(device):
            n = launch(_lib(), out, torch.cuda.current_stream(device).cuda_stream)
        _count(FAMILY_OF[key[0]], key, n)
    return out


# -- K4 -------------------------------------------------------------------------

# field.cu's MapOp codes: FAMILIES' order
_MAP_OPS = {op: i for i, op in enumerate(FAMILIES["field_map"])}


class MapPlan(NamedTuple):
    """An element-by-element launch (K4, and K5's inverse and
    ext_inverse_vec)."""

    key: tuple  # (op, out shape, strides of each operand, extra)
    out_shape: tuple
    dims: list
    strides: list  # per operand, over dims
    comp: list  # per operand: the stride between an extension element's two words


def map_plan(op: str, *xs, c: int | None = None) -> MapPlan:
    """The launch of `op` on operands xs (one or two); an extension op's
    operands are (..., 2) and broadcast over their leading dims."""
    check_operands(*xs)
    if op in ("ext_mul", "ext_inverse_vec"):
        shape, strides = broadcast(*_ext_parts(*xs))
        comp = [x.stride(-1) for x in xs]
        key_strides = tuple(s + (cs,) for s, cs in zip(strides, comp))
        out_shape = shape + (2,)
    else:
        shape, strides = broadcast(*xs)
        comp = [0] * len(xs)
        key_strides = tuple(strides)
        out_shape = shape
    dims, cstrides = coalesce(shape, strides)
    return MapPlan((op, out_shape, key_strides, c), out_shape, dims, cstrides, comp)


def launch_map(lib, plan: MapPlan, xs, out, stream) -> int:
    """K4 through `lib` (field.cu's C interface) for `plan`."""
    b = 1 if len(xs) > 1 else 0
    _check(lib.qzk_field_map(_MAP_OPS[plan.key[0]], xs[0].data_ptr(), _arr(plan.strides[0]),
                             plan.comp[0], xs[b].data_ptr(), _arr(plan.strides[b]), plan.comp[b],
                             plan.key[3] or 0, len(plan.dims), _arr(plan.dims), out.data_ptr(),
                             stream), "qzk_field_map")
    return 1


def map_path(lib, plan: MapPlan, xs, out) -> int:
    """The K4 path that `plan` takes (field.cu's qzk_map_path): 0 the
    general one, 1 the fast one, 2 the fast one with 16-byte accesses."""
    b = 1 if len(xs) > 1 else 0
    return lib.qzk_map_path(_MAP_OPS[plan.key[0]], len(plan.dims), _arr(plan.dims),
                            _arr(plan.strides[0]), _arr(plan.strides[b]), xs[0].data_ptr(),
                            xs[b].data_ptr(), out.data_ptr())


def _map(op: str, plain, xs, c=None):
    plan = map_plan(op, *xs, c=c)
    if xs[0].device.type == "cpu":
        return plain()
    return _launch(plan.key, plan.out_shape, xs[0].device,
                   lambda lib, out, s: launch_map(lib, plan, xs, out, s))


def add(a, b):
    return _map("add", lambda: gt.add(a, b), (a, b))


def sub(a, b):
    return _map("sub", lambda: gt.sub(a, b), (a, b))


def neg(a):
    return _map("neg", lambda: gt.neg(a), (a,))


def mul(a, b):
    return _map("mul", lambda: gt.mul(a, b), (a, b))


def square(a):
    return _map("square", lambda: gt.square(a), (a,))


def mul_small(a, c: int):
    """Multiply by a small constant 0 <= c < 2^32 (a Python int)."""
    if not 0 <= c < (1 << 32):
        raise ValueError(f"mul_small takes a constant below 2^32, got {c}")
    return _map("mul_small", lambda: gt.mul_small(a, c), (a,), c=int(c))


def reduce128(lo, hi):
    return _map("reduce128", lambda: gt.reduce128(lo, hi), (lo, hi))


def ext_add(a, b):
    return add(a, b)


def ext_sub(a, b):
    return sub(a, b)


def ext_mul(a, b):
    return _map("ext_mul", lambda: gt.ext_mul(a, b), (a, b))


def pow7(a):
    """a^7, the Poseidon S-box, element by element."""
    return _map("pow7", lambda: gt.pow7(a), (a,))


class MdsPlan(NamedTuple):
    """A launch of the Poseidon gate's round (K4's qzk_mds)."""

    key: tuple  # (op, (12, m), strides of each operand, None)
    out_shape: tuple


def mds_plan(op: str, *xs) -> MdsPlan:
    """mds_full on (x,) or mds_partial on (x0, x): x a (12, m) state at
    any strides, x0 an (m,) row."""
    check_operands(*xs)
    x = xs[-1]
    if x.dim() != 2 or x.shape[0] != 12 or x.shape[1] < 1:
        raise ValueError(f"{op}: expected a (12, m) state, got {tuple(x.shape)}")
    if op == "mds_partial" and tuple(xs[0].shape) != (x.shape[1],):
        raise ValueError(f"mds_partial: expected an ({x.shape[1]},) row 0, got "
                         f"{tuple(xs[0].shape)}")
    return MdsPlan((op, tuple(x.shape), tuple(tuple(t.stride()) for t in xs), None),
                   tuple(x.shape))


def launch_mds(lib, plan: MdsPlan, xs, out, stream) -> int:
    """K4's round through `lib` for `plan`."""
    x, x0 = xs[-1], xs[0]
    full = plan.key[0] == "mds_full"
    _check(lib.qzk_mds(int(full), x.data_ptr(), x.stride(0), x.stride(1), x0.data_ptr(),
                       0 if full else x0.stride(0), x.shape[1], out.data_ptr(), stream),
           "qzk_mds")
    return 1


def _mds(op: str, plain, xs):
    plan = mds_plan(op, *xs)
    if xs[0].device.type == "cpu":
        return plain()
    return _launch(plan.key, plan.out_shape, xs[0].device,
                   lambda lib, out, s: launch_mds(lib, plan, xs, out, s))


def mds_full(x):
    """The Poseidon gate's full round: the MDS layer along axis 0 of
    x^7, x a (12, m) state."""
    return _mds("mds_full", lambda: pt.mds_full(x), (x,))


def mds_partial(x0, x):
    """The Poseidon gate's partial round: the MDS layer along axis 0
    of the state whose row 0 is x0^7 and rows 1-11 are x's (x's row 0
    is not read)."""
    return _mds("mds_partial", lambda: pt.mds_partial(x0, x), (x0, x))


# -- K5 -------------------------------------------------------------------------


def launch_inverse(lib, plan: MapPlan, a, out, stream) -> int:
    """K5 element by element: inverse, or ext_inverse_vec."""
    _check(lib.qzk_field_inverse(int(plan.key[0] == "ext_inverse_vec"), a.data_ptr(),
                                 _arr(plan.strides[0]), plan.comp[0], len(plan.dims),
                                 _arr(plan.dims), out.data_ptr(), stream), "qzk_field_inverse")
    return 1


def _inverse(op: str, plain, a):
    plan = map_plan(op, a)
    if a.device.type == "cpu":
        return plain()
    return _launch(plan.key, plan.out_shape, a.device,
                   lambda lib, out, s: launch_inverse(lib, plan, a, out, s))


def inverse(a):
    """a^-1 by Fermat (0 -> 0), element by element."""
    return _inverse("inverse", lambda: gt.inverse(a), a)


def ext_inverse_vec(a):
    """(..., 2) extension inverse: conjugate over the norm."""
    return _inverse("ext_inverse_vec", lambda: gt.ext_inverse_vec(a), a)


class LanePlan(NamedTuple):
    """A launch along one axis (K5's batch inversion, K7): `dims` the
    lanes' index space, `strides` the input's, the output's (and
    dot_mod's weight's) over it, `axis` their strides along a lane, `n`
    a lane's length."""

    key: tuple
    out_shape: tuple
    dims: list
    strides: list  # [input, output] (+ [weight] for dot_mod)
    axis: tuple  # (input, output) (+ (weight,) for dot_mod)
    n: int


def lane_plan(op: str, a, axis: int, w=None) -> LanePlan:
    """The launch of `op` (sum_mod, dot_mod with weight w,
    batch_inverse_axis, batch_divide_axis with numerators w, or
    prefix_prod_exclusive) along `axis` of `a`: one lane for each index
    of the other dims."""
    check_operands(a, *([] if w is None else [w]))
    if not 1 <= a.dim() <= MAX_DIMS:
        raise ValueError(f"{op}: expected 1 to {MAX_DIMS} dims, got {tuple(a.shape)}")
    axis = axis % a.dim()
    rest = [k for k in range(a.dim()) if k != axis]
    lane_shape = tuple(a.shape[k] for k in rest)
    if op in ("sum_mod", "dot_mod"):
        out_shape = lane_shape
        o_strides, o_axis = contiguous_strides(lane_shape), 0
    else:
        out_shape = tuple(a.shape)
        full = contiguous_strides(out_shape)
        o_strides, o_axis = tuple(full[k] for k in rest), full[axis]
    a_strides = tuple(a.stride(k) for k in rest)
    key_strides, operands, axes = (tuple(a.stride()),), [a_strides, o_strides], ()
    if op == "batch_divide_axis":
        if tuple(w.shape) != tuple(a.shape):
            raise ValueError(f"batch_divide_axis: nums of {tuple(w.shape)} and dens of "
                             f"{tuple(a.shape)} differ in shape")
        key_strides = (tuple(w.stride()),) + key_strides  # (nums, dens): the call's order
        operands.append(tuple(w.stride(k) for k in rest))
        axes = (w.stride(axis),)
    if op == "dot_mod":
        shape, (_, ws) = broadcast(a, w)
        if shape != tuple(a.shape):
            raise ValueError(f"dot_mod: a weight of {tuple(w.shape)} does not broadcast to "
                             f"{tuple(a.shape)}")
        key_strides += (ws,)
        operands.append(tuple(ws[k] for k in rest))
        axes = (ws[axis],)
    dims, strides = coalesce(lane_shape, operands)
    return LanePlan((op, tuple(a.shape), key_strides, axis), out_shape, dims,
                    strides, (a.stride(axis), o_axis) + axes, a.shape[axis])


def batch_group(lib, k: int) -> int:
    """log2 of the threads a lane of k words takes in field.cu's batch
    inversion (qzk_batch_group); raises past BATCH_MAX_WORDS."""
    log_g = lib.qzk_batch_group(k)
    if log_g < 0:
        raise ValueError(f"batch inversion along a lane of {k} words; the kernel takes at "
                         f"most {BATCH_MAX_WORDS}")
    return log_g


def launch_batch_inverse(lib, plan: LanePlan, a, out, stream, nums=None, log_g=None) -> int:
    """K5's batch inversion of `a` along the plan's lanes, or with nums
    batch_divide_axis; log_g: log2 of the threads a lane (by default
    field.cu's qzk_batch_group)."""
    if log_g is None:
        log_g = batch_group(lib, plan.n)
    div = nums is not None
    _check(lib.qzk_batch_inverse(a.data_ptr(), _arr(plan.strides[0]), plan.axis[0],
                                 nums.data_ptr() if div else None,
                                 _arr(plan.strides[2] if div else ()),
                                 plan.axis[2] if div else 0, len(plan.dims), _arr(plan.dims),
                                 _arr(plan.strides[1]), plan.axis[1], plan.n, log_g,
                                 out.data_ptr(), stream), "qzk_batch_inverse")
    return 1


def batch_inverse_axis(a, axis: int = 0):
    """Montgomery batch inversion along one short axis, a group of
    threads a lane; a zero in a lane zeroes the lane."""
    plan = lane_plan("batch_inverse_axis", a, axis)
    if a.device.type == "cpu":
        return gt.batch_inverse_axis(a, axis)
    return _launch(plan.key, plan.out_shape, a.device,
                   lambda lib, out, s: launch_batch_inverse(lib, plan, a, out, s))


def batch_divide_axis(nums, dens, axis: int = 0):
    """nums times the batch inverse of dens along one short axis (nums
    and dens of one shape), in one launch."""
    plan = lane_plan("batch_divide_axis", dens, axis, nums)
    if dens.device.type == "cpu":
        return gt.batch_divide_axis(nums, dens, axis)
    return _launch(plan.key, plan.out_shape, dens.device,
                   lambda lib, out, s: launch_batch_inverse(lib, plan, dens, out, s, nums))


# -- K6 -------------------------------------------------------------------------

_SINGLE_BASE = {"powers_vec_multi": "powers_vec", "ext_powers_multi": "ext_powers"}


class PowersPlan(NamedTuple):
    key: tuple
    out_shape: tuple
    comps: tuple  # per base: the stride between an extension base's two words


def powers_plan(op: str, bases, n: int) -> PowersPlan:
    """powers_vec or ext_powers of one base (b one element, or two), or
    their multi-base forms over a sequence of such bases (out (B, n) or
    (B, n, 2)); n powers a base."""
    multi = op in _SINGLE_BASE
    ext = _SINGLE_BASE.get(op, op) == "ext_powers"
    bases = tuple(bases) if multi else (bases,)
    if not 1 <= len(bases) <= MAX_BASES:
        raise ValueError(f"{op}: {len(bases)} bases; a launch takes 1 to {MAX_BASES}")
    check_operands(*bases)
    for b in bases:
        if b.numel() != (2 if ext else 1):
            raise ValueError(f"{op}: expected {'(2,) bases' if ext else 'one-element bases'}, "
                             f"got {tuple(b.shape)}")
    if n < 0:
        raise ValueError(f"{op}: n = {n}")
    comps = tuple(b.reshape(2).stride(0) if ext else 0 for b in bases)
    out_shape = ((len(bases),) if multi else ()) + ((n, 2) if ext else (n,))
    key_strides = tuple((0, c) if ext else (0,) for c in comps)
    return PowersPlan((op, out_shape, key_strides, None), out_shape, comps)


def launch_powers(lib, plan: PowersPlan, bases, out, stream) -> int:
    """K6 for `plan` over its bases (a sequence, one for the single-base
    ops)."""
    ext = plan.key[0] in ("ext_powers", "ext_powers_multi")
    n = plan.out_shape[-2] if ext else plan.out_shape[-1]
    if n > POW_MAX_N:
        raise ValueError(f"{plan.key[0]}: {n} powers; the kernel takes at most {POW_MAX_N}")
    ptrs = (ctypes.c_void_p * len(bases))(*[b.data_ptr() for b in bases])
    _check(lib.qzk_field_powers(int(ext), len(bases), ptrs, _arr(plan.comps), n,
                                out.data_ptr(), stream), "qzk_field_powers")
    return 1


def _powers(op: str, plain, bases, n: int):
    plan = powers_plan(op, bases, n)
    seq = tuple(bases) if op in _SINGLE_BASE else (bases,)
    if seq[0].device.type == "cpu":
        return plain()
    return _launch(plan.key, plan.out_shape, seq[0].device,
                   lambda lib, out, s: launch_powers(lib, plan, seq, out, s))


def powers_vec(b, n: int):
    """[b^0 .. b^(n-1)] for a one-element tensor b."""
    return _powers("powers_vec", lambda: gt.powers_vec(b, n), b, n)


def ext_powers(z, n: int):
    """[z^0 .. z^(n-1)] as (n, 2) for a (2,) extension scalar z."""
    return _powers("ext_powers", lambda: gt.ext_powers(z, n), z, n)


def powers_vec_multi(bases, n: int):
    """(B, n): powers_vec of each one-element base of the sequence
    `bases` (a tensor's rows, too), in one launch."""
    bases = tuple(bases)
    return _powers("powers_vec_multi", lambda: gt.powers_vec_multi(bases, n), bases, n)


def ext_powers_multi(bases, n: int):
    """(B, n, 2): ext_powers of each (2,) base of the sequence `bases`,
    in one launch."""
    bases = tuple(bases)
    return _powers("ext_powers_multi", lambda: gt.ext_powers_multi(bases, n), bases, n)


# -- K7 -------------------------------------------------------------------------


def launch_sum_mod(lib, plan: LanePlan, a, out, stream, w=None) -> int:
    """The sum (or with a weight w, dot_mod's), with the halvings into
    scratch that field.cu's qzk_sum_plan asks for when a lane is longer
    than one block's shared memory holds."""
    words = ctypes.c_longlong(0)
    launches = lib.qzk_sum_plan(out.numel(), plan.n, plan.axis[0], ctypes.byref(words))
    # Alive until the launches are queued; the stream orders any reuse.
    scratch = torch.empty(words.value, dtype=torch.int64, device=a.device) if words.value else None
    weighted = w is not None
    _check(lib.qzk_sum_mod(a.data_ptr(), _arr(plan.strides[0]), plan.axis[0],
                           w.data_ptr() if weighted else None,
                           _arr(plan.strides[2] if weighted else ()),
                           plan.axis[2] if weighted else 0, len(plan.dims), _arr(plan.dims),
                           plan.n, None if scratch is None else scratch.data_ptr(),
                           out.data_ptr(), stream), "qzk_sum_mod")
    return launches


def launch_dot_mod(lib, plan: LanePlan, a, w, out, stream) -> int:
    return launch_sum_mod(lib, plan, a, out, stream, w)


def sum_mod(a, axis: int = -1):
    """Modular sum along an axis, in the plain version's pairing."""
    plan = lane_plan("sum_mod", a, axis)
    if a.device.type == "cpu":
        return gt.sum_mod(a, axis)
    return _launch(plan.key, plan.out_shape, a.device,
                   lambda lib, out, s: launch_sum_mod(lib, plan, a, out, s))


def dot_mod(a, w, axis: int):
    """sum_mod(mul(a, w), axis) for w broadcast to a's shape, the
    products formed as they are read."""
    plan = lane_plan("dot_mod", a, axis, w)
    if a.device.type == "cpu":
        return gt.dot_mod(a, w, axis)
    return _launch(plan.key, plan.out_shape, a.device,
                   lambda lib, out, s: launch_dot_mod(lib, plan, a, w, out, s))


class ChunkPlan(NamedTuple):
    """A prod_chunks launch: the output's shape (the input's, the axis
    cut to its runs) and the input's strides over it (the axis stride
    times the run length)."""

    key: tuple
    out_shape: tuple
    strides: tuple
    axis: int
    a_axis: int
    n: int
    chunk: int


def chunk_plan(a, axis: int, chunk: int) -> ChunkPlan:
    check_operands(a)
    if not 1 <= a.dim() <= MAX_DIMS:
        raise ValueError(f"prod_chunks: expected 1 to {MAX_DIMS} dims, got {tuple(a.shape)}")
    if chunk < 1:
        raise ValueError(f"prod_chunks: chunk = {chunk}")
    axis = axis % a.dim()
    n = a.shape[axis]
    out_shape = tuple(-(-n // chunk) if k == axis else a.shape[k] for k in range(a.dim()))
    strides = tuple(a.stride(k) * (chunk if k == axis else 1) for k in range(a.dim()))
    return ChunkPlan(("prod_chunks", tuple(a.shape), (tuple(a.stride()),), (axis, chunk)),
                     out_shape, strides, axis, a.stride(axis), n, chunk)


def launch_prod_chunks(lib, plan: ChunkPlan, a, out, stream) -> int:
    _check(lib.qzk_prod_chunks(a.data_ptr(), _arr(plan.strides), len(plan.out_shape),
                               _arr(plan.out_shape), plan.axis, plan.a_axis, plan.n, plan.chunk,
                               out.data_ptr(), stream), "qzk_prod_chunks")
    return 1


def prod_chunks(a, axis: int, chunk: int):
    """The product of each run of `chunk` words along `axis` (the last
    run ragged; a run of one word is that word)."""
    plan = chunk_plan(a, axis, chunk)
    if a.device.type == "cpu":
        return gt.prod_chunks(a, axis, chunk)
    return _launch(plan.key, plan.out_shape, a.device,
                   lambda lib, out, s: launch_prod_chunks(lib, plan, a, out, s))


def launch_prefix_prod(lib, plan: LanePlan, a, out, stream) -> int:
    _check(lib.qzk_prefix_prod(a.data_ptr(), _arr(plan.strides[0]), plan.axis[0],
                               len(plan.dims), _arr(plan.dims), _arr(plan.strides[1]),
                               plan.axis[1], plan.n, out.data_ptr(), stream), "qzk_prefix_prod")
    return 1


def prefix_threads(n: int) -> int:
    """The threads of prefix_prod_exclusive's block for a lane of n
    words (field.cu's qzk_prefix_threads; needs the built library)."""
    return _lib().qzk_prefix_threads(n)


def prefix_prod_exclusive(a):
    """Exclusive modular prefix product along axis 0."""
    plan = lane_plan("prefix_prod_exclusive", a, 0)
    if a.device.type == "cpu":
        return gt.prefix_prod_exclusive(a)
    return _launch(plan.key, plan.out_shape, a.device,
                   lambda lib, out, s: launch_prefix_prod(lib, plan, a, out, s))


# -- FIELD_SHAPES keys back into calls ----------------------------------------------


def call_of(key: tuple, make):
    """(function, args) that repeat the call of a FIELD_SHAPES key: each
    operand a view, at the key's shape and element strides, of
    make(words), a fresh int64 tensor of that many words."""
    op, shape, strides, extra = key

    def view(st, shp):
        words = 1 + sum((n - 1) * s for n, s in zip(shp, st))
        return make(words).as_strided(shp, st)

    fn = globals()[op]
    if op == "dot_mod":
        return fn, (view(strides[0], shape), view(strides[1], shape), extra)
    if op == "prod_chunks":
        return fn, (view(strides[0], shape), *extra)
    if op == "mds_partial":
        return fn, (view(strides[0], shape[1:]), view(strides[1], shape))
    if op == "powers_vec":
        return fn, (make(1).reshape(()), shape[0])
    if op == "ext_powers":
        return fn, (view(strides[0][1:], (2,)), shape[0])
    if op == "powers_vec_multi":
        return fn, (tuple(make(1).reshape(()) for _ in strides), shape[1])
    if op == "ext_powers_multi":
        return fn, (tuple(view(st[1:], (2,)) for st in strides), shape[1])
    if op == "batch_divide_axis":
        return fn, (view(strides[0], shape), view(strides[1], shape), extra)
    if op in ("sum_mod", "batch_inverse_axis"):
        return fn, (view(strides[0], shape), extra)
    if op == "prefix_prod_exclusive":
        return fn, (view(strides[0], shape),)
    args = tuple(view(st, shape) for st in strides)
    return fn, (args + (extra,) if op == "mul_small" else args)

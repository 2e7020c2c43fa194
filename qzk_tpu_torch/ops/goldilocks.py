"""Goldilocks field arithmetic — host-side numpy reference semantics.

p = 2^64 - 2^32 + 1.  All values are kept **canonical** (in [0, p)) at
every API boundary.  This module is the semantic oracle for the torch
field layer (goldilocks_torch.py) and the CUDA kernels built on
csrc/goldilocks.cuh.

Semantics mirror the field trait surface the reference uses
(`reference common/src/utils.rs:93-145` — `to_canonical_u64`,
`from_noncanonical_u64`, `F::ORDER`), re-derived from the published
Goldilocks field definition; no code is shared with the reference.

Vectorized over numpy uint64 arrays with explicit 32-bit-split
multiplication (numpy has no 128-bit integers).
"""

from __future__ import annotations

import numpy as np

# The Goldilocks prime.
P = 0xFFFFFFFF_00000001
# 2^64 mod p == 2^32 - 1 (used for wrap-around corrections).
EPSILON = 0xFFFFFFFF

_P = np.uint64(P)
_EPS = np.uint64(EPSILON)
_U32 = np.uint64(0xFFFFFFFF)
_32 = np.uint64(32)

# Multiplicative group generator (plonky2 convention) and the 2-adicity
# of the field: p - 1 = 2^32 * 4294967295.
GENERATOR = 7
TWO_ADICITY = 32
# Order-2^32 subgroup generator: g^((p-1)/2^32) mod p with g = 7.
POWER_OF_TWO_GENERATOR = pow(GENERATOR, (P - 1) >> TWO_ADICITY, P)


def _as_u64(x) -> np.ndarray:
    return np.asarray(x, dtype=np.uint64)


# -- native (C++) fast paths --------------------------------------------------
# Same-shape / scalar-broadcast mul/add/sub dispatch to the C library
# (native/): one 64x64->128 hardware product per element instead
# of numpy's ~15 vector passes.  Bit-exact (tests/test_field.py runs
# both); falls back to pure numpy when the toolchain is unavailable.

_native_lib = None
_native_checked = False


def _nlib():
    global _native_lib, _native_checked
    if not _native_checked:
        try:
            from ..native import get_lib

            _native_lib = get_lib()
        except Exception:
            _native_lib = None
        _native_checked = True
    return _native_lib


def _native_binop(a, b, ew, sa, as_=None):
    """Try the native elementwise/scalar kernels; None if not applicable.

    Pointer arguments pass as raw ndarray.ctypes.data ints (the gl_*
    argtypes are c_void_p): data_as(POINTER(c_uint64)) costs ~3.5 µs per
    argument, which dominated the host verifier's small-array profile.
    """
    lib = _nlib()
    if lib is None:
        return None
    # strided views (e.g. the [..., 0] component slices of packed
    # (..., 2) extension arrays) are cheap to materialize relative to
    # the ~16-dispatch numpy fallback they would otherwise take — but
    # only materialize once a branch has actually been selected, so a
    # non-qualifying call pays no wasted copy (ADVICE r4)
    use_a = a.ndim and (
        a.flags.c_contiguous or a.size <= (1 << 16)
    )
    use_b = b.ndim and (
        b.flags.c_contiguous or b.size <= (1 << 16)
    )
    if a.shape == b.shape and use_a and use_b:
        a = np.ascontiguousarray(a)
        b = np.ascontiguousarray(b)
        out = np.empty_like(a)
        getattr(lib, ew)(
            a.ctypes.data, b.ctypes.data, out.ctypes.data, a.size
        )
        return out
    if a.ndim == 0 and use_b and sa:
        b = np.ascontiguousarray(b)
        out = np.empty_like(b)
        getattr(lib, sa)(int(a), b.ctypes.data, out.ctypes.data, b.size)
        return out
    if b.ndim == 0 and use_a and as_:
        a = np.ascontiguousarray(a)
        out = np.empty_like(a)
        getattr(lib, as_)(a.ctypes.data, int(b), out.ctypes.data, a.size)
        return out
    if a.ndim and b.ndim and a.shape != b.shape:
        # small broadcasts: materializing both sides and using the
        # elementwise kernel beats the ~16-dispatch numpy fallback
        # (the host verifier's FRI walk is all (Q, ...) broadcasts)
        try:
            shape = np.broadcast_shapes(a.shape, b.shape)
        except ValueError:
            return None
        if int(np.prod(shape)) <= 1 << 16:
            ab = np.ascontiguousarray(np.broadcast_to(a, shape))
            bb = np.ascontiguousarray(np.broadcast_to(b, shape))
            out = np.empty(shape, dtype=np.uint64)
            getattr(lib, ew)(
                ab.ctypes.data, bb.ctypes.data, out.ctypes.data, out.size
            )
            return out
    return None


def add(a, b) -> np.ndarray:
    """(a + b) mod p for canonical a, b."""
    a = _as_u64(a)
    b = _as_u64(b)
    if b.ndim == 0 and a.ndim:
        a, b = b, a  # commutative: scalar first
    out = _native_binop(a, b, "gl_add", "gl_add_sa")
    if out is not None:
        return out
    with np.errstate(over="ignore"):
        s = a + b
        carry = s < a
        s = s + carry.astype(np.uint64) * _EPS
        s = np.where(s >= _P, s - _P, s)
    return s


def sub(a, b) -> np.ndarray:
    """(a - b) mod p for canonical a, b."""
    a = _as_u64(a)
    b = _as_u64(b)
    out = _native_binop(a, b, "gl_sub", "gl_sub_sa", "gl_sub_as")
    if out is not None:
        return out
    with np.errstate(over="ignore"):
        d = a - b
        borrow = a < b
        d = d - borrow.astype(np.uint64) * _EPS
    return d


def neg(a) -> np.ndarray:
    a = _as_u64(a)
    return np.where(a == 0, np.uint64(0), _P - a)


def _mul_64_64(a, b):
    """Full 64x64 -> 128-bit product as (lo64, hi64) numpy uint64."""
    a = _as_u64(a)
    b = _as_u64(b)
    a0 = a & _U32
    a1 = a >> _32
    b0 = b & _U32
    b1 = b >> _32
    with np.errstate(over="ignore"):
        p00 = a0 * b0
        p01 = a0 * b1
        p10 = a1 * b0
        p11 = a1 * b1
        # lo = p00 + ((p01 + p10) << 32), tracking carries.
        mid = p01 + (p00 >> _32)  # <= (2^32-1)^2/2^32 + ... fits u64
        mid_carry = mid < p01
        mid2 = mid + p10
        mid2_carry = mid2 < mid
        lo = (p00 & _U32) | (mid2 << _32)
        hi = (
            p11
            + (mid2 >> _32)
            + (mid_carry.astype(np.uint64) << _32)
            + (mid2_carry.astype(np.uint64) << _32)
        )
    return lo, hi


def reduce128(lo, hi) -> np.ndarray:
    """Reduce a 128-bit value (hi * 2^64 + lo) into [0, p).

    Uses 2^64 ≡ 2^32 - 1 and 2^96 ≡ -1 (mod p):
      value ≡ lo - hi_hi + hi_lo * (2^32 - 1)  (mod p)
    """
    lo = _as_u64(lo)
    hi = _as_u64(hi)
    hi_hi = hi >> _32
    hi_lo = hi & _U32
    with np.errstate(over="ignore"):
        t = lo - hi_hi
        borrow = lo < hi_hi
        t = t - borrow.astype(np.uint64) * _EPS
        a = hi_lo * _EPS  # < 2^64
        s = t + a
        carry = s < t
        s = s + carry.astype(np.uint64) * _EPS
        s = np.where(s >= _P, s - _P, s)
        s = np.where(s >= _P, s - _P, s)
    return s


def mul(a, b) -> np.ndarray:
    """(a * b) mod p for canonical a, b."""
    a = _as_u64(a)
    b = _as_u64(b)
    if b.ndim == 0 and a.ndim:
        a, b = b, a  # commutative: scalar first
    out = _native_binop(a, b, "gl_mul", "gl_mul_sa")
    if out is not None:
        return out
    lo, hi = _mul_64_64(a, b)
    return reduce128(lo, hi)


def square(a) -> np.ndarray:
    return mul(a, a)


def exp(base, e: int) -> np.ndarray:
    """base^e mod p (e a python int >= 0), vectorized over base."""
    result = np.full_like(_as_u64(base), np.uint64(1))
    acc = _as_u64(base).copy()
    while e > 0:
        if e & 1:
            result = mul(result, acc)
        acc = mul(acc, acc)
        e >>= 1
    return result


def inverse(a) -> np.ndarray:
    """a^-1 mod p (a != 0).

    Small arrays go through python-int pow (a few µs per element);
    the vectorized Fermat chain costs ~128 numpy dispatches (~30 µs
    EACH at small shapes — native-call overhead, not arithmetic), which
    dominated the host verifier's latency profile (round 4)."""
    a = _as_u64(a)
    if np.any(a == 0):
        raise ZeroDivisionError("inverse of zero in Goldilocks field")
    if a.size <= 64:
        flat = [pow(int(x), P - 2, P) for x in a.ravel()]
        return np.array(flat, dtype=np.uint64).reshape(a.shape)
    return exp(a, P - 2)


def batch_inverse(a) -> np.ndarray:
    """Montgomery batch inversion of a flat array (all nonzero).

    Reshapes to a (rows, cols) grid and runs the serial Montgomery walk
    along the short rows axis only, vectorized over cols, so cost is
    O(rows) numpy calls + one wide Fermat inversion of the cols totals."""
    a = _as_u64(a).ravel()
    n = a.shape[0]
    if n == 0:
        return a
    if n == 1:
        return inverse(a)
    cols = min(4096, 1 << ((n.bit_length() - 1) // 2 + 1))
    rows = -(-n // cols)
    padded = np.ones(rows * cols, dtype=np.uint64)
    padded[:n] = a
    out = batch_inverse_axis(padded.reshape(rows, cols), axis=0).ravel()
    return out[:n].copy()


def batch_inverse_axis(a: np.ndarray, axis: int = 0) -> np.ndarray:
    """Montgomery batch inversion along one axis (all entries nonzero),
    vectorized over every other axis: K serial steps for shape[axis]=K."""
    a = _as_u64(a)
    a = np.moveaxis(a, axis, 0)
    k = a.shape[0]
    prefix = np.empty_like(a)
    acc = np.ones(a.shape[1:], dtype=np.uint64)
    for i in range(k):
        prefix[i] = acc
        acc = mul(acc, a[i])
    inv_acc = inverse(acc)
    out = np.empty_like(a)
    for i in range(k - 1, -1, -1):
        out[i] = mul(inv_acc, prefix[i])
        inv_acc = mul(inv_acc, a[i])
    return np.moveaxis(out, 0, axis)


def sum_mod(a: np.ndarray, axis: int = -1) -> np.ndarray:
    """Modular sum along an axis via halving tree reduction (log2 n
    vectorized adds)."""
    a = np.moveaxis(_as_u64(a), axis, -1)
    n = a.shape[-1]
    if n == 0:
        return np.zeros(a.shape[:-1], dtype=np.uint64)
    while n > 1:
        half = n // 2
        s = add(a[..., :half], a[..., half : 2 * half])
        if n & 1:
            s = s.copy()
            s[..., 0] = add(s[..., 0], a[..., -1])
        a = s
        n = half
    return a[..., 0]


# ---------------------------------------------------------------------------
# Quadratic extension F_p[X] / (X^2 - W) with W = 7 (plonky2 convention,
# D = 2 in the reference: reference common/src/circuit.rs:10).
# Elements are represented as (..., 2) uint64 arrays [c0, c1].
# ---------------------------------------------------------------------------

W_EXT = 7
_W = np.uint64(W_EXT)
_PI = P  # python-int modulus for the single-scalar fast paths
# Frobenius constant: W^((p-1)/2) = -1 for non-residue; x^p = -x ... the
# Frobenius map sends (c0, c1) -> (c0, c1 * DTH_ROOT) with
# DTH_ROOT = W^((p-1)/2) mod p.
DTH_ROOT = pow(W_EXT, (P - 1) // 2, P)


def ext(c0, c1=0) -> np.ndarray:
    c0 = _as_u64(c0)
    c1 = np.broadcast_to(_as_u64(c1), c0.shape)
    return np.stack([c0, c1], axis=-1)


def _is_pair(a) -> bool:
    return isinstance(a, np.ndarray) and a.shape == (2,)


def ext_add(a, b) -> np.ndarray:
    if _is_pair(a) and _is_pair(b):
        # single ext scalar: python ints beat three array dispatches
        return np.array(
            [(int(a[0]) + int(b[0])) % _PI, (int(a[1]) + int(b[1])) % _PI],
            dtype=np.uint64,
        )
    return np.stack(
        [add(a[..., 0], b[..., 0]), add(a[..., 1], b[..., 1])], axis=-1
    )


def ext_sub(a, b) -> np.ndarray:
    if _is_pair(a) and _is_pair(b):
        return np.array(
            [(int(a[0]) - int(b[0])) % _PI, (int(a[1]) - int(b[1])) % _PI],
            dtype=np.uint64,
        )
    return np.stack(
        [sub(a[..., 0], b[..., 0]), sub(a[..., 1], b[..., 1])], axis=-1
    )


def ext_mul(a, b) -> np.ndarray:
    if _is_pair(a) and _is_pair(b):
        a0, a1, b0, b1 = int(a[0]), int(a[1]), int(b[0]), int(b[1])
        return np.array(
            [(a0 * b0 + 7 * a1 * b1) % _PI, (a0 * b1 + a1 * b0) % _PI],
            dtype=np.uint64,
        )
    a0, a1 = a[..., 0], a[..., 1]
    b0, b1 = b[..., 0], b[..., 1]
    c0 = add(mul(a0, b0), mul(_W, mul(a1, b1)))
    c1 = add(mul(a0, b1), mul(a1, b0))
    return np.stack([c0, c1], axis=-1)


def ext_scalar_mul(s, a) -> np.ndarray:
    return np.stack([mul(s, a[..., 0]), mul(s, a[..., 1])], axis=-1)


def ext_inverse(a) -> np.ndarray:
    """(c0 + c1 x)^-1 = (c0 - c1 x) / (c0^2 - W c1^2)."""
    a0, a1 = a[..., 0], a[..., 1]
    norm = sub(mul(a0, a0), mul(_W, mul(a1, a1)))
    inv_norm = inverse(norm)
    return np.stack([mul(a0, inv_norm), mul(neg(a1), inv_norm)], axis=-1)


def ext_powers_vec(z: np.ndarray, n: int) -> np.ndarray:
    """[z^0 .. z^(n-1)] as (n, 2).

    Python-int sequential products: at the sizes the verifier uses
    (n <= a few hundred) a 4-mult int loop at ~1 µs/step beats the
    log-doubling numpy ladder, whose ~60 small-array dispatches cost
    ~2 ms of overhead (round-5 verifier profile)."""
    if n <= 4096:
        z0, z1 = int(z.reshape(2)[0]), int(z.reshape(2)[1])
        a0, a1 = 1, 0
        out = np.empty((n, 2), dtype=np.uint64)
        o0, o1 = out[:, 0], out[:, 1]
        for i in range(n):
            o0[i] = a0
            o1[i] = a1
            a0, a1 = (
                (a0 * z0 + 7 * a1 * z1) % _PI,
                (a0 * z1 + a1 * z0) % _PI,
            )
        return out
    pows = np.array([[1, 0]], dtype=np.uint64)
    z_len = z.reshape(1, 2)
    while pows.shape[0] < n:
        pows = np.concatenate(
            [pows, ext_mul(pows, np.broadcast_to(z_len, pows.shape))]
        )
        z_len = ext_mul(z_len, z_len)
    return pows[:n]


def ext_exp(a, e: int) -> np.ndarray:
    result = ext(np.ones_like(a[..., 0]), np.zeros_like(a[..., 0]))
    acc = a.copy()
    while e > 0:
        if e & 1:
            result = ext_mul(result, acc)
        acc = ext_mul(acc, acc)
        e >>= 1
    return result

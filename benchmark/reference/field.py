"""The Goldilocks field p = 2^64 - 2^32 + 1 and its quadratic extension
(x^2 = 7), written plainly: numpy uint64 arrays for the vectorised work
and Python integers for single values.  Every array operation takes and
returns canonical words (< p)."""

from __future__ import annotations

import numpy as np

P = 0xFFFFFFFF00000001
EPS = 0xFFFFFFFF  # 2^64 mod p
MULTIPLICATIVE_GENERATOR = 7
TWO_ADICITY = 32
W = 7  # the extension's non-residue: x^2 = W

_P = np.uint64(P)
_EPS = np.uint64(EPS)
_LO = np.uint64(0xFFFFFFFF)
_32 = np.uint64(32)


def u64(a) -> np.ndarray:
    return np.asarray(a, dtype=np.uint64)


def add(a, b) -> np.ndarray:
    a, b = u64(a), u64(b)
    with np.errstate(over="ignore"):
        s = a + b
        s = np.where(s < a, s + _EPS, s)
    return np.where(s >= _P, s - _P, s)


def sub(a, b) -> np.ndarray:
    a, b = u64(a), u64(b)
    with np.errstate(over="ignore"):
        d = a - b
        return np.where(a < b, d - _EPS, d)


def reduce128(lo, hi) -> np.ndarray:
    """(hi * 2^64 + lo) mod p, canonical."""
    with np.errstate(over="ignore"):
        hi_hi = hi >> _32
        hi_lo = hi & _LO
        t0 = lo - hi_hi
        t0 = np.where(lo < hi_hi, t0 - _EPS, t0)
        t1 = (hi_lo << _32) - hi_lo
        s = t0 + t1
        s = np.where(s < t0, s + _EPS, s)
    return np.where(s >= _P, s - _P, s)


def mul(a, b) -> np.ndarray:
    a, b = u64(a), u64(b)
    with np.errstate(over="ignore"):
        a0, a1 = a & _LO, a >> _32
        b0, b1 = b & _LO, b >> _32
        ll, lh, hl, hh = a0 * b0, a0 * b1, a1 * b0, a1 * b1
        mid = lh + hl
        mid_carry = (mid < lh).astype(np.uint64)
        lo = ll + (mid << _32)
        lo_carry = (lo < ll).astype(np.uint64)
        hi = hh + (mid >> _32) + (mid_carry << _32) + lo_carry
    return reduce128(lo, hi)


def sum_mod(a, axis: int) -> np.ndarray:
    """Sum modulo p along `axis`, folding halves."""
    a = np.moveaxis(u64(a), axis, 0)
    while a.shape[0] > 1:
        half = a.shape[0] // 2
        folded = add(a[:half], a[half : 2 * half])
        a = np.concatenate([folded, a[2 * half :]]) if a.shape[0] & 1 else folded
    return a[0]


def root_of_unity(log_n: int) -> int:
    """The primitive 2^log_n-th root of unity from the field's 2^32 one."""
    root = pow(MULTIPLICATIVE_GENERATOR, (P - 1) >> TWO_ADICITY, P)
    for _ in range(TWO_ADICITY - log_n):
        root = root * root % P
    return root


# -- single values as Python integers --------------------------------------


def inv(a: int) -> int:
    if a % P == 0:
        raise ZeroDivisionError("inverse of zero")
    return pow(a, P - 2, P)


def e_mul(a, b):
    return ((a[0] * b[0] + W * a[1] * b[1]) % P, (a[0] * b[1] + a[1] * b[0]) % P)


def e_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def e_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def e_pow(a, e: int):
    out, base = (1, 0), a
    while e:
        if e & 1:
            out = e_mul(out, base)
        base = e_mul(base, base)
        e >>= 1
    return out


def e_inv(a):
    norm = (a[0] * a[0] - W * a[1] * a[1]) % P
    n_inv = inv(norm)
    return (a[0] * n_inv % P, -a[1] * n_inv % P)


def e_powers(a, n: int) -> np.ndarray:
    """[a^0 .. a^(n-1)] as a (n, 2) array."""
    out = np.empty((n, 2), dtype=np.uint64)
    acc = (1, 0)
    for i in range(n):
        out[i] = acc
        acc = e_mul(acc, a)
    return out

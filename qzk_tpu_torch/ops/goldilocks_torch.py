"""Goldilocks field arithmetic on torch tensors.

A field element is the uint64 bit pattern of a canonical value, held in
a ``torch.int64`` tensor: torch's CPU kernels have no ``+``, ``<`` or
``>>`` for ``torch.uint64``, while int64 add, sub and mul wrap mod 2^64.
Unsigned compares flip the sign bit first, and logical right shifts mask
after the arithmetic ``>>``.

Every function mirrors its counterpart in the JAX package's
``goldilocks_jax`` operation for operation, so results agree bit for bit
on every 64-bit input, canonical or not.  The numpy oracle is
``goldilocks.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from .goldilocks import P

_MIN = -(1 << 63)  # sign bit as an int64
_M32 = 0xFFFFFFFF
EPS = 0xFFFFFFFF  # 2^64 mod p


def i64(v: int) -> int:
    """A Python int in [0, 2^64) as the int64 with the same bits."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >> 63 else v


_P = i64(P)  # -0xFFFFFFFF


def from_u64(x, device=None) -> torch.Tensor:
    """uint64 array-like -> int64 tensor with the same bits."""
    a = np.ascontiguousarray(np.asarray(x, dtype=np.uint64))
    return torch.from_numpy(a.view(np.int64).copy()).to(device)


def to_u64(x: torch.Tensor) -> np.ndarray:
    """int64 tensor -> uint64 numpy array with the same bits."""
    return x.detach().cpu().contiguous().numpy().view(np.uint64).copy()


def scalar(v, device=None) -> torch.Tensor:
    """A 0-d field element (Python int or numpy uint64)."""
    return torch.tensor(i64(int(v)), dtype=torch.int64, device=device)


def lt(a, b):
    """Unsigned a < b on int64 bit patterns."""
    return (a ^ _MIN) < (b ^ _MIN)


def ge(a, b):
    return (a ^ _MIN) >= (b ^ _MIN)


def shr(a, k: int):
    """Logical right shift by k (1 <= k < 64)."""
    return (a >> k) & ((1 << (64 - k)) - 1)


def zeros(shape, device=None) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.int64, device=device)


def ones(shape, device=None) -> torch.Tensor:
    return torch.ones(shape, dtype=torch.int64, device=device)


def add(a, b):
    s = a + b
    s = torch.where(lt(s, a), s + EPS, s)
    return torch.where(ge(s, _P), s - _P, s)


def sub(a, b):
    d = a - b
    return torch.where(lt(a, b), d - EPS, d)


def neg(a):
    return torch.where(a == 0, torch.zeros_like(a), _P - a)


def _mul_wide(a, b):
    """Full 64x64 -> 128-bit product as (lo, hi) bit patterns."""
    a0 = a & _M32
    a1 = shr(a, 32)
    b0 = b & _M32
    b1 = shr(b, 32)
    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    p11 = a1 * b1
    mid1 = p01 + shr(p00, 32)
    mid2 = mid1 + p10
    carry = lt(mid2, mid1).to(torch.int64)
    lo = (p00 & _M32) | (mid2 << 32)
    hi = p11 + shr(mid2, 32) + (carry << 32)
    return lo, hi


def reduce128(lo, hi):
    """hi*2^64 + lo into [0, p), using 2^64 = 2^32 - 1 and 2^96 = -1."""
    hi_hi = shr(hi, 32)
    hi_lo = hi & _M32
    t = lo - hi_hi
    t = torch.where(lt(lo, hi_hi), t - EPS, t)
    s = t + hi_lo * EPS
    s = torch.where(lt(s, t), s + EPS, s)
    s = torch.where(ge(s, _P), s - _P, s)
    return torch.where(ge(s, _P), s - _P, s)


def mul(a, b):
    return reduce128(*_mul_wide(a, b))


def square(a):
    return mul(a, a)


def mul_small(a, c: int):
    """Multiply by a small constant 0 <= c < 2^32."""
    assert 0 <= c < (1 << 32)
    lo = (a & _M32) * c
    hi = shr(a, 32) * c
    s_lo = lo + (hi << 32)
    carry = lt(s_lo, lo).to(torch.int64)
    s_hi = shr(hi, 32) + carry
    return reduce128(s_lo, s_hi)


def pow7(x):
    """x^7, the Poseidon S-box: the Poseidon gate's x7."""
    x2 = mul(x, x)
    x3 = mul(x2, x)
    return mul(mul(x2, x2), x3)


def exp_const(a, e: int):
    """a^e for a Python-int exponent (square and multiply)."""
    assert e >= 0
    result = torch.ones_like(a)
    acc = a
    while e > 0:
        if e & 1:
            result = mul(result, acc)
        acc = square(acc)
        e >>= 1
    return result


def inverse(a):
    """a^-1 by Fermat (a assumed nonzero): the same 64-step bit walk
    over P - 2 as the JAX package's scan."""
    result = torch.ones_like(a)
    acc = a
    for i in range(64):
        if (P - 2) >> i & 1:
            result = mul(result, acc)
        acc = square(acc)
    return result


def powers_vec(b, n: int):
    """[b^0 .. b^(n-1)] for a 0-d tensor b, by log2(n) doubling steps."""
    pows = torch.ones(1, dtype=torch.int64, device=b.device)
    cur = b.reshape(1)
    while pows.shape[0] < n:
        pows = torch.cat([pows, mul(pows, cur.expand(pows.shape))])
        cur = mul(cur, cur)
    return pows[:n]


def batch_inverse_axis(a, axis: int = 0):
    """Montgomery batch inversion along one short axis: 2K serial
    vector muls and one Fermat inversion."""
    a = torch.movedim(a, axis, 0)
    acc = torch.ones_like(a[0])
    prefix = []
    for ai in a:
        prefix.append(acc)
        acc = mul(acc, ai)
    inv = inverse(acc)
    outs = [None] * a.shape[0]
    for k in range(a.shape[0] - 1, -1, -1):
        outs[k] = mul(inv, prefix[k])
        inv = mul(inv, a[k])
    return torch.movedim(torch.stack(outs), 0, axis)


def batch_divide_axis(nums, dens, axis: int = 0):
    """nums times the batch inverse of dens along one axis (the
    permutation argument's ratios)."""
    return mul(nums, batch_inverse_axis(dens, axis))


def powers_vec_multi(bases, n: int):
    """(B, n): powers_vec of each of B one-element bases."""
    return torch.stack([powers_vec(b, n) for b in bases])


def sum_mod(a, axis: int = -1):
    """Modular sum along an axis: log2(n) halving adds."""
    a = torch.movedim(a, axis, -1)
    n = a.shape[-1]
    if n == 0:
        return torch.zeros(a.shape[:-1], dtype=torch.int64, device=a.device)
    while n > 1:
        half = n // 2
        s = add(a[..., :half], a[..., half : 2 * half])
        if n & 1:
            s = s.clone()
            s[..., 0] = add(s[..., 0], a[..., -1])
        a = s
        n = half
    return a[..., 0]


def dot_mod(a, w, axis: int):
    """sum_mod of a times w (w broadcast to a's shape) along an axis."""
    return sum_mod(mul(a, w), axis)


def prod_chunks(a, axis: int, chunk: int):
    """The product of each run of `chunk` words along an axis, the last
    run ragged, sequentially (a run of one word is that word)."""
    a = torch.movedim(a, axis, 0)
    n = a.shape[0]
    if n == 0:
        return torch.movedim(torch.zeros_like(a), 0, axis)
    out = []
    for lo in range(0, n, chunk):
        acc = a[lo]
        for j in range(lo + 1, min(lo + chunk, n)):
            acc = mul(acc, a[j])
        out.append(acc)
    return torch.movedim(torch.stack(out), 0, axis)


def prefix_prod_exclusive(a):
    """Exclusive modular prefix product along axis 0 (Hillis-Steele,
    log2(n) vector muls)."""
    n = a.shape[0]
    res = a
    k = 1
    while k < n:
        shifted = torch.cat([torch.ones_like(res[:k]), res[:-k]])
        res = mul(res, shifted)
        k *= 2
    return torch.cat([torch.ones_like(res[:1]), res[:-1]])


# -- quadratic extension (..., 2): c0 + c1*x with x^2 = 7 -------------------


def ext_add(a, b):
    return add(a, b)


def ext_sub(a, b):
    return sub(a, b)


def ext_mul(a, b):
    a0, a1 = a[..., 0], a[..., 1]
    b0, b1 = b[..., 0], b[..., 1]
    c0 = add(mul(a0, b0), mul_small(mul(a1, b1), 7))
    c1 = add(mul(a0, b1), mul(a1, b0))
    return torch.stack([c0, c1], dim=-1)


def ext_inverse_vec(a):
    """(..., 2) extension inverse: conjugate over the norm."""
    a0, a1 = a[..., 0], a[..., 1]
    norm = sub(mul(a0, a0), mul_small(mul(a1, a1), 7))
    inv = inverse(norm)
    return torch.stack([mul(a0, inv), mul(neg(a1), inv)], dim=-1)


def ext_powers(z, n: int):
    """[z^0 .. z^(n-1)] as (n, 2) for a (2,) extension scalar z."""
    pows = torch.nn.functional.pad(torch.ones((1, 1), dtype=torch.int64, device=z.device),
                                   (0, 1))  # [[1, 0]], built on the device
    z_len = z.reshape(1, 2)
    while pows.shape[0] < n:
        pows = torch.cat([pows, ext_mul(pows, z_len.expand(pows.shape))])
        z_len = ext_mul(z_len, z_len)
    return pows[:n]


def ext_powers_multi(bases, n: int):
    """(B, n, 2): ext_powers of each of B (2,) extension bases."""
    return torch.stack([ext_powers(z, n) for z in bases])

"""Number-theoretic transform (radix-2) over Goldilocks + low-degree
extension — numpy oracle and JAX device implementation.

The Goldilocks field has 2-adicity 32: p - 1 = 2^32 * (2^32 - 1), so the
multiplicative group contains a 2^32 subgroup generated by
POWER_OF_TWO_GENERATOR.  The prover's LDE evaluates witness polynomials
of degree < n on the coset g * <w_{rate*n}> (g = 7, the multiplicative
group generator), exactly the domain layout the reference engine uses for
its FRI commitments (SURVEY.md §2b "Prove pipeline": wire polys -> LDE
(rate 8) -> Merkle commit).

Conventions:
  * ntt: coefficients -> evaluations over <w_n>, natural order both ends
    (evals[j] = P(w^j)).
  * intt: inverse.
  * coset_lde: P -> evaluations of P on shift * <w_{n<<rate_bits}>.

The torch path (pease_tables, ntt_pease, intt_pease, coset_lde_pease)
runs the constant-geometry transform of the JAX package's ntt.py as
batched-row tensor ops on int64 bit patterns; it is bit-exact against
the numpy oracle and against the JAX package (tests/test_torch_ntt.py).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import goldilocks as gl
from . import goldilocks_torch as gt

# ---------------------------------------------------------------------------
# Host-side root/twiddle computation (python ints, exact)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def root_of_unity(log_n: int) -> int:
    """Primitive 2^log_n-th root of unity (square-chain from the 2^32 gen)."""
    assert 0 <= log_n <= gl.TWO_ADICITY
    root = gl.POWER_OF_TWO_GENERATOR
    for _ in range(gl.TWO_ADICITY - log_n):
        root = root * root % gl.P
    return root


@functools.lru_cache(maxsize=None)
def _powers_table(base: int, n: int) -> np.ndarray:
    out = np.empty(n, dtype=np.uint64)
    acc = 1
    for i in range(n):
        out[i] = acc
        acc = acc * base % gl.P
    return out


def powers(base: int, n: int) -> np.ndarray:
    """[1, base, base^2, ..., base^(n-1)] as uint64."""
    return _powers_table(base % gl.P, n).copy()


def bit_reverse_perm(log_n: int) -> np.ndarray:
    n = 1 << log_n
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


# ---------------------------------------------------------------------------
# numpy oracle
# ---------------------------------------------------------------------------


_stage_tw_cache: dict[int, np.ndarray] = {}


def _stage_twiddles(log_n: int) -> np.ndarray:
    """Concatenated per-stage twiddles: stage s (half = 2^(s-1)) at
    offset half-1, entry j = w_s^j.  n-1 entries total."""
    if log_n not in _stage_tw_cache:
        parts = [
            _powers_table(root_of_unity(s), 1 << (s - 1))
            for s in range(1, log_n + 1)
        ]
        _stage_tw_cache[log_n] = (
            np.concatenate(parts)
            if parts
            else np.zeros(0, dtype=np.uint64)
        )
    return _stage_tw_cache[log_n]


def ntt_np(coeffs: np.ndarray) -> np.ndarray:
    """Forward NTT along the last axis (length must be a power of 2)."""
    coeffs = np.asarray(coeffs, dtype=np.uint64)
    n = coeffs.shape[-1]
    log_n = n.bit_length() - 1
    assert 1 << log_n == n
    if coeffs.size >= 1 << 12 and coeffs.ndim <= 2:
        from .. import native

        out = native.ntt_rows(
            coeffs.reshape(-1, n), _stage_twiddles(log_n)
        )
        if out is not None:
            return out.reshape(coeffs.shape)
    x = coeffs[..., bit_reverse_perm(log_n)].copy()
    for s in range(1, log_n + 1):
        half = 1 << (s - 1)
        w = root_of_unity(s)
        tw = powers(w, half)
        x = x.reshape(*x.shape[:-1], n >> s, 2, half)
        e = x[..., 0, :]
        o = gl.mul(x[..., 1, :], tw)
        x = np.stack([gl.add(e, o), gl.sub(e, o)], axis=-2)
        x = x.reshape(*x.shape[:-3], n)
    return x


def intt_np(evals: np.ndarray) -> np.ndarray:
    """Inverse NTT along the last axis."""
    evals = np.asarray(evals, dtype=np.uint64)
    n = evals.shape[-1]
    log_n = n.bit_length() - 1
    # inverse transform = forward with w^-1, scaled by n^-1
    inv_w = pow(root_of_unity(log_n), gl.P - 2, gl.P)
    # evaluate with inverse root: reuse ntt by index reversal:
    # INTT(x)[i] = (1/n) * sum_j x[j] w^{-ij} = (1/n) * NTT(x)[(-i) mod n]
    y = ntt_np(evals)
    out = np.empty_like(y)
    out[..., 0] = y[..., 0]
    out[..., 1:] = y[..., :0:-1]
    n_inv = np.uint64(pow(n, gl.P - 2, gl.P))
    return gl.mul(out, n_inv)


def coset_lde_np(
    coeffs: np.ndarray, rate_bits: int, shift: int = gl.GENERATOR
) -> np.ndarray:
    """Evaluate P on shift * <w_N>, N = len(coeffs) << rate_bits."""
    coeffs = np.asarray(coeffs, dtype=np.uint64)
    n = coeffs.shape[-1]
    big_n = n << rate_bits
    pw = powers(shift, n)
    if coeffs.ndim == 2:
        # materialized broadcast keeps the scale on the native
        # same-shape multiply path
        pw = np.ascontiguousarray(np.broadcast_to(pw, coeffs.shape))
    padded = np.zeros((*coeffs.shape[:-1], big_n), dtype=np.uint64)
    padded[..., :n] = gl.mul(coeffs, pw)
    if padded.size >= 1 << 12 and padded.ndim <= 2:
        from .. import native

        log_big = big_n.bit_length() - 1
        if native.ntt_rows_inplace(
            padded.reshape(-1, big_n), _stage_twiddles(log_big)
        ):
            return padded
    return ntt_np(padded)


# ---------------------------------------------------------------------------
# Constant-geometry (Pease) NTT, for the device prover
# ---------------------------------------------------------------------------
#
# Every stage has IDENTICAL data flow:
#     a, b = x[: n/2], x[n/2 :]
#     e = a + b;  o = (a - b) * tw_s        (radix-2 DIF butterfly)
#     x' = interleave(e, o)                 (perfect shuffle — a
#                                            reshape/stack, no gather)
# with per-stage twiddles tw_s[k] = w_{2^(m-s)}^(k >> s), natural-order
# input, bit-reversed output (one final gather).  Validated bit-exact
# against ntt_np (tests/test_torch_ntt.py).
#
# It is the transform the JAX package's device prover runs; the port
# keeps it so that both stacks take the same steps.  The tables are host
# numpy, uploaded once per circuit by the device prover.


@functools.lru_cache(maxsize=None)
def pease_tables(log_n: int) -> dict:
    """{"tw": (m, n/2), "twinv": (m, n/2), "rev": (n,) int32} host
    tables for ntt_pease/intt_pease at size 2^log_n."""
    n = 1 << log_n
    tw = np.empty((log_n, n // 2), dtype=np.uint64)
    twinv = np.empty((log_n, n // 2), dtype=np.uint64)
    k = np.arange(n // 2)
    for s in range(log_n):
        ws = root_of_unity(log_n - s)
        size_half = max(1, n >> (s + 1))
        tw[s] = powers(ws, size_half)[k >> s]
        twinv[s] = powers(pow(ws, gl.P - 2, gl.P), size_half)[k >> s]
    return {
        "tw": tw,
        "twinv": twinv,
        "rev": bit_reverse_perm(log_n).astype(np.int32),
    }


def ntt_pease(x: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """Forward NTT along the last axis, natural order at both ends:
    one radix-2 DIF stage per row of `tw` (from pease_tables, as an
    int64 tensor on x's device), then the output bit-reversal."""
    n = x.shape[-1]
    lead = x.shape[:-1]
    for s in range(tw.shape[0]):
        a, b = x[..., : n // 2], x[..., n // 2 :]
        e = gt.add(a, b)
        o = gt.mul(gt.sub(a, b), tw[s])
        x = torch.stack([e, o], dim=-1).reshape(*lead, n)
    rev = torch.as_tensor(bit_reverse_perm(n.bit_length() - 1), device=x.device)
    return x.index_select(-1, rev)


def intt_pease(x: torch.Tensor, twinv: torch.Tensor, log_n: int = 0) -> torch.Tensor:
    """Inverse NTT along the last axis: (1/n) * NTT_{w^-1}(x)."""
    if not log_n:
        log_n = x.shape[-1].bit_length() - 1
    y = ntt_pease(x, twinv)
    return gt.mul(y, gt.scalar(pow(1 << log_n, gl.P - 2, gl.P), y.device))


def coset_lde_pease(
    coeffs: torch.Tensor, rate_bits: int, shift_pows: torch.Tensor, tw_lde: torch.Tensor
) -> torch.Tensor:
    """coeffs (..., n) -> evaluations on the shifted coset of size
    n << rate_bits (shift_pows: (n,) powers of the coset shift)."""
    n = coeffs.shape[-1]
    shifted = gt.mul(coeffs, shift_pows)
    return ntt_pease(torch.nn.functional.pad(shifted, (0, (n << rate_bits) - n)), tw_lde)

"""Number-theoretic transform (radix-2) over Goldilocks + low-degree
extension — numpy oracle and torch plans.

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

The torch plans (NTTPlan, FourStepPlan) mirror the JAX package's and
are bit-exact against it and against the numpy oracle
(tests/test_torch_ntt_fourstep.py).  The prover's batched-row iNTT and
coset LDE run through the CUDA kernel K3 in ops/ntt_fourstep.py.
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
# Radix-2 plan (torch), the benchmark's "radix2" variant
# ---------------------------------------------------------------------------


class NTTPlan:
    """Bit-reversal permutation and per-stage twiddles for size 2^log_n.

    The tables are host numpy, uploaded to a device at first use there;
    `ntt`/`intt` transform the last axis of an int64 tensor, one torch
    butterfly layer per stage."""

    def __init__(self, log_n: int):
        self.log_n = log_n
        self.n = 1 << log_n
        self.rev = bit_reverse_perm(log_n)
        self.stage_tw = [
            powers(root_of_unity(s), 1 << (s - 1))
            for s in range(1, log_n + 1)
        ]
        self.n_inv = pow(self.n, gl.P - 2, gl.P)
        self._rev_idx = np.concatenate([[0], np.arange(self.n - 1, 0, -1)])
        self._dev: dict = {}

    def _tables(self, device: torch.device):
        key = str(device)
        if key not in self._dev:
            self._dev[key] = (
                torch.as_tensor(self.rev, device=device),
                [gt.from_u64(t, device) for t in self.stage_tw],
                torch.as_tensor(self._rev_idx, device=device),
                gt.scalar(self.n_inv, device),
            )
        return self._dev[key]

    def ntt(self, x: torch.Tensor) -> torch.Tensor:
        n = self.n
        rev, stage_tw, _, _ = self._tables(x.device)
        x = x.index_select(-1, rev)
        for s in range(1, self.log_n + 1):
            half = 1 << (s - 1)
            xr = x.reshape(*x.shape[:-1], n >> s, 2, half)
            e = xr[..., 0, :]
            o = gt.mul(xr[..., 1, :], stage_tw[s - 1])
            x = torch.stack([gt.add(e, o), gt.sub(e, o)], dim=-2).reshape(
                *x.shape[:-1], n
            )
        return x

    def intt(self, evals: torch.Tensor) -> torch.Tensor:
        _, _, rev_idx, n_inv = self._tables(evals.device)
        return gt.mul(self.ntt(evals).index_select(-1, rev_idx), n_inv)


@functools.lru_cache(maxsize=None)
def get_plan(log_n: int) -> NTTPlan:
    return NTTPlan(log_n)


# ---------------------------------------------------------------------------
# Four-step NTT: tables, and the plain torch transform
# ---------------------------------------------------------------------------
#
#   x[j1 + n1*j2]  viewed as  xr[j2, j1]      (n2, n1) C-order
#   1. length-n2 NTTs along axis 0 (root w^n1)  -> A[k2, j1]
#   2. A *= T,  T[k2, j1] = w^(j1*k2)           (elementwise)
#   3. transpose -> (n1, n2), length-n1 NTTs along axis 0 (root w^n2)
#   4. result B[k1, k2] IS the natural-order output reshaped (n,)
#
# ops/ntt_fourstep.py runs the same steps through the CUDA kernel K3
# (csrc/ntt.cu), which does each axis-0 pass in one launch.


def powers_mul_table(base: int, n: int) -> np.ndarray:
    """powers(base, n) built by vectorized doubling (O(log n) numpy
    passes; the scalar loop of _powers_table is too slow at n ~ 2^22)."""
    out = np.ones(1, dtype=np.uint64)
    b = np.uint64(base % gl.P)
    while out.shape[0] < n:
        out = np.concatenate([out, gl.mul(out, b)])
        b = gl.mul(b, b)
    return out[:n]


class FourStepPlan:
    """Host tables for the four-step NTT at size 2^log_n: the (n2, n1)
    twiddle matrix w^(j1*k2), the two bit-reversal permutations and the
    two passes' per-stage twiddles."""

    def __init__(self, log_n: int):
        self.log_n = log_n
        self.log1 = log_n // 2
        self.log2 = log_n - self.log1
        n1, n2 = 1 << self.log1, 1 << self.log2
        self.n1, self.n2 = n1, n2
        w = root_of_unity(log_n)
        pw = powers_mul_table(w, 1 << log_n)
        exps = (
            np.arange(n2, dtype=np.int64)[:, None]
            * np.arange(n1, dtype=np.int64)[None, :]
        ) & ((1 << log_n) - 1)
        self.twiddle = pw[exps]  # (n2, n1) w^(j1*k2)
        self.rev1 = bit_reverse_perm(self.log1)
        self.rev2 = bit_reverse_perm(self.log2)
        self.stage_tw1 = [
            powers(root_of_unity(s), 1 << (s - 1))
            for s in range(1, self.log1 + 1)
        ]
        self.stage_tw2 = [
            powers(root_of_unity(s), 1 << (s - 1))
            for s in range(1, self.log2 + 1)
        ]
        self._dev: dict = {}

    def _tables(self, device: torch.device):
        key = str(device)
        if key not in self._dev:
            self._dev[key] = (
                gt.from_u64(self.twiddle, device),
                torch.as_tensor(self.rev1, device=device),
                torch.as_tensor(self.rev2, device=device),
                [gt.from_u64(t, device)[None, :, None] for t in self.stage_tw1],
                [gt.from_u64(t, device)[None, :, None] for t in self.stage_tw2],
            )
        return self._dev[key]

    @staticmethod
    def _ntt_axis0(x, rev, stage_tw):
        """Radix-2 DIT along axis 0, the columns untouched."""
        n = x.shape[0]
        x = x.index_select(0, rev)
        for s in range(1, n.bit_length()):
            half = 1 << (s - 1)
            xr = x.reshape(n >> s, 2, half, -1)
            e = xr[:, 0]
            o = gt.mul(xr[:, 1], stage_tw[s - 1])
            x = torch.stack([gt.add(e, o), gt.sub(e, o)], dim=1).reshape(n, -1)
        return x

    def ntt(self, x: torch.Tensor) -> torch.Tensor:
        """Forward NTT of a (n,) or (1, n) vector, in torch ops."""
        twiddle, rev1, rev2, tw1, tw2 = self._tables(x.device)
        lead = x.shape[:-1]
        a = self._ntt_axis0(x.reshape(self.n2, self.n1), rev2, tw2)
        a = gt.mul(a, twiddle)
        b = self._ntt_axis0(a.T, rev1, tw1)
        return b.reshape(*lead, 1 << self.log_n)


@functools.lru_cache(maxsize=None)
def get_fourstep_plan(log_n: int) -> FourStepPlan:
    return FourStepPlan(log_n)

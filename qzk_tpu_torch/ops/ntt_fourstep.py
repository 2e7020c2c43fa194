"""Four-step Goldilocks NTT through the kernel K3 (counterpart of the
JAX package's ntt_pallas.FourStepPallasPlan).

A length-n transform of every row of a (..., n) tensor, natural order
at both ends, is two K3 launches (ops/ntt_cuda.py), with n = n1 * n2
and each row viewed as an (n2, n1) matrix:

  1. the length-n2 NTT of every column, times the twiddle block
     T[k2, j1] = w^(j1*k2), in one launch;
  2. the length-n1 NTT of every column of the transpose, read in place,
     in the second; its (n1, n2) output is the natural-order result.

The inverse runs the same two launches with the inverse root and with
n^-1 folded into the twiddle block.  The prover's batched-row iNTT and
coset LDE and the single long vector of the kernels benchmark take this
path; on CPU tensors the two launches are K3's plain torch version.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import goldilocks as gl
from . import goldilocks_cuda as gt
from . import ntt as ntt_mod
from . import ntt_cuda
from .ntt_torch import stage_tw_table


class FourStepCudaPlan:
    """Host tables of the two passes for size 2^log_n, in each
    direction; each device gets its copy at first use."""

    def __init__(self, log_n: int):
        base = ntt_mod.get_fourstep_plan(log_n)
        self.log_n = log_n
        self.log1, self.log2 = base.log1, base.log2
        self.n1, self.n2 = base.n1, base.n2
        self.twiddle = base.twiddle  # (n2, n1)
        self.tw1 = stage_tw_table(self.log1)
        self.tw2 = stage_tw_table(self.log2)
        self._dev: dict = {}

    def _inverse_tables(self):
        """Inverse-root stage tables, and the twiddle block w^-(j1*k2)
        times n^-1."""
        n = 1 << self.log_n
        w_inv = pow(ntt_mod.root_of_unity(self.log_n), gl.P - 2, gl.P)
        exps = (
            np.arange(self.n2, dtype=np.int64)[:, None]
            * np.arange(self.n1, dtype=np.int64)[None, :]
        ) & (n - 1)
        twiddle = gl.mul(ntt_mod.powers_mul_table(w_inv, n)[exps],
                         np.uint64(pow(n, gl.P - 2, gl.P)))
        return (stage_tw_table(self.log2, inverse=True), twiddle,
                stage_tw_table(self.log1, inverse=True))

    def tables(self, device: torch.device, inverse: bool):
        key = (str(device), inverse)
        if key not in self._dev:
            host = self._inverse_tables() if inverse else (self.tw2, self.twiddle, self.tw1)
            self._dev[key] = tuple(gt.from_u64(t, device) for t in host)
        return self._dev[key]

    def _transform(self, x: torch.Tensor, inverse: bool) -> torch.Tensor:
        tw2, twiddle, tw1 = self.tables(x.device, inverse)
        lead = x.shape[:-1]
        a = ntt_cuda.ntt_axis0(x.reshape(-1, self.n2, self.n1).contiguous(), tw2, twiddle)
        b = ntt_cuda.ntt_axis0(a.transpose(1, 2), tw1)
        return b.reshape(*lead, 1 << self.log_n)

    def ntt(self, x: torch.Tensor) -> torch.Tensor:
        """Forward NTT of every row of x (..., n): a (n,) or (1, n)
        vector, or the prover's (B, n) rows."""
        return self._transform(x, inverse=False)

    def intt(self, x: torch.Tensor) -> torch.Tensor:
        """Inverse NTT of every row of x (..., n)."""
        return self._transform(x, inverse=True)


@functools.lru_cache(maxsize=None)
def get_fourstep_cuda_plan(log_n: int) -> FourStepCudaPlan:
    return FourStepCudaPlan(log_n)


def coset_lde(coeffs: torch.Tensor, rate_bits: int, shift_pows: torch.Tensor) -> torch.Tensor:
    """coeffs (..., n) -> evaluations on the shifted coset of size
    n << rate_bits (shift_pows: (n,) powers of the coset shift)."""
    n = coeffs.shape[-1]
    shifted = gt.mul(coeffs, shift_pows)
    padded = torch.nn.functional.pad(shifted, (0, (n << rate_bits) - n))
    return get_fourstep_cuda_plan(n.bit_length() - 1 + rate_bits).ntt(padded)

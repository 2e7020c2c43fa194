"""The transform building blocks of the sharded commit: batched iNTT and
coset LDE over polynomial rows, the prover's dominant transform workload
(SURVEY.md §3.1 step 2), on the four-step NTT through K3
(ops/ntt_fourstep.py; its plain torch version on a CPU tensor).
Counterpart of the JAX package's qzk_tpu/parallel/kernels.py."""

from __future__ import annotations

import torch

from ..ops import goldilocks as gl
from ..ops import goldilocks_cuda as gt
from ..ops import ntt as ntt_mod
from ..ops import ntt_fourstep as nfs
from ..utils.device import device_constant


def coset_lde_rows(coeffs: torch.Tensor, rate_bits: int) -> torch.Tensor:
    """coeffs (S, N) -> evaluations (S, N << rate_bits) on the coset of
    the multiplicative generator."""
    n = coeffs.shape[-1]
    shift = device_constant(("coset_shift_pows", n), coeffs.device,
                            lambda: gt.from_u64(ntt_mod.powers(gl.GENERATOR, n), coeffs.device))
    return nfs.coset_lde(coeffs, rate_bits, shift)


def intt_lde_rows(values: torch.Tensor, rate_bits: int):
    """values (S, N) subgroup evaluations -> (coeffs (S, N), lde
    (S, N << rate_bits))."""
    coeffs = nfs.get_fourstep_cuda_plan(values.shape[-1].bit_length() - 1).intt(values)
    return coeffs, coset_lde_rows(coeffs, rate_bits)

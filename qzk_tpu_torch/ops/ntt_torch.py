"""Plain torch version of the NTT kernel K3 (csrc/ntt.cu).

``ntt_axis0`` computes what the JAX package's Pallas kernel
``_ntt_axis0_kernel`` (qzk_tpu/ops/ntt_pallas.py) computes: all radix-2
DIT stages along the row axis of a (2^log_n, M) block, then optionally
an elementwise product with the four-step twiddle block.  One contract
differs: the rows come in natural order and the function applies the
bit-reversal itself, as K3 does while it loads a tile.

The tests hold it against the Pallas kernel (interpret mode), and the
CUDA wrapper (ntt_cuda.py) runs it for CPU tensors.  Field elements are
int64 bit patterns (goldilocks_torch); ``gt.sub`` takes the place of
the Pallas ``_gsub``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import device_constant
from . import goldilocks as gl
from . import goldilocks_torch as gt
from .ntt import bit_reverse_perm, powers, root_of_unity


def stage_tw_table(log_n: int, inverse: bool = False) -> np.ndarray:
    """(log_n, max(1, n/2)) per-stage twiddles: row s-1 holds the
    stage-s twiddles w_s^j (j < 2^(s-1)) left-aligned, zero-padded.
    `inverse` takes w_s^-1, for a transform with the inverse root."""
    n = 1 << log_n
    out = np.zeros((log_n, max(1, n // 2)), dtype=np.uint64)
    for s in range(1, log_n + 1):
        half = 1 << (s - 1)
        w = root_of_unity(s)
        out[s - 1, :half] = powers(pow(w, gl.P - 2, gl.P) if inverse else w, half)
    return out


def ntt_axis0(
    x: torch.Tensor, stage_tw: torch.Tensor, twiddle: torch.Tensor | None = None
) -> torch.Tensor:
    """x (2^log_n, M) or (B, 2^log_n, M), rows in natural order ->
    the length-2^log_n NTT of every column, natural order, times
    `twiddle` (2^log_n, M) elementwise when it is given.  `stage_tw` is
    stage_tw_table(log_n) as an int64 tensor on x's device."""
    n = x.shape[-2]
    log_n = n.bit_length() - 1
    rev = device_constant(("bit_reverse", log_n), x.device,
                          lambda: torch.as_tensor(bit_reverse_perm(log_n), device=x.device))
    y = x.index_select(-2, rev)
    lead, m = y.shape[:-2], y.shape[-1]
    for s in range(1, log_n + 1):
        half = 1 << (s - 1)
        yr = y.reshape(*lead, n >> s, 2, half, m)
        e = yr[..., 0, :, :]
        o = gt.mul(yr[..., 1, :, :], stage_tw[s - 1, :half, None])
        y = torch.stack([gt.add(e, o), gt.sub(e, o)], dim=-3).reshape(*lead, n, m)
    if twiddle is not None:
        y = gt.mul(y, twiddle)
    return y

"""Batched Poseidon on torch int64 tensors: the plain version of the CUDA
kernels in ``poseidon_cuda.py``.

Width 12, rate 8, 30 rounds (4 full, 22 partial, 4 full), S-box x^7 and
the circulant-plus-diagonal MDS matrix of ``poseidon.py``.  The MDS layer
accumulates each output lane exactly as a (lo, hi) pair of 64-bit words
(entries are at most 49) and reduces once per lane.  Operation for
operation this mirrors the JAX package's ``poseidon_jax``, so it agrees
with it bit for bit on every input, and the CUDA kernels mirror it.
"""

from __future__ import annotations

import torch

from ..utils.device import device_constant
from . import goldilocks_torch as gt
from .poseidon import CAP, HALF_FULL, MDS_MATRIX, N_PARTIAL_ROUNDS, RATE, WIDTH, _RC

_M32 = 0xFFFFFFFF


def _tables(device):
    """The round constants (30, 12) and the MDS matrix on `device`."""
    return (
        device_constant("poseidon_rc", device, lambda: gt.from_u64(_RC, device)),
        device_constant("poseidon_mds", device,
                        lambda: torch.as_tensor(MDS_MATRIX.astype("int64"), device=device)),
    )


def mds_layer(state, mds):
    """(..., 12) -> (..., 12): out[r] = sum_c M[r, c] * state[c]."""
    s = state[..., None, :]
    lo_sum = ((s & _M32) * mds).sum(-1)  # < 2^42
    hi_sum = (gt.shr(s, 32) * mds).sum(-1)
    lo64 = lo_sum + (hi_sum << 32)
    carry = gt.lt(lo64, lo_sum).to(torch.int64)
    hi64 = gt.shr(hi_sum, 32) + carry
    return gt.reduce128(lo64, hi64)


def _mds_rows(st):
    """mds_layer along axis 0 of a (12, m) state."""
    return mds_layer(st.T, _tables(st.device)[1]).T


def mds_full(x):
    """The Poseidon gate's full round, x a (12, m) state: the MDS layer
    along axis 0 of x^7."""
    return _mds_rows(gt.pow7(x))


def mds_partial(x0, x):
    """The Poseidon gate's partial round: the MDS layer along axis 0 of
    the state whose row 0 is x0^7 and rows 1-11 are x's."""
    return _mds_rows(torch.cat([gt.pow7(x0)[None], x[1:]]))


def permute(state: torch.Tensor) -> torch.Tensor:
    """Poseidon permutation on (..., 12) int64 states."""
    rc, mds = _tables(state.device)
    p0, p1 = HALF_FULL, HALF_FULL + N_PARTIAL_ROUNDS
    for r in range(p0):
        state = mds_layer(gt.pow7(gt.add(state, rc[r])), mds)
    for r in range(p0, p1):
        state = gt.add(state, rc[r])
        state = torch.cat([gt.pow7(state[..., :1]), state[..., 1:]], dim=-1)
        state = mds_layer(state, mds)
    for r in range(p1, p1 + HALF_FULL):
        state = mds_layer(gt.pow7(gt.add(state, rc[r])), mds)
    return state


def hash_no_pad_batch(inputs: torch.Tensor) -> torch.Tensor:
    """Overwrite-mode sponge over rows: (B, L) -> (B, 4) digests."""
    B, L = inputs.shape
    state = gt.zeros((B, WIDTH), inputs.device)
    for start in range(0, max(L, 1), RATE):
        chunk = inputs[:, start : min(start + RATE, L)]
        state = torch.cat([chunk, state[:, chunk.shape[1] :]], dim=1)
        state = permute(state)
    return state[:, :CAP].contiguous()


def two_to_one_batch(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Merkle compression: (B, 4) x (B, 4) -> (B, 4)."""
    return hash_no_pad_batch(torch.cat([left, right], dim=1))

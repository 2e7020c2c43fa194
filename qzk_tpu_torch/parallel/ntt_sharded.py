"""Distributed NTT/iNTT over a device mesh: the four-step decomposition
with all_to_all stage exchanges (counterpart of the JAX package's
qzk_tpu/parallel/ntt_sharded.py, step for step).

A length-N transform whose data is block-sharded over d shards runs as

    N = A * C  (A = d shards, C = N/d local columns)
    step 1: all_to_all  - row-sharded (a) -> column-chunk-sharded (c)
    step 2: length-A DFT across the a digit (local, A^2 vector ops)
    step 3: twiddle by w^(c*k1) (local; each shard its twiddle block)
    step 4: all_to_all  - k1 planes to their owner shard
    step 5: length-C NTT along c (local: the four-step NTT through K3,
            ops/ntt_fourstep.py)
    step 6: all_to_all  - digit-reversed output back to block order

Steps 2 and 3 are elementwise torch; the collectives are the copies of
sharded.py.  `four_step_block` takes and returns the list of per-shard
blocks; `ntt_sharded` / `intt_sharded` shard an array first.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import goldilocks as gl
from ..ops import goldilocks_cuda as gt
from ..ops import ntt as ntt_mod
from ..ops import ntt_fourstep as nfs
from ..utils.device import device_constant
from .sharded import Mesh, all_to_all, shard


@functools.lru_cache(maxsize=None)
def _dft_matrix(log_a: int, inverse: bool, log_scale: int) -> np.ndarray:
    """(A, A) DFT matrix W[k, a] = w_A^(+-a k) / 2^log_scale."""
    A = 1 << log_a
    w = ntt_mod.root_of_unity(log_a)
    if inverse:
        w = pow(w, gl.P - 2, gl.P)
    scale_inv = pow(pow(2, log_scale, gl.P), gl.P - 2, gl.P)
    W = np.empty((A, A), dtype=np.uint64)
    for k in range(A):
        for a in range(A):
            W[k, a] = pow(w, a * k, gl.P) * scale_inv % gl.P
    return W


@functools.lru_cache(maxsize=None)
def _twiddle_table(log_n: int, n_dev: int, inverse: bool) -> np.ndarray:
    """(C,) = w^(+-c) for c in [0, C), C = N/d; sharded over the mesh it
    hands each shard its step-3 chunk [p*C/A, (p+1)*C/A)."""
    w = ntt_mod.root_of_unity(log_n)
    if inverse:
        w = pow(w, gl.P - 2, gl.P)
    return ntt_mod.powers(w, (1 << log_n) // n_dev)


def four_step_block(x_blocks, tw_blocks, log_n: int, mesh: Mesh, inverse: bool) -> list:
    """The distributed transform along the last axis.

    x_blocks[a]: (..., C), shard a's block of a global (..., N) array,
    N = d * C.  tw_blocks[p]: (C/A,), shard p's block of the step-3
    twiddle table w^(+-c).  Returns the blocks of the transformed array,
    natural order, block sharding."""
    A = mesh.size
    log_a = A.bit_length() - 1
    C = x_blocks[0].shape[-1]
    if 1 << log_a != A or A * C != 1 << log_n or C % A:
        raise ValueError(f"need N = d*C with d a power of two dividing C: "
                         f"N=2^{log_n}, d={A}, C={C}")
    batch = x_blocks[0].shape[:-1]
    nb = len(batch)

    # step 1: a2a - each shard ends with all `a` rows of its c-chunk
    y = all_to_all([x.reshape(*batch, A, C // A) for x in x_blocks], mesh,
                   split_axis=nb, concat_axis=nb)  # (..., A, C/A): axis -2 = source row a

    W_host = _dft_matrix(log_a, inverse, log_n if inverse else 0)
    plan = nfs.get_fourstep_cuda_plan(C.bit_length() - 1)
    z_blocks = []
    for y_l, tw_l in zip(y, tw_blocks):
        dev = y_l.device
        W = device_constant(("dft_matrix", log_a, inverse, log_n), dev,
                            lambda: gt.from_u64(W_host, dev))
        # step 2: length-A DFT across the a digit (the 1/N scale of the
        # inverse folds in here)
        rows = []
        for k1 in range(A):
            acc = gt.mul(W[k1, 0].expand(y_l.shape[:-2] + y_l.shape[-1:]), y_l[..., 0, :])
            for a in range(1, A):
                acc = gt.add(acc, gt.mul(W[k1, a], y_l[..., a, :]))
            rows.append(acc)
        z = torch.stack(rows, dim=-2)  # (..., A=k1, C/A)
        # step 3: twiddle z[k1, c'] *= w^(+-c*k1), c local to this shard
        cur = torch.ones_like(tw_l)
        planes = []
        for k1 in range(A):
            planes.append(gt.mul(z[..., k1, :], cur))
            cur = gt.mul(cur, tw_l)
        z_blocks.append(torch.stack(planes, dim=-2))

    # step 4: a2a - k1 plane q to shard q, c segments concatenated in order
    z_blocks = all_to_all(z_blocks, mesh, split_axis=nb, concat_axis=nb + 1)  # (..., 1, C)

    v_blocks = []
    for z in z_blocks:
        # step 5: the local length-C transform along c (the inverse-root
        # variant is the forward transform index-reversed)
        v = plan.ntt(z.reshape(*batch, C))
        if inverse:
            rev = device_constant(("reverse_index", C), v.device, lambda: torch.as_tensor(
                np.concatenate([[0], np.arange(C - 1, 0, -1)]), device=v.device))
            v = v.index_select(-1, rev)
        v_blocks.append(v.reshape(*batch, A, C // A))

    # step 6: a2a - shard q holds X[q + A*k2]; send k2-chunks to their
    # block owner, then interleave locally (x = A*k2' + q)
    v_blocks = all_to_all(v_blocks, mesh, split_axis=nb, concat_axis=nb)  # (..., A=q, C/A=k2')
    return [v.transpose(-1, -2).reshape(*batch, C) for v in v_blocks]


def _transform(x, mesh: Mesh, inverse: bool) -> list:
    blocks = x if isinstance(x, (list, tuple)) else shard(x, mesh, axis=-1)
    log_n = (blocks[0].shape[-1] * mesh.size).bit_length() - 1
    tw = shard(_twiddle_table(log_n, mesh.size, inverse), mesh)
    return four_step_block(blocks, tw, log_n, mesh, inverse)


def ntt_sharded(x, mesh: Mesh) -> list:
    """Forward NTT along the last axis, natural order.  x: a (..., N)
    array (numpy uint64 or an int64 tensor), sharded here along its last
    axis, or the list of its per-shard blocks.  Returns the result's
    blocks (sharded.gather assembles them)."""
    return _transform(x, mesh, False)


def intt_sharded(x, mesh: Mesh) -> list:
    """Inverse NTT along the last axis; as ntt_sharded."""
    return _transform(x, mesh, True)

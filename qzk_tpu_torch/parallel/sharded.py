"""The device mesh, its collectives, and the sharded commit step.

Counterpart of the JAX package's qzk_tpu/parallel/sharded.py.  There
the mesh is a jax Mesh and every stage one shard_map; here one process
drives every shard in turn.  A mesh is a tuple of torch devices, one a
shard, in which a device may repeat (four shards on one card, the
counterpart of XLA's virtual host devices); a sharded array is the list
of its per-shard blocks, block i on mesh.devices[i].  The collectives
are plain functions over such lists, with the semantics of their
jax.lax namesakes:

  all_to_all(blocks, split_axis, concat_axis)   (tiled=True)
      each shard splits its block along split_axis into d chunks; chunk
      j goes to shard j, which concatenates what it receives along
      concat_axis in source-shard order;
  all_gather(blocks)                            (tiled=True)
      every shard gets the blocks concatenated along axis 0;
  ppermute(blocks, perm)
      perm lists (source, destination) pairs; a shard that receives
      nothing gets zeros;
  psum(blocks)
      every shard gets the sum of the blocks;

and axis_index is the shard's position in the list.  Every collective
returns fresh tensors: on a repeated device Tensor.to(device) is the
same storage, and an in-place write after a "transfer" would reach
another shard.  Across cards each transfer is a peer copy on the
current streams of both cards, which PyTorch orders.

The sharded commit step (commit_sharded, train_step_sharded): polynomial
rows are data-parallel for the iNTT and coset LDE (parallel/kernels.py,
K3); one all_to_all re-shards rows to LDE points, after which each shard
hashes its contiguous leaf chunk (K1) and reduces it to its slice of the
Merkle cap; one all_gather assembles the cap.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import goldilocks_cuda as gt
from ..ops import poseidon_cuda as pc
from ..plonk.device_prover import context_device
from . import kernels


class Mesh:
    """A 1-D mesh: one torch device a shard, repeats allowed."""

    def __init__(self, devices):
        # a bare "cuda" is the current card, so that "cuda" and "cuda:0"
        # name one device
        self.devices = tuple(context_device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one shard")

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A mesh of n_devices shards, round-robin over `devices` (default:
    the visible cards); n_devices defaults to len(devices).  On one card
    make_mesh(4) is four shards on cuda:0."""
    if devices is None:
        from ..utils.device import resolve_device

        resolve_device("cuda")  # raises without a card
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n = len(devices) if n_devices is None else n_devices
    return Mesh([devices[i % len(devices)] for i in range(n)])


# -- moving blocks ------------------------------------------------------------


def _send(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """t on `dev`, a fresh tensor even when t is already there."""
    if t.device == dev:
        return t.clone()
    return t.to(dev, non_blocking=True)


def concat_on(parts, dev: torch.device, axis: int = 0) -> torch.Tensor:
    """The parts concatenated along `axis` on `dev`, each copied there
    first if it lies elsewhere: torch.cat always allocates, so the
    result aliases none of them."""
    return torch.cat([p if p.device == dev else p.to(dev, non_blocking=True) for p in parts],
                     dim=axis)


def shard(x, mesh: Mesh, axis: int = 0) -> list:
    """Split an array (numpy uint64, or an int64 tensor) into mesh.size
    equal blocks along `axis`, block i uploaded or copied to shard i."""
    d = mesh.size
    if not isinstance(x, torch.Tensor):
        x = gt.from_u64(x)
    if x.shape[axis] % d:
        raise ValueError(f"axis {axis} of length {x.shape[axis]} does not split into {d} blocks")
    parts = x.chunk(d, dim=axis)
    return [_send(p, dev).contiguous() for p, dev in zip(parts, mesh.devices)]


def replicate(x, mesh: Mesh) -> list:
    """x (numpy uint64 or an int64 tensor) on every shard."""
    if not isinstance(x, torch.Tensor):
        x = gt.from_u64(x)
    return [_send(x, dev) for dev in mesh.devices]


def gather(blocks, axis: int = 0) -> torch.Tensor:
    """The global array of a sharded one, on shard 0's device."""
    return concat_on(blocks, blocks[0].device, axis)


# -- collectives --------------------------------------------------------------


def all_to_all(blocks, mesh: Mesh, split_axis: int, concat_axis: int) -> list:
    """jax.lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)."""
    d = mesh.size
    chunks = []
    for b in blocks:
        if b.shape[split_axis] % d:
            raise ValueError(f"axis {split_axis} of {tuple(b.shape)} does not split {d} ways")
        chunks.append(b.chunk(d, dim=split_axis))
    return [concat_on([chunks[i][j] for i in range(d)], dev, concat_axis)
            for j, dev in enumerate(mesh.devices)]


def all_gather(blocks, mesh: Mesh) -> list:
    """jax.lax.all_gather(x, axis, tiled=True): axis 0 concatenated."""
    return [concat_on(blocks, dev, 0) for dev in mesh.devices]


def ppermute(blocks, mesh: Mesh, perm) -> list:
    """jax.lax.ppermute(x, axis, perm): perm holds (source, destination)
    pairs; shards that receive nothing get zeros."""
    out = [torch.zeros_like(b) for b in blocks]
    for src, dst in perm:
        out[dst] = _send(blocks[src], mesh.devices[dst])
    return out


def psum(blocks, mesh: Mesh) -> list:
    """jax.lax.psum(x, axis): the sum of the blocks on every shard."""
    return [functools.reduce(torch.add, [_send(b, dev) for b in blocks]) for dev in mesh.devices]


# -- the sharded commit step --------------------------------------------------


def _local_cap_reduce(digests: torch.Tensor, local_cap: int) -> torch.Tensor:
    """Reduce (m, 4) leaf digests to (local_cap, 4) by repeated 2-to-1
    compression (K1; m and local_cap powers of two)."""
    level = digests
    while level.shape[0] > local_cap:
        pairs = level.reshape(-1, 2, 4)
        level = pc.two_to_one(pairs[:, 0, :], pairs[:, 1, :])
    return level


def _commit_block(value_blocks, rate_bits: int, cap_height: int, mesh: Mesh):
    """Row-sharded (S/d, N) blocks -> (coeffs, lde, cap): a local
    iNTT + LDE on every shard, one all_to_all from row to point
    sharding, local leaf hashing and cap reduction, an all_gather of
    the cap (replicated: each shard's copy)."""
    d = mesh.size
    coeffs, lde = zip(*(kernels.intt_lde_rows(v, rate_bits) for v in value_blocks))
    # rows -> points: (S/d, M) => (S, M/d) on each shard
    leaves_t = all_to_all(lde, mesh, split_axis=1, concat_axis=0)
    cap_size = 1 << cap_height
    local_cap = max(1, cap_size // d)
    cap_slices = [_local_cap_reduce(pc.hash_no_pad_rows(lt.T.contiguous()), local_cap)
                  for lt in leaves_t]
    if d > cap_size:
        # more shards than cap entries: finish the reduction across
        # shards (gather the single digests, reduce on every shard)
        cap = [_local_cap_reduce(g, cap_size) for g in all_gather(cap_slices, mesh)]
    else:
        cap = all_gather(cap_slices, mesh)
    return list(coeffs), list(lde), cap


def commit_sharded(values, rate_bits: int, cap_height: int, mesh: Mesh):
    """(S, N) subgroup evaluations (numpy uint64 or an int64 tensor) ->
    (coeffs blocks (S/d, N), lde blocks (S/d, N << rate_bits), the cap
    (2^cap_height, 4) on shard 0), computed across the mesh.

    S must be divisible by the mesh size; N << rate_bits must give each
    shard at least max(1, 2^cap_height / d) leaves."""
    if not isinstance(values, torch.Tensor):
        values = gt.from_u64(np.asarray(values, dtype=np.uint64))
    s, n = values.shape
    d = mesh.size
    m = n << rate_bits
    if s % d or m % d or m // d < max(1, (1 << cap_height) // d):
        raise ValueError(f"({s}, {n}) rows at rate 2^{rate_bits} do not split over {d} shards "
                         f"with a cap of 2^{cap_height}")
    coeffs, lde, cap = _commit_block(shard(values, mesh, 0), rate_bits, cap_height, mesh)
    return coeffs, lde, cap[0]


def train_step_sharded(values, rate_bits: int, cap_height: int, mesh: Mesh):
    """One full sharded pipeline step: iNTT -> coset LDE -> all_to_all
    transpose -> Poseidon leaf hash -> Merkle cap, over the mesh.
    Returns the cap."""
    _, _, cap = commit_sharded(values, rate_bits, cap_height, mesh)
    return cap

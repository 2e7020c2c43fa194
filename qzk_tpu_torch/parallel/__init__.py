"""Multi-device parallelism: one process drives every shard of a mesh.

`set_mesh(mesh)` routes every subsequent prove through the sharded
pipeline (prover_sharded.py); `set_mesh(None)` restores the
single-device paths.  The QZK_SHARD=N environment variable does the
same at first use (N shards round-robin over the visible cards, as
sharded.make_mesh(N) lays them out).  Counterpart of the JAX package's
qzk_tpu/parallel, whose mesh is one shard_map over a jax Mesh."""

from __future__ import annotations

import os

_active_mesh = None
_explicit_off = False  # set_mesh(None) called: suppress the QZK_SHARD default


def set_mesh(mesh) -> None:
    """Route proves through the sharded pipeline on `mesh` (None: off).

    Passing None disables sharding even when QZK_SHARD is set in the
    environment; a later set_mesh(mesh) re-enables it."""
    global _active_mesh, _explicit_off
    _active_mesh = mesh
    _explicit_off = mesh is None


def active_mesh():
    global _active_mesh
    if _active_mesh is None and not _explicit_off:
        n = os.environ.get("QZK_SHARD")
        if n:
            from .sharded import make_mesh

            _active_mesh = make_mesh(int(n))
    return _active_mesh

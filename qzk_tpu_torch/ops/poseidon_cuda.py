"""Wrappers of the hand-written Poseidon CUDA kernels (csrc/poseidon.cu).

K1 ``hash_no_pad_rows`` / ``two_to_one``: the row sponge, replacing the
JAX package's Pallas ``_hash_rows_pallas``.  K2 ``permute``: the batched
permutation, replacing ``_permute_pallas``.

On a CUDA tensor a wrapper launches its kernel on PyTorch's current
stream, or raises; on a CPU tensor it runs the plain torch version in
``poseidon_torch.py``.  Inputs are (rows, width) row-major int64 tensors
holding uint64 bit patterns, as everywhere in the port: the kernels
stage their reads through shared memory, so no transposed copy is made.
``LAUNCHES`` counts kernel launches, and nothing else; ``K1_SHAPES``
counts K1's launches by (n, w), so that a run can time K1 at every
shape a prove gave it.  A call under CUDA graph capture launches
nothing: inside ``recording()`` it is recorded, and ``count_replay``
counts the recorded launches at each replay of the graph.  The library
loads, and the counts move, under a lock: the aggregator proves chunks
from several threads.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import os
import threading

import numpy as np
import torch

from . import poseidon_torch as pt
from .poseidon import _RC

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")

LAUNCHES = {"hash_rows": 0, "permute": 0}
K1_SHAPES: collections.Counter = collections.Counter()
_LOCK = threading.Lock()
# thread id -> the Counter of an active recording()
_RECORDING: dict = {}


def reset_launches() -> None:
    with _LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        K1_SHAPES.clear()


def _count(key: str, k1_shape=None) -> None:
    with _LOCK:
        rec = _RECORDING.get(threading.get_ident())
        if rec is not None:  # captured into a CUDA graph: no launch yet
            rec[(key, k1_shape)] += 1
            return
        LAUNCHES[key] += 1
        if k1_shape is not None:
            K1_SHAPES[k1_shape] += 1


@contextlib.contextmanager
def recording():
    """Records, and does not count, the launches this thread makes in
    the block: under CUDA graph capture a wrapper's call launches
    nothing.  Yields a Counter of (key, shape) for count_replay."""
    rec: collections.Counter = collections.Counter()
    tid = threading.get_ident()
    with _LOCK:
        _RECORDING[tid] = rec
    try:
        yield rec
    finally:
        with _LOCK:
            del _RECORDING[tid]


def count_replay(rec: collections.Counter) -> None:
    """Counts the launches of one replay of a graph whose capture
    recorded `rec`."""
    with _LOCK:
        for (key, shape), n in rec.items():
            LAUNCHES[key] += n
            if shape is not None:
                K1_SHAPES[shape] += n


class _Kernels:
    """The loaded library, and the devices whose constants are set."""

    lib = None
    ready: set = set()


def library_path() -> str:
    """Builds (at first use) and returns the kernels' shared library."""
    from ..utils import build

    return build.cuda_library(
        "qzk_poseidon",
        os.path.join(CSRC, "poseidon.cu"),
        [os.path.join(CSRC, "goldilocks.cuh")],
    )


def _lib(device: torch.device):
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx in _Kernels.ready:
        return _Kernels.lib
    with _LOCK:
        if _Kernels.lib is None:
            lib = ctypes.CDLL(library_path())
            vp, ll = ctypes.c_void_p, ctypes.c_longlong
            lib.qzk_poseidon_init.argtypes = [vp]
            lib.qzk_hash_rows.argtypes = [vp, vp, ll, ctypes.c_int, vp]
            lib.qzk_permute.argtypes = [vp, vp, ll, vp]
            for f in (lib.qzk_poseidon_init, lib.qzk_hash_rows, lib.qzk_permute):
                f.restype = ctypes.c_int
            _Kernels.lib = lib
        if idx not in _Kernels.ready:
            rc = np.ascontiguousarray(_RC, dtype=np.uint64)
            with torch.cuda.device(idx):
                _check(_Kernels.lib.qzk_poseidon_init(rc.ctypes.data), "qzk_poseidon_init")
            _Kernels.ready.add(idx)
    return _Kernels.lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def _validate(x: torch.Tensor, width: int | None = None) -> None:
    if not isinstance(x, torch.Tensor) or x.dtype != torch.int64:
        raise TypeError("expected an int64 tensor of uint64 bit patterns")
    if x.dim() != 2 or (width is not None and x.shape[1] != width):
        raise ValueError(f"expected shape (n, {width or 'w'}), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("expected a contiguous (row-major) tensor")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def hash_no_pad_rows(rows: torch.Tensor) -> torch.Tensor:
    """Batched hash_no_pad: (n, w) -> (n, 4) digests (K1)."""
    _validate(rows)
    if rows.device.type == "cpu":
        return pt.hash_no_pad_batch(rows)
    n, w = rows.shape
    out = torch.empty((n, 4), dtype=torch.int64, device=rows.device)
    if n == 0:
        return out
    lib = _lib(rows.device)
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    with torch.cuda.device(rows.device):
        _check(lib.qzk_hash_rows(rows.data_ptr(), out.data_ptr(), n, w, stream),
               "qzk_hash_rows")
    _count("hash_rows", (n, w))
    return out


def two_to_one(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Merkle compression: (n, 4) x (n, 4) -> (n, 4), K1 at w = 8."""
    return hash_no_pad_rows(torch.cat([left, right], dim=1))


def permute(states: torch.Tensor) -> torch.Tensor:
    """Batched Poseidon permutation: (b, 12) -> (b, 12) (K2)."""
    _validate(states, 12)
    if states.device.type == "cpu":
        return pt.permute(states)
    b = states.shape[0]
    out = torch.empty_like(states)
    if b == 0:
        return out
    lib = _lib(states.device)
    stream = torch.cuda.current_stream(states.device).cuda_stream
    with torch.cuda.device(states.device):
        _check(lib.qzk_permute(states.data_ptr(), out.data_ptr(), b, stream),
               "qzk_permute")
    _count("permute")
    return out

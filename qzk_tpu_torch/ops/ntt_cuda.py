"""Wrapper of the hand-written NTT kernel K3 (csrc/ntt.cu).

``ntt_axis0`` replaces the JAX package's Pallas ``_ntt_axis0_pallas``:
every radix-2 stage of a transform along the row axis of a
(2^log_n, M) or (B, 2^log_n, M) block, rows in natural order, times an
optional twiddle block.  On a CUDA tensor it launches K3 on PyTorch's
current stream, or raises; on a CPU tensor it runs the plain torch
version in ``ntt_torch.py``.  The input may be row-major or the
transpose of a row-major tensor (the second four-step pass reads one in
place).  ``LAUNCHES`` counts kernel launches, and nothing else;
``K3_SHAPES`` counts them by (b, log_n, m, strided, twiddle), so that a
run can time K3 at every shape a prove gave it; under CUDA graph
capture, ``recording()`` and ``count_replay`` as in poseidon_cuda.py.
The library loads, and the counts move, under a lock: the aggregator
proves chunks from several threads.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import os
import threading
from typing import NamedTuple

import torch

from . import ntt_torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")

LAUNCHES = {"ntt_axis0": 0}
K3_SHAPES: collections.Counter = collections.Counter()
_LOCK = threading.Lock()
# thread id -> the Counter of an active recording()
_RECORDING: dict = {}

# The block size a tile grows to.
TARGET_THREADS = 128


def reset_launches() -> None:
    with _LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        K3_SHAPES.clear()


def _count(key: str, k3_shape) -> None:
    with _LOCK:
        rec = _RECORDING.get(threading.get_ident())
        if rec is not None:  # captured into a CUDA graph: no launch yet
            rec[(key, k3_shape)] += 1
            return
        LAUNCHES[key] += 1
        K3_SHAPES[k3_shape] += 1


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
                K3_SHAPES[shape] += n


class _Kernel:
    """The loaded library, and each initialised device's opt-in
    shared-memory limit in bytes and SM count."""

    lib = None
    devices: dict = {}


def library_path() -> str:
    """Builds (at first use) and returns the kernel's shared library."""
    from ..utils import build

    return build.cuda_library(
        "qzk_ntt",
        os.path.join(CSRC, "ntt.cu"),
        [os.path.join(CSRC, "goldilocks.cuh")],
    )


def bind(lib):
    """Declares the C interface of ntt.cu on a loaded library."""
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    pi, pll = ctypes.POINTER(i), ctypes.POINTER(ll)
    lib.qzk_ntt_init.argtypes = [pi, pi]
    lib.qzk_ntt_init.restype = i
    lib.qzk_ntt_block.argtypes = [i, i, i, pi, pi, pll, pll]
    lib.qzk_ntt_block.restype = i
    lib.qzk_ntt_blocks_per_sm.argtypes = [i, i, ll, pi]
    lib.qzk_ntt_blocks_per_sm.restype = i
    lib.qzk_ntt_axis0.argtypes = [vp, ll, ll, ll, vp, vp, vp, i, ll, ll, i, i, i, i, vp]
    lib.qzk_ntt_axis0.restype = i
    return lib


class Block(NamedTuple):
    """A launch plan's block: its threads, the most its instantiation
    takes, its shared bytes and its columns a tile."""

    threads: int
    max_threads: int
    smem: int
    cols: int


def block(lib, log_n: int, log_r: int, log_cp: int) -> Block:
    """The block of the plan (log_n, log_r, log_cp), as ntt.cu sizes it."""
    t, mt = ctypes.c_int(0), ctypes.c_int(0)
    smem, cols = ctypes.c_longlong(0), ctypes.c_longlong(0)
    _check(lib.qzk_ntt_block(log_n, log_r, log_cp, ctypes.byref(t), ctypes.byref(mt),
                             ctypes.byref(smem), ctypes.byref(cols)), "qzk_ntt_block")
    return Block(t.value, mt.value, smem.value, cols.value)


def _lib(device: torch.device):
    """The library, and (max shared bytes, SM count) of the device."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    found = _Kernel.devices.get(idx)
    if found is not None:
        return _Kernel.lib, found
    with _LOCK:
        if _Kernel.lib is None:
            _Kernel.lib = bind(ctypes.CDLL(library_path()))
        if idx not in _Kernel.devices:
            limit, sms = ctypes.c_int(0), ctypes.c_int(0)
            with torch.cuda.device(idx):
                _check(_Kernel.lib.qzk_ntt_init(ctypes.byref(limit), ctypes.byref(sms)),
                       "qzk_ntt_init")
            _Kernel.devices[idx] = (limit.value, sms.value)
    return _Kernel.lib, _Kernel.devices[idx]


def _blocks_per_sm(lib, log_r: int, threads: int, smem: int) -> int:
    blocks = ctypes.c_int(0)
    _check(lib.qzk_ntt_blocks_per_sm(log_r, threads, smem, ctypes.byref(blocks)),
           "qzk_ntt_blocks_per_sm")
    return blocks.value


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def _validate(x, stage_tw, twiddle) -> None:
    for name, t in (("x", x), ("stage_tw", stage_tw), ("twiddle", twiddle)):
        if t is None:
            continue
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int64:
            raise TypeError(f"{name}: expected an int64 tensor of uint64 bit patterns")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if x.dim() not in (2, 3):
        raise ValueError(f"expected shape (n, M) or (B, n, M), got {tuple(x.shape)}")
    n, m = x.shape[-2:]
    log_n = n.bit_length() - 1
    if n != 1 << log_n:
        raise ValueError(f"the row count {n} is not a power of two")
    if x.stride(-1) != 1 and x.stride(-2) != 1:
        raise ValueError("expected row-major x or the transpose of a row-major tensor")
    if tuple(stage_tw.shape) != (log_n, max(1, n // 2)) or not stage_tw.is_contiguous():
        raise ValueError(f"stage_tw: expected a contiguous ({log_n}, {max(1, n // 2)}) table")
    if twiddle is not None and (tuple(twiddle.shape) != (n, m) or not twiddle.is_contiguous()):
        raise ValueError(f"twiddle: expected a contiguous ({n}, {m}) block")


def log_rows(log_n: int) -> int:
    """K for 2^log_n rows: four rows of two columns a thread (64
    registers) while a column fits 256 threads, eight (80 registers) at
    2^11 rows, and 32 rows of one column from 2^12 to 2^14 (512 threads
    at most)."""
    return min(2, log_n) if log_n <= 10 else 3 if log_n == 11 else 5


def launch_plan(b: int, log_n: int, m: int, sms: int, max_smem: int,
                block_of, blocks_per_sm) -> tuple[int, int, int]:
    """(log_r, log_cp, grid) of a K3 launch on (b, 2^log_n, m), at
    log_r = log_rows(log_n).

    block_of(log_n, log_r, log_cp) is the kernel's Block of a plan, and
    blocks_per_sm(log_r, threads, smem) its occupancy.  The tile starts
    at one thread across and doubles while the block stays within
    TARGET_THREADS and the columns need it.  One tile a block, except
    between one and two waves of tiles: then one wave of blocks walks
    them, in place of a ragged second wave."""
    log_r = log_rows(log_n)
    log_cp = 0
    while (block_of(log_n, log_r, log_cp + 1).threads <= TARGET_THREADS
           and block_of(log_n, log_r, log_cp).cols < m):
        log_cp += 1
    blk = block_of(log_n, log_r, log_cp)
    if blk.threads > blk.max_threads or blk.smem > max_smem:
        raise ValueError(f"2^{log_n} rows do not fit one block of K3 (2^14 at most)")
    units = b * -(-m // blk.cols)
    resident = max(1, blocks_per_sm(log_r, blk.threads, blk.smem)) * sms
    return log_r, log_cp, resident if resident < units < 2 * resident else units


def ntt_axis0(
    x: torch.Tensor, stage_tw: torch.Tensor, twiddle: torch.Tensor | None = None
) -> torch.Tensor:
    """x (2^log_n, M) or (B, 2^log_n, M) -> the NTT of every column,
    natural order at both ends, times `twiddle` when given (K3).
    `stage_tw` is ntt_torch.stage_tw_table(log_n) on x's device."""
    _validate(x, stage_tw, twiddle)
    if x.device.type == "cpu":
        return ntt_torch.ntt_axis0(x, stage_tw, twiddle)
    x3 = x if x.dim() == 3 else x.unsqueeze(0)
    b, n, m = x3.shape
    out = torch.empty((b, n, m), dtype=torch.int64, device=x.device)
    if b == 0 or m == 0:
        return out.reshape(x.shape)
    log_n = n.bit_length() - 1
    lib, _ = _lib(x.device)
    log_r, log_cp, grid = device_plan(x.device, b, log_n, m)
    sb, sr, sc = x3.stride()
    # 16-byte accesses where the layout and alignment allow them
    flags = 0
    if m % 2 == 0:
        if sc == 1 and sr % 2 == 0 and sb % 2 == 0 and x3.data_ptr() % 16 == 0:
            flags |= 1
        if out.data_ptr() % 16 == 0 and (twiddle is None or twiddle.data_ptr() % 16 == 0):
            flags |= 2
    stream = torch.cuda.current_stream(x.device).cuda_stream
    tw_ptr = twiddle.data_ptr() if twiddle is not None else None
    with torch.cuda.device(x.device):
        _check(
            lib.qzk_ntt_axis0(x3.data_ptr(), sb, sr, sc, out.data_ptr(), stage_tw.data_ptr(),
                              tw_ptr, log_n, m, b, log_r, log_cp, grid, flags, stream),
            "qzk_ntt_axis0",
        )
    _count("ntt_axis0", (b, log_n, m, sc != 1, twiddle is not None))
    return out.reshape(x.shape)


def device_plan(device: torch.device, b: int, log_n: int, m: int) -> tuple[int, int, int]:
    """launch_plan on `device`, computed once per shape."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    return _device_plan(idx, b, log_n, m)


@functools.lru_cache(maxsize=None)
def _device_plan(idx: int, b: int, log_n: int, m: int) -> tuple[int, int, int]:
    lib, (max_smem, sms) = _lib(torch.device("cuda", idx))
    return launch_plan(b, log_n, m, sms, max_smem, functools.partial(block, lib),
                       functools.partial(_blocks_per_sm, lib))

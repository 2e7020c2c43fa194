"""Wrapper of the hand-written NTT kernel K3 (csrc/ntt.cu).

``ntt_axis0`` replaces the JAX package's Pallas ``_ntt_axis0_pallas``:
every radix-2 stage of a transform along the row axis of a
(2^log_n, M) or (B, 2^log_n, M) block, rows in natural order, times an
optional twiddle block.  On a CUDA tensor it launches K3 on PyTorch's
current stream, or raises; on a CPU tensor it runs the plain torch
version in ``ntt_torch.py``.  The input may be row-major or the
transpose of a row-major tensor (the second four-step pass reads one in
place).  ``LAUNCHES`` counts kernel launches, and nothing else.
"""

from __future__ import annotations

import ctypes
import os

import torch

from . import ntt_torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")

LAUNCHES = {"ntt_axis0": 0}

# Shared memory a tile aims at: three blocks of 256 threads an SM.
TILE_BYTES = 64 * 1024


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class _Kernel:
    """The loaded library, and each initialised device's opt-in
    shared-memory limit in bytes."""

    lib = None
    max_smem: dict = {}


def library_path() -> str:
    """Builds (at first use) and returns the kernel's shared library."""
    from ..utils import build

    return build.cuda_library(
        "qzk_ntt",
        os.path.join(CSRC, "ntt.cu"),
        [os.path.join(CSRC, "goldilocks.cuh")],
    )


def _lib(device: torch.device):
    if _Kernel.lib is None:
        lib = ctypes.CDLL(library_path())
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.qzk_ntt_init.argtypes = [ctypes.POINTER(i)]
        lib.qzk_ntt_init.restype = i
        lib.qzk_ntt_tile_bytes.argtypes = [i, i]
        lib.qzk_ntt_tile_bytes.restype = ll
        lib.qzk_ntt_axis0.argtypes = [vp, ll, ll, ll, vp, vp, vp, i, ll, ll, i, vp]
        lib.qzk_ntt_axis0.restype = i
        _Kernel.lib = lib
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _Kernel.max_smem:
        limit = ctypes.c_int(0)
        with torch.cuda.device(idx):
            _check(_Kernel.lib.qzk_ntt_init(ctypes.byref(limit)), "qzk_ntt_init")
        _Kernel.max_smem[idx] = limit.value
    return _Kernel.lib, _Kernel.max_smem[idx]


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


def tile_log_cols(log_n: int, m: int) -> int:
    """log2 of K3's tile width C: the widest power of two whose tile
    fits TILE_BYTES (at least one column), and no wider than M needs."""
    log_c = 0
    while (8 << (log_n + log_c + 1)) <= TILE_BYTES and (1 << log_c) < m:
        log_c += 1
    return log_c


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
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the kernel's grid limit of 65535")
    out = torch.empty((b, n, m), dtype=torch.int64, device=x.device)
    if b == 0 or m == 0:
        return out.reshape(x.shape)
    log_n = n.bit_length() - 1
    log_c = tile_log_cols(log_n, m)
    lib, max_smem = _lib(x.device)
    if lib.qzk_ntt_tile_bytes(log_n, log_c) > max_smem:
        raise ValueError(f"2^{log_n} rows do not fit the device's {max_smem} B of shared memory")
    sb, sr, sc = x3.stride()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    tw_ptr = twiddle.data_ptr() if twiddle is not None else None
    with torch.cuda.device(x.device):
        _check(
            lib.qzk_ntt_axis0(x3.data_ptr(), sb, sr, sc, out.data_ptr(), stage_tw.data_ptr(),
                              tw_ptr, log_n, m, b, log_c, stream),
            "qzk_ntt_axis0",
        )
    LAUNCHES["ntt_axis0"] += 1
    return out.reshape(x.shape)

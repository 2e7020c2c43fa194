"""Wrapper of the hand-written threefry kernel (csrc/threefry.cu).

K8 ``threefry_draw``: one zk blinding draw,
``jax.random.bits(key, shape, "uint64") >> 1`` as int64, in one launch
on PyTorch's current stream.  It replaces no TPU kernel: the JAX package
draws with ``jax.random``.  ``threefry.random_bits_u64_shr1`` calls
``draw`` on a CUDA device and runs the plain version,
``threefry.plain_bits_u64_shr1``, on any other; the plain version is the
kernel's oracle.  The key's two 32-bit words are kernel arguments, so a
draw uploads nothing and reads nothing back.

A draw is never captured into a CUDA graph: its key changes with every
prove, and a capture would freeze it, so ``draw`` raises under capture.
``LAUNCHES`` counts launches, and nothing else.  The library loads, and
the count moves, under a lock: callers draw from threads of their own.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")

LAUNCHES = {"threefry_draw": 0}
_LOCK = threading.Lock()


def reset_launches() -> None:
    with _LOCK:
        LAUNCHES["threefry_draw"] = 0


class _Kernels:
    lib = None


def library_path() -> str:
    """Builds (at first use) and returns the kernel's shared library."""
    from ..utils import build

    return build.cuda_library("qzk_threefry", os.path.join(CSRC, "threefry.cu"), [])


def bind(lib):
    """Declares the C interface of threefry.cu on a loaded library."""
    u, ll, vp = ctypes.c_uint, ctypes.c_longlong, ctypes.c_void_p
    lib.qzk_threefry_draw.argtypes = [u, u, vp, ll, vp]
    lib.qzk_threefry_draw.restype = ctypes.c_int
    lib.qzk_threefry_blocks.argtypes = [ll]
    lib.qzk_threefry_blocks.restype = ll
    return lib


def _lib():
    if _Kernels.lib is None:
        with _LOCK:
            if _Kernels.lib is None:
                _Kernels.lib = bind(ctypes.CDLL(library_path()))
    return _Kernels.lib


def draw(key: tuple[int, int], shape, device) -> torch.Tensor:
    """The draw of `shape` under `key` (two 32-bit words) on the CUDA
    `device`, by K8; an empty shape launches nothing."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"K8 draws on a CUDA device, not {device}")
    k0, k1 = (int(k) for k in key)
    if not (0 <= k0 < 1 << 32 and 0 <= k1 < 1 << 32):
        raise ValueError(f"key words {key} are not 32-bit")
    out = torch.empty(tuple(int(s) for s in shape), dtype=torch.int64, device=device)
    n = out.numel()
    if n == 0:
        return out
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("a blinding draw must not be captured: the graph would freeze its key")
    lib = _lib()
    with torch.cuda.device(device):
        err = lib.qzk_threefry_draw(k0, k1, out.data_ptr(), n,
                                    torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"qzk_threefry_draw: CUDA error {err}")
    with _LOCK:
        LAUNCHES["threefry_draw"] += 1
    return out

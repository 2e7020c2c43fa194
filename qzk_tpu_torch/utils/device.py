"""Which device an entry point runs on, and the constants kept there."""

from __future__ import annotations

import threading

import torch


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device: CUDA unless the caller asks for the
    CPU.  Raises when CUDA is asked for (or implied) and there is no
    card: the port never drops to the CPU by itself."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain torch path on the CPU"
        )
    return dev


# Small per-device tables (round constants, index vectors, field
# constants), uploaded at first use and kept: an upload inside a prove
# is a host round trip, and one inside a captured CUDA graph would be
# an error.
_CONSTANTS: dict = {}
_CONSTANTS_LOCK = threading.Lock()


def device_constant(key, device, make) -> torch.Tensor:
    """make() (a tensor on `device`), built once per (key, device)."""
    k = (key, str(torch.device(device)))
    t = _CONSTANTS.get(k)
    if t is None:
        t = make()
        with _CONSTANTS_LOCK:
            t = _CONSTANTS.setdefault(k, t)
    return t

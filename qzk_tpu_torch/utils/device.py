"""Which device an entry point runs on."""

from __future__ import annotations

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

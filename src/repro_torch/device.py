"""Device resolution: the port's counterpart of ``repro.kernels.ops._on_accelerator``.

Entry points run on the card.  The CPU is used only when the caller asks
for it with ``device="cpu"`` (the tests do); there, every kernel wrapper
takes its plain PyTorch version.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

MIN_CAPABILITY = (9, 0)   # Hopper: the kernels are built for sm_90a


def resolve(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``"cuda"``.  A CUDA device must exist and be Hopper or
    newer; anything else raises rather than running somewhere unexpected."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; the port runs on an NVIDIA Hopper card "
            "unless device='cpu' is passed")
    cap = torch.cuda.get_device_capability(dev)
    if tuple(cap) < MIN_CAPABILITY:
        raise RuntimeError(
            f"{torch.cuda.get_device_name(dev)} has compute capability "
            f"{cap[0]}.{cap[1]}; the kernels need sm_90a (Hopper)")
    return dev

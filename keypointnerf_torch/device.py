"""Default-device resolution for the port's entry points.

Entry points run on the card unless the caller asks for another device;
nothing falls back to the CPU on its own.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`device`, or CUDA when None; raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "keypointnerf_torch: no CUDA device is available; pass "
            "device='cpu' to run on the CPU"
        )
    return dev

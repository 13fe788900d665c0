"""Default-device resolution for the port's entry points.

Entry points run on the card unless the caller asks for another device;
nothing falls back to the CPU on its own.
"""
from __future__ import annotations

import functools
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


def tracing() -> bool:
    """True while torch.compile or torch.export traces the caller: the
    tensors it makes then are the trace's (fake) tensors, valid only
    inside it."""
    return torch.compiler.is_compiling() or torch.compiler.is_exporting()


def cached(make):
    """`make(*key)` made once a key in eager code (a tensor built from host
    values is copied to the card, and that copy waits for the work queued
    before it), and made anew, uncached, inside a trace (`tracing`): a
    trace's tensor in the cache would be returned to every later eager
    call. Callers must not write to the tensors."""
    stored = functools.lru_cache(maxsize=256)(make)

    @functools.wraps(make)
    def get(*key):
        return make(*key) if tracing() else stored(*key)

    return get


@cached
def constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """The tensor of `values` (a Python number or a tuple of them) as
    `dtype` on `device`, made once a (values, dtype, device) (`cached`)."""
    return torch.tensor(values, dtype=dtype, device=device)

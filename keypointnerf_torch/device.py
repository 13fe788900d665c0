"""Default-device resolution for the port's entry points, and the
deterministic mode of training.

Entry points run on the card unless the caller asks for another device;
nothing falls back to the CPU on its own.

The training step is bit-reproducible: the same inputs, weights, draws
and process layout give the same loss terms, gradients and parameters on
every run, as the JAX package's step does. K1 sums in a fixed order by
its design; torch's own ops need `deterministic_training`, in which every
training step runs. cuBLAS reads CUBLAS_WORKSPACE_CONFIG when the
process makes its first cuBLAS handle (and torch checks it at its first
cuBLAS call), so it is put in place when this module is imported, before
any work of the port's on the card; a value the caller set stays.
"""
from __future__ import annotations

import contextlib
import functools
import os
from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]

# cuBLAS's fixed workspace (8 buffers of 4 MiB), which torch requires before
# it runs cuBLAS in deterministic mode
CUBLAS_WORKSPACE_CONFIG = ":4096:8"
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE_CONFIG)


@contextlib.contextmanager
def deterministic_training():
    """Deterministic mode for the body, and the mode as it was after: every
    training step runs in it (`training.train.train_batch_step_fn`, the
    ICON step), and nothing outside a step does, so a render or an export
    keeps torch's defaults. The mode: torch's deterministic algorithms in
    strict mode (an op with no deterministic implementation raises),
    cuDNN's deterministic algorithms without autotuning, and
    CUBLAS_WORKSPACE_CONFIG (a caller's own value stays). torch would also
    fill every new tensor (torch.empty) with NaN in this mode, a debugging
    aid that costs a pass over each buffer and changes no value the port
    computes: that stays off."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE_CONFIG)
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled(),
           torch.utils.deterministic.fill_uninitialized_memory,
           torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
        torch.utils.deterministic.fill_uninitialized_memory = was[2]
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = was[3:]


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
